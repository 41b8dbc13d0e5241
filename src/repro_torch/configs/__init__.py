"""Architecture registry: ``--arch <id>`` resolution.

Each registered architecture has a module here exporting ``config()`` (the
exact published configuration) and ``reduced()`` (a tiny same-family config
for CPU tests), copied from the JAX package's ``repro.configs``. The port
serves the ``dense`` family, so only ``smollm-135m`` is registered so far.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ArchConfig

_ARCH_MODULES: Dict[str, str] = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str, reduced: bool = False) -> ArchConfig:
    """Resolve an architecture id to its (full or reduced) config."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.reduced() if reduced else mod.config()
