"""Architecture registry: ``--arch <id>`` resolution.

Each registered architecture has a module here exporting ``config()`` (the
exact published configuration) and ``reduced()`` (a tiny same-family config
for CPU tests), copied from the JAX package's ``repro.configs``: all ten
of its architectures, in its order.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ArchConfig

_ARCH_MODULES: Dict[str, str] = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
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
