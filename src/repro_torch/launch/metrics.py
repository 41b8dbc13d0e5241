"""Offline metrics dump: Prometheus text without an HTTP server.

The port's batch runs (``train_forest``, ``ingest``) have no server to
scrape, so their ``--metrics-dump`` flag writes the exposition format at
exit through :func:`dump`, from the process-wide
:func:`repro_torch.obs.default_registry` that the fit pipeline and
``DatasetStore`` ingest instrument.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from repro_torch.obs import (MetricsRegistry, default_registry,
                             render_prometheus)


def dump(path: Optional[str] = None, *,
         registries: Optional[Sequence[MetricsRegistry]] = None) -> str:
    """Render ``registries`` (default: the process-wide default registry)
    to Prometheus text; write to ``path`` (``"-"``/``None`` = stdout) and
    return the text."""
    regs = list(registries) if registries else [default_registry()]
    text = render_prometheus(*regs)
    if path is None or path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote metrics to {path}")
    return text
