"""The program's own spans of a traced window, read from the ring of
``repro_torch.obs.default_tracer()``, into which every generate call
records its eight ``sample.*`` spans (``tabgen/sampling.py``).

The window issues and resolves each of its calls once, after the warm-up
and before the check, so its calls' spans of a name are the newest
``len(ctx.record["calls"])`` of that name in the ring.
"""
from __future__ import annotations

from typing import List, Optional


def window_spans(ctx, name: str) -> Optional[List]:
    """The window's spans named ``name``, one a call, oldest first; ``None``
    outside a traced run, or when the ring holds fewer than the window's
    calls (a program that records no such span, or a ring too small)."""
    if ctx.trace is None:
        return None
    from repro_torch.obs import default_tracer
    calls = len(ctx.record["calls"])
    spans = default_tracer().spans(name=name)
    if calls == 0 or len(spans) < calls:
        return None
    return spans[-calls:]


def mean_ms(spans: Optional[List]) -> Optional[float]:
    """The mean host ms of ``spans`` (``None`` for ``None``)."""
    if spans is None:
        return None
    return 1e3 * sum(s.duration_s for s in spans) / len(spans)
