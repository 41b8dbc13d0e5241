"""The plain summing kernel's share of the multi-output summing launches of
the traced window, in %: Σ ``sum_plain`` / Σ (``sum_tma`` + ``sum_plain``)
× 100 over the window's ``sample.solve`` spans. The two attributes are the
``tree_predict`` launcher's own report of how each summing launch was fed
its leaves: by TMA (``sum_tma_kernel``, which needs a 16-byte-aligned leaf
row) or by ``cp.async`` from all threads (``sum_kernel``). It reads 100 at
an unaligned width such as the pions' 533 outputs, 0 where every launch
took TMA. It reads ``tree_sum_plain_pct.<cells>``.

A program whose spans carry no ``sum_tma`` / ``sum_plain`` (one older than
the attributes) is read from the device trace instead: ``sum_kernel``'s
share of the device time of the two summing kernels, which equals the
share of launches wherever the window ran one kind alone, as a cell's
fixed width does. Nothing is read where neither shows a summing launch.
"""
import re

from harness.spans import window_spans

PLAIN = re.compile(r"(^|[^A-Za-z0-9])sum_kernel")
TMA = re.compile(r"(^|[^A-Za-z0-9])sum_tma_kernel")


def share(plain, tma):
    """``plain``'s share of ``plain + tma`` in %; ``None`` for none."""
    return 100.0 * plain / (plain + tma) if plain + tma > 0 else None


def read(ctx):
    if ctx.trace is None:
        return None
    solves = window_spans(ctx, "sample.solve")
    if solves is not None and all("sum_tma" in s.attrs
                                  and "sum_plain" in s.attrs
                                  for s in solves):
        return share(sum(s.attrs["sum_plain"] for s in solves),
                     sum(s.attrs["sum_tma"] for s in solves))
    ops = ctx.trace.device_ops
    return share(sum(t for name, t in ops if PLAIN.search(name)),
                 sum(t for name, t in ops if TMA.search(name)))
