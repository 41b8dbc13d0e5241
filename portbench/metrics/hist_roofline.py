"""The histogram calls' share of their roofline: the least time of every
traced ``build_histogram`` call at its shapes (each input read once, each
output written once, at 3.35 TB/s and 67 TFLOP/s) over the device time of
the operations launched inside the ``bench.hist`` spans (the kernel and its
layout passes)."""
from harness.work import bound_s, hist_bytes_ops


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.span_device_s("bench.hist")
    if dev <= 0:
        return None
    least = sum(bound_s(*hist_bytes_ops(*s))
                for s in ctx.shapes["hist_shapes"])
    return 100.0 * least / dev
