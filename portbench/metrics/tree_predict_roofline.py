"""The forest-predict calls' share of their roofline: the least time of
every traced ``forest_predict`` call at its shapes (each input read once,
the output written once) over the device time of the operations launched
inside the ``bench.tree_predict`` spans (routing and summing kernels)."""
from harness.work import bound_s, predict_bytes_ops


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.span_device_s("bench.tree_predict")
    if dev <= 0:
        return None
    least = sum(bound_s(*predict_bytes_ops(*s))
                for s in ctx.shapes["predict_shapes"])
    return 100.0 * least / dev
