"""Kernels the device ran in the traced window (copies and sets left out)
per call."""


def read(ctx):
    if ctx.trace is None or ctx.trace.n_kernels <= 0:
        return None
    return ctx.trace.n_kernels / len(ctx.record["calls"])
