"""The share of the traced window in which no operation ran on the device
(the union of the device's kernels, copies and sets, from the profiler's
trace). It reads ``device_idle_pct.<cells>``, whichever part names the
cells that report it."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.idle_pct
