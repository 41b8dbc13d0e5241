"""Device ms of the split search (the operations launched inside the
``bench.best_splits`` spans around ``repro_torch.forest.tree.best_splits``)
per ensemble fitted in the traced window."""


def read(ctx):
    if ctx.trace is None or "bench.best_splits" not in ctx.trace.spans:
        return None
    dev = ctx.trace.span_device_s("bench.best_splits")
    if dev <= 0:
        return None
    return 1e3 * dev / ctx.record["ensembles"]
