"""Launches of the hist kernel (its wrapper's counter,
``repro_torch.kernels.hist.ops.histogram.launches``) per ensemble fitted in
the traced window."""


def read(ctx):
    n = ctx.record.get("hist_launches", 0)
    if n <= 0:
        return None
    return n / ctx.record["ensembles"]
