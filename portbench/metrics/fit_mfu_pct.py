"""The whole fit's share of the card's peaks: the least time of the
required work of every ensemble of the traced window (each round and lane:
every level's histograms written once and read once by the split search,
the codes at one byte and the gradients read once a level, the leaf sums)
over the window's time."""
from harness.work import fit_round_s


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    s = ctx.shapes
    per_round = fit_round_s(s["n"], s["p"], s["out"], s["depth"],
                            s["n_bins"])
    least = ctx.record["ensembles"] * s["lanes"] * s["rounds"] * per_round
    return 100.0 * least / ctx.record["elapsed_s"]
