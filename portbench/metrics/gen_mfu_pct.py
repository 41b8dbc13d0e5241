"""The whole generate call's share of the card's peaks: the least time of
the required work of every call of the traced window (each solver step:
the rows read and written once, the step's trees read once) over the
window's time."""
from harness.work import generate_call_s


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    s = ctx.shapes
    per_call = generate_call_s(s["n_y"], s["rows"], s["p"], s["T"],
                               s["depth"], s["out"], s["steps"])
    return 100.0 * len(ctx.record["calls"]) * per_call / ctx.record[
        "elapsed_s"]
