"""The median latency of the traced window's calls (issue to rows on the
host), in ms."""
import numpy as np


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * float(np.percentile(ctx.record["latencies_s"], 50))
