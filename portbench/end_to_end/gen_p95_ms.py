"""The 95th percentile of every call's latency in the window (issue to
rows on the host), in ms: over all calls, never over medians of chunks."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.record["latencies_s"], 95))
