"""Rows handed back on the host over the whole window, to the end of its
last call."""


def read(ctx):
    r = ctx.record
    return r["rows"] / r["elapsed_s"]
