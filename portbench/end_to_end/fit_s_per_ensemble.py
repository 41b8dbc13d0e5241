"""Seconds of the window, up to the end of its last call, over the
ensembles of every call completed in it."""


def read(ctx):
    r = ctx.record
    return r["elapsed_s"] / r["ensembles"]
