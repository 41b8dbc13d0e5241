"""Host ms of a call's ``result()`` (the ``bench.result`` span: the wait
for the copy, unpad and shuffle), the mean over the traced window's
calls."""


def read(ctx):
    if ctx.trace is None:
        return None
    host = ctx.trace.span_host_s("bench.result")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
