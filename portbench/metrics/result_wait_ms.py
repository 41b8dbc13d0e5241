"""Host ms a call's ``result()`` waits for its copy to reach the host (the
program's ``sample.result.wait`` span), the mean over the traced window's
calls. It reads ``result_wait_ms.<cells>``."""
from harness.spans import mean_ms, window_spans


def read(ctx):
    return mean_ms(window_spans(ctx, "sample.result.wait"))
