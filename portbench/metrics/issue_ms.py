"""Host ms of a call's ``sample_async`` (the program's ``sample.issue``
span: labels, x1, enqueuing the solve, the copy), the mean over the traced
window's calls. It reads ``issue_ms.<cells>``."""
from harness.spans import mean_ms, window_spans


def read(ctx):
    return mean_ms(window_spans(ctx, "sample.issue"))
