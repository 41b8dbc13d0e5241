"""Host ms of a call's ``result()`` outside its wait for the copy: the
program's ``sample.result`` span less its ``sample.result.wait`` child,
which leaves the unpad and the shuffle. The mean over the traced window's
calls. It reads ``result_finish_ms.<cells>``."""
from harness.spans import window_spans


def read(ctx):
    results = window_spans(ctx, "sample.result")
    waits = window_spans(ctx, "sample.result.wait")
    if results is None or waits is None:
        return None
    wait_of = {w.parent_id: w.duration_s for w in waits}
    if any(r.span_id not in wait_of for r in results):
        return None
    return 1e3 * sum(r.duration_s - wait_of[r.span_id]
                     for r in results) / len(results)
