"""Host µs to enqueue one solver step: the host time of the traced window's
``sample.solve`` spans (the solver call and its unscale; on the card the
host enqueuing every step) over the steps they ran (their ``steps``). It
reads ``step_enqueue_us.<cells>``."""
from harness.spans import window_spans


def read(ctx):
    solves = window_spans(ctx, "sample.solve")
    if solves is None:
        return None
    steps = sum(s.attrs["steps"] for s in solves)
    if steps <= 0:
        return None
    return 1e6 * sum(s.duration_s for s in solves) / steps
