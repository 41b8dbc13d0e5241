"""Tree walks a second in the forest-predict kernels, in G walks/s: a walk
is one row routed from the root of one tree of one lane to its leaf. The
walks of the traced window's calls are Σ (n_y · m rows, the program's
``sample.issue`` attributes) × ``lanes`` × ``trees`` × ``steps`` (the
attributes of the ``sample.solve`` span under that issue); the time is
the device time of the operations launched inside the
``bench.tree_predict`` spans. It counts no bytes, so it does not rest on a
byte model as ``tree_predict_roofline`` does. It reads
``tree_walks_g_per_s.<cells>``.

A program whose ``sample.solve`` spans carry no ``lanes`` / ``trees`` (one
older than those attributes) is read from the shapes of the kernel calls
that the benchmark's wrapper noted, which count the same walks (B·n rows ×
S lanes × T trees a call), so that its traced run reports the metric too.
"""
from harness.spans import window_spans


def span_walks(issues, solves):
    """The walks of the window's calls from the program's spans; ``None``
    where a solve lacks its issue or an attribute."""
    issue_of = {s.span_id: s for s in issues}
    walks = 0
    for s in solves:
        iss = issue_of.get(s.parent_id)
        if iss is None or "lanes" not in s.attrs or "trees" not in s.attrs:
            return None
        walks += (iss.attrs["n_y"] * iss.attrs["m"] * s.attrs["lanes"]
                  * s.attrs["trees"] * s.attrs["steps"])
    return walks


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.span_device_s("bench.tree_predict")
    issues = window_spans(ctx, "sample.issue")
    solves = window_spans(ctx, "sample.solve")
    if dev <= 0 or issues is None or solves is None:
        return None
    if any("lanes" in s.attrs for s in solves):
        walks = span_walks(issues, solves)
    else:                                   # a program without the attributes
        walks = sum(B * n * S * T for B, S, T, _, _, _, n
                    in ctx.shapes["predict_shapes"])
    if not walks:
        return None
    return 1e-9 * walks / dev
