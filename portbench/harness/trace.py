"""Spans around the program's layers, and the reading of a device trace.

Spans: in a traced run (``--trace 1``) the benchmark wraps a few functions
of the program, by name, in ``torch.profiler.record_function`` ranges
called ``bench.<what>`` (:class:`Wrapper`); in an untimed run nothing is
wrapped, so the end-to-end metrics are measured with tracing off. A wrapper
may also record the arguments' shapes of each call, so that a roofline can
count the work of exactly the calls the trace timed.

Trace: :func:`summarise` reads a finished ``torch.profiler.profile`` into a
:class:`Trace`: every device operation (kernels, copies, sets) and every
``bench.*`` range with the device time of the operations launched inside
it, the traced window (the ``bench.window`` range), the union of device
time inside it (``busy_s``), the operations that took most time and the
longest idle gaps, each labelled by the innermost ``bench.*`` range the host
was in when the device went idle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"


class Wrapper:
    """Replace ``module.attr`` by a wrapper that runs it inside a
    ``record_function(span)`` range and passes its arguments to ``note``
    (when given); :meth:`restore` puts the original back."""

    def __init__(self):
        self._saved: List[Tuple[object, str, Callable]] = []

    def wrap(self, module: str, attr: str, span: str,
             note: Optional[Callable] = None) -> None:
        import torch
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            if note is not None:
                note(*args, **kwargs)
            with torch.profiler.record_function(span):
                return orig(*args, **kwargs)

        self._saved.append((mod, attr, orig))
        setattr(mod, attr, wrapped)

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


def span(name: str, active: bool):
    """A ``record_function`` range when tracing, else nothing."""
    if not active:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    """A traced window. Times in seconds."""
    window_s: float
    busy_s: float
    n_kernels: int
    # bench.* range name -> [(host seconds, device seconds of its ops)]
    spans: Dict[str, List[Tuple[float, float]]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def span_device_s(self, name: str) -> float:
        return sum(d for _, d in self.spans.get(name, []))

    def span_host_s(self, name: str) -> List[float]:
        return [h for h, _ in self.spans.get(name, [])]

    @property
    def idle_pct(self) -> float:
        return 100.0 * (self.window_s - self.busy_s) / self.window_s


def merge(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def label_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
               ranges: List[Tuple[float, float, str]]
               ) -> List[Tuple[str, float]]:
    """The idle gaps of ``[lo, hi]`` outside ``busy``, summed by the
    innermost (latest-starting) of ``ranges`` that covers a gap's start,
    longest first."""
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    ranges = sorted(ranges)
    starts = [s for s, _, _ in ranges]
    by: Dict[str, float] = {}
    for a, b in gaps:
        label = "host outside any bench span"
        for k in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if ranges[k][1] > a:
                label = ranges[k][2]
                break
        by[label] = by.get(label, 0.0) + (b - a)
    return sorted(by.items(), key=lambda kv: -kv[1])


def _inside(busy: List[Tuple[float, float]], starts: List[float],
            a: float, b: float) -> float:
    """The length of ``busy`` (sorted, disjoint; ``starts`` its starts)
    inside ``[a, b]``."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    for s, e in busy[k:]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def summarise(prof, top: int = 10) -> Trace:
    """Read a finished profile whose window ran inside a
    :data:`WINDOW` range.

    A ``record_function`` range shows twice in the trace: on the host, and
    on the device as an annotation from the first operation launched in it
    to the end of the last. Device operations are the device events that
    are not annotations; a span's device time is the device's busy time
    inside its annotations (one stream: only its own operations run
    there)."""
    from torch.autograd import DeviceType
    ops, ranges, notes = [], [], {}
    window = None
    host: Dict[str, List[float]] = {}
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith("bench."):
                notes.setdefault(ev.name, []).append((tr.start, tr.end))
            else:
                ops.append((tr.start, tr.end, ev.name))
        elif ev.name == WINDOW:
            window = (tr.start, tr.end)
        elif ev.name.startswith("bench."):
            ranges.append((tr.start, tr.end, ev.name))
            host.setdefault(ev.name, []).append((tr.end - tr.start) * 1e-6)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = window
    inside = [(a, b, name) for a, b, name in ops if b > lo and a < hi]
    busy = merge([(a, b) for a, b, _ in inside], lo, hi)
    starts = [a for a, _ in busy]
    spans = {}
    for name, hosts in host.items():
        dev = [_inside(busy, starts, a, b) * 1e-6
               for a, b in notes.get(name, [])]
        dev += [0.0] * (len(hosts) - len(dev))
        spans[name] = list(zip(hosts, dev))
    by_op: Dict[str, float] = {}
    for a, b, name in inside:
        by_op[name] = by_op.get(name, 0.0) + (min(b, hi) - max(a, lo)) * 1e-6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(name, s * 1e-6) for name, s in
            label_gaps(busy, lo, hi, ranges)][:top]
    return Trace(window_s=(hi - lo) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 n_kernels=sum(1 for _, _, name in inside
                               if not name.startswith(("Memcpy", "Memset"))),
                 spans=spans, device_ops=device_ops, idle_gaps=gaps)
