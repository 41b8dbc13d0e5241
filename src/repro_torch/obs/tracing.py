"""Lightweight span tracing: ring-buffered, queryable, cross-thread safe.

A :class:`Span` is a named interval with attributes; a :class:`Tracer`
collects completed spans into a bounded ring (old spans evict, memory is
O(capacity) forever).  Two usage shapes:

* ``with tracer.span("fit.batch", batch=3) as sp:`` — scoped work on
  one thread.  Nesting is tracked per-thread, so ``sp.parent_id`` links
  child to parent and a flamegraph falls out of the JSONL export.
* ``sp = tracer.start("serve.queue", ...); ... sp.end()`` — intervals
  that *cross* threads (a request enqueued on the HTTP thread and claimed
  by the scheduler thread).  This is how the serving hot path measures
  queue-wait and device-time: span durations, not hand-stamped deltas.

Spans can carry *trace context* (PR 10): ``start(..., trace_id=rid)``
stamps a request identity on a span, ``start(..., links=(rid1, rid2))``
marks a span (e.g. one coalesced ``serve.device`` batch) as serving many
request traces at once, and ``tracer.trace(rid)`` returns every completed
span indexed under that id — the per-request timeline behind
``GET /v1/trace/<id>``.  ``start(..., t_start=now)`` lets the caller
supply the clock reading, so a deadline computed from the same reading
can never skew from the span (the scheduler's one-reading contract).

``tracer.spans(name=...)`` queries completed spans (oldest first);
``tracer.export_jsonl(path)`` dumps them for offline tooling (truncating
by default; ``append=True`` accumulates across dumps — the
:class:`SlowLog` below is always append).

The profiler mirror: ``Tracer(torch_annotations=True)``, or
``REPRO_OBS_TORCH_TRACE=1`` when ``torch_annotations`` is ``None`` (read
per span, not at import), also opens each *scoped* span as a
``torch.profiler.record_function`` range of the same name, so a
``torch.profiler`` capture (``POST /debug/profile``,
``scripts/profile_torch_generation.py``) holds the program's spans on the
device trace's clock and an idle gap can be put down to the span the host
was in.  Cross-thread ``start()``/``end()`` spans stay host-only.  Its one
hazard: on a CUDA device a range also shows as a device-side annotation
over the operations launched inside it, so a reader of a capture that
counts every device event as work counts the program's annotations too;
keep events named as spans apart from device operations.  Off, the mirror
costs one environment lookup a span.  A copy of the JAX package's
``repro.obs.tracing``, whose ``REPRO_OBS_JAX_TRACE`` mirror into
``jax.profiler`` this one follows.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Span", "SlowLog", "Tracer"]


class Span:
    """One timed interval.  Create via ``Tracer.start`` / ``Tracer.span``.

    ``trace_id`` names the request trace this span *belongs to* (one
    ``serve.queue`` span per request); ``links`` are the trace ids a span
    *served* without belonging to any single one (one coalesced
    ``serve.device`` batch links every request it carried).  Both index
    the span under ``Tracer.trace``.
    """

    __slots__ = ("name", "attrs", "span_id", "parent_id", "thread",
                 "t_start", "t_end", "trace_id", "links", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, object],
                 span_id: int, parent_id: Optional[int], *,
                 trace_id: Optional[str] = None,
                 links: Sequence[str] = (),
                 t_start: Optional[float] = None):
        self.name = name
        self.attrs = attrs
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = threading.current_thread().name
        self.t_start = time.monotonic() if t_start is None else float(t_start)
        self.t_end: Optional[float] = None
        self.trace_id = trace_id
        self.links: Tuple[str, ...] = tuple(links)
        self._tracer = tracer

    @property
    def duration_s(self) -> float:
        """Seconds from start to end (to *now* while still open)."""
        end = self.t_end if self.t_end is not None else time.monotonic()
        return end - self.t_start

    def end(self, **attrs) -> float:
        """Close the span (idempotent), record it, return the duration.

        Extra keyword attributes merge in at close — e.g.
        ``sp.end(outcome="deadline")`` on the drop path.
        """
        if self.t_end is None:
            self.t_end = time.monotonic()
            if attrs:
                self.attrs.update(attrs)
            self._tracer._record(self)
        return self.t_end - self.t_start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "links": list(self.links),
            "thread": self.thread,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "duration_s": None if self.t_end is None else self.duration_s,
            "attrs": self.attrs,
        }

    def __repr__(self):
        state = f"{self.duration_s * 1e3:.2f}ms" if self.t_end else "open"
        return f"Span({self.name!r}, {state}, attrs={self.attrs!r})"


class Tracer:
    """Bounded ring of completed spans + per-thread nesting stacks.

    ``capacity`` bounds memory: the ring holds the newest N completed
    spans and silently evicts the oldest.  All mutation happens under one
    lock; ``start``/``end`` are a few dict ops, cheap enough for the
    serving hot path (one queue span per request, one device span per
    batch).  ``torch_annotations`` turns the profiler mirror on or off
    (module docstring); ``None`` leaves it to ``REPRO_OBS_TORCH_TRACE``.
    """

    def __init__(self, capacity: int = 2048,
                 torch_annotations: Optional[bool] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._torch_annotations = torch_annotations
        self._lock = threading.Lock()
        # eviction is manual (not deque(maxlen=...)): the trace index below
        # must drop exactly the spans the ring drops, or an evicted span
        # would pin memory and serve stale lookups forever
        self._ring: deque = deque()
        self._by_trace: Dict[str, List[Span]] = {}
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- internals -----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @staticmethod
    def _trace_ids(span: Span) -> Iterable[str]:
        """Every trace id a span is indexed under: its own + its links."""
        if span.trace_id is not None:
            yield span.trace_id
        for tid in span.links:
            if tid != span.trace_id:
                yield tid

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            for tid in self._trace_ids(span):
                self._by_trace.setdefault(tid, []).append(span)
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                for tid in self._trace_ids(old):
                    bucket = self._by_trace.get(tid)
                    if bucket is not None:
                        try:
                            bucket.remove(old)
                        except ValueError:
                            pass
                        if not bucket:
                            del self._by_trace[tid]

    def _torch_annotation(self, name: str):
        """A ``torch.profiler.record_function`` range for scoped spans, or
        a null context.  The env knob is read per call, not at import."""
        on = self._torch_annotations
        if on is None:
            on = os.environ.get("REPRO_OBS_TORCH_TRACE", "") not in ("", "0")
        if not on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    # -- span creation -------------------------------------------------------

    def start(self, name: str, *, trace_id: Optional[str] = None,
              links: Sequence[str] = (),
              t_start: Optional[float] = None, **attrs) -> Span:
        """Begin a span that may end on a *different* thread.

        The parent link comes from the starting thread's active scoped
        span (if any).  Call ``span.end()`` to close and record it.

        ``trace_id`` / ``links`` index the span for :meth:`trace` lookups;
        ``t_start`` overrides the start timestamp with a clock reading the
        caller already took (``time.monotonic()`` domain), so one reading
        can drive both the span and caller-side arithmetic (deadlines).
        The three names are reserved — they cannot be used as span attrs.
        """
        st = self._stack()
        parent = st[-1].span_id if st else None
        return Span(self, name, attrs, next(self._ids), parent,
                    trace_id=trace_id, links=links, t_start=t_start)

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             links: Sequence[str] = (), **attrs):
        """Scoped span: times the ``with`` body, tracks nesting."""
        sp = self.start(name, trace_id=trace_id, links=links, **attrs)
        st = self._stack()
        st.append(sp)
        try:
            with self._torch_annotation(name):
                yield sp
        finally:
            st.pop()
            sp.end()

    # -- read side -----------------------------------------------------------

    def spans(self, name: Optional[str] = None,
              prefix: Optional[str] = None) -> List[Span]:
        """Completed spans, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        if prefix is not None:
            out = [s for s in out if s.name.startswith(prefix)]
        return out

    def trace(self, trace_id: str) -> List[Span]:
        """Completed spans indexed under ``trace_id`` (the span's own id
        or one of its ``links``), ordered by start time.  Empty when the
        id is unknown *or its spans were evicted from the ring* — callers
        (``GET /v1/trace/<id>``) must treat the two the same."""
        with self._lock:
            out = list(self._by_trace.get(trace_id, ()))
        out.sort(key=lambda s: s.t_start)
        return out

    def durations(self, name: str) -> List[float]:
        return [s.duration_s for s in self.spans(name=name)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_trace.clear()

    def export_jsonl(self, path: str, *, append: bool = False) -> int:
        """Write completed spans as JSON lines; returns the span count.

        **Truncates** ``path`` by default: each export is a self-contained
        snapshot of the ring (dumping twice yields one ring's worth of
        spans, not two).  Pass ``append=True`` to accumulate exports in
        one file — e.g. periodic dumps from a long-running server.  The
        slow-request log is different on purpose: :class:`SlowLog` always
        appends, because each record is written exactly once, as it
        happens, and must survive later dumps.
        """
        spans = self.spans()
        with open(path, "a" if append else "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
        return len(spans)


class SlowLog:
    """Append-only JSONL sink for slow-request timelines.

    The scheduler writes one record per resolved request whose latency
    (submit -> delivery) exceeds ``threshold_s``: the request identity,
    its latency, and the linked span timeline (queue + device spans).
    Unlike :meth:`Tracer.export_jsonl`, records are *appended* as they
    happen — a restarted server extends the same file, and an operator
    can tail it live.  The file is created eagerly so "no slow requests"
    reads as an empty file, not a missing one.
    """

    def __init__(self, path: str, threshold_s: float):
        if threshold_s < 0:
            raise ValueError(f"threshold_s={threshold_s} must be >= 0")
        self.path = path
        self.threshold_s = float(threshold_s)
        self._lock = threading.Lock()
        self.written = 0
        with open(path, "a"):
            pass

    def record(self, payload: dict) -> None:
        """Append one JSON record (thread-safe, flushed per line)."""
        line = json.dumps(payload, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
            self.written += 1
