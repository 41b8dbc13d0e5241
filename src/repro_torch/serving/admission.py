"""Admission control: priority/SLO buckets, per-tenant token buckets,
bounded queues, explicit backpressure.

A copy of the JAX package's ``repro.serving.admission`` (stdlib only;
importing that package's ``serving`` would load jax, so the port keeps its
own):

* two priority classes, ``interactive`` and ``bulk`` (``PRIORITIES``); the
  scheduler always drains interactive first, so bulk traffic can saturate
  the device without moving the interactive tail;
* per-tenant token buckets metered in *rows* (the unit of device work, not
  requests — one 4096-row bulk call costs what 64 interactive 64-row calls
  cost); a tenant over its rate gets :class:`RateLimited` with a concrete
  ``retry_after_s`` instead of a slot in a queue it will time out of;
* per-priority bounded queues — a full queue raises :class:`QueueFull`
  (reject-with-retry-after, the open-loop-load answer to unbounded
  buffering);
* per-request deadlines: the scheduler drops a request whose deadline
  passed *before* spending device time on it and fails its future with
  :class:`DeadlineExceeded`.

``offer``/``pop``/``pop_matching`` are the scheduler-facing queue API; the
batch former uses ``pop_matching`` to coalesce same-(model, sampler)
requests across both priority classes while leaving everything else queued.

Per-tenant accounting lives in :mod:`repro_torch.obs` instruments
(``admission_requests_total{tenant,outcome}`` etc.): instruments are
internally lock-guarded, the queue-depth gauge is updated under ``_cond``
alongside the deques it mirrors, and ``stats_snapshot()`` keeps its dict
shape as a fold over the registry.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from repro_torch.obs import MetricsRegistry

PRIORITIES = ("interactive", "bulk")

#: ``pop()`` returns this once the controller is closed *and* drained —
#: requests accepted before ``close()`` are always served first.
CLOSED = object()

_OUTCOMES = ("admitted", "rejected_rate", "rejected_queue")


class AdmissionError(RuntimeError):
    """Rejected at the door. ``retry_after_s`` tells a well-behaved caller
    when to come back (the HTTP front end maps it to ``Retry-After``)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class RateLimited(AdmissionError):
    """Tenant token bucket empty."""


class QueueFull(AdmissionError):
    """Priority queue at its bound (or the server is shutting down)."""


class DeadlineExceeded(RuntimeError):
    """Request expired while queued; dropped before dispatch."""


class TokenBucket:
    """Rows/sec token bucket with lazy monotonic-clock refill.

    Not thread-safe on its own — the controller serialises access under its
    condition lock.
    """

    def __init__(self, rate_rows_per_s: float, burst_rows: float):
        self.rate = float(rate_rows_per_s)
        self.burst = float(burst_rows)
        self.tokens = self.burst
        self._last = None  # first take() starts the clock

    def take(self, rows: float, now: float) -> Optional[float]:
        """Consume ``rows`` tokens. Returns ``None`` when granted, else the
        seconds until enough tokens will have refilled (the request is NOT
        queued against future tokens — retry-after, not reservation)."""
        if self._last is None:
            self._last = now
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if rows <= self.tokens:
            self.tokens -= rows
            return None
        deficit = rows - self.tokens
        return deficit / max(self.rate, 1e-9)


class AdmissionController:
    """The scheduler's front door: rate-limit, bound, and order requests.

    ``tenant_rates`` maps tenant name -> ``(rate_rows_per_s, burst_rows)``;
    ``default_rate`` (same tuple) applies to tenants without an explicit
    entry, ``None`` meaning unmetered. ``queue_limits`` bounds the number of
    queued requests per priority class.  ``metrics`` shares a
    :class:`~repro_torch.obs.MetricsRegistry` with the other serving components
    (default: a private registry, so tests never share counters).
    """

    DEFAULT_QUEUE_LIMITS = {"interactive": 256, "bulk": 1024}

    def __init__(self, *, queue_limits: Optional[Dict[str, int]] = None,
                 tenant_rates: Optional[Dict[str, Tuple[float, float]]] = None,
                 default_rate: Optional[Tuple[float, float]] = None,
                 clock=time.monotonic,
                 metrics: Optional[MetricsRegistry] = None):
        self.queue_limits = dict(self.DEFAULT_QUEUE_LIMITS)
        self.queue_limits.update(queue_limits or {})
        self._rates = dict(tenant_rates or {})
        self._default_rate = default_rate
        self._buckets: Dict[str, TokenBucket] = {}
        self._clock = clock
        self._cond = threading.Condition()
        self._queues = {p: deque() for p in PRIORITIES}
        self._closed = False
        self.metrics = metrics or MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "admission_requests", "Admission decisions by tenant and "
            "outcome (admitted / rejected_rate / rejected_queue)",
            ("tenant", "outcome"))
        self._m_rows = self.metrics.counter(
            "admission_rows", "Rows admitted past the front door",
            ("tenant",))
        self._m_queued = self.metrics.gauge(
            "admission_queued", "Requests waiting per priority class",
            ("priority",))
        self._m_queue_limit = self.metrics.gauge(
            "admission_queue_limit", "Configured queue bound per priority "
            "class", ("priority",))
        for p in PRIORITIES:
            self._m_queued.set(0, priority=p)
            self._m_queue_limit.set(self.queue_limits[p], priority=p)

    # -- tenant accounting ---------------------------------------------------

    def _bucket_for_locked(self, tenant: str) -> Optional[TokenBucket]:
        """Caller holds ``_cond`` (buckets are mutated lazily here)."""
        if tenant in self._buckets:
            return self._buckets[tenant]
        spec = self._rates.get(tenant, self._default_rate)
        if spec is None:
            return None
        bucket = TokenBucket(*spec)
        self._buckets[tenant] = bucket
        return bucket

    def charge(self, tenant: str, rows: int) -> None:
        """Meter ``rows`` against ``tenant``'s bucket without queueing —
        the unbatched paths (HTTP ``/v1/impute``) pay for device time too."""
        with self._cond:
            bucket = self._bucket_for_locked(tenant)
            if bucket is not None:
                retry = bucket.take(rows, self._clock())
                if retry is not None:
                    self._m_requests.inc(1, tenant=tenant,
                                         outcome="rejected_rate")
                    raise RateLimited(
                        f"tenant {tenant!r} over its row rate", retry)
            self._m_requests.inc(1, tenant=tenant, outcome="admitted")
            self._m_rows.inc(rows, tenant=tenant)

    # -- queue API (scheduler-facing) ----------------------------------------

    def offer(self, req) -> None:
        """Admit or reject ``req`` (a scheduler Request). Raises
        :class:`RateLimited` / :class:`QueueFull`; on success the request is
        queued and the scheduler woken."""
        if req.priority not in PRIORITIES:
            raise ValueError(f"priority={req.priority!r}: "
                             f"expected one of {PRIORITIES}")
        with self._cond:
            if self._closed:
                raise QueueFull("server is shutting down", 1.0)
            bucket = self._bucket_for_locked(req.tenant)
            if bucket is not None:
                retry = bucket.take(req.n, self._clock())
                if retry is not None:
                    self._m_requests.inc(1, tenant=req.tenant,
                                         outcome="rejected_rate")
                    raise RateLimited(
                        f"tenant {req.tenant!r} over its row rate "
                        f"({req.n} rows)", retry)
            q = self._queues[req.priority]
            limit = self.queue_limits[req.priority]
            if len(q) >= limit:
                self._m_requests.inc(1, tenant=req.tenant,
                                     outcome="rejected_queue")
                # no reservation to base an estimate on; one dispatch
                # window is the cheapest honest hint
                raise QueueFull(
                    f"{req.priority} queue at its bound ({limit})", 0.05)
            self._m_requests.inc(1, tenant=req.tenant, outcome="admitted")
            self._m_rows.inc(req.n, tenant=req.tenant)
            q.append(req)
            span = getattr(req, "span", None)
            if span is not None:
                # depth *seen at admit* (self included) — the per-request
                # trace shows how deep the line was when this request joined
                span.attrs["queue_depth"] = len(q)
            self._m_queued.set(len(q), priority=req.priority)
            self._cond.notify()

    def pop(self, timeout: Optional[float] = None):
        """Highest-priority queued request; ``CLOSED`` once closed and
        drained; ``None`` on timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                for p in PRIORITIES:
                    if self._queues[p]:
                        req = self._queues[p].popleft()
                        self._m_queued.set(len(self._queues[p]), priority=p)
                        return req
                if self._closed:
                    return CLOSED
                left = (None if deadline is None
                        else deadline - self._clock())
                if left is not None and left <= 0:
                    return None
                self._cond.wait(left)

    def pop_matching(self, model: str, sampler: str, max_rows: int,
                     timeout: float = 0.0):
        """First queued request for the same (model, sampler) whose row
        count fits ``max_rows`` — scanning interactive before bulk, leaving
        everything else queued. Blocks up to ``timeout`` for one to arrive;
        ``None`` when the window closes empty-handed."""
        deadline = self._clock() + timeout
        with self._cond:
            while True:
                for p in PRIORITIES:
                    q = self._queues[p]
                    for i, r in enumerate(q):
                        if (r.model == model and r.sampler == sampler
                                and r.n <= max_rows):
                            del q[i]
                            self._m_queued.set(len(q), priority=p)
                            return r
                if self._closed:
                    return None
                left = deadline - self._clock()
                if left <= 0:
                    return None
                self._cond.wait(left)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Stop admitting; already-queued requests still drain via pop()."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        with self._cond:
            self._closed = False

    def queued(self) -> Dict[str, int]:
        with self._cond:
            return {p: len(q) for p, q in self._queues.items()}

    # -- read side -----------------------------------------------------------

    @property
    def stats(self) -> Dict[str, dict]:
        """Per-tenant counters — a read-only view folded from the metrics
        registry."""
        return self._tenants_view()

    def _tenants_view(self) -> Dict[str, dict]:
        with self.metrics.lock:
            req = self._m_requests.series()   # (tenant, outcome) -> n
            rows = self._m_rows.series()      # (tenant,) -> n
        tenants = {t for t, _ in req} | {t for (t,) in rows}
        return {
            t: {
                "admitted": int(req.get((t, "admitted"), 0)),
                "rows": int(rows.get((t,), 0)),
                "rejected_rate": int(req.get((t, "rejected_rate"), 0)),
                "rejected_queue": int(req.get((t, "rejected_queue"), 0)),
            }
            for t in sorted(tenants)
        }

    def stats_snapshot(self) -> dict:
        """``queued`` / ``queue_limits`` / ``tenants``, folded from the same
        instruments ``GET /metrics`` exports."""
        with self._cond:
            queued = {p: len(q) for p, q in self._queues.items()}
        return {"queued": queued,
                "queue_limits": dict(self.queue_limits),
                "tenants": self._tenants_view()}
