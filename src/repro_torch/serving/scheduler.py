"""InflightScheduler: admission-controlled micro-batching with in-flight
dispatch.

The port's twin of the JAX package's ``repro.serving.scheduler``. A
drain-then-serve loop (form a batch, dispatch it, block on the result,
split rows, repeat) makes every request wait queue-time + full device-time
of everything ahead of it, and the device idles while the host
copies out and delivers the previous batch.

This scheduler splits those roles across two threads, riding the property
that :func:`repro_torch.tabgen.sample_async` returns once the solve and
its copy to pinned host memory are enqueued on the device:

* the **scheduler thread** pops admitted requests (interactive before
  bulk), coalesces same-(model, sampler) requests within a short window,
  and *dispatches* the batch — ``ModelHandle.generate_async`` returns as
  soon as the work is enqueued on the device;
* the **waiter thread** resolves in-flight batches in dispatch order:
  wait for the batch's own copy event, copy out/decode, slice rows back per
  request, deliver futures, account stats.

While the waiter waits on batch ``k``, the scheduler is already admitting
and dispatching batch ``k+1`` — the device queue stays fed, so queue wait
no longer stacks on device time. Batch ``k``'s copy to the host was
enqueued before batch ``k+1``'s solve, so the waiter never waits for the
device work of a later batch. ``inflight_depth`` bounds how many
dispatched-but-unresolved batches may exist (backpressure against flooding
the device queue); ``sync_resolve=True`` degrades to the drain-then-serve
loop (kept as the reference arm).

Request lifecycle: ``submit()`` validates eagerly (unknown model / sampler
raise to the *caller*, not into a future after a wasted dispatch), the
admission controller rate-limits and bounds queues
(:class:`~repro_torch.serving.admission.RateLimited` /
:class:`~repro_torch.serving.admission.QueueFull`), expired deadlines fail
with :class:`~repro_torch.serving.admission.DeadlineExceeded` before any
device time is spent, and cancelled futures are dropped at batch-claim
time.

Observability: every request carries a ``serve.queue`` span from
``submit()`` to batch-claim, and every dispatched batch a ``serve.device``
span from dispatch to resolution — queue-wait vs device-time is *span
durations*, and the same spans feed the :mod:`repro_torch.obs` instruments
behind ``stats_snapshot()``, ``/statz`` and ``GET /metrics``. Pass a
shared ``metrics=``/``tracer=`` pair (as ``serve_http`` does) to co-export
with the admission controller and model registry; the default is a private
pair per scheduler so tests and benchmark arms never share counters.

Request-scoped tracing: ``submit()`` mints (or accepts) a ``request_id``,
stamps it on the ``serve.queue`` span as its ``trace_id``, and the
``serve.device`` span *links* every request id the coalesced batch served —
so ``tracer.trace(rid)`` reconstructs the per-request timeline (admission
-> queue wait -> batch id -> device time -> sync) that
``GET /v1/trace/<id>`` returns. One ``time.monotonic()`` reading per
request drives both the span start and the absolute deadline, so the SLO
clock can never skew from the trace clock. Per-priority latency objectives
(``slo=``) feed ``serving_slo_requests`` / ``serving_slo_violations``
counters — a request *violates* when its submit->delivery latency exceeds
its priority's objective, or when it is dropped at the deadline — and
resolved requests over the :class:`~repro_torch.obs.SlowLog` threshold
dump their linked span timeline to the slow-log JSONL.

A batch is ``registry.dispatch``: on a registry with a mesh, that is a
collective that rank 0 publishes to the other ranks
(:mod:`repro_torch.serving.spmd`). The waiter issues none.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, List, Optional

from repro_torch.obs import MetricsRegistry, SlowLog, Tracer
from repro_torch.serving.admission import (CLOSED, AdmissionController,
                                     DeadlineExceeded)
from repro_torch.serving.registry import (  # noqa: F401
    ModelRegistry, UnknownModel)

#: Seed base of the micro-batched path: coalesced batches draw their own
#: sample seeds from a scheduler-local counter offset far from the ones
#: users hand to ``generate(seed=...)``, so the two paths never collide in
#: the label-draw RNG space.
BATCH_SEED_BASE = 1 << 20

_SHUTDOWN = object()

_EMPTY_HIST = {"buckets": (), "sum": 0.0, "count": 0}


@dataclasses.dataclass
class Request:
    """One queued generation request (``n``, ``sampler`` and ``future``
    first, positionally, as the JAX package's)."""
    n: int
    sampler: str
    future: Future
    model: str = "default"
    tenant: str = "default"
    priority: str = "interactive"
    enqueued_s: float = dataclasses.field(default_factory=time.monotonic)
    deadline_s: Optional[float] = None  # absolute time.monotonic()
    span: Optional[object] = None       # serve.queue span (set by submit)
    request_id: str = ""                # trace id minted/accepted by submit


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unresolved batch travelling to the waiter."""
    handle: object            # ModelHandle snapshot the batch runs on
    sample: object            # SampleHandle / _DecodingHandle
    batch: List[Request]
    total_rows: int
    span: object              # serve.device span (dispatch -> resolution)


class InflightScheduler:
    def __init__(self, registry: ModelRegistry,
                 admission: Optional[AdmissionController] = None, *,
                 max_coalesce_rows: Optional[int] = None,
                 coalesce_window_s: float = 0.002,
                 inflight_depth: int = 2,
                 sync_resolve: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 slo: Optional[Dict[str, float]] = None,
                 slo_error_budget: float = 0.01,
                 slow_log: Optional[SlowLog] = None):
        self.registry = registry
        self.admission = admission or AdmissionController()
        # default row cap = the largest bucket: coalescing past it would
        # push the merged batch into oversize exact-size territory, a
        # padded shape of its own per distinct total
        self.max_coalesce_rows = int(max_coalesce_rows
                                     or max(registry.buckets))
        self.coalesce_window_s = float(coalesce_window_s)
        self.inflight_depth = int(inflight_depth)
        self.sync_resolve = bool(sync_resolve)
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer or Tracer()
        m = self.metrics
        self._m_requests = m.counter(
            "serving_requests", "Generation requests resolved",
            ("sampler", "tenant"))
        self._m_rows = m.counter(
            "serving_rows", "Rows generated and delivered",
            ("sampler", "tenant"))
        self._h_queue_wait = m.histogram(
            "serving_queue_wait_seconds",
            "Per-request wait from submit to batch dispatch "
            "(serve.queue span durations)", ("sampler", "tenant"))
        self._h_device = m.histogram(
            "serving_device_seconds",
            "Per-batch device time from dispatch to resolution "
            "(serve.device span durations); count = batches", ("sampler",))
        self._m_coalesced = m.counter(
            "serving_coalesced_requests",
            "Requests that rode a batch they did not open")
        self._m_dropped = m.counter(
            "serving_dropped_deadline",
            "Requests dropped before dispatch: queued past their deadline")
        self._m_warm = m.counter(
            "serving_warmup_seconds", "Wall time spent in sampler warmup")
        self._m_inflight = m.gauge(
            "serving_inflight", "Dispatched-but-unresolved batches now")
        self._m_inflight_max = m.gauge(
            "serving_inflight_max",
            "High-watermark of concurrently in-flight batches")
        # SLO layer: objectives come from flags / module constants, never
        # from benchmark cfg dicts (record identity must not change)
        if slo_error_budget <= 0:
            raise ValueError(
                f"slo_error_budget={slo_error_budget} must be > 0")
        self.slo = {str(k): float(v) for k, v in (slo or {}).items()}
        self.slo_error_budget = float(slo_error_budget)
        self.slow_log = slow_log
        self._g_slo_objective = m.gauge(
            "serving_slo_objective_seconds",
            "Configured per-priority latency objective", ("priority",))
        self._m_slo_requests = m.counter(
            "serving_slo_requests",
            "Requests measured against a latency objective", ("priority",))
        self._m_slo_violations = m.counter(
            "serving_slo_violations",
            "Requests over their priority's latency objective "
            "(deadline drops included)", ("priority",))
        for prio, objective in self.slo.items():
            if objective <= 0:
                raise ValueError(
                    f"slo[{prio!r}]={objective} must be > 0 seconds")
            self._g_slo_objective.set(objective, priority=prio)
        self._seed_lock = threading.Lock()
        self._batch_seed = 0
        self._inflight_q: "queue.Queue" = queue.Queue(maxsize=self.inflight_depth)
        self._scheduler_t: Optional[threading.Thread] = None
        self._waiter_t: Optional[threading.Thread] = None
        self._lifecycle_lock = threading.Lock()

    # -- public API ----------------------------------------------------------

    def submit(self, n: int, *, model: str = "default",
               sampler: Optional[str] = None, tenant: str = "default",
               priority: str = "interactive",
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None) -> Future:
        """Queue a generation request; resolves to ``(X, y)``.

        Validation is eager: an unknown model raises
        :class:`~repro_torch.serving.registry.UnknownModel` and a sampler the
        model doesn't serve raises :class:`ValueError` here, to the caller —
        never inside the dispatcher after a wasted dispatch attempt.
        Admission rejections (:class:`RateLimited` / :class:`QueueFull`)
        also raise here: explicit backpressure, not unbounded queueing.
        ``deadline_s`` is a *relative* SLO; a request still queued when it
        lapses fails with :class:`DeadlineExceeded` before dispatch.

        ``request_id`` is the trace identity (minted here when the caller
        doesn't bring one, e.g. from an ingress header); it is stamped on
        the returned future (``future.request_id``) and indexes the
        request's timeline under ``tracer.trace(request_id)``.
        """
        handle = self.registry.peek(model)
        name = sampler or handle.samplers[0]
        if name not in handle.samplers:
            raise ValueError(
                f"model {model!r} does not serve sampler {name!r}; "
                f"served: {list(handle.samplers)}")
        rid = request_id or uuid.uuid4().hex[:16]
        # one clock reading drives the span start AND the absolute
        # deadline: deriving the deadline from a tracer-owned timestamp
        # coupled SLO arithmetic to tracer internals (and skewed if a
        # tracer subclass adjusted t_start)
        now = time.monotonic()
        span = self.tracer.start(
            "serve.queue", trace_id=rid, t_start=now,
            model=model, sampler=name, tenant=tenant,
            priority=priority, rows=int(n))
        req = Request(int(n), name, Future(), model=model, tenant=tenant,
                      priority=priority, enqueued_s=now,
                      deadline_s=None if deadline_s is None
                      else now + float(deadline_s),
                      span=span, request_id=rid)
        req.future.request_id = rid
        # enqueue under the lifecycle lock: a submit racing with stop()
        # could otherwise land behind the close with no threads left to
        # serve it — the lock serialises the two, so the request either
        # precedes the drain or gets fresh threads
        with self._lifecycle_lock:
            self._start_locked()
            t0 = time.monotonic()
            try:
                self.admission.offer(req)
            except BaseException:
                span.end(outcome="rejected")
                raise
            span.attrs["admission_s"] = time.monotonic() - t0
        return req.future

    def start(self) -> None:
        with self._lifecycle_lock:
            self._start_locked()

    def stop(self, timeout: float = 10.0) -> None:
        """Drain admitted requests, then stop both threads."""
        with self._lifecycle_lock:
            if self._scheduler_t is None:
                return
            self.admission.close()
            self._scheduler_t.join(timeout)
            if self._waiter_t is not None:
                self._waiter_t.join(timeout)
            self._scheduler_t = None
            self._waiter_t = None

    def rows_per_sec(self) -> float:
        with self.metrics.lock:
            return self._m_rows.sum() / max(self._h_device.sum(), 1e-9)

    @property
    def stats(self) -> dict:
        """A dict *view* over the metrics registry (``server.stats["rows"]``;
        see ``stats_snapshot``)."""
        return self.stats_snapshot()

    def stats_snapshot(self) -> dict:
        """Stats dict folded from the metrics registry.

        The JAX package's keys (``requests``, ``rows``, ``gen_s``,
        ``warm_s``, ``batches``, ``coalesced_requests``, ``queue_wait_s``,
        ``device_s``, ``dropped_deadline``, ``max_inflight_observed``,
        ``per_sampler``, ``per_tenant``, ``inflight``, ``slo``) — every
        number derived from the same instruments ``GET /metrics`` exports,
        so the two surfaces cannot disagree. The fold runs under the
        registry lock: one consistent cut. ``slo`` (``{}`` when no
        objectives are configured) maps each priority to its objective,
        measured request / violation counts, violation rate, and
        error-budget burn (violation rate over the allowed budget; > 1.0
        means the budget is being spent faster than allotted).
        """
        with self.metrics.lock:
            req = self._m_requests.series()      # (sampler, tenant) -> n
            rows = self._m_rows.series()
            qw = self._h_queue_wait.series()     # (sampler, tenant) -> hist
            dev = self._h_device.series()        # (sampler,) -> hist
            coalesced = self._m_coalesced.get()
            dropped = self._m_dropped.get()
            warm = self._m_warm.get()
            inflight = self._m_inflight.get()
            inflight_max = self._m_inflight_max.get()
            slo_req = self._m_slo_requests.series()      # (priority,) -> n
            slo_viol = self._m_slo_violations.series()
        slo = {}
        for prio, objective in sorted(self.slo.items()):
            n = int(slo_req.get((prio,), 0))
            v = int(slo_viol.get((prio,), 0))
            rate = v / n if n else 0.0
            slo[prio] = {
                "objective_s": objective,
                "requests": n,
                "violations": v,
                "violation_rate": rate,
                "error_budget": self.slo_error_budget,
                "budget_burn": rate / self.slo_error_budget,
            }
        per_sampler = {}
        for s in sorted({k[0] for k in req} | {k[0] for k in dev}):
            d = dev.get((s,), _EMPTY_HIST)
            per_sampler[s] = {
                "requests": int(sum(v for k, v in req.items() if k[0] == s)),
                "rows": int(sum(v for k, v in rows.items() if k[0] == s)),
                "batches": int(d["count"]),
                "queue_wait_s": sum(h["sum"] for k, h in qw.items()
                                    if k[0] == s),
                "device_s": d["sum"],
            }
        per_tenant = {}
        for t in sorted({k[1] for k in req}):
            per_tenant[t] = {
                "requests": int(sum(v for k, v in req.items() if k[1] == t)),
                "rows": int(sum(v for k, v in rows.items() if k[1] == t)),
                "queue_wait_s": sum(h["sum"] for k, h in qw.items()
                                    if k[1] == t),
            }
        device_s = sum(h["sum"] for h in dev.values())
        return {
            "requests": int(sum(req.values())),
            "rows": int(sum(rows.values())),
            "gen_s": device_s,
            "warm_s": warm,
            "batches": int(sum(h["count"] for h in dev.values())),
            "coalesced_requests": int(coalesced),
            "queue_wait_s": sum(h["sum"] for h in qw.values()),
            "device_s": device_s,
            "dropped_deadline": int(dropped),
            "max_inflight_observed": int(inflight_max),
            "per_sampler": per_sampler,
            "per_tenant": per_tenant,
            "inflight": int(inflight),
            "slo": slo,
        }

    # -- bookkeeping shared with the synchronous server path -----------------

    def record_warm(self, wall_s: float) -> None:
        self._m_warm.inc(wall_s)

    def record_sync(self, *, n: int, sampler: str, tenant: str,
                    wall_s: float) -> None:
        """Account a synchronous ``generate()`` served outside the queue
        (one request = one batch, zero queue wait)."""
        with self.metrics.lock:
            self._m_requests.inc(1, sampler=sampler, tenant=tenant)
            self._m_rows.inc(n, sampler=sampler, tenant=tenant)
            self._h_queue_wait.observe(0.0, sampler=sampler, tenant=tenant)
            self._h_device.observe(wall_s, sampler=sampler)

    # -- threads -------------------------------------------------------------

    def _start_locked(self) -> None:
        if self._scheduler_t is None or not self._scheduler_t.is_alive():
            self.admission.reopen()
            self._scheduler_t = threading.Thread(
                target=self._scheduler_loop, name="serving-scheduler",
                daemon=True)
            self._scheduler_t.start()
        if not self.sync_resolve and (
                self._waiter_t is None or not self._waiter_t.is_alive()):
            self._waiter_t = threading.Thread(
                target=self._waiter_loop, name="serving-waiter", daemon=True)
            self._waiter_t.start()

    def _expired(self, req: Request, now: Optional[float] = None) -> bool:
        """Drop a deadline-lapsed request before dispatch; True if dropped."""
        if req.deadline_s is None:
            return False
        now = time.monotonic() if now is None else now
        if now <= req.deadline_s:
            return False
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceeded(
                f"deadline lapsed {now - req.deadline_s:.3f}s ago while "
                "queued"))
        if req.span is not None:
            req.span.end(outcome="deadline")
        self._m_dropped.inc()
        # a deadline drop is the worst latency outcome there is: it burns
        # error budget even though no latency was ever measured
        if req.priority in self.slo:
            self._m_slo_requests.inc(1, priority=req.priority)
            self._m_slo_violations.inc(1, priority=req.priority)
        return True

    def _scheduler_loop(self) -> None:
        while True:
            req = self.admission.pop(timeout=0.1)
            if req is CLOSED:
                if not self.sync_resolve:
                    self._inflight_q.put(_SHUTDOWN)
                return
            if req is None or self._expired(req):
                continue
            batch, rows = [req], req.n
            deadline = time.monotonic() + self.coalesce_window_s
            while rows < self.max_coalesce_rows:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                nxt = self.admission.pop_matching(
                    req.model, req.sampler, self.max_coalesce_rows - rows,
                    timeout=left)
                if nxt is None:
                    break
                if self._expired(nxt):
                    continue
                batch.append(nxt)
                rows += nxt.n
            inflight = self._dispatch(batch)
            if inflight is None:
                continue
            if self.sync_resolve:
                # drain-then-serve (the reference arm): the scheduler
                # blocks until the batch resolves, so nothing overlaps
                # device time
                self._resolve(inflight)
            else:
                self._inflight_q.put(inflight)  # bounded: dispatch backpressure

    def _waiter_loop(self) -> None:
        while True:
            item = self._inflight_q.get()
            if item is _SHUTDOWN:
                return
            self._resolve(item)

    # -- batch mechanics -----------------------------------------------------

    def _dispatch(self, batch: List[Request]) -> Optional[_Inflight]:
        """Claim futures, snapshot the model, enqueue one device program.
        Returns the in-flight record (or None if nothing survived)."""
        # claim each future first: a client that cancelled while queued is
        # dropped here — set_result on a cancelled Future raises and would
        # otherwise kill the scheduler thread, stranding the whole batch
        claimed = []
        for r in batch:
            if r.future.set_running_or_notify_cancel():
                claimed.append(r)
            elif r.span is not None:
                r.span.end(outcome="cancelled")
        batch = claimed
        if not batch:
            return None
        total = sum(r.n for r in batch)
        with self._seed_lock:
            batch_id = self._batch_seed
            seed = BATCH_SEED_BASE + batch_id
            self._batch_seed += 1
        # the device span opens *before* placement: acquire() may promote a
        # cold model, and that cost belongs to device time. It *links*
        # every request id it serves: the coalesced batch belongs to N
        # traces at once.
        trace_ids = tuple(r.request_id for r in batch if r.request_id)
        dspan = self.tracer.start(
            "serve.device", links=trace_ids,
            model=batch[0].model, sampler=batch[0].sampler,
            rows=total, requests=len(batch), batch_id=batch_id)
        for r in batch:
            if r.span is not None:
                r.span.end(batch_id=batch_id)   # queue wait: submit -> claim
        try:
            handle, sample = self.registry.dispatch(
                batch[0].model, total, batch[0].sampler, seed=seed)
        except BaseException as exc:  # noqa: BLE001 — delivered via futures
            dspan.end(outcome="error")
            for r in batch:
                r.future.set_exception(exc)
            return None
        # fakes in the control-plane tests return bare handles: tag() is
        # best-effort context for downstream tooling, not a contract
        tag = getattr(sample, "tag", None)
        if tag is not None:
            tag(batch_id=batch_id, trace_ids=trace_ids)
        v = self._m_inflight.inc(1)
        self._m_inflight_max.set_max(v)
        return _Inflight(handle, sample, batch, total, dspan)

    def _resolve(self, inflight: _Inflight) -> None:
        """Wait for the batch's copy to the host, deliver per-request
        slices, account queue-wait vs device-time from the batch's
        spans."""
        batch = inflight.batch
        t_sync = time.monotonic()
        try:
            X, y = inflight.sample.result()
        except BaseException as exc:  # noqa: BLE001 — delivered via futures
            inflight.span.end(outcome="error")
            for r in batch:
                r.future.set_exception(exc)
            self._m_inflight.dec(1)
            return
        dt = inflight.span.end(sync_s=time.monotonic() - t_sync,
                               outcome="ok")
        off = 0
        for r in batch:
            r.future.set_result((X[off:off + r.n], y[off:off + r.n]))
            off += r.n
        now = time.monotonic()
        sampler = batch[0].sampler
        with self.metrics.lock:
            self._m_inflight.dec(1)
            self._h_device.observe(dt, sampler=sampler)
            self._m_coalesced.inc(len(batch) - 1)
            for r in batch:
                self._m_requests.inc(1, sampler=sampler, tenant=r.tenant)
                self._m_rows.inc(r.n, sampler=sampler, tenant=r.tenant)
                wait = (r.span.duration_s if r.span is not None
                        else inflight.span.t_start - r.enqueued_s)
                self._h_queue_wait.observe(wait, sampler=sampler,
                                           tenant=r.tenant)
                if r.priority in self.slo:
                    self._m_slo_requests.inc(1, priority=r.priority)
                    if now - r.enqueued_s > self.slo[r.priority]:
                        self._m_slo_violations.inc(1, priority=r.priority)
        # slow-log writes after delivery, outside the metrics lock: file
        # I/O must never serialise the accounting hot path
        if self.slow_log is not None:
            for r in batch:
                lat = now - r.enqueued_s
                if lat <= self.slow_log.threshold_s:
                    continue
                spans = [r.span.to_dict()] if r.span is not None else []
                spans.append(inflight.span.to_dict())
                self.slow_log.record({
                    "request_id": r.request_id,
                    "latency_s": lat,
                    "model": r.model,
                    "sampler": sampler,
                    "tenant": r.tenant,
                    "priority": r.priority,
                    "rows": r.n,
                    "batch_id": inflight.span.attrs.get("batch_id"),
                    "spans": spans,
                })

    def serve_batch_sync(self, batch: List[Request]) -> None:
        """Dispatch + resolve one pre-formed batch on the calling thread —
        the test seam (and the drain arm's inner step)."""
        inflight = self._dispatch(batch)
        if inflight is not None:
            self._resolve(inflight)
