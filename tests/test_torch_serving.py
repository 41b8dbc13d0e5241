"""The port's forest serving plane against the JAX package, on the CPU.

``repro_torch.serving`` (admission, registry, scheduler) and the launchers
over it are the JAX package's ``repro.serving`` with torch tensors under
them. Held here:

* admission: the same offers, pops and charges on an injected clock give
  the same outcomes and ``retry_after_s`` in both packages;
* registry: a model saved by the JAX package and loaded by the port has
  the same buckets and bytes, and the same acquire sequence gives the same
  hot set and event counts;
* scheduler: twins of the JAX package's fake-registry tests
  (``tests/test_serving_control_plane.py``), and end to end, served rows
  equal to a ``sample()`` replay of their batch bit for bit;
* the kernel build module and the launch counters under concurrent first
  use;
* ``obs``: the profiler and the resource monitor on the CPU;
* the refresh loop, ingest -> fit -> serve -> append + extend -> reload.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro.config import ForestConfig as JForestConfig
from repro.data.tabular import two_moons
from repro.launch import metrics as jmetrics
from repro.serving import AdmissionController as JAdmission
from repro.serving import ModelRegistry as JRegistry
from repro.serving import QueueFull as JQueueFull
from repro.serving import RateLimited as JRateLimited
from repro.serving import TokenBucket as JTokenBucket
from repro.serving.registry import ModelHandle as JHandle
from repro.serving.registry import artifacts_nbytes as j_nbytes
from repro.tabgen import fit_artifacts as j_fit
from repro_torch.config import ForestConfig
from repro_torch.kernels import build
from repro_torch.launch import metrics as tmetrics
from repro_torch.launch.serve_forest import ForestServer
from repro_torch.obs import (MetricsRegistry, ProfileInProgress, Profiler,
                             ResourceMonitor, Tracer)
from repro_torch.serving import (AdmissionController, DeadlineExceeded,
                                 InflightScheduler, ModelRegistry, QueueFull,
                                 RateLimited, TokenBucket, UnknownModel)
from repro_torch.serving.registry import ModelHandle, artifacts_nbytes
from repro_torch.serving.scheduler import BATCH_SEED_BASE
from repro_torch.tabgen import TabularGenerator, fit_artifacts, sample


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A two-moons flow model trained by the JAX package and saved: the
    port loads the file."""
    X, y = two_moons(240, seed=0)
    cfg = JForestConfig(method="flow", n_t=4, duplicate_k=4, n_trees=6,
                        max_depth=3, n_bins=16, reg_lambda=1.0)
    art = j_fit(X, y, cfg, seed=0)
    path = art.save(str(tmp_path_factory.mktemp("jax_model") / "moons"))
    return art, path


@pytest.fixture(scope="module")
def flow_mo():
    """A tiny MO flow model fitted by the port on the CPU."""
    X, y = two_moons(200, seed=1)
    cfg = ForestConfig(method="flow", n_t=5, duplicate_k=4, n_trees=6,
                       max_depth=3, n_bins=16, reg_lambda=1.0,
                       multi_output=True)
    return fit_artifacts(X, y, cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def diffusion():
    X, y = two_moons(200, seed=2)
    cfg = ForestConfig(method="diffusion", n_t=6, duplicate_k=4, n_trees=6,
                       max_depth=3, n_bins=16, reg_lambda=1.0)
    return fit_artifacts(X, y, cfg, seed=0, device="cpu")


# ---------------------------------------------------------------------------
# admission: the same decisions on an injected clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _req(i, n, tenant="t", priority="interactive", model="m",
         sampler="euler"):
    return type("Req", (), dict(i=i, n=n, tenant=tenant, priority=priority,
                                model=model, sampler=sampler, span=None))()


# (op, args): offers and charges advance the clock by the step given
_SCRIPT = [
    ("offer", (0, 60, "t", "interactive"), 0.0),
    ("offer", (1, 60, "t", "interactive"), 0.0),
    ("offer", (2, 60, "t", "interactive"), 0.0),      # over the burst
    ("offer", (3, 40, "u", "bulk"), 0.1),
    ("offer", (4, 40, "u", "bulk"), 0.0),             # over u's rate
    ("offer", (5, 10, "free", "interactive"), 0.0),
    ("offer", (6, 10, "free", "interactive"), 0.0),   # queue at its bound
    ("charge", ("t", 30), 0.5),
    ("charge", ("t", 500), 0.0),
    ("pop", (), 0.0),
    ("match", ("m", "euler", 50), 0.0),
    ("match", ("m", "heun", 50), 0.0),
    ("pop", (), 0.0),
    ("pop", (), 0.0),
    ("offer", (7, 20, "free", "bulk", "m", "heun"), 0.0),
    ("match", ("m", "heun", 10), 0.0),
    ("match", ("m", "heun", 20), 0.0),
    ("offer", (8, 150, "t", "bulk"), 2.0),
    ("pop", (), 0.0),
    ("offer", (9, 5, "t", "express"), 0.0),
]


def _run_script(Admission, QueueFullE, RateLimitedE):
    clock = _Clock()
    adm = Admission(queue_limits={"interactive": 2, "bulk": 3},
                    tenant_rates={"t": (100.0, 150.0), "u": (50.0, 60.0)},
                    clock=clock)
    out = []
    for op, args, step in _SCRIPT:
        clock.t += step
        try:
            if op == "offer":
                adm.offer(_req(*args))
                out.append("ok")
            elif op == "charge":
                adm.charge(*args)
                out.append("ok")
            else:
                got = (adm.pop(timeout=0) if op == "pop"
                       else adm.pop_matching(*args, timeout=0.0))
                out.append(None if got is None else got.i)
        except (QueueFullE, RateLimitedE) as exc:
            out.append((type(exc).__name__, exc.retry_after_s))
        except ValueError as exc:
            out.append(("ValueError", "priority" in str(exc)))
    return out, adm.stats_snapshot()


def test_admission_decisions_match_jax():
    got = _run_script(AdmissionController, QueueFull, RateLimited)
    ref = _run_script(JAdmission, JQueueFull, JRateLimited)
    assert got == ref
    outcomes = got[0]
    assert ("RateLimited", pytest.approx(0.3)) in outcomes     # t's bucket
    assert any(o[0] == "QueueFull" for o in outcomes if isinstance(o, tuple))


@pytest.mark.parametrize("rate,burst,takes", [
    (10.0, 20.0, [(20, 0.0), (10, 0.0), (10, 1.0), (5, 1.0)]),
    (100.0, 50.0, [(60, 0.0), (50, 0.2), (49, 0.6), (1, 0.6)]),
])
def test_token_bucket_matches_jax(rate, burst, takes):
    a, b = TokenBucket(rate, burst), JTokenBucket(rate, burst)
    for rows, now in takes:
        assert a.take(rows, now) == b.take(rows, now)
        assert a.tokens == b.tokens


# ---------------------------------------------------------------------------
# registry: a JAX-saved model in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_sampler", ["label", "multinomial"])
def test_registry_bucket_and_nbytes_match_jax(jax_model, label_sampler):
    art, path = jax_model
    jart = dataclasses.replace(art, config=dataclasses.replace(
        art.config, label_sampler=label_sampler))
    port = TabularGenerator.load(path, device="cpu").artifacts
    port = dataclasses.replace(port, config=dataclasses.replace(
        port.config, label_sampler=label_sampler))
    buckets = (8, 64, 256)
    j = JHandle("m", jart, buckets=buckets)
    t = ModelHandle("m", port, device="cpu", buckets=buckets)
    for n, seed in [(1, 0), (15, 3), (100, 7), (129, 1), (600, 5),
                    (5000, 11)]:
        assert t.bucket(n, seed) == j.bucket(n, seed), (n, seed)
    assert artifacts_nbytes(port) == j_nbytes(jart)
    assert t.samplers == j.samplers


def test_registry_lru_sequence_matches_jax(jax_model):
    art, path = jax_model
    port = TabularGenerator.load(path, device="cpu").artifacts
    budget = int(j_nbytes(art) * 2.5)              # 2 of 3 hot
    jreg = JRegistry(buckets=(64,), device_budget_bytes=budget)
    treg = ModelRegistry(device="cpu", buckets=(64,),
                         device_budget_bytes=budget)
    for name in ("a", "b", "c"):
        jreg.register(name, art)
        treg.register(name, port)
        assert treg.hot_names() == jreg.hot_names()
    for name in ("a", "b", "a", "c", "c", "b"):
        jreg.acquire(name)
        treg.acquire(name)
        assert treg.hot_names() == jreg.hot_names(), name
    treg.swap("a", port)
    jreg.swap("a", art)
    keys = ("hot", "nbytes", "version", "samplers", "buckets", "n_features",
            "n_classes", "acquires", "promotions", "demotions", "swaps")
    jd, td = jreg.describe(), treg.describe()
    assert set(td) == set(jd)
    for name in jd:
        assert set(td[name]) == set(jd[name])
        assert {k: td[name][k] for k in keys} == \
            {k: jd[name][k] for k in keys}, name
    assert treg.hot_bytes() == jreg.hot_bytes()
    assert treg.stats_snapshot().keys() == jreg.stats_snapshot().keys()


def test_registry_lru_roundtrip_is_bit_identical(flow_mo):
    """Twin of the JAX package's LRU test: a demote / promote round trip
    is invisible to callers, and a cold model still serves."""
    budget = int(artifacts_nbytes(flow_mo) * 2.5)
    reg = ModelRegistry(device="cpu", buckets=(64,),
                        device_budget_bytes=budget)
    for name in ("a", "b", "c"):
        reg.register(name, flow_mo)
    assert reg.hot_names() == ["b", "c"]
    ref_X, ref_y = reg.acquire("a").generate(50, seed=3)
    assert reg.hot_names() == ["a", "c"]
    reg.acquire("b")
    assert reg.hot_names() == ["a", "b"]
    d = reg.describe()
    assert d["a"]["promotions"] == 1 and d["a"]["demotions"] == 1
    assert d["c"]["demotions"] == 1
    X2, y2 = reg.acquire("a").generate(50, seed=3)
    np.testing.assert_array_equal(ref_X, X2)
    np.testing.assert_array_equal(ref_y, y2)
    Xc, _ = reg.peek("c").generate(20, seed=1)
    assert Xc.shape == (20, 2)
    # registry_hot_bytes is the summed tensor bytes of the hot models
    assert reg.metrics.gauge("registry_hot_bytes", "").get() == \
        2 * artifacts_nbytes(flow_mo)


def test_registry_max_hot_cap_and_unknown(flow_mo):
    reg = ModelRegistry(device="cpu", buckets=(64,), max_hot=1)
    reg.register("a", flow_mo)
    reg.register("b", flow_mo)
    assert reg.hot_names() == ["b"]
    reg.acquire("a")
    assert reg.hot_names() == ["a"]
    assert reg.stats_snapshot()["hot_bytes"] > 0
    with pytest.raises(UnknownModel):
        reg.acquire("nope")
    with pytest.raises(UnknownModel):
        reg.swap("nope", flow_mo)


def test_registry_mesh_is_not_ported():
    """``mesh="auto"`` on a host without two GPUs resolves to no mesh, as
    the trainer's does; a value that is not a mesh is refused (sharded
    serving itself: tests/test_torch_sharded_sampling.py)."""
    assert ModelRegistry(device="cpu", mesh="auto").mesh is None
    with pytest.raises(ValueError, match="expected a DeviceMesh"):
        ModelRegistry(device="cpu", mesh="2x1")


def test_registry_register_from_path_keeps_schema(tmp_path):
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.normal(size=120), rng.integers(0, 3, 120),
                         rng.integers(0, 5, 120)]).astype(np.float64)
    cfg = ForestConfig(n_t=3, duplicate_k=3, n_trees=4, max_depth=2,
                       n_bins=8)
    gen = TabularGenerator(cfg, cat_cols=[1], int_cols=[2]).fit(
        X, device="cpu")
    path = gen.save(str(tmp_path / "mixed"))
    reg = ModelRegistry(device="cpu", buckets=(64,))
    handle = reg.register("mixed", path=path)
    assert handle.schema is not None
    Xg, _ = handle.generate(40, seed=2)
    Xr, _ = gen.generate(40, seed=2, pad_to=handle.bucket(40, 2))
    np.testing.assert_array_equal(Xg, Xr)
    assert set(np.unique(Xg[:, 1])) <= {0.0, 1.0, 2.0}
    sample_handle = handle.generate_async(10, "euler", seed=0)
    assert sample_handle.tag(batch_id=4, trace_ids=("r",)) is sample_handle
    assert (sample_handle.batch_id, sample_handle.trace_ids) == (4, ("r",))
    assert sample_handle.ready is None          # the CPU copies nothing


# ---------------------------------------------------------------------------
# scheduler: twins of the fake-registry tests
# ---------------------------------------------------------------------------

class _FakeSample:
    def __init__(self, gate, total):
        self._gate, self._total = gate, total

    def result(self):
        assert self._gate.wait(30), "test gate never opened"
        return (np.zeros((self._total, 2), np.float32),
                np.zeros(self._total, np.int64))


class _FakeHandle:
    samplers = ("euler",)
    buckets = (64,)
    version = 1

    def __init__(self, gate):
        self._gate = gate
        self.dispatched = 0

    def generate_async(self, n, sampler, *, seed):
        self.dispatched += 1
        return _FakeSample(self._gate, n)


class _FakeRegistry:
    buckets = (64,)

    def __init__(self, handle):
        self._handle = handle

    def peek(self, name):
        return self._handle

    def acquire(self, name):
        return self._handle

    def dispatch(self, name, n, sampler, *, seed):
        return self._handle, self._handle.generate_async(n, sampler,
                                                         seed=seed)


def test_inflight_overlap_two_batches_in_flight():
    gate = threading.Event()
    sched = InflightScheduler(_FakeRegistry(_FakeHandle(gate)),
                              coalesce_window_s=0.0, inflight_depth=2)
    try:
        f1 = sched.submit(8)
        f2 = sched.submit(8)
        deadline = time.monotonic() + 20
        while (sched.stats_snapshot()["max_inflight_observed"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert sched.stats_snapshot()["max_inflight_observed"] >= 2
    finally:
        gate.set()
        sched.stop()
    for f in (f1, f2):
        X, y = f.result(timeout=30)
        assert X.shape == (8, 2) and len(y) == 8
    assert sched.stats["batches"] == 2


def test_drain_reference_never_overlaps():
    gate = threading.Event()
    gate.set()
    sched = InflightScheduler(_FakeRegistry(_FakeHandle(gate)),
                              coalesce_window_s=0.0, sync_resolve=True)
    try:
        futs = [sched.submit(8) for _ in range(6)]
        for f in futs:
            f.result(timeout=30)
    finally:
        sched.stop()
    assert sched.stats["max_inflight_observed"] <= 1
    assert sched.stats["requests"] == 6


def test_deadline_expired_dropped_before_dispatch():
    gate = threading.Event()
    handle = _FakeHandle(gate)
    sched = InflightScheduler(_FakeRegistry(handle), coalesce_window_s=0.0,
                              inflight_depth=1, slo={"interactive": 10.0})
    try:
        plug = [sched.submit(8) for _ in range(4)]
        doomed = sched.submit(8, deadline_s=0.05)
        time.sleep(0.4)
    finally:
        gate.set()
        sched.stop()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=30)
    for f in plug:
        assert f.result(timeout=30)[0].shape == (8, 2)
    assert sched.stats["dropped_deadline"] == 1
    assert handle.dispatched == len(plug)
    assert sched.stats["slo"]["interactive"]["violations"] >= 1


def test_queue_full_rejects_with_retry_after():
    gate = threading.Event()
    admission = AdmissionController(queue_limits={"interactive": 2,
                                                  "bulk": 2})
    sched = InflightScheduler(_FakeRegistry(_FakeHandle(gate)), admission,
                              coalesce_window_s=0.0, inflight_depth=1)
    futs = []
    try:
        with pytest.raises(QueueFull) as ei:
            for _ in range(50):
                futs.append(sched.submit(8))
        assert ei.value.retry_after_s > 0
        assert admission.stats_snapshot()["tenants"]["default"][
            "rejected_queue"] >= 1
    finally:
        gate.set()
        sched.stop()
    for f in futs:
        assert f.result(timeout=30)[0].shape == (8, 2)


def test_rate_limited_rejects_with_retry_after():
    gate = threading.Event()
    gate.set()
    admission = AdmissionController(default_rate=(100.0, 100.0))
    sched = InflightScheduler(_FakeRegistry(_FakeHandle(gate)), admission,
                              coalesce_window_s=0.0)
    try:
        ok = sched.submit(80)
        with pytest.raises(RateLimited) as ei:
            sched.submit(80)
        assert 0 < ei.value.retry_after_s < 2.0
        ok.result(timeout=30)
    finally:
        sched.stop()


def test_priority_interactive_pops_before_bulk():
    adm = AdmissionController()
    adm.offer(_req(0, 8, priority="bulk"))
    adm.offer(_req(1, 8, priority="interactive"))
    assert adm.pop(timeout=1).priority == "interactive"
    assert adm.pop(timeout=1).priority == "bulk"
    with pytest.raises(ValueError):
        adm.offer(_req(2, 8, priority="express"))


def test_submit_validates_eagerly(flow_mo):
    server = ForestServer(flow_mo, device="cpu", buckets=(64,))
    with pytest.raises(ValueError, match="no_such"):
        server.submit(16, sampler="no_such")
    with pytest.raises(ValueError, match="no_such"):
        server.generate(16, sampler="no_such")
    with pytest.raises(UnknownModel):
        server.scheduler.submit(16, model="missing")
    server.stop()
    assert server.stats["requests"] == 0


def test_stats_split_per_sampler_and_wait_vs_device(flow_mo):
    server = ForestServer(flow_mo, device="cpu", samplers=("euler", "heun"),
                          buckets=(64,), coalesce_window_s=0.05)
    server.warmup()
    server.generate(20, sampler="euler", seed=0)
    futs = [server.submit(10, sampler="heun", tenant="t1"),
            server.submit(10, sampler="heun", tenant="t2")]
    for f in futs:
        f.result(timeout=120)
    server.stop()
    s = server.scheduler.stats_snapshot()
    assert s["per_sampler"]["euler"]["requests"] == 1
    assert s["per_sampler"]["heun"]["requests"] == 2
    assert s["per_sampler"]["heun"]["rows"] == 20
    assert s["per_tenant"]["t1"]["rows"] == 10
    assert s["per_tenant"]["t2"]["rows"] == 10
    assert s["device_s"] == pytest.approx(
        sum(v["device_s"] for v in s["per_sampler"].values()))
    assert s["queue_wait_s"] >= 0.0 and s["gen_s"] > 0.0


# ---------------------------------------------------------------------------
# scheduler end to end: served rows == sample() replay of their batch
# ---------------------------------------------------------------------------

def replay(tracer, futures, handle, sampler):
    """Hold every request against ``sample()`` of its batch (batch
    membership from the ``serve.device`` spans' links), bit for bit.
    Returns the number of batches."""
    by_id = {f.request_id: f for f in futures}
    batches = tracer.spans(name="serve.device")
    seen = set()
    for span in batches:
        rids = [r for r in span.links if r in by_id]
        if not rids:
            continue
        total = span.attrs["rows"]
        seed = BATCH_SEED_BASE + span.attrs["batch_id"]
        X, y = sample(handle.artifacts, total, sampler=sampler, seed=seed,
                      pad_to=handle.bucket(total, seed))
        off = 0
        for rid in span.links:
            Xr, yr = by_id[rid].result(timeout=0)
            np.testing.assert_array_equal(Xr, X[off:off + len(Xr)])
            np.testing.assert_array_equal(yr, y[off:off + len(Xr)])
            off += len(Xr)
            seen.add(rid)
        assert off == total
    assert seen == set(by_id)
    return len(batches)


@pytest.mark.parametrize("sampler,model", [("euler", "flow_mo"),
                                           ("heun", "flow_mo"),
                                           ("em", "diffusion")])
@pytest.mark.parametrize("sync_resolve", [False, True])
def test_served_rows_equal_sample_replay(request, sampler, model,
                                         sync_resolve):
    art = request.getfixturevalue(model)
    server = ForestServer(art, device="cpu", samplers=(sampler,),
                          buckets=(16, 64), coalesce_window_s=0.02,
                          sync_resolve=sync_resolve)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 60, size=10)
    futs = []
    lock = threading.Lock()

    def client(part):
        for n in part:
            f = server.submit(int(n), priority="bulk" if n > 40
                              else "interactive")
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client, args=(sizes[i::2],))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for f in futs:
        f.result(timeout=120)
    server.stop()
    n_batches = replay(server.tracer, futs, server.registry.peek("default"),
                       sampler)
    assert n_batches == server.stats["batches"]
    assert sorted(len(f.result()[0]) for f in futs) == sorted(sizes)


def test_hot_swap_zero_downtime_under_concurrent_submits(flow_mo):
    """A same-shape swap drops no request: every response is served wholly
    by the old or the new version, rows equal to their batch's replay on
    that version."""
    art_new = dataclasses.replace(flow_mo, mins=flow_mo.mins + 1000.0,
                                  maxs=flow_mo.maxs + 1000.0)
    server = ForestServer(flow_mo, device="cpu", buckets=(64,),
                          coalesce_window_s=0.01)
    old_handle = server.registry.peek(server.MODEL)
    Xb, _ = server.submit(30).result(timeout=120)
    stop = threading.Event()
    futs, futs_lock = [], threading.Lock()

    def hammer():
        while not stop.is_set():
            f = server.submit(10)
            with futs_lock:
                futs.append(f)
            time.sleep(0.002)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    handle = server.registry.swap(server.MODEL, art_new)
    assert handle.version == 2
    time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    Xa, _ = server.submit(30).result(timeout=120)
    server.stop()
    assert Xb.mean() < 500 < Xa.mean()
    n_old = n_new = 0
    for f in futs:
        X, y = f.result(timeout=120)
        assert X.shape == (10, 2) and len(y) == 10
        if (X.mean(axis=1) < 500).all():
            n_old += 1
        else:
            assert (X.mean(axis=1) > 500).all(), "mixed model versions"
            n_new += 1
    assert n_old + n_new == len(futs) and n_new > 0
    assert server.registry.describe()["default"]["swaps"] == 1
    # each batch replays bit-equal on the version it ran on
    by_id = {f.request_id: f for f in futs}
    for span in server.tracer.spans(name="serve.device"):
        if span.links[0] not in by_id:
            continue
        total = span.attrs["rows"]
        seed = BATCH_SEED_BASE + span.attrs["batch_id"]
        Xr = by_id[span.links[0]].result()[0]
        assert any(np.array_equal(Xr, sample(
            h.artifacts, total, seed=seed,
            pad_to=h.bucket(total, seed))[0][:len(Xr)])
            for h in (old_handle, handle))


# ---------------------------------------------------------------------------
# request tracing: twins of tests/test_request_tracing.py
# ---------------------------------------------------------------------------

def test_coalesced_batch_links_every_request(flow_mo):
    server = ForestServer(flow_mo, device="cpu", buckets=(64,),
                          coalesce_window_s=2.0)
    try:
        f1, f2 = server.submit(32), server.submit(32)
        for f in (f1, f2):
            assert len(f.result(timeout=120)[0]) == 32
        r1, r2 = f1.request_id, f2.request_id
        assert r1 != r2
        dev = server.tracer.spans(name="serve.device")
        assert len(dev) == 1 and set(dev[0].links) == {r1, r2}
        tl1, tl2 = server.tracer.trace(r1), server.tracer.trace(r2)
        assert [s.name for s in tl1] == ["serve.queue", "serve.device"]
        assert tl1[1] is dev[0] and tl2[1] is dev[0]
        assert (tl1[0].attrs["batch_id"] == tl2[0].attrs["batch_id"]
                == dev[0].attrs["batch_id"])
    finally:
        server.stop()


class _SkewedTracer(Tracer):
    """Backdates the spans it owns the timestamp for."""

    def start(self, name, *, t_start=None, **kw):
        if t_start is None:
            t_start = time.monotonic() - 999.0
        return super().start(name, t_start=t_start, **kw)


class _SpyAdmission(AdmissionController):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def offer(self, req):
        self.seen.append(req)
        raise QueueFull("spy: rejecting everything", retry_after_s=0.1)


def test_deadline_and_span_share_one_clock_reading(flow_mo):
    metrics = MetricsRegistry()
    registry = ModelRegistry(device="cpu", buckets=(64,), metrics=metrics)
    registry.register("m", flow_mo)
    spy = _SpyAdmission(metrics=metrics)
    sched = InflightScheduler(registry, spy, metrics=metrics,
                              tracer=_SkewedTracer())
    try:
        before = time.monotonic()
        with pytest.raises(QueueFull):
            sched.submit(8, model="m", deadline_s=1.5)
        after = time.monotonic()
        (req,) = spy.seen
        assert req.deadline_s == req.enqueued_s + 1.5
        assert req.span.t_start == req.enqueued_s
        assert before <= req.enqueued_s <= after
        assert req.span.attrs["outcome"] == "rejected"
    finally:
        sched.stop()


def test_slo_violations_and_slow_log_capture(flow_mo, tmp_path):
    import json
    from repro_torch.obs import SlowLog
    slow = SlowLog(str(tmp_path / "slow.jsonl"), threshold_s=0.0)
    server = ForestServer(flow_mo, device="cpu", buckets=(64,),
                          slo={"interactive": 1e-9, "bulk": 10.0},
                          slow_log=slow)
    try:
        f = server.submit(8)
        f.result(timeout=120)
    finally:
        server.stop()
    slo = server.stats["slo"]
    assert slo["interactive"]["objective_s"] == pytest.approx(1e-9)
    assert slo["interactive"]["violations"] == 1
    assert slo["interactive"]["violation_rate"] == 1.0
    assert slo["interactive"]["budget_burn"] >= 1.0
    assert slo["bulk"]["requests"] == 0
    recs = [json.loads(ln) for ln in open(slow.path).read().splitlines()]
    assert len(recs) == 1 and recs[0]["request_id"] == f.request_id
    assert {sp["name"] for sp in recs[0]["spans"]} == {"serve.queue",
                                                       "serve.device"}
    with pytest.raises(ValueError):
        ForestServer(flow_mo, device="cpu", slo_error_budget=0.0)


# ---------------------------------------------------------------------------
# kernels/build.py and the launch counters, from many threads
# ---------------------------------------------------------------------------

def test_build_load_builds_once_under_concurrent_first_use(monkeypatch):
    calls = []

    def slow_build(names):
        calls.extend(names)
        time.sleep(0.2)
        return {n: (f"/nowhere/lib{n}.so", "") for n in names}

    opened = []
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "open_library",
                        lambda path, name: opened.append(path) or object())
    build._load.cache_clear()
    try:
        before = build.load.cache_info()
        barrier = threading.Barrier(8)
        libs = []

        def first_use():
            barrier.wait(timeout=30)
            libs.append(build.load("demo"))

        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert calls == ["demo"] and len(opened) == 1
        assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
        info = build.load.cache_info()
        assert info.misses - before.misses == 1
        assert info.hits - before.hits == 7
    finally:
        build._load.cache_clear()


def test_temp_files_are_named_by_process_and_thread(tmp_path, monkeypatch):
    import os
    monkeypatch.setattr(build, "_HERE", str(tmp_path))
    csrc = tmp_path / "demo" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "demo.cu").write_text("// kernel\n")
    seen = []

    class FakeProc:
        returncode = 1

        def __init__(self, cmd, **kw):
            seen.append((cmd[cmd.index("-o") + 1], threading.get_ident()))

        def communicate(self):
            return ("fake nvcc", None)

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    done = threading.Barrier(4)       # all four alive at once: distinct ids

    def first_use():
        with pytest.raises(RuntimeError, match="fake nvcc"):
            build.build(["demo"])
        done.wait(timeout=30)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    lib = build.library_path("demo")
    assert len(seen) == 4 and len({tmp for tmp, _ in seen}) == 4
    assert all(tmp == f"{lib}.{os.getpid()}.{ident}.tmp"
               for tmp, ident in seen)


def test_launch_counters_lose_no_count():
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                build.count_launch(wrapper)

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 8 * 2000


def test_every_wrapper_counts_through_count_launch():
    import pathlib
    root = pathlib.Path(build.__file__).parent
    bumps = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "launches += 1" in p.read_text()]
    assert bumps == ["build.py"], bumps
    for name in ("tree_predict", "hist", "flash_attention"):
        assert "count_launch(" in (root / name / "ops.py").read_text()


# ---------------------------------------------------------------------------
# obs: profiler and resource monitor
# ---------------------------------------------------------------------------

def test_profiler_serializes_and_clamps_captures(tmp_path):
    prof = Profiler(str(tmp_path / "profiles"), max_seconds=0.3)
    results = {}

    def long_capture():
        results["first"] = prof.capture(5.0)     # clamped to 0.3 s

    t = threading.Thread(target=long_capture)
    t.start()
    deadline = time.monotonic() + 10
    while not prof.active:
        assert time.monotonic() < deadline, "capture never started"
        time.sleep(0.005)
    with pytest.raises(ProfileInProgress):
        prof.capture(0.05)
    t.join(timeout=60)
    first = results["first"]
    assert first["duration_s"] == pytest.approx(0.3)
    assert first["capture"] == 1
    assert (tmp_path / "profiles" / "capture-0001" / "trace.json").exists()
    assert prof.capture(0.01)["capture"] == 2
    with pytest.raises(ValueError):
        prof.capture(0.0)
    with pytest.raises(ValueError):
        Profiler(str(tmp_path), max_seconds=0)


def test_resource_monitor_samples_the_cpu_without_device_gauges(flow_mo):
    from repro_torch.obs import render_prometheus
    metrics = MetricsRegistry()
    admission = AdmissionController(metrics=metrics)
    registry = ModelRegistry(device="cpu", buckets=(64,), metrics=metrics)
    registry.register("m", flow_mo)
    mon = ResourceMonitor(metrics, interval_s=60.0, admission=admission,
                          registry=registry)
    out = mon.sample()
    assert out["rss_bytes"] > 0 and out["rss_peak_bytes"] >= out["rss_bytes"]
    assert out["hot_model_bytes"] == artifacts_nbytes(flow_mo)
    assert out["queue_depth"] == {"interactive": 0, "bulk": 0}
    assert "device_memory" not in out and "device_buffer_bytes" not in out
    text = render_prometheus(metrics)
    assert "resource_rss_bytes " in text
    assert "resource_device_memory_bytes{" not in text
    assert "resource_device_buffer_bytes{" not in text
    assert mon.start() is True and mon.start() is False
    assert mon.running
    assert mon.stop() is True and mon.stop() is False
    with pytest.raises(ValueError):
        ResourceMonitor(metrics, interval_s=0)


def test_metrics_cli_demo_matches_jax(capsys, tmp_path):
    jmetrics.main(["--demo"])
    ref = capsys.readouterr().out
    tmetrics.main(["--demo"])
    assert capsys.readouterr().out == ref
    out = tmp_path / "m.prom"
    tmetrics.main(["--demo", "--out", str(out)])
    assert out.read_text() == ref
    tmetrics.main(["--resource", "--out", str(tmp_path / "r.prom")])
    assert "resource_rss_bytes" in (tmp_path / "r.prom").read_text()


# ---------------------------------------------------------------------------
# the refresh loop: ingest -> fit -> serve -> append + extend -> reload
# ---------------------------------------------------------------------------

def test_reload_swaps_and_surfaces_lineage(tmp_path):
    from repro_torch.launch.serve_http import ServingApp
    rng = np.random.default_rng(3)
    X = rng.normal(size=(96, 3)).astype(np.float32)
    y = (rng.random(96) > 0.5).astype(np.int64)
    cfg = ForestConfig(n_t=2, duplicate_k=3, n_trees=4, max_depth=2,
                       n_bins=8, reg_lambda=1.0)
    base = fit_artifacts(X, y, cfg, seed=5, device="cpu")
    p1, p2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    base.save(p1)
    base.extend(X, y, extra_trees=2, seed=5, device="cpu").save(p2)
    registry = ModelRegistry(device="cpu", buckets=(64,))
    registry.register("m", path=p1)
    app = ServingApp(registry, AdmissionController(), model_paths={"m": p1})
    try:
        assert registry.describe()["m"]["lineage"]["base"] is None
        status, body = app.reload_model("m", {"path": p2})
        assert status == 200 and body["version"] == 2
        assert body["lineage"]["base"]["round_range"] == [4, 6]
        status, body = app.reload_model("m", {})
        assert status == 200 and body["path"] == p2
        status, body = app.reload_model("nope", {"path": p2})
        assert status == 404 and body["models"] == ["m"]
        status, body = app.reload_model("m", {"path": str(tmp_path / "x")})
        assert status == 400 and "failed" in body["error"]
        assert registry.peek("m").version == 3
    finally:
        app.stop()


def test_refresh_cli_appends_extends_and_reloads_a_live_server(tmp_path):
    """ingest -> train_forest -> serve_http -> refresh, on the CPU: the
    served model reaches version 2 while /v1/generate keeps answering."""
    import json
    import urllib.request
    from repro_torch.launch import ingest as ingest_cli
    from repro_torch.launch import refresh, train_forest
    from repro_torch.launch.serve_http import ServingApp, serve_in_thread
    store, base, out = (str(tmp_path / d) for d in ("store", "base", "v2"))
    ingest_cli.main(["--out", store, "--synthetic", "600x3x2",
                     "--shard-rows", "256", "--batch-rows", "200"])
    train_forest.main(["--data-dir", store, "--mesh", "none", "--device",
                       "cpu", "--n-t", "2", "--duplicate-k", "2",
                       "--n-trees", "3", "--max-depth", "2", "--n-bins", "8",
                       "--out", base])
    registry = ModelRegistry(device="cpu", buckets=(64,))
    registry.register("fresh", path=base)
    app = ServingApp(registry, AdmissionController(),
                     model_paths={"fresh": base})
    httpd, thread = serve_in_thread(app)
    url = "http://%s:%d" % httpd.server_address[:2]
    stop, codes = threading.Event(), []

    def traffic():
        while not stop.is_set():
            req = urllib.request.Request(
                f"{url}/v1/generate", method="POST",
                data=json.dumps({"model": "fresh", "n": 8}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                codes.append(r.status)

    client = threading.Thread(target=traffic)
    client.start()
    try:
        summary = refresh.main([
            "--store", store, "--artifacts", base, "--out", out,
            "--synthetic", "200x3x2", "--seed", "7", "--batch-rows", "100",
            "--extra-trees", "2", "--device", "cpu", "--server", url,
            "--model", "fresh"])
        time.sleep(0.05)
    finally:
        stop.set()
        client.join(timeout=60)
        httpd.shutdown()
        httpd.server_close()
        app.stop()
        thread.join(timeout=10)
    assert summary["rows_appended"] == 200 and summary["rows"] == 800
    assert summary["served_version"] == 2 and summary["n_trees"] == 5
    d = registry.describe()["fresh"]
    assert d["version"] == 2 and d["lineage"]["base"]["round_range"] == [3, 5]
    assert codes and set(codes) == {200}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_forest_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve_forest
    X, y = two_moons(200, seed=0)
    cfg = ForestConfig(n_t=3, duplicate_k=3, n_trees=4, max_depth=2,
                       n_bins=8)
    path = TabularGenerator(cfg).fit(X, y, device="cpu").save(
        str(tmp_path / "m"))
    prom, spans = str(tmp_path / "m.prom"), str(tmp_path / "s.jsonl")
    server = serve_forest.main(["--artifacts", path, "--device", "cpu",
                                "--requests", "6", "--buckets", "16,64",
                                "--metrics-dump", prom, "--trace-jsonl",
                                spans])
    out = capsys.readouterr().out
    assert "served 6 requests" in out
    assert server.stats["requests"] == 6
    assert "serving_rows_total" in open(prom).read()
    assert len(open(spans).read().splitlines()) >= 7
    serve_forest.main(["--artifacts", path, "--device", "cpu", "--requests",
                       "3", "--buckets", "64", "--sync"])
    assert "served 3 requests" in capsys.readouterr().out
