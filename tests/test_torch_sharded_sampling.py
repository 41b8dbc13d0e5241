"""The port's sharded sampling and sharded serving on the CPU, against its
own unsharded path and against the JAX package's mesh-sharded solve.

One rank runs in this process (a one-rank gloo group, a 1x1 mesh). Two
ranks run as two worker processes of a gloo group
(``tests/_torch_sharded_worker.py``) at data 2 x model 1 and data 1 x
model 2, beside the JAX package's ``_solve_all_classes(mesh=)`` on two
virtual CPU devices in a subprocess (the device count must be set before
``jax`` is imported; under jax 0.9 ``jax.make_mesh`` defaults to
``Explicit`` axes, which the reference's sharding constraints refuse, so
its mesh is built with ``AxisType.Auto`` axes).

The models are random, seeded forests made with numpy (features in
``[0, p)``, thresholds on a 1/8 grid with +inf sentinels), saved in the
format both packages read. Sharded rows must equal the unsharded call's
bit for bit on the same device type: every rank draws x1 from the same
``(seed, class, block)`` streams and a stochastic sampler's step noise as
its slice of the whole draw. With the JAX package's x1 and step noise
handed over, the port's sharded solve is held within 1e-4 of the
reference's sharded solve, as ``test_solve_all_classes_matches_jax``
holds the unsharded one. Every subprocess has a timeout, so a hung
collective fails the test instead of stalling the suite.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config import ForestConfig as JConfig
from repro.tabgen import ForestArtifacts as JArtifacts
from repro.tabgen import artifacts as jart
from repro.tabgen import impute as j_impute
from repro_torch.config import ForestConfig
from repro_torch.core import interpolants as titp
from repro_torch.launch.mesh import forest_mesh
from repro_torch.serving import ModelRegistry
from repro_torch.serving.scheduler import BATCH_SEED_BASE
from repro_torch.tabgen import (TabularGenerator, artifacts_from_numpy,
                                get_sampler, impute, sample)
from repro_torch.tabgen.artifacts import class_span, solve_axes
from repro_torch.tabgen.sampling import solve_all_classes

REPO = pathlib.Path(__file__).resolve().parents[1]
N, SEED, SOLVE_SEED = 151, 5, 3
TIMEOUT = 120            # seconds a subprocess may take
SAMPLERS = (("flow", "euler"), ("flow", "heun"), ("diffusion", "ddim"),
            ("diffusion", "em"))
# name -> (method, classes, multi_output, seed, counts); counts give an odd
# per-class bucket m at n = 151 (101 and 63): uneven over two data ranks
MODELS = {"flow2": ("flow", 2, False, 0, (100, 50)),
          "flow2b": ("flow", 2, False, 1, (100, 50)),
          "diff2": ("diffusion", 2, True, 2, (100, 50)),
          "flow3": ("flow", 3, True, 3, (40, 30, 50)),
          "diff3": ("diffusion", 3, False, 4, (40, 30, 50))}
P, N_T, T, DEPTH = 3, 4, 4, 3


def numpy_model(name):
    """Host arrays and config of a seeded random model."""
    method, n_y, mo, seed, counts = MODELS[name]
    rng = np.random.default_rng(seed)
    S, out = (1, P) if mo else (P, 1)
    H, L = 2 ** DEPTH - 1, 2 ** DEPTH
    thr = np.round(rng.uniform(-1, 1, (N_T, n_y, S, T, H)) * 8) / 8
    thr[rng.random(thr.shape) < 0.1] = np.inf
    mins = rng.uniform(0, 1, (n_y, P))
    cfg = ForestConfig(method=method, n_t=N_T, n_trees=T, max_depth=DEPTH,
                       multi_output=mo)
    arrays = dict(
        feat=rng.integers(0, P, (N_T, n_y, S, T, H)).astype(np.int32),
        thr_val=thr.astype(np.float32),
        leaf=(rng.normal(size=(N_T, n_y, S, T, L, out)) * 0.1).astype(
            np.float32),
        best_round=np.full((N_T, n_y, S), T - 1, np.int32),
        rounds_run=np.full((N_T, n_y, S), T, np.int32),
        val_curve=np.zeros((N_T, n_y, S, T), np.float32),
        mins=mins.astype(np.float32),
        maxs=(mins + rng.uniform(0.5, 2, (n_y, P))).astype(np.float32),
        classes=np.arange(n_y) * 10, counts=np.asarray(counts))
    return arrays, dataclasses.asdict(cfg)


def port_model(name):
    return artifacts_from_numpy(*numpy_model(name), "cpu")


N_IMP, IMPUTE_SEED, IMPUTE_ROUNDS = 37, 2, 2
# name -> (mesh, model): two classes split over two model ranks (flow and
# diffusion), and three classes replicated with rows split over two data
# ranks
IMPUTE_CASES = {"flow2_1x2": ((1, 2), "flow2"), "diff2_1x2": ((1, 2), "diff2"),
                "flow3_2x1": ((2, 1), "flow3")}


def impute_inputs(model):
    """Rows of a model's p features with about a third of the cells
    missing (every row keeps one), and labels from its classes."""
    n_y = MODELS[model][1]
    rng = np.random.default_rng(n_y)
    X = rng.uniform(0, 2, (N_IMP, P)).astype(np.float32)
    X[rng.random(X.shape) < 0.35] = np.nan
    X[np.isnan(X).all(axis=1), 0] = 1.0
    y = (rng.integers(0, n_y, N_IMP) * 10).astype(np.int64)
    return X, y


def jax_impute_noise(y, n_y, seed, rounds):
    """Per class ``[1 + rounds, n_c, p]``: the noise of the JAX package's
    impute (``key = PRNGKey(seed + 31)``; per class with rows ``split`` ->
    eps_fix, then per round ``split`` -> eps_r)."""
    key = jax.random.PRNGKey(seed + 31)
    draws = {}
    for yi in range(n_y):
        n_c = int((y == yi * 10).sum())
        if n_c == 0:
            continue
        steps = []
        for _ in range(1 + max(1, rounds)):
            key, sub = jax.random.split(key)
            steps.append(np.asarray(jax.random.normal(sub, (n_c, P),
                                                      jnp.float32)))
        draws[f"noise{yi}"] = np.stack(steps)
    return draws


def sample_cases():
    """(name, mesh, model, sampler): the four samplers at 2x1 and 1x2 on
    two classes, and on three classes at 1x2 (replicated over the two
    model ranks)."""
    cases = []
    for mesh, n_y in (((2, 1), 2), ((1, 2), 2), ((1, 2), 3)):
        for method, sampler in SAMPLERS:
            model = f"{'flow' if method == 'flow' else 'diff'}{n_y}"
            cases.append((f"{model}_{sampler}_{mesh[0]}x{mesh[1]}", mesh,
                          model, sampler))
    return cases


SOLVE_CASES = [(f"{model}_{sampler}_{d}x{m}", (d, m), model, sampler)
               for d, m in ((2, 1), (1, 2))
               for model, sampler in (("flow2", "euler"), ("diff2", "em"))]


def jax_em_noise(key, n_steps, shape):
    """diffusion_em's per-step draws: ``k, sub = split(k)`` then
    ``normal(sub, x.shape)`` (repro/core/generate.py)."""
    steps = []
    k = key
    for _ in range(n_steps):
        k, sub = jax.random.split(k)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(steps)


def jax_solve_inputs(seed, n_y, m, p, n_steps):
    """x1 ``[n_y, m, p]`` and em noise ``[n_steps, n_y, m, p]`` as
    repro.tabgen.sampling draws them: per class ``split`` into (k_x1,
    k_solve), per row ``fold_in(k_x1, i)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), n_y)
    x1, noise = [], []
    for c in range(n_y):
        k_x1, k_solve = jax.random.split(keys[c])
        row_keys = jax.vmap(jax.random.fold_in, (None, 0))(k_x1, jnp.arange(m))
        x1.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (p,), jnp.float32))(row_keys)))
        noise.append(jax_em_noise(k_solve, n_steps, (m, p)))
    return np.stack(x1), np.stack(noise, axis=1)


# the JAX package's sharded solve on two virtual devices, Auto axes
_JAX_REF = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import interpolants as itp
from repro.tabgen import ForestArtifacts, samplers
from repro.tabgen.sampling import _solve_all_classes
work = sys.argv[1]
assert jax.device_count() == 2, jax.devices()
with open(work + "/cases.json") as f:
    cases = json.load(f)
for c in cases["solve"]:
    art = ForestArtifacts.load(work + "/" + c["model"])
    fc = art.config
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    keys = jax.random.split(jax.random.PRNGKey(c["seed"] + 7), art.n_y)
    ts = jnp.asarray(itp.timesteps(fc.method, fc.n_t, fc.eps_diff,
                                   fc.t_schedule))
    out = _solve_all_classes(
        art.feat, art.thr_val, art.leaf, keys, art.mins, art.maxs, ts,
        solver_fn=samplers.get_sampler(c["sampler"]).fn, m=c["m"],
        depth=fc.max_depth, n_t=fc.n_t, multi_output=fc.multi_output,
        eps=fc.eps_diff, impl="xla", mesh=mesh)
    np.savez(work + "/jax_" + c["name"] + ".npz", x=np.asarray(out))
"""


def _run_all(procs):
    """Wait for every process (each within TIMEOUT); kill the rest on the
    way out. Returns [(returncode, output)]."""
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            logs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Every two-rank case on two gloo ranks of the port, and the solve
    cases on the JAX package's two virtual devices, all three processes at
    once."""
    work = tmp_path_factory.mktemp("sharded")
    for name in MODELS:
        port_model(name).save(str(work / name))
    m = N                     # the solve cases' rows a class
    for model in {c[2] for c in SOLVE_CASES}:
        n_y = MODELS[model][1]
        x1, noise = jax_solve_inputs(SOLVE_SEED, n_y, m, P, N_T - 1)
        np.savez(work / f"jax_inputs_{model}.npz", x1=x1, noise=noise)
    for model in {m for _, m in IMPUTE_CASES.values()}:
        X, y = impute_inputs(model)
        np.savez(work / f"impute_{model}.npz", X=X, y=y,
                 **jax_impute_noise(y, MODELS[model][1], IMPUTE_SEED,
                                    IMPUTE_ROUNDS))
    cases = {
        "models": list(MODELS), "meshes": [[2, 1], [1, 2]],
        "impute": [dict(name=n, mesh=list(mesh), model=model,
                        seed=IMPUTE_SEED, rounds=IMPUTE_ROUNDS)
                   for n, (mesh, model) in IMPUTE_CASES.items()],
        "sample": [dict(name=n, mesh=list(mesh), model=model, sampler=s,
                        n=N, seed=SEED)
                   for n, mesh, model, s in sample_cases()],
        "solve": [dict(name=n, mesh=list(mesh), model=model, sampler=s,
                       m=m, seed=SOLVE_SEED)
                  for n, mesh, model, s in SOLVE_CASES]}
    (work / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_REF, str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_sharded_worker.py"),
         str(r), "2", str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for rc, out in _run_all(procs):
        assert rc == 0, out[-3000:]
    return work


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A one-rank gloo group (file rendezvous) and its 1x1 mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield forest_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


class FakeMesh:
    """The parts of a ``(data, model)`` ``DeviceMesh`` that the placement
    policy reads, at a chosen rank, with no process group."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, shape, data_rank=0, model_rank=0):
        self.shape = tuple(shape)
        self._ranks = {"data": data_rank, "model": model_rank}

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self._ranks[name]


class FakeJaxMesh:
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.devices = np.empty(shape)


def assert_same_rows(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the placement policy and the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2),
                                   (1, 4)])
def test_solve_axes_match_jax(shape):
    for n_y in range(1, 9):
        assert (solve_axes(FakeMesh(shape), n_y)
                == jart.solve_axes(FakeJaxMesh(shape), n_y)), (shape, n_y)


def test_shard_places_the_rank_classes_and_refuses_what_it_lacks(tmp_path):
    art = port_model("flow3")
    two = port_model("diff2")
    # three classes on two model ranks: replicated, every rank whole
    whole = art.shard(FakeMesh((1, 2), model_rank=1))
    assert whole.class_range == (0, 3) and not whole.is_slice
    assert class_span(FakeMesh((1, 2), model_rank=1), 3) == (0, 3)
    # two classes on two model ranks: rank 1 holds class 1
    part = two.shard(FakeMesh((1, 2), model_rank=1))
    assert part.class_range == (1, 2) and part.is_slice and part.n_y == 2
    for f in ("feat", "thr_val", "leaf", "best_round", "rounds_run",
              "val_curve"):
        assert torch.equal(getattr(part, f), getattr(two, f)[:, 1:2]), f
    assert torch.equal(part.mins, two.mins[1:2])
    assert torch.equal(part.class_forest(1).leaf, two.class_forest(1).leaf)
    with pytest.raises(ValueError, match=r"classes \[0, 1\)"):
        part.class_forest(0)
    with pytest.raises(ValueError, match="slice holding classes"):
        part.save(str(tmp_path / "m"))
    with pytest.raises(ValueError, match="slice holding classes"):
        part.extend(np.zeros((4, P), np.float32), extra_trees=1)
    with pytest.raises(ValueError, match="slice holding classes"):
        sample(part, 10)
    with pytest.raises(ValueError, match="slice holding classes"):
        impute(part, np.zeros((2, P), np.float32), np.array([10, 20]))


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,sampler", SAMPLERS)
def test_one_rank_mesh_sample_equals_unsharded(one_rank_mesh, method,
                                               sampler):
    art = port_model("flow2" if method == "flow" else "diff2")
    ref = sample(art, N, sampler=sampler, seed=SEED)
    assert_same_rows(sample(art, N, sampler=sampler, seed=SEED,
                            mesh=one_rank_mesh), ref)
    assert_same_rows(sample(art.shard(one_rank_mesh), N, sampler=sampler,
                            seed=SEED, mesh=one_rank_mesh), ref)
    gen = TabularGenerator(art.config)
    gen.artifacts = art
    assert_same_rows(gen.generate(N, sampler=sampler, seed=SEED,
                                  mesh=one_rank_mesh), ref)


def test_one_rank_mesh_registry_serves_swaps_and_closes(one_rank_mesh):
    """Requests through a scheduler, a swap from another thread between
    them, each answer equal to its batch's unsharded replay; a handle the
    swap replaced, an unserved sampler and a closed registry are refused;
    impute (classes not split) equals the unsharded impute."""
    from repro_torch.serving import AdmissionController, InflightScheduler
    a, b = port_model("flow2"), port_model("flow2b")
    reg = ModelRegistry(device="cpu", mesh=one_rank_mesh, buckets=(16, 64))
    reg.register("m", a)
    d = reg.describe()["m"]
    assert d["nbytes"] == d["rank_nbytes"] > 0
    old = reg.handle("m")
    sched = InflightScheduler(reg, AdmissionController())
    plain = ModelRegistry(device="cpu", buckets=(16, 64))
    try:
        got = [sched.submit(n, model="m").result(timeout=60)
               for n in (17, 40)]
        swapper = threading.Thread(target=reg.swap, args=("m", b))
        swapper.start()
        swapper.join(60)
        assert reg.peek("m").version == 2
        got.append(sched.submit(90, model="m").result(timeout=60))
    finally:
        sched.stop()
    for i, ((X, y), art) in enumerate(zip(got, (a, a, b))):
        plain.register("m", art)
        ref = plain.acquire("m").generate(len(X), seed=BATCH_SEED_BASE + i)
        assert_same_rows((X, y), ref)
    with pytest.raises(ValueError, match="swapped out"):
        old.generate(5)
    with pytest.raises(ValueError, match="does not serve sampler 'heun'"):
        reg.handle("m").generate(5, "heun")
    X_missing = sample(b, 6, seed=1)[0]
    X_missing[::2, 1] = np.nan
    labels = np.array([0, 10] * 3)
    np.testing.assert_array_equal(
        reg.handle("m").impute(X_missing, labels, seed=2),
        plain.acquire("m").impute(X_missing, labels, seed=2))
    reg.close()
    with pytest.raises(RuntimeError, match="closed"):
        reg.handle("m").generate(5)


@pytest.mark.parametrize("model", ["flow2", "diff2", "flow3"])
def test_one_rank_mesh_impute_equals_unsharded(one_rank_mesh, model):
    """impute(mesh=) on one rank, from the whole model and from its slice,
    and through a mesh registry, equals the unsharded impute bit for
    bit."""
    art = port_model(model)
    X, y = impute_inputs(model)
    ref = impute(art, X, y, seed=2, refine_rounds=2)
    for a in (art, art.shard(one_rank_mesh)):
        np.testing.assert_array_equal(
            impute(a, X, y, seed=2, refine_rounds=2, mesh=one_rank_mesh),
            ref)
    reg = ModelRegistry(device="cpu", mesh=one_rank_mesh)
    reg.register("m", art)
    np.testing.assert_array_equal(
        reg.handle("m").impute(X, y, seed=2, refine_rounds=2), ref)
    np.testing.assert_array_equal(reg.impute("m", X, y, seed=2,
                                             refine_rounds=2), ref)
    reg.close()


def test_mesh_of_another_device_type_is_refused(one_rank_mesh):
    art = port_model("flow2")
    with pytest.raises(ValueError, match="cpu mesh cannot sample"):
        sample(art.to("meta"), 8, mesh=one_rank_mesh)
    with pytest.raises(ValueError, match="cpu mesh cannot impute"):
        impute(art.to("meta"), np.zeros((2, P), np.float32),
               np.array([0, 10]), mesh=one_rank_mesh)
    with pytest.raises(ValueError, match="cpu mesh cannot serve"):
        ModelRegistry(device="meta", mesh=one_rank_mesh)
    with pytest.raises(ValueError, match="expected a DeviceMesh"):
        sample(art, 8, mesh="2x1")


# ---------------------------------------------------------------------------
# two gloo ranks, and the JAX package on two virtual devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh,model,sampler", sample_cases())
def test_two_rank_sample_equals_unsharded(two_rank_runs, name, mesh, model,
                                          sampler):
    ref = sample(port_model(model), N, sampler=sampler, seed=SEED)
    for rank in (0, 1):
        with np.load(two_rank_runs / f"rank{rank}_{name}.npz") as d:
            assert_same_rows((d["X"], d["y"]), ref)
            assert_same_rows((d["Xs"], d["ys"]), ref)


@pytest.mark.parametrize("name,mesh,model,sampler", SOLVE_CASES)
def test_two_rank_sharded_solve_matches_jax(two_rank_runs, name, mesh, model,
                                            sampler):
    art = port_model(model)
    fc = art.config
    with np.load(two_rank_runs / f"jax_inputs_{model}.npz") as d:
        x1, noise = d["x1"], d["noise"]
    with np.load(two_rank_runs / f"solve_{name}.npz") as d:
        got = d["x"]
    with np.load(two_rank_runs / f"jax_{name}.npz") as d:
        ref = d["x"]
    assert got.shape == ref.shape == x1.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    spec = get_sampler(sampler)
    unsharded = solve_all_classes(
        art.feat, art.thr_val, art.leaf, torch.from_numpy(x1), art.mins,
        art.maxs, titp.timesteps(fc.method, fc.n_t, fc.eps_diff,
                                 fc.t_schedule),
        solver_fn=spec.fn, depth=fc.max_depth, n_t=fc.n_t,
        multi_output=fc.multi_output, eps=fc.eps_diff,
        noise=torch.from_numpy(noise) if spec.stochastic else None)
    np.testing.assert_array_equal(got, unsharded.numpy())


def test_two_rank_server_answers_equal_an_unsharded_replay(two_rank_runs):
    """Requests of 17, 40 and 90 rows on a 2x1 ForestServer, a swap before
    the last: each answer equals its batch's replay on an unsharded
    registry, and rank 1 replayed every batch rank 0 dispatched."""
    done0 = json.loads((two_rank_runs / "done0.json").read_text())
    done1 = json.loads((two_rank_runs / "done1.json").read_text())
    assert done0["version"] == 2
    assert done0["nbytes"] == done0["rank_nbytes"] > 0
    plain = ModelRegistry(device="cpu", buckets=(16, 64))
    with np.load(two_rank_runs / "served.npz") as d:
        assert list(d["rows"]) == [17, 40, 90]
        for n, batch_id, art in zip((17, 40, 90), d["batch_ids"],
                                    ("flow2", "flow2", "flow2b")):
            plain.register("m", port_model(art))
            ref = plain.acquire("m").generate(
                n, seed=BATCH_SEED_BASE + int(batch_id))
            assert_same_rows((d[f"X{n}"], d[f"y{n}"]), ref)
    # warmup: one euler batch a bucket; then the three requests
    assert done1["replayed"] == 2 + 3


def test_two_rank_failure_after_publish_breaks_the_stream(two_rank_runs):
    """A failure planted in rank 0's enqueue of a batch, after its
    publication: that request gets the failure, no later batch returns
    rows, and rank 1 fails at the batch's failure check, before its
    gather, instead of waiting out the group's timeout."""
    fault0 = json.loads((two_rank_runs / "fault0.json").read_text())
    fault1 = json.loads((two_rank_runs / "fault1.json").read_text())
    first, failed, later = fault0["got"]
    assert first == 17
    assert failed == "MemoryError: planted after the publication"
    assert later.startswith("StreamBroken: the command stream broke")
    assert "planted" in fault0["broken"]
    assert fault0["calls"] == ["on_break"]      # serve_http's exit hook
    assert "raised" in fault1, fault1
    assert fault1["after_s"] < 30     # the group timeout is 30 minutes


@pytest.mark.parametrize("name", list(IMPUTE_CASES))
def test_two_rank_impute_equals_unsharded_and_matches_jax(two_rank_runs,
                                                         name):
    """impute(mesh=) on two ranks (two classes split over the model ranks,
    or rows split over the data ranks), from the whole model and from each
    rank's slice: on every rank bit-equal to the unsharded impute. With the
    JAX package's noise handed over, equal to the unsharded port impute on
    that noise and within the impute tolerance of repro's impute."""
    _, model = IMPUTE_CASES[name]
    art = port_model(model)
    with np.load(two_rank_runs / f"impute_{model}.npz") as d:
        inputs = dict(d)
    X, y = inputs["X"], inputs["y"]
    kw = dict(seed=IMPUTE_SEED, refine_rounds=IMPUTE_ROUNDS)
    ref = impute(art, X, y, **kw)
    with_jax_noise = impute(art, X, y, noise=lambda yi, shape: torch.from_numpy(
        inputs[f"noise{yi}"]), **kw)
    jax_ref = j_impute(JArtifacts.load(str(two_rank_runs / model)), X, y,
                       **kw)
    np.testing.assert_allclose(with_jax_noise, jax_ref, rtol=1e-4, atol=1e-4)
    assert np.isnan(X).any() and not np.isnan(ref).any()
    for rank in (0, 1):
        with np.load(two_rank_runs / f"rank{rank}_impute_{name}.npz") as d:
            np.testing.assert_array_equal(d["X"], ref)
            np.testing.assert_array_equal(d["Xs"], ref)
            np.testing.assert_array_equal(d["Xj"], with_jax_noise)


def test_two_rank_mesh_server_impute_equals_an_unsharded_replay(
        two_rank_runs):
    """A ForestServer on a mesh that splits the classes: bad impute requests
    are refused on rank 0 before any other rank hears of them (HTTP 400 /
    ValueError, the stream unbroken, rank 1 replays nothing of them); the
    imputes after them (a command each, replayed by rank 1) equal the
    unsharded registry's, and a request after them equals its batch's
    unsharded replay."""
    done = [json.loads((two_rank_runs / f"done_impute{r}.json").read_text())
            for r in (0, 1)]
    assert done[1] == {"replayed": 1}
    assert done[0]["ok"] and done[0]["broken"] == "None"
    (s_label, e_label), (s_width, e_width), (s_none, e_none), raised = \
        done[0]["refused"]
    assert (s_label, s_width, s_none) == (400, 400, 400)
    assert "labels [7] are not among the model's classes" in e_label["error"]
    assert f"the model imputes [n, {P}]" in e_width["error"]
    assert "imputation needs" in e_none["error"]
    assert raised == "ValueError: labels required for conditional models"
    plain = ModelRegistry(device="cpu", buckets=(16, 64))
    plain.register("m", port_model("flow2"))
    X, y = impute_inputs("flow2")
    with np.load(two_rank_runs / "served_impute.npz") as d:
        for seed in (2, 3):
            np.testing.assert_array_equal(
                d[f"I{seed}"], plain.acquire("m").impute(X, y, seed=seed))
        ref = plain.acquire("m").generate(
            40, seed=BATCH_SEED_BASE + int(d["batch_ids"][0]))
        assert_same_rows((d["X40"], d["y40"]), ref)


@pytest.mark.parametrize("where", ["batch", "impute"])
def test_two_rank_follower_failure_stops_the_mesh(two_rank_runs, where):
    """A failure planted in rank 1's replay of a batch (or of an impute),
    after its publication: rank 0 raises at the command's failure check
    within seconds (not in a gather that will not pair), returns no rows
    for it, and every later command raises StreamBroken; rank 1's follow
    raises the planted failure."""
    got0 = json.loads((two_rank_runs / f"ffault_{where}0.json").read_text())
    got1 = json.loads((two_rank_runs / f"ffault_{where}1.json").read_text())
    assert got1["raised"] == f"MemoryError: planted in the follower's {where}"
    assert got1["after_s"] < 30
    first = 2 if where == "batch" else 1   # the call whose replay failed
    assert got0["got"][:first] == [17, N_IMP][:first]
    failed, *later = got0["got"][first:]
    assert failed.startswith("StreamBroken: 1 rank(s) failed"), failed
    assert got0["seconds"][first] < 30
    assert later and all(g.startswith("StreamBroken: the command stream "
                                      "broke") for g in later), later
    assert "1 rank(s) failed" in got0["broken"]


def test_jax_config_fields_match_for_the_saved_models():
    """The saved models' config loads in the JAX package unchanged."""
    for name in MODELS:
        _, cfg = numpy_model(name)
        assert dataclasses.asdict(JConfig(**cfg)) == cfg
