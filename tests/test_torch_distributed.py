"""The port's sharded trainer against the JAX package's, on the CPU.

One rank runs in this process (a one-rank gloo group where a mesh is
needed); two ranks run as two worker processes of a gloo group
(``tests/_torch_dist_worker.py``), held against the JAX package's
``shard_map`` trainer on two virtual CPU devices in a subprocess (the
device count must be set before ``jax`` is imported).

Noise: the port's draws come from ``torch.Generator``s, so the tests hand
it the JAX package's per-shard draws (``fold_in(key, shard)`` of each
ensemble's key, then ``split`` into the x1 and jitter keys) through
``noise(eid, split, shape, shard)``.

Tolerances, as ``tests/test_torch_training.py`` holds the single-device
fit: tree structure, ``best_round`` and ``rounds_run`` equal, ``thr_val``,
``leaf`` and ``val_curve`` within 1e-5. With two data ranks each sum of two
partial histograms is the same in either order. The configurations avoid
exact gain ties (flow at t = 0 with K duplicated rows and no jitter gives
several splits of the same rows), where either package's last bit picks
the winner.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config import ForestConfig as JConfig
from repro.data.tabular import two_moons
from repro.forest import distributed as jdist
from repro.tabgen import fit_artifacts as j_fit_artifacts
from repro_torch.config import ForestConfig
from repro_torch.data.store import ingest
from repro_torch.forest import distributed as tdist
from repro_torch.launch.mesh import forest_mesh
from repro_torch.tabgen import TabularGenerator, fit_artifacts

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
          "mins", "maxs")
BASE = dict(n_t=3, duplicate_k=4, n_trees=4, max_depth=3, n_bins=16,
            reg_lambda=1.0)
SEED = 3
N_ROWS = 97                 # not divisible by two data ranks: a padded row


def moons(n=N_ROWS):
    X, y = two_moons(n + n % 2, seed=0)
    return X[:n], y[:n]


def assert_matches(port, jax_arrays):
    for f in ("feat", "best_round", "rounds_run", "mins", "maxs"):
        np.testing.assert_array_equal(np.asarray(port[f]),
                                      np.asarray(jax_arrays[f]), err_msg=f)
    for f in ("thr_val", "leaf", "val_curve"):
        np.testing.assert_allclose(np.asarray(port[f]),
                                   np.asarray(jax_arrays[f]), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def arrays(art):
    return {f: getattr(art, f).numpy() for f in FIELDS}


def assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def jax_shard_draws(seed, n_ens, shape, shards):
    """The JAX sharded trainer's bridge draws: ``{(eid, split, shard): (x1,
    jitter)}`` for rows of ``shape`` on each data shard."""
    table = jdist.build_grid_key_table(jax.random.PRNGKey(seed), n_ens)
    out = {}
    for eid in range(n_ens):
        for split in (0, 1):
            for shard in range(shards):
                k = jax.random.fold_in(jnp.asarray(table[eid, split]), shard)
                kn, kj = jax.random.split(k)
                out[eid, split, shard] = (
                    np.asarray(jax.random.normal(kn, shape, jnp.float32)),
                    np.asarray(jax.random.normal(kj, shape, jnp.float32)))
    return out


def jax_noise(seed, n_ens, shape, shards=1):
    draws = jax_shard_draws(seed, n_ens, shape, shards)

    def noise(eid, split, shp, shard):
        x1, jit = draws[eid, split, shard]
        assert x1.shape == shp
        return torch.tensor(x1), torch.tensor(jit)
    return noise


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group (file rendezvous: no port is shared with other
    test workers) and its 1x1 mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield forest_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

# jitted, as the JAX trainer runs it: XLA then rounds the quantile positions
_jax_sketch_edges = jax.jit(jdist._sketch_edges,
                            static_argnames=("n_bins", "data_axes"))


@pytest.mark.parametrize("n_bins", [10, 16, 37, 64])
def test_sketch_edges_equal_jax_on_one_shard(n_bins):
    """Zero-weight rows sort last as +inf and are not counted; the
    quantile positions round as XLA rounds them inside the trainer."""
    rng = np.random.default_rng(n_bins)
    xt = rng.normal(size=(3000, 5)).astype(np.float32)
    w = (rng.random(3000) > 0.3).astype(np.float32)
    ref = _jax_sketch_edges(jnp.asarray(xt), jnp.asarray(w), n_bins=n_bins,
                            data_axes=())
    got = tdist._sketch_edges(torch.from_numpy(xt), torch.from_numpy(w),
                              n_bins, tdist.Shards.one())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,shards", [(97, 2), (96, 2), (10, 3), (5, 1)])
def test_row_shards_own_the_shuffle_in_rank_order(n, shards):
    """Rank r owns positions [r·n_pad/d, (r+1)·n_pad/d) of perm; past n the
    rows are padding of weight 0, x 0 and class 0."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    cid = rng.integers(0, 2, n).astype(np.int32)
    mins, maxs = X.min(0, keepdims=True).repeat(2, 0), X.max(0)[None].repeat(
        2, 0)
    perm = rng.permutation(n)
    parts = [tdist.build_row_shards(X, cid, mins, maxs, perm,
                                    tdist.Shards(None, None, r, shards, 0, 1))
             for r in range(shards)]
    n_pad = -(-n // shards) * shards
    x0 = torch.cat([p[0] for p in parts]).numpy()
    w = torch.cat([p[1] for p in parts]).numpy()
    c = torch.cat([p[2] for p in parts]).numpy()
    assert x0.shape == (n_pad, 3) and all(len(p[1]) == n_pad // shards
                                          for p in parts)
    np.testing.assert_array_equal(w, (np.arange(n_pad) < n).astype(np.float32))
    np.testing.assert_array_equal(c[:n], cid[perm])
    assert (c[n:] == 0).all() and (x0[n:] == 0).all()
    # rescaled as the JAX package's build_row_shards rescales its rows
    from repro.tabgen.artifacts import rescale
    want = rescale(X[perm], mins[cid[perm]], maxs[cid[perm]])
    np.testing.assert_array_equal(x0[:n], want.astype(np.float32))


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

ONE_RANK = [("flow_so", {}), ("flow_mo_jitter", dict(multi_output=True,
                                                     sigma=0.1)),
            ("hist_bf16", dict(hist_bf16=True)),
            ("mo_es", dict(multi_output=True, sigma=0.1, n_trees=8,
                           early_stop_rounds=2))]


@pytest.mark.parametrize("name,kw", ONE_RANK)
def test_one_rank_fit_matches_jax_1x1_mesh(name, kw):
    """The store-less one-rank route (no process group) against the JAX
    package's 1x1 mesh, given its per-shard draws."""
    X, y = moons()
    cfg = dict(BASE, **kw)
    jart = j_fit_artifacts(X, y, JConfig(**cfg), seed=SEED,
                           mesh=jax.make_mesh((1, 1), ("data", "model")))
    from repro_torch.tabgen import fitting
    noise = jax_noise(SEED, 3 * 2, (N_ROWS * 4, 2))
    tart = fitting._fit_artifacts_sharded(
        X, y, ForestConfig(**cfg), tdist.Shards.one(),
        device=torch.device("cpu"), seed=SEED, checkpoint_dir=None,
        resume=False, ensembles_per_batch=0, row_chunk=65536, noise=noise)
    assert_matches(arrays(tart), {f: np.asarray(getattr(jart, f))
                                  for f in FIELDS})


def test_store_fit_equals_in_memory(tmp_path, one_rank_group):
    """A store fit (no mesh) equals the in-memory sharded fit on a 1x1
    mesh, bit for bit, checkpoints included."""
    X, y = moons()
    cfg = ForestConfig(**BASE, multi_output=True)
    store = ingest(((X[s:s + 30], y[s:s + 30]) for s in range(0, N_ROWS, 30)),
                   str(tmp_path / "store"), shard_rows=40)
    mem = fit_artifacts(X, y, cfg, seed=SEED, mesh=one_rank_group,
                        device="cpu", checkpoint_dir=str(tmp_path / "ck_mem"),
                        ensembles_per_batch=4)
    stored = fit_artifacts(store, None, cfg, seed=SEED, device="cpu",
                           checkpoint_dir=str(tmp_path / "ck_store"),
                           ensembles_per_batch=4)
    assert_same(mem, stored)
    for name in ("batch_0.npz", "batch_4.npz"):      # a tail batch of 2
        a = np.load(tmp_path / "ck_mem" / name)
        b = np.load(tmp_path / "ck_store" / name)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert stored.lineage["store"]["fingerprint"] == store.fingerprint


def test_facade_fits_a_mesh_and_refuses_a_store_with_a_schema(
        tmp_path, one_rank_group):
    X, y = moons()
    cfg = ForestConfig(**BASE)
    gen = TabularGenerator(cfg).fit(X, y, seed=SEED, mesh=one_rank_group,
                                    device="cpu")
    ref = fit_artifacts(X, y, cfg, seed=SEED, mesh=one_rank_group,
                        device="cpu")
    assert_same(gen.artifacts, ref)
    store = ingest([(X, y)], str(tmp_path / "store"), shard_rows=48)
    with pytest.raises(ValueError, match="schema-aware"):
        TabularGenerator(cfg, cat_cols=[0]).fit(store, device="cpu")


@pytest.mark.parametrize("multi_output", [False, True])
def test_store_extension_equals_a_cold_fit(tmp_path, multi_output):
    """Warm start on the sharded route: a store model of 3 rounds extended
    by 2 equals a cold store fit of 5 rounds bit for bit (a tail batch of
    the grid included)."""
    from repro_torch.tabgen import extend_artifacts
    X, y = moons()
    store = _one_rank_store(X, y, tmp_path)
    cfg = ForestConfig(**dict(BASE, n_trees=5), multi_output=multi_output)
    cold = fit_artifacts(store, None, cfg, seed=SEED, device="cpu",
                         ensembles_per_batch=4)
    base = fit_artifacts(store, None, dataclasses.replace(cfg, n_trees=3),
                         seed=SEED, device="cpu", ensembles_per_batch=4)
    ext = extend_artifacts(base, store, extra_trees=2, seed=SEED,
                           device="cpu", ensembles_per_batch=4)
    assert_same(cold, ext)


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _no_training(*a, **k):
    raise AssertionError("a committed batch was trained again")


def test_port_resumes_a_jax_sharded_checkpoint(tmp_path, monkeypatch):
    X, y = moons()
    cfg = dict(BASE)
    d = str(tmp_path / "ck")
    jart = j_fit_artifacts(X, y, JConfig(**cfg), seed=SEED,
                           mesh=jax.make_mesh((1, 1), ("data", "model")),
                           checkpoint_dir=d, ensembles_per_batch=4)
    monkeypatch.setattr(tdist, "_fit_one_sharded", _no_training)
    store = ingest([(X, y)], str(tmp_path / "store"), shard_rows=50)
    # elastic resume: the batch size comes from the manifest
    tart = fit_artifacts(store, None, ForestConfig(**cfg), seed=SEED,
                         checkpoint_dir=d, resume=True, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tart, f).numpy(),
                                      np.asarray(getattr(jart, f)), f)


def test_jax_resumes_a_port_sharded_checkpoint_and_refusals(tmp_path,
                                                             monkeypatch):
    X, y = moons()
    cfg = dict(BASE)
    d = str(tmp_path / "ck")
    tart = fit_artifacts(_one_rank_store(X, y, tmp_path), None,
                         ForestConfig(**cfg), seed=SEED, device="cpu",
                         checkpoint_dir=d, ensembles_per_batch=2)
    with pytest.raises(ValueError, match="ensembles_per_batch=2"):
        fit_artifacts(_one_rank_store(X, y, tmp_path, "s2"), None,
                      ForestConfig(**cfg), seed=SEED, checkpoint_dir=d,
                      resume=True, ensembles_per_batch=3, device="cpu")
    monkeypatch.setattr(jdist, "make_distributed_fit",
                        lambda *a, **k: _no_training)
    jart = j_fit_artifacts(X, y, JConfig(**cfg), seed=SEED,
                           mesh=jax.make_mesh((1, 1), ("data", "model")),
                           checkpoint_dir=d, resume=True)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jart, f)),
                                      getattr(tart, f).numpy(), f)


def _one_rank_store(X, y, tmp_path, name="s"):
    return ingest([(X, y)], str(tmp_path / name), shard_rows=50)


# ---------------------------------------------------------------------------
# two ranks: gloo workers against JAX on two virtual devices
# ---------------------------------------------------------------------------

TWO_RANK = [("allreduce", (2, 1), {}),
            ("reduce_scatter", (2, 1), dict(split_reduce="reduce_scatter",
                                            multi_output=True, sigma=0.1)),
            ("hist_bf16", (2, 1), dict(hist_bf16=True)),
            ("model_axis", (1, 2), dict(multi_output=True, sigma=0.1))]

_JAX_REF = """
import json, sys
import numpy as np
import jax
from repro.config import ForestConfig
from repro.tabgen import fit_artifacts
work = sys.argv[1]
with open(work + "/cases.json") as f:
    cases = json.load(f)
with np.load(work + "/data.npz") as d:
    X, y = d["X"], d["y"]
for case in cases:
    mesh = jax.make_mesh(tuple(case["mesh"]), ("data", "model"))
    art = fit_artifacts(X, y, ForestConfig(**case["config"]),
                        seed=case["seed"], mesh=mesh)
    np.savez(work + "/jax_" + case["name"] + ".npz",
             **{f: np.asarray(getattr(art, f)) for f in %r})
""" % (FIELDS,)


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Every TWO_RANK case trained by two gloo ranks of the port and by the
    JAX package on two virtual devices, all four processes at once."""
    work = tmp_path_factory.mktemp("two_ranks")
    X, y = moons()
    np.savez(work / "data.npz", X=X, y=y)
    cases = [dict(name=name, mesh=list(mesh), seed=SEED,
                  config=dict(BASE, **kw)) for name, mesh, kw in TWO_RANK]
    (work / "cases.json").write_text(json.dumps(cases))
    for name, (d, _), _ in TWO_RANK:
        n_loc = -(-N_ROWS // d)
        draws = jax_shard_draws(SEED, 3 * 2, (n_loc * BASE["duplicate_k"], 2),
                                d)
        np.savez(work / f"noise_{name}.npz", **{
            f"{kind}_{e}_{s}_{r}": v[i] for (e, s, r), v in draws.items()
            for i, kind in enumerate(("x1", "jit"))})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_REF, str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_dist_worker.py"),
         str(r), "2", str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out in logs:
        assert rc == 0, out[-3000:]
    return work


@pytest.mark.parametrize("name,mesh,kw", TWO_RANK)
def test_two_rank_gloo_fit_matches_jax_two_devices(two_rank_runs, name, mesh,
                                                   kw):
    """n = 97 rows on data 2 x model 1 (a padded row on rank 1), and on
    data 1 x model 2 (the batch split over the model ranks and gathered)."""
    with np.load(two_rank_runs / f"port_{name}.npz") as p, \
            np.load(two_rank_runs / f"jax_{name}.npz") as j:
        assert_matches(dict(p), dict(j))


# ---------------------------------------------------------------------------
# the CLIs, in-process
# ---------------------------------------------------------------------------

def test_ingest_and_train_clis(tmp_path):
    """repro_torch.launch.ingest -> train_forest --data-dir --mesh none:
    the CLI's model is the API's fit of the same store; a 1x1 mesh (the
    CLI's own one-rank group) gives the same bits."""
    from repro_torch.data.store import DatasetStore
    from repro_torch.launch import ingest as ingest_cli
    from repro_torch.launch import train_forest
    from repro_torch.tabgen import ForestArtifacts

    d = str(tmp_path / "store")
    ingest_cli.main(["--out", d, "--synthetic", "96x3x2", "--shard-rows",
                     "32", "--batch-rows", "20", "--seed", "3"])
    flags = ["--n-t", "2", "--duplicate-k", "3", "--n-trees", "3",
             "--max-depth", "2", "--n-bins", "8", "--device", "cpu"]
    out = str(tmp_path / "model")
    train_forest.main(["--data-dir", d, "--mesh", "none", "--out", out]
                      + flags)
    art = ForestArtifacts.load(out, device="cpu")
    assert art.n_t == 2 and art.n_y == 2
    cfg = ForestConfig(n_t=2, duplicate_k=3, n_trees=3, max_depth=2,
                       n_bins=8, reg_lambda=1.0)
    assert_same(art, fit_artifacts(DatasetStore(d), None, cfg,
                                   device="cpu"))
    again = train_forest.main(["--data-dir", d, "--mesh", "1x1"] + flags)
    assert_same(art, again)
    assert not dist.is_initialized()


def test_dataclass_roundtrip_of_the_sharded_config():
    """split_reduce and hist_bf16 are the JAX package's fields: a sharded
    config round-trips through the sidecar dict."""
    cfg = ForestConfig(**BASE, split_reduce="reduce_scatter", hist_bf16=True)
    assert JConfig(**dataclasses.asdict(cfg)).split_reduce == "reduce_scatter"
