"""The port's generation slice (load -> sample -> impute) against the JAX
package, on the CPU.

Both sides get the same inputs: forests trained by the JAX package and
carried across, and noise drawn from the JAX package's own key chains
(rebuilt here) and handed to the port as tensors. The port draws its noise
with ``torch.Generator``s, which give other numbers than ``jax.random``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ForestConfig
from repro.core import generate as JG
from repro.core import interpolants as jitp
from repro.data.tabular import two_moons
from repro.forest.packed import PackedForest as JPackedForest
from repro.tabgen import ForestArtifacts as JForestArtifacts
from repro.tabgen import TabularGenerator as JTabularGenerator
from repro.tabgen import fit_artifacts, impute as j_impute, sampling as JS
from repro.tabgen import samplers as jsamplers
from repro_torch.config import ForestConfig as TForestConfig
from repro_torch.core import generate as TG
from repro_torch.core import interpolants as titp
from repro_torch.tabgen import (ForestArtifacts, TabularGenerator,
                                artifacts_from_numpy, get_sampler, sample,
                                sample_async, sample_labels)
from repro_torch.tabgen import samplers as tsamplers
from repro_torch.tabgen import sampling as TS
from repro_torch.tabgen import solve_graph
from repro_torch.tabgen.artifacts import rescale, unscale
from repro_torch.tabgen.imputation import clamped_solve
from repro_torch.tabgen.imputation import impute as port_impute

_FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
           "mins", "maxs", "classes", "counts")


def to_port(art):
    """A JAX ForestArtifacts carried across to the port, on the CPU."""
    return artifacts_from_numpy({f: np.asarray(getattr(art, f)) for f in _FIELDS},
                                dataclasses.asdict(art.config), "cpu")


@pytest.fixture(scope="module")
def moons():
    return two_moons(240, seed=0)


def _fit(moons, **kw):
    X, y = moons
    base = dict(n_t=5, duplicate_k=6, n_trees=8, max_depth=3, n_bins=16,
                reg_lambda=1.0)
    base.update(kw)
    return fit_artifacts(X, y, ForestConfig(**base), seed=0)


@pytest.fixture(scope="module")
def flow_so(moons):
    return _fit(moons, method="flow")


@pytest.fixture(scope="module")
def flow_mo(moons):
    return _fit(moons, method="flow", multi_output=True)


@pytest.fixture(scope="module")
def diff_so(moons):
    return _fit(moons, method="diffusion", n_t=6)


@pytest.fixture(scope="module")
def flow_deep(moons):
    """Depth 9: past the old CUDA kernel's uint8 leaf indices."""
    return _fit(moons, method="flow", multi_output=True, n_t=3, n_trees=4,
                max_depth=9)


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# interpolants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_t", [2, 5, 6, 10, 50, 100, 200])
@pytest.mark.parametrize("method", ["flow", "diffusion"])
def test_uniform_timesteps_match_jax(method, n_t):
    ref = np.asarray(jitp.timesteps(method, n_t, 1e-3))
    got = titp.timesteps(method, n_t, 1e-3).numpy()
    assert got.dtype == np.float32 and got.shape == (n_t,)
    # flow grids agree to the bit; diffusion grids (lo = 1e-3) to one ulp
    assert ulps(got, ref) <= (0 if method == "flow" else 1)


@pytest.mark.parametrize("n_t", [5, 50, 200])
@pytest.mark.parametrize("method", ["flow", "diffusion"])
def test_cosine_timesteps_match_jax(method, n_t):
    ref = np.asarray(jitp.timesteps(method, n_t, 1e-3, "cosine"))
    got = titp.timesteps(method, n_t, 1e-3, "cosine").numpy()
    # 1 - cos: the libraries' last-place cos difference near 1 becomes an
    # absolute one: at most one ulp of 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -24)


def test_vp_coefficients_match_jax():
    t = np.linspace(1e-3, 1.0, 97).astype(np.float32)
    a_ref, s_ref = jitp.vp_alpha_sigma(jnp.asarray(t))
    a, s = titp.vp_alpha_sigma(torch.from_numpy(t))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(titp.vp_beta(torch.from_numpy(t)).numpy(),
                               np.asarray(jitp.vp_beta(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the four solvers, one class, same x1 (and for em the same step noise)
# ---------------------------------------------------------------------------

def jax_em_noise(key, n_steps, shape):
    """diffusion_em's per-step draws: ``k, sub = split(k)`` then
    ``normal(sub, x.shape)`` (repro/core/generate.py)."""
    steps = []
    k = key
    for _ in range(n_steps):
        k, sub = jax.random.split(k)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(steps)


def jax_vp_alpha_sigma(t):
    """repro's coefficients as torch tensors: XLA's and PyTorch's expf
    differ in the last place on ~8% of inputs."""
    a, s = jitp.vp_alpha_sigma(jnp.asarray(t.numpy()))
    return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(s))


@pytest.mark.parametrize("solver,art_name", [
    ("euler", "flow_so"), ("euler", "flow_mo"), ("heun", "flow_so"),
    ("heun", "flow_mo"), ("ddim", "diff_so"), ("em", "diff_so")])
def test_solver_matches_jax(request, monkeypatch, solver, art_name):
    """Same forests, x1 and step noise: 1e-5. DDIM divides by alpha(1) ~
    0.0066, which turns a last-place expf difference into ~2e-5, so it is
    held at 1e-5 with repro's coefficients and at 1e-4 with its own."""
    art = request.getfixturevalue(art_name)
    port = to_port(art)
    fc, yi, n = art.config, 1, 97
    x1 = np.random.default_rng(0).normal(size=(n, art.p)).astype(np.float32)
    jforests = JPackedForest(art.feat[:, yi], art.thr_val[:, yi],
                             art.leaf[:, yi], fc.multi_output)
    forests = port.class_forest(yi)
    depth, n_t, eps = fc.max_depth, fc.n_t, fc.eps_diff
    x1_t = torch.from_numpy(x1)[None]
    if solver == "euler":
        ref = JG.flow_euler(jnp.asarray(x1), jforests, depth, n_t)
        got = TG.flow_euler(x1_t, forests, depth, n_t)
    elif solver == "heun":
        ref = JG.flow_heun(jnp.asarray(x1), jforests, depth, n_t)
        got = TG.flow_heun(x1_t, forests, depth, n_t)
    elif solver == "ddim":
        ref = JG.diffusion_ddim(jnp.asarray(x1), jforests, depth, n_t, eps)
        own = TG.diffusion_ddim(x1_t, forests, depth, n_t, eps)
        np.testing.assert_allclose(own[0].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
        monkeypatch.setattr(TG.itp, "vp_alpha_sigma", jax_vp_alpha_sigma)
        got = TG.diffusion_ddim(x1_t, forests, depth, n_t, eps)
    else:
        key = jax.random.PRNGKey(4)
        ref = JG.diffusion_em(jnp.asarray(x1), jforests, depth, n_t, eps, key)
        noise = jax_em_noise(key, n_t - 1, (n, art.p))  # jaxlint: disable=JX001 — rebuilds the draws diffusion_em made from this key
        got = TG.diffusion_em(x1_t, forests, depth, n_t, eps,
                              noise=torch.from_numpy(noise)[:, None])
    assert got.shape == (1, n, art.p)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the class-batched solve and the sample() bookkeeping
# ---------------------------------------------------------------------------

def jax_solve_inputs(seed, n_y, m, p, n_steps):
    """x1 and em noise as repro.tabgen.sampling draws them: per class
    ``split`` into (k_x1, k_solve), per row ``fold_in(k_x1, i)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), n_y)
    x1, noise = [], []
    for c in range(n_y):
        k_x1, k_solve = jax.random.split(keys[c])
        row_keys = jax.vmap(jax.random.fold_in, (None, 0))(k_x1, jnp.arange(m))
        x1.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (p,), jnp.float32))(row_keys)))
        noise.append(jax_em_noise(k_solve, n_steps, (m, p)))
    return keys, np.stack(x1), np.stack(noise, axis=1)


@pytest.mark.parametrize("solver,art_name", [
    ("euler", "flow_so"), ("euler", "flow_mo"), ("heun", "flow_so"),
    ("ddim", "diff_so"), ("em", "diff_so"), ("euler", "flow_deep")])
def test_solve_all_classes_matches_jax(request, solver, art_name):
    art = request.getfixturevalue(art_name)
    port = to_port(art)
    fc, m, seed = art.config, 131, 3
    keys, x1, noise = jax_solve_inputs(seed, art.n_y, m, art.p, fc.n_t - 1)
    ts = jnp.asarray(jitp.timesteps(fc.method, fc.n_t, fc.eps_diff,
                                    fc.t_schedule))
    ref = JS._solve_all_classes(
        art.feat, art.thr_val, art.leaf, keys, art.mins, art.maxs, ts,
        solver_fn=jsamplers.get_sampler(solver).fn, m=m, depth=fc.max_depth,
        n_t=fc.n_t, multi_output=fc.multi_output, eps=fc.eps_diff, impl="xla")
    got = TS.solve_all_classes(
        port.feat, port.thr_val, port.leaf, torch.from_numpy(x1), port.mins,
        port.maxs, titp.timesteps(fc.method, fc.n_t, fc.eps_diff,
                                  fc.t_schedule),
        solver_fn=get_sampler(solver).fn, depth=fc.max_depth, n_t=fc.n_t,
        multi_output=fc.multi_output, eps=fc.eps_diff,
        noise=torch.from_numpy(noise))
    assert got.shape == (art.n_y, m, art.p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["label", "multinomial"])
def test_sample_labels_match_jax(mode):
    counts = np.array([5, 17, 3, 11])
    got = sample_labels(counts, 101, np.random.default_rng(2), mode)
    ref = JS.sample_labels(counts, 101, np.random.default_rng(2), mode)
    np.testing.assert_array_equal(got, ref)


def host_unpad_and_shuffle(x_all, per_class, classes, rng):
    """The oracle: the unpad and shuffle as the host once did them after
    the copy, on the ``[n_y, m, p]`` samples."""
    X = np.concatenate([x_all[yi, :c] for yi, c in enumerate(per_class)])
    y = np.repeat(classes, per_class)
    perm = rng.permutation(len(X))
    return X[perm], y[perm]


@pytest.mark.parametrize("per_class,m", [
    ([40, 7, 0], 64),            # pad_to a bucket above the largest class
    ([9, 0, 23], 23),            # a class with zero rows, between two
    ([0, 1, 0], 1),              # n = 1
], ids=["bucket_above_largest", "class_with_zero_rows", "n_1"])
def test_sample_handle_unpads_and_shuffles_like_jax(per_class, m):
    x_all = np.random.default_rng(0).normal(size=(3, m, 4)).astype(np.float32)
    per_class = np.array(per_class)
    classes = np.array([10, 20, 30])
    X_ref, y_ref = JS.SampleHandle(jnp.asarray(x_all), per_class, classes,
                                   np.random.default_rng(9)).result()
    X_old, y_old = host_unpad_and_shuffle(x_all, per_class, classes,
                                          np.random.default_rng(9))
    perm = np.random.default_rng(9).permutation(int(per_class.sum()))
    x, y = TS.compact(torch.from_numpy(x_all), per_class, classes, perm)
    X, y = TS.SampleHandle(x, y).result()
    for want_X, want_y in ((X_ref, y_ref), (X_old, y_old)):
        np.testing.assert_array_equal(X, want_X)
        np.testing.assert_array_equal(y, want_y)
    assert X.dtype == X_old.dtype and y.dtype == y_old.dtype


@pytest.mark.parametrize("pool", [False, True], ids=["one_thread", "pool"])
def test_result_rows_own_their_memory(flow_so, monkeypatch, pool):
    """``result()``'s rows are an array of their own: writeable, C order,
    untouched by a later call; by one thread or the intra-op pool."""
    if pool:
        monkeypatch.setattr(TS, "POOL_COPY_BYTES", 0)
    port = to_port(flow_so)
    X1, _ = sample_async(port, 50, seed=3).result()
    assert X1.flags.owndata and X1.flags.writeable and X1.flags.c_contiguous
    kept = X1.copy()
    X2, _ = sample_async(port, 50, seed=4).result()
    np.testing.assert_array_equal(X1, kept)
    assert not np.array_equal(X1, X2)


def test_a_second_result_names_the_one_shot_contract():
    """A handle hands its rows over once and lets go of them: a second
    ``result()`` raises an error that says so, not an ``AttributeError``
    from deep inside the copy."""
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    h = TS.SampleHandle(x, np.arange(4))
    X, y = h.result()
    np.testing.assert_array_equal(X, x.numpy())
    with pytest.raises(RuntimeError, match="rows over once"):
        h.result()


def test_registry_mirrors_jax():
    for name in jsamplers.list_samplers():
        j, t = jsamplers.get_sampler(name), tsamplers.get_sampler(name)
        assert (t.method, t.stochastic) == (j.method, j.stochastic), name
    assert tsamplers.list_samplers() == jsamplers.list_samplers()
    assert tsamplers.list_samplers("flow") == ("euler", "heun")
    with pytest.raises(KeyError):
        get_sampler("no_such_solver")


def test_sampler_method_mismatch_raises(flow_so):
    with pytest.raises(ValueError):
        sample(to_port(flow_so), 16, sampler="ddim")


# ---------------------------------------------------------------------------
# noise and padding inside the port
# ---------------------------------------------------------------------------

def test_row_noise_depends_only_on_seed_class_and_row():
    block = TS.NOISE_BLOCK
    small = TS.row_noise(5, 2, 100, 3, "cpu")
    big = TS.row_noise(5, 2, 2 * block + 7, 3, "cpu")
    torch.testing.assert_close(big[:, :100], small, rtol=0, atol=0)
    assert not torch.equal(big[0, :100], big[1, :100])       # classes differ
    assert not torch.equal(TS.row_noise(6, 2, 100, 3, "cpu"), small)


@pytest.mark.parametrize("sampler,art_name", [("euler", "flow_so"),
                                              ("heun", "flow_mo"),
                                              ("ddim", "diff_so")])
def test_pad_to_bucket_same_samples(request, sampler, art_name):
    """Padding to a bucket (here past one noise block) keeps every row."""
    port = to_port(request.getfixturevalue(art_name))
    G1, y1 = sample(port, 100, sampler=sampler, seed=5)
    G2, y2 = sample(port, 100, sampler=sampler, seed=5,
                    pad_to=TS.NOISE_BLOCK + 30)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(G1, G2)


@pytest.mark.parametrize("device,sampler,pad_to,mesh", [
    ("cpu", "euler", 1024, None), ("cuda", "euler", None, None),
    ("cuda", "euler", 1024, object()), ("cuda", "em", 1024, None)],
    ids=["cpu", "unbucketed", "mesh", "em"])
def test_solve_graph_bypasses(device, sampler, pad_to, mesh):
    """The solve runs eagerly on the CPU, without a bucket, on a mesh and
    for a stochastic sampler: no graph key."""
    stochastic = tsamplers.get_sampler(sampler).stochastic
    assert solve_graph.graph_key(device, sampler=sampler,
                                 stochastic=stochastic, pad_to=pad_to,
                                 shape=(15, 1024, 368), mesh=mesh) is None


@pytest.mark.parametrize("sampler", ["euler", "heun", "ddim"])
def test_solve_graph_keys_bucketed_cuda_calls(sampler):
    """A bucketed call of a deterministic sampler on a CUDA device has a
    key; two calls at one shape share it, another shape or sampler not."""
    def key(shape=(15, 1024, 368), name=sampler):
        return solve_graph.graph_key(
            torch.device("cuda", 0), sampler=name,
            stochastic=tsamplers.get_sampler(name).stochastic,
            pad_to=shape[1], shape=shape)
    assert key() is not None
    assert key() == key(tuple(np.int64(s) for s in (15, 1024, 368)))
    assert key((15, 256, 368)) != key()
    assert key(name="euler" if sampler != "euler" else "heun") != key()


@pytest.mark.parametrize("sampler,art_name", [("euler", "flow_so"),
                                              ("em", "diff_so")])
def test_sample_async_equals_sample(request, sampler, art_name):
    port = to_port(request.getfixturevalue(art_name))
    handle = sample_async(port, 77, sampler=sampler, seed=8)
    G1, y1 = handle.result()
    G2, y2 = sample(port, 77, sampler=sampler, seed=8)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(y1, y2)
    assert G1.shape == (77, port.p) and np.isfinite(G1).all()
    ref_labels = np.sort(JS.sample_labels(
        port.counts, 77, np.random.default_rng(8), port.config.label_sampler))
    np.testing.assert_array_equal(
        np.sort(y1), np.asarray(port.classes)[ref_labels])


# ---------------------------------------------------------------------------
# imputation
# ---------------------------------------------------------------------------

def port_impute_with_jax_noise(art, port, X_missing, y, seed, rounds):
    """The port's clamped solve, per class, fed the noise of repro's
    impute: ``key = PRNGKey(seed + 31)``; per class ``split`` -> eps_fix,
    then per round ``split`` -> eps_r (repro/tabgen/imputation.py)."""
    fc = port.config
    ts = titp.timesteps(fc.method, fc.n_t, fc.eps_diff, fc.t_schedule).numpy()
    lut = {c: i for i, c in enumerate(port.classes)}
    y_idx = np.asarray([lut[v] for v in y])
    out = X_missing.copy()
    key = jax.random.PRNGKey(seed + 31)
    for yi in range(port.n_y):
        sel = np.where(y_idx == yi)[0]
        if len(sel) == 0:
            continue
        rows = X_missing[sel]
        mask = ~np.isnan(rows)
        key, k_fix = jax.random.split(key)
        eps_fix = np.array(jax.random.normal(k_fix, rows.shape, jnp.float32))
        eps_rounds = []
        for _ in range(rounds):
            key, kr = jax.random.split(key)
            eps_rounds.append(torch.from_numpy(np.array(
                jax.random.normal(kr, rows.shape, jnp.float32))))
        obs = rescale(torch.from_numpy(np.nan_to_num(rows)), port.mins[yi],
                      port.maxs[yi])
        x0 = clamped_solve(port.class_forest(yi), obs, torch.from_numpy(mask),
                           torch.from_numpy(eps_fix), eps_rounds, ts,
                           method=fc.method, depth=fc.max_depth)
        vals = unscale(x0, port.mins[yi], port.maxs[yi]).numpy()
        out[sel] = np.where(mask, rows, vals)
    return out


@pytest.mark.parametrize("art_name,rounds", [("flow_so", 1), ("flow_so", 3),
                                             ("flow_mo", 2), ("diff_so", 3),
                                             ("flow_deep", 2)])
def test_impute_matches_jax(request, moons, art_name, rounds):
    art = request.getfixturevalue(art_name)
    port = to_port(art)
    X, y = moons
    Xm = X[:24].copy()
    Xm[::2, 1] = np.nan
    Xm[1::3, 0] = np.nan
    lab = y[:24]
    ref = j_impute(art, Xm, lab, seed=2, refine_rounds=rounds)
    got = port_impute_with_jax_noise(art, port, Xm, lab, 2, rounds)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_impute_keeps_observed_cells(flow_so, moons):
    X, y = moons
    Xm = X[:30].copy()
    Xm[::2, 0] = np.nan
    port = to_port(flow_so)
    gen = TabularGenerator(port.config)
    gen.artifacts = port
    filled = gen.impute(Xm, y[:30], seed=1)
    observed = ~np.isnan(Xm)
    np.testing.assert_array_equal(filled[observed], Xm[observed])
    assert np.isfinite(filled).all()
    np.testing.assert_array_equal(filled, gen.impute(Xm, y[:30], seed=1))


@pytest.mark.parametrize("rows,labels,match", [
    (slice(None, 1), "y", r"rows of shape \(6, 1\)"),
    (slice(None), None, "labels required for conditional models"),
    (slice(None), "bad", r"labels \[7\] are not among the model's classes"),
    (slice(None), "short", r"labels of shape \(5,\) for 6 rows"),
])
def test_impute_refuses_rows_and_labels_that_do_not_fit(flow_so, moons, rows,
                                                        labels, match):
    """A request that does not fit the model is refused with a ValueError
    before any solve (a serving mesh checks it so before publishing)."""
    X, y = moons
    Xm = X[:6].copy()
    Xm[::2, 0] = np.nan
    lab = {"y": y[:6], None: None, "bad": np.array([0, 1, 7, 0, 1, 0]),
           "short": y[:5]}[labels]
    with pytest.raises(ValueError, match=match):
        port_impute(to_port(flow_so), Xm[:, rows], lab, seed=1)


# ---------------------------------------------------------------------------
# save / load across the two packages, and the slice end to end
# ---------------------------------------------------------------------------

def _assert_same_model(a, b):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert a.lineage == b.lineage


def test_jax_save_loads_in_port_and_back(tmp_path, flow_mo):
    art = dataclasses.replace(flow_mo, lineage={"rows": 240, "store": None,
                                                "base": None})
    base = art.save(str(tmp_path / "jax_model"))
    port = ForestArtifacts.load(base, device="cpu")
    assert isinstance(port.config, TForestConfig)
    _assert_same_model(port.to("cpu"), art)
    base2 = port.save(str(tmp_path / "port_model"))
    back = JForestArtifacts.load(base2)
    _assert_same_model(back, art)


def _mixed_dataset(n=200, seed=1):
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=n)
    x_int = np.round(3 * x_num + rng.normal(size=n)).clip(-5, 5)
    x_cat = (x_num > 0).astype(float) + rng.integers(0, 2, size=n)
    return np.stack([x_num, x_int, x_cat], 1)


def test_mixed_schema_round_trip_across_packages(tmp_path):
    X = _mixed_dataset()
    fcfg = ForestConfig(method="flow", n_t=4, duplicate_k=4, n_trees=4,
                        max_depth=3, n_bins=16, reg_lambda=1.0)
    jgen = JTabularGenerator(fcfg, cat_cols=[2], int_cols=[1]).fit(X, seed=0)
    base = jgen.save(str(tmp_path / "mixed"))
    gen = TabularGenerator.load(base, device="cpu")
    assert gen.schema.to_dict() == jgen.schema.to_dict()
    G, _ = gen.generate(150, seed=1)
    assert G.shape == (150, 3)
    assert set(np.unique(G[:, 2])) <= set(np.unique(X[:, 2]))
    np.testing.assert_array_equal(G[:, 1], np.round(G[:, 1]))
    Xm = X[:20].copy()
    Xm[::2, 2] = np.nan
    filled = gen.impute(Xm, seed=0)
    assert set(np.unique(filled[:, 2])) <= set(np.unique(X[:, 2]))
    np.testing.assert_array_equal(filled[1::2], X[1:20:2])
    base2 = gen.save(str(tmp_path / "mixed_port"))
    jgen2 = JTabularGenerator.load(base2)
    assert jgen2.schema.to_dict() == jgen.schema.to_dict()
    _assert_same_model(jgen2.artifacts, jgen.artifacts)


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_slice_end_to_end_from_jax_model(tmp_path, flow_so, sampler):
    """A model trained and saved by the JAX package, loaded and served by
    the port: the same labels as JAX's sample, finite rows near the data."""
    base = flow_so.save(str(tmp_path / "m"))
    gen = TabularGenerator.load(base, device="cpu")
    G, y = gen.generate(200, sampler=sampler, seed=3)
    G_j, y_j = JS.sample(flow_so, 200, sampler=sampler, seed=3)
    assert G.shape == G_j.shape == (200, 2) and np.isfinite(G).all()
    np.testing.assert_array_equal(np.sort(y), np.sort(y_j))
    # other noise, same model: the same distribution to within sampling error
    np.testing.assert_allclose(G.mean(0), G_j.mean(0), atol=0.15)
    np.testing.assert_allclose(G.std(0), G_j.std(0), atol=0.15)


def test_deep_model_loads_samples_and_imputes_on_the_cpu(tmp_path, flow_deep,
                                                         moons):
    """A depth-9 model trained and saved by the JAX package goes load ->
    sample -> impute through the port on the CPU (the plain path takes any
    depth): JAX's labels, finite rows, observed cells kept."""
    base = flow_deep.save(str(tmp_path / "deep"))
    gen = TabularGenerator.load(base, device="cpu")
    assert gen.artifacts.config.max_depth == 9
    G, y = gen.generate(120, seed=3)
    _, y_j = JS.sample(flow_deep, 120, seed=3)
    assert G.shape == (120, 2) and np.isfinite(G).all()
    np.testing.assert_array_equal(np.sort(y), np.sort(y_j))
    X, lab = moons
    Xm = X[:20].copy()
    Xm[::2, 0] = np.nan
    filled = gen.impute(Xm, lab[:20], seed=1)
    observed = ~np.isnan(Xm)
    assert np.isfinite(filled).all()
    np.testing.assert_array_equal(filled[observed], Xm[observed])


def _same_seed_twice(device, art, moons):
    """generate, impute and fit, each twice with one seed on ``device``:
    identical results; another seed gives other rows."""
    gen = TabularGenerator(art.config)
    gen.artifacts = art.to(device)
    G1, y1 = gen.generate(150, seed=5)
    G2, y2 = gen.generate(150, seed=5)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(y1, y2)
    assert not np.array_equal(G1, gen.generate(150, seed=6)[0])
    X, lab = moons
    Xm = X[:30].copy()
    Xm[1::2, 1] = np.nan
    np.testing.assert_array_equal(gen.impute(Xm, lab[:30], seed=2),
                                  gen.impute(Xm, lab[:30], seed=2))
    cfg = TForestConfig(n_t=2, duplicate_k=3, n_trees=3, max_depth=2,
                        n_bins=16)
    a = TabularGenerator(cfg).fit(X, lab, seed=4, device=device).artifacts
    b = TabularGenerator(cfg).fit(X, lab, seed=4, device=device).artifacts
    for f in ("feat", "thr_val", "leaf", "mins", "maxs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_one_seed_gives_identical_rows_twice_on_the_cpu(flow_so, moons):
    _same_seed_twice("cpu", to_port(flow_so), moons)


@pytest.mark.cuda
def test_one_seed_gives_identical_rows_twice_on_the_card(flow_so, moons):
    """The card draws its own noise (Philox), not the CPU's, for one seed;
    on one device type a seed is reproducible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python3 chip_smoke.py runs the "
                    "port on the card")
    _same_seed_twice("cuda", to_port(flow_so), moons)
