"""The port's training slice (fit -> extend -> save) against the JAX
package, on the CPU.

Both sides get the same inputs. For whole fits the test rebuilds the JAX
package's bridge noise from its own key chains (``fold_in(root, 2·eid +
split)`` per ensemble, then ``split`` into the x1 and jitter keys) and hands
it to the port through ``fit_artifacts(noise=...)``; the port's own draws
come from ``torch.Generator``s and differ.

Tolerances. Tree structure (``feat``, ``thr_bin``), ``best_round`` and
``rounds_run`` must be equal. The histograms and the split search's prefix
sums add in the JAX package's order, so on small inputs the splits agree
exactly; XLA fuses the bridge's multiply-adds differently from case to case,
so a value of x_t, and so a threshold, may differ by one ulp: ``thr_val``,
``leaf`` and ``val_curve`` are held to 1e-5 (relative, for diffusion's large
validation losses). On dyadic inputs every sum is exact in any order, and
trees are compared bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ForestConfig
from repro.core import interpolants as jitp
from repro.data.tabular import two_moons
from repro.forest import binning as jbin
from repro.forest.boosting import fit_ensemble as j_fit_ensemble
from repro.forest.split import best_splits as j_best_splits
from repro.forest.tree import grow_tree as j_grow_tree
from repro.forest.tree import predict_tree_codes as j_predict_codes
from repro.forest.tree import predict_tree_values as j_predict_values
from repro.tabgen import ForestArtifacts as JForestArtifacts
from repro.tabgen import TabularGenerator as JTabularGenerator
from repro.tabgen import fit_artifacts as j_fit_artifacts
from repro.tabgen import sample as j_sample
from repro.tabgen.fitting import weighted_edges as j_weighted_edges
from repro_torch.config import ForestConfig as TForestConfig
from repro_torch.core import interpolants as titp
from repro_torch.forest import binning as tbin
from repro_torch.forest.boosting import fit_boosted, fit_ensemble
from repro_torch.forest.split import best_splits, prefix_sum
from repro_torch.forest.tree import (Tree, grow_tree, predict_tree_codes,
                                     predict_tree_values)
from repro_torch.tabgen import (ForestArtifacts, TabularGenerator,
                                extend_artifacts, fit_artifacts, sample)
from repro_torch.tabgen import fitting as tfitting
from repro_torch.train.checkpoint import GridManifest

FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
          "mins", "maxs")
MOONS_CFG = dict(n_t=5, duplicate_k=6, n_trees=8, max_depth=3, n_bins=16,
                 reg_lambda=1.0)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_noise(seed):
    """The JAX package's bridge draws, as the port's ``noise`` hook."""
    root = jax.random.PRNGKey(seed)

    def noise(eid, split, shape):
        k_noise, k_jitter = jax.random.split(
            jax.random.fold_in(root, eid * 2 + split))
        return (t(jax.random.normal(k_noise, shape, jnp.float32)),
                t(jax.random.normal(k_jitter, shape, jnp.float32)))

    return noise


def assert_fit_matches(jart, tart, rtol=1e-5):
    for f in ("feat", "best_round", "rounds_run", "mins", "maxs"):
        np.testing.assert_array_equal(getattr(tart, f).numpy(),
                                      np.asarray(getattr(jart, f)), err_msg=f)
    for f in ("thr_val", "leaf", "val_curve"):
        np.testing.assert_allclose(getattr(tart, f).numpy(),
                                   np.asarray(getattr(jart, f)), rtol=rtol,
                                   atol=1e-5, err_msg=f)


def assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def moons():
    return two_moons(240, seed=0)


# ---------------------------------------------------------------------------
# interpolants and binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["flow", "diffusion"])
def test_bridge_matches_jax(method):
    x0 = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
    sigma = 0.2 if method == "flow" else 0.0
    for i, tt in enumerate((0.001, 0.25, 0.5, 0.9)):
        x1, jit = jax_noise(i)(0, 0, x0.shape)
        key = jax.random.fold_in(jax.random.PRNGKey(i), 0)
        _, xt_j, tgt_j = jitp.sample_bridge(key, jnp.asarray(x0), method,
                                            jnp.float32(tt), sigma)
        _, xt, tgt = titp.sample_bridge(t(x0), method, t(np.float32(tt)),
                                        sigma, x1=x1, jitter=jit)
        # one rounding of a + b·c on both sides; exp differs in the last place
        np.testing.assert_allclose(xt.numpy(), np.asarray(xt_j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_j), rtol=1e-6,
                                   atol=1e-6)


def test_bridge_jitter_is_a_second_independent_draw():
    x0 = torch.zeros((500, 3))
    gen = torch.Generator().manual_seed(0)
    x1, xt, _ = titp.sample_bridge(x0, "flow", torch.tensor(0.5), 0.3,
                                   generator=gen)
    jitter = (xt - 0.5 * x1) / 0.3
    assert abs(torch.corrcoef(torch.stack([x1.flatten(),
                                           jitter.flatten()]))[0, 1]) < 0.1
    with pytest.raises(ValueError, match="generator"):
        titp.sample_bridge(x0, "flow", torch.tensor(0.5), 0.3)


def calo_like(n, p, seed):
    """Rows with ties and zero-heavy columns, as calorimeter voxels are."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 1.0, (n, p)).astype(np.float32)
    x[rng.random((n, p)) < 0.6] = 0.0
    x[:, 1] = np.round(x[:, 1])                 # heavy ties
    x[:, 2] = 0.0                               # a dead column
    return x


@pytest.mark.parametrize("n_bins", [8, 16, 33, 64])
def test_weighted_edges_and_transform_match_jax(n_bins):
    x = calo_like(500, 6, seed=n_bins)
    w = np.ones(500, np.float32)
    w[450:] = 0.0                                # padded rows
    e_j = np.asarray(j_weighted_edges(jnp.asarray(x), jnp.asarray(w), n_bins))
    e_t = tfitting.weighted_edges(t(x), t(w), n_bins)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    # values equal to an edge, between edges and above the last
    probe = np.concatenate([x, e_j.T, e_j.T + 1e-3], axis=0)
    c_j = np.asarray(jbin.transform(jnp.asarray(probe), jnp.asarray(e_j)))
    c_t = tbin.transform(t(probe), t(e_j))
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    # the routing contract: code > b  <=>  x > edges[:, b]
    b = n_bins // 2
    np.testing.assert_array_equal(c_t.numpy() > b, probe > e_j[:, b])


def test_fit_bins_pack_codes_and_sentinel_match_jax():
    x = calo_like(400, 5, seed=1)
    np.testing.assert_allclose(tbin.fit_bins(t(x), 16).numpy(),
                               np.asarray(jbin.fit_bins(jnp.asarray(x), 16)),
                               rtol=1e-6, atol=1e-7)
    codes = np.arange(10, dtype=np.int32)[:, None]
    for n_bins, dtype in ((16, torch.int8), (300, torch.int16),
                          (40000, torch.int32)):
        assert tbin.pack_codes(t(codes), n_bins).dtype == dtype
    e = np.sort(x[:7].T, axis=1)
    np.testing.assert_array_equal(
        tbin.edges_with_sentinel(t(e)).numpy(),
        np.asarray(jbin.edges_with_sentinel(jnp.asarray(e))))


# ---------------------------------------------------------------------------
# split search
# ---------------------------------------------------------------------------

_jax_cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=2))


@pytest.mark.parametrize("length", [1, 2, 15, 16, 17, 33, 64, 100, 256, 300])
def test_prefix_sum_adds_in_xlas_order(length):
    rng = np.random.default_rng(length)
    x = (rng.normal(size=(3, 4, length, 2))
         * rng.uniform(0.1, 1e3, size=(3, 4, 1, 2))).astype(np.float32)
    ref = np.asarray(_jax_cumsum(x))
    np.testing.assert_array_equal(prefix_sum(t(x), 2).numpy(), ref)
    np.testing.assert_array_equal(prefix_sum(t(x[..., 0]), -1).numpy(),
                                  ref[..., 0])


@pytest.mark.parametrize("out", [1, 2, 3])
@pytest.mark.parametrize("data", ["integer", "dyadic", "float"])
def test_best_splits_match_jax(data, out):
    rng = np.random.default_rng(out)
    nodes, p, bins = 4, 5, 16
    if data == "integer":
        sum_g = rng.integers(-20, 20, (nodes, p, bins, out)).astype(np.float32)
        count = rng.integers(0, 6, (nodes, p, bins)).astype(np.float32)
    else:
        sum_g = rng.normal(size=(nodes, p, bins, out)).astype(np.float32)
        count = rng.uniform(0, 4, (nodes, p, bins)).astype(np.float32)
        if data == "dyadic":
            sum_g, count = np.round(sum_g * 64) / 64, np.round(count * 4) / 4
    count[0, :, 1:] = 0.0                       # a node no split can cut
    for mcw in (1e-6, 1.0):
        ref = j_best_splits(jnp.asarray(sum_g), jnp.asarray(count), 1.0, mcw)
        got = best_splits(t(sum_g)[None], t(count)[None], 1.0, mcw)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def test_best_splits_breaks_ties_to_the_first_index():
    sum_g = np.zeros((1, 2, 4, 1), np.float32)
    sum_g[0, :, 0, 0], sum_g[0, :, 3, 0] = 1.0, -1.0   # same gain everywhere
    count = np.ones((1, 2, 4), np.float32)
    feat, thr, _ = best_splits(t(sum_g)[None], t(count)[None], 0.0, 1e-6)
    assert (feat.item(), thr.item()) == (0, 0)


# ---------------------------------------------------------------------------
# trees, on dyadic gradients (every sum exact in any order)
# ---------------------------------------------------------------------------

def tree_inputs(n, p, out, n_bins, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, p)).astype(np.int32)
    g = np.round(rng.normal(size=(n, out)) * 64).astype(np.float32) / 64
    w = (rng.random(n) > 0.2).astype(np.float32)
    edges = np.sort(rng.normal(size=(p, n_bins - 1)), axis=1).astype(
        np.float32)
    return codes, g, w, np.asarray(jbin.edges_with_sentinel(jnp.asarray(edges)))


TREE_KW = dict(reg_lambda=1.0, min_child_weight=1e-6, learning_rate=0.5)
_j_grow_tree = jax.jit(j_grow_tree, static_argnames=(
    "depth", "n_bins", "reg_lambda", "min_child_weight", "learning_rate",
    "hist_bf16"))


@pytest.mark.parametrize("hist_bf16", [False, True])
@pytest.mark.parametrize("depth,n_bins,out", [(3, 8, 3), (4, 16, 1),
                                              (2, 64, 2)])
def test_grow_tree_equals_jax(depth, n_bins, out, hist_bf16):
    codes, g, w, es = tree_inputs(300, 5, out, n_bins, seed=depth)
    jtree, jnode = _j_grow_tree(jnp.asarray(codes), jnp.asarray(g),
                               jnp.asarray(w), jnp.asarray(es), depth=depth,
                               n_bins=n_bins, hist_bf16=hist_bf16, **TREE_KW)
    tree, node = grow_tree(t(codes), t(g)[None], t(w), t(es), depth=depth,
                           n_bins=n_bins, hist_bf16=hist_bf16, **TREE_KW)
    for f in Tree._fields:
        np.testing.assert_array_equal(getattr(tree, f)[0].numpy(),
                                      np.asarray(getattr(jtree, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(node[0].numpy(), np.asarray(jnode))
    # traversal by codes and by raw values that the codes were cut from
    rng = np.random.default_rng(1)
    vcodes = rng.integers(0, n_bins, (77, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        predict_tree_codes(t(vcodes), tree, depth)[0].numpy(),
        np.asarray(j_predict_codes(jnp.asarray(vcodes), jtree, depth)))
    x = rng.normal(size=(77, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        predict_tree_values(t(x), tree.feat, tree.thr_val, tree.leaf,
                            depth)[0].numpy(),
        np.asarray(j_predict_values(jnp.asarray(x), jtree.feat,
                                    jtree.thr_val, jtree.leaf, depth)))


def test_so_lanes_grow_the_trees_jax_vmaps():
    codes, g, w, es = tree_inputs(200, 4, 3, 16, seed=9)
    grow = jax.jit(jax.vmap(lambda gc: j_grow_tree(
        jnp.asarray(codes), gc[:, None], jnp.asarray(w), jnp.asarray(es),
        depth=3, n_bins=16, **TREE_KW)[0], in_axes=1))
    jtree = grow(jnp.asarray(g))
    tree, _ = grow_tree(t(codes), t(g).T[..., None].contiguous(), t(w),
                        t(es), depth=3, n_bins=16, **TREE_KW)
    for f in Tree._fields:
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(getattr(jtree, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# boosting
# ---------------------------------------------------------------------------

def boost_inputs(seed, n=240, p=3, n_bins=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    xv = rng.normal(size=(n, p)).astype(np.float32)
    tgt = (np.sin(2 * x) + 0.3 * rng.normal(size=(n, p))).astype(np.float32)
    tgtv = (np.sin(2 * xv) + 0.3 * rng.normal(size=(n, p))).astype(np.float32)
    w = np.ones(n, np.float32)
    w[-20:] = 0.0
    edges = np.asarray(j_weighted_edges(jnp.asarray(x), jnp.asarray(w),
                                        n_bins))
    codes = np.asarray(jbin.transform(jnp.asarray(x), jnp.asarray(edges)))
    vcodes = np.asarray(jbin.transform(jnp.asarray(xv), jnp.asarray(edges)))
    es = np.asarray(jbin.edges_with_sentinel(jnp.asarray(edges)))
    return codes, tgt, w, es, vcodes, tgtv, x, xv


BOOST_CFG = dict(n_trees=10, max_depth=3, n_bins=16, reg_lambda=1.0,
                 learning_rate=0.7)


@pytest.mark.parametrize("es_rounds", [0, 2])
@pytest.mark.parametrize("mo", [False, True])
def test_fit_ensemble_matches_jax(mo, es_rounds):
    codes, tgt, w, es, vcodes, tgtv, _, _ = boost_inputs(seed=4)
    cfg = dict(BOOST_CFG, multi_output=mo, early_stop_rounds=es_rounds)
    ref = j_fit_ensemble(*(jnp.asarray(a) for a in (codes, tgt, w, es, vcodes,
                                                    tgtv, w)),
                         ForestConfig(**cfg))
    got = fit_ensemble(t(codes), t(tgt), t(w), t(es), t(vcodes), t(tgtv),
                       t(w), TForestConfig(**cfg))
    for f in ("feat", "best_round", "rounds_run"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("thr_val", "leaf", "val_curve"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


@pytest.fixture(scope="module")
def so_early_stopped():
    """SO lanes whose validation targets are mostly noise, so they stop at
    different rounds."""
    codes, tgt, w, es, vcodes, tgtv, _, _ = boost_inputs(seed=11, p=4)
    rng = np.random.default_rng(2)
    tgtv = tgtv + rng.normal(size=tgtv.shape).astype(np.float32) * \
        np.array([0.0, 1.0, 2.0, 4.0], np.float32)
    cfg = TForestConfig(**dict(BOOST_CFG, n_trees=14, early_stop_rounds=2))
    args = (t(codes), t(tgt), t(w), t(es), t(vcodes), t(tgtv), t(w), cfg)
    return args, fit_ensemble(*args)


def test_so_lanes_stop_at_different_rounds_as_jax_does(so_early_stopped):
    args, got = so_early_stopped
    assert len(set(got.rounds_run.tolist())) > 1, got.rounds_run
    assert (got.rounds_run < 14).any()
    ref = j_fit_ensemble(*(jnp.asarray(a.numpy()) for a in args[:7]),
                         ForestConfig(**dataclasses.asdict(args[7])))
    for f in ("feat", "best_round", "rounds_run"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(np.isinf(got.val_curve.numpy()),
                                  np.isinf(np.asarray(ref.val_curve)))


def test_each_so_lane_equals_that_lane_fitted_alone(so_early_stopped):
    (codes, tgt, w, es, vcodes, tgtv, vw, cfg), got = so_early_stopped
    for s in range(tgt.shape[1]):
        alone = fit_boosted(codes, tgt[:, s, None][None], w, es, vcodes,
                            tgtv[:, s, None][None], vw, cfg)
        for f in alone._fields:
            assert torch.equal(getattr(got, f)[s], getattr(alone, f)[0]), \
                (s, f)


def test_warm_fit_boosted_continues_to_the_cold_result():
    codes, tgt, w, es, vcodes, tgtv, x, xv = (t(a) for a in
                                              boost_inputs(seed=5))
    cfg = TForestConfig(**dict(BOOST_CFG, early_stop_rounds=2))
    cold = fit_ensemble(codes, tgt, w, es, vcodes, tgtv, w, cfg)
    base = fit_ensemble(codes, tgt, w, es, vcodes, tgtv, w,
                        dataclasses.replace(cfg, n_trees=4))
    warm = (base.feat, base.thr_val, base.leaf, base.val_curve,
            base.best_round)
    ext = fit_ensemble(codes, tgt, w, es, vcodes, tgtv, w, cfg, warm=warm,
                       x_raw=x, val_raw=xv)
    for f in cold._fields:
        assert torch.equal(getattr(cold, f), getattr(ext, f)), f
    with pytest.raises(ValueError, match="x_raw"):
        fit_ensemble(codes, tgt, w, es, vcodes, tgtv, w, cfg, warm=warm)


# ---------------------------------------------------------------------------
# the whole fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moons_fits(moons):
    """(JAX fit, port fit with the JAX fit's noise) per configuration."""
    X, y = moons
    cache = {}

    def get(name, **kw):
        if name not in cache:
            cfg = dict(MOONS_CFG, **kw)
            jart = j_fit_artifacts(X, y, ForestConfig(**cfg), seed=0)
            tart = fit_artifacts(X, y, TForestConfig(**cfg), seed=0,
                                 device="cpu", noise=jax_noise(0))
            cache[name] = (jart, tart)
        return cache[name]

    return get


@pytest.mark.parametrize("name,kw", [
    ("flow_so", dict(method="flow")),
    ("flow_mo", dict(method="flow", multi_output=True)),
    ("flow_so_jitter", dict(method="flow", sigma=0.1)),
    ("flow_mo_es", dict(method="flow", multi_output=True, n_trees=12,
                        early_stop_rounds=2)),
])
def test_fit_artifacts_matches_jax(moons_fits, name, kw):
    jart, tart = moons_fits(name, **kw)
    try:
        assert_fit_matches(jart, tart)
    except AssertionError:
        # report how close the splits were where the structure differs
        diff = np.argwhere(tart.feat.numpy() != np.asarray(jart.feat))
        raise AssertionError(f"{name}: feat differs at {diff[:5].tolist()}")
    assert tart.lineage == {"rows": 240, "p": 2, "store": None, "base": None}


def test_diffusion_fit_matches_jax_given_its_grid_and_coefficients(
        moons, monkeypatch):
    """Diffusion grids differ by an ulp, and XLA's exp from PyTorch's in the
    last place; given the JAX package's grid and coefficients the fits
    agree (validation losses reach 1e4 here: rtol 1e-5)."""
    X, y = moons
    cfg = dict(MOONS_CFG, method="diffusion", n_t=6)
    jart = j_fit_artifacts(X, y, ForestConfig(**cfg), seed=0)
    grid = np.asarray(jitp.timesteps("diffusion", 6, 1e-3))
    vp = jax.jit(jitp.vp_alpha_sigma)
    monkeypatch.setattr(titp, "timesteps", lambda *a, **k: t(grid))
    monkeypatch.setattr(titp, "vp_alpha_sigma", lambda tt: tuple(
        t(v) for v in vp(jnp.asarray(tt.numpy()))))
    tart = fit_artifacts(X, y, TForestConfig(**cfg), seed=0, device="cpu",
                         noise=jax_noise(0))
    assert_fit_matches(jart, tart, rtol=1e-5)


def test_artifacts_cross_load_and_sample_both_ways(moons_fits, tmp_path):
    jart, tart = moons_fits("flow_mo", method="flow", multi_output=True)
    # port-trained -> JAX: samples agree with the JAX-trained model's
    base = TabularGenerator(tart.config)
    base.artifacts = tart
    path = base.save(str(tmp_path / "port"))
    jloaded = JTabularGenerator.load(path)
    Xa, ya = j_sample(jloaded.artifacts, 300, seed=3)
    Xb, yb = j_sample(jart, 300, seed=3)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_allclose(Xa, Xb, rtol=1e-4, atol=1e-4)
    # JAX-trained -> port
    jgen = JTabularGenerator(jart.config)
    jgen.artifacts = jart
    tloaded = TabularGenerator.load(jgen.save(str(tmp_path / "jax")),
                                    device="cpu")
    Xc, yc = tloaded.generate(300, seed=3)
    Xd, yd = sample(tart, 300, seed=3)
    np.testing.assert_array_equal(yc, yd)
    np.testing.assert_allclose(Xc, Xd, rtol=1e-4, atol=1e-4)
    assert np.isfinite(Xc).all() and Xc.shape == (300, 2)


# ---------------------------------------------------------------------------
# warm start, checkpoints, the facade
# ---------------------------------------------------------------------------

SMALL = TForestConfig(n_t=2, duplicate_k=3, n_trees=6, max_depth=2, n_bins=8,
                      reg_lambda=1.0)


@pytest.fixture(scope="module")
def small_data():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(96, 3)).astype(np.float32)
    y = (rng.random(96) > 0.5).astype(np.int64)
    return X, y


@pytest.mark.parametrize("kw", [dict(), dict(early_stop_rounds=2),
                                dict(multi_output=True, early_stop_rounds=2)])
def test_extend_is_bit_identical_to_a_cold_fit(small_data, kw):
    X, y = small_data
    fcfg = dataclasses.replace(SMALL, **kw)
    cold = fit_artifacts(X, y, fcfg, seed=5, device="cpu")
    base = fit_artifacts(X, y, dataclasses.replace(fcfg, n_trees=4), seed=5,
                         device="cpu")
    ext = extend_artifacts(base, X, y, extra_trees=2, seed=5, device="cpu")
    assert ext.config.n_trees == 6
    assert_same(cold, ext)
    assert ext.lineage["base"]["round_range"] == [4, 6]
    assert ext.lineage["rows"] == len(X) and ext.lineage["store"] is None
    assert_same(base.extend(X, y, extra_trees=2, seed=5, device="cpu"), ext)


def test_extend_validation_errors(small_data):
    X, y = small_data
    base = fit_artifacts(X, y, dataclasses.replace(SMALL, n_trees=4), seed=5,
                         device="cpu")
    with pytest.raises(ValueError, match="extra_trees"):
        extend_artifacts(base, X, y, extra_trees=0, device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        fit_artifacts(X, y, dataclasses.replace(SMALL, max_depth=3),
                      warm_start=base, device="cpu")
    with pytest.raises(ValueError, match="p=3"):
        extend_artifacts(base, X[:, :2], y, extra_trees=2, device="cpu")
    with pytest.raises(ValueError, match="class mismatch"):
        extend_artifacts(base, X, y + 5, extra_trees=2, device="cpu")


def test_grid_manifest_accepts_warm_base_and_refuses_strangers(tmp_path):
    d = str(tmp_path / "ckpt")
    base_fp = {"config": {"n_trees": 4, "max_depth": 2}, "grid": [2, 2],
               "ensembles_per_batch": 2, "data": [96, 3]}
    m0 = GridManifest(d, base_fp)
    m0.load_done(resume=False)
    m0.mark_done((0, 2))
    ext_fp = dict(base_fp, config={"n_trees": 6, "max_depth": 2},
                  warm_start=4)
    m1 = GridManifest(d, ext_fp, warm_base={"config": base_fp["config"],
                                            "grid": base_fp["grid"]})
    assert m1.load_done(resume=True) == set()
    with pytest.raises(ValueError) as ei:
        GridManifest(d, ext_fp).load_done(resume=True)
    msg = str(ei.value)
    assert "differing keys" in msg and "config" in msg
    assert "checkpoint fingerprint" in msg
    other = GridManifest(d, ext_fp, warm_base={"config": {"n_trees": 9},
                                               "grid": [2, 2]})
    with pytest.raises(ValueError, match="differing keys"):
        other.load_done(resume=True)


def test_extension_resumes_over_the_base_checkpoint(tmp_path, small_data):
    X, y = small_data
    d = str(tmp_path / "ckpt")
    base = fit_artifacts(X, y, dataclasses.replace(SMALL, n_trees=4), seed=5,
                         checkpoint_dir=d, ensembles_per_batch=2,
                         device="cpu")
    ext = extend_artifacts(base, X, y, extra_trees=2, seed=5,
                           checkpoint_dir=d, resume=True,
                           ensembles_per_batch=2, device="cpu")
    assert_same(fit_artifacts(X, y, SMALL, seed=5, device="cpu"), ext)
    man = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert man["fingerprint"]["warm_start"] == 4


def _no_training(*args, **kwargs):
    raise AssertionError("a committed batch was trained again")


def test_resume_retrains_nothing(tmp_path, small_data, monkeypatch):
    X, y = small_data
    d = str(tmp_path / "ckpt")
    first = fit_artifacts(X, y, SMALL, seed=5, checkpoint_dir=d,
                          ensembles_per_batch=3, device="cpu")
    monkeypatch.setattr(tfitting, "fit_ensemble", _no_training)
    again = fit_artifacts(X, y, SMALL, seed=5, checkpoint_dir=d, resume=True,
                          ensembles_per_batch=3, device="cpu")
    assert_same(first, again)
    with pytest.raises(ValueError, match="mismatched run configuration"):
        fit_artifacts(X, y, dataclasses.replace(SMALL, n_bins=16),
                      checkpoint_dir=d, resume=True, ensembles_per_batch=3,
                      device="cpu")


def test_port_resumes_a_jax_checkpoint(tmp_path, small_data, monkeypatch):
    """Same batch files, same fingerprint: the port picks up every batch
    the JAX trainer committed and trains none of them again."""
    X, y = small_data
    d = str(tmp_path / "ckpt")
    jart = j_fit_artifacts(X, y, ForestConfig(**dataclasses.asdict(SMALL)),
                           seed=5, checkpoint_dir=d, ensembles_per_batch=2)
    monkeypatch.setattr(tfitting, "fit_ensemble", _no_training)
    tart = fit_artifacts(X, y, SMALL, seed=5, checkpoint_dir=d, resume=True,
                         ensembles_per_batch=2, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tart, f).numpy(),
                                      np.asarray(getattr(jart, f)))


def test_fit_refuses_what_is_not_ported(small_data):
    X, y = small_data
    with pytest.raises(NotImplementedError, match="sharded"):
        fit_artifacts(X, y, SMALL, mesh="auto", device="cpu")

    class Store:
        fingerprint, version, shape = "abc", 1, (96, 3)

    with pytest.raises(NotImplementedError, match="store"):
        fit_artifacts(Store(), None, SMALL, device="cpu")


def test_tabular_generator_fit_round_trips_the_schema(tmp_path):
    rng = np.random.default_rng(0)
    n = 150
    X = np.stack([rng.normal(size=n), rng.integers(0, 5, n),
                  rng.choice([10, 20, 30], n), rng.normal(size=n) * 3],
                 axis=1).astype(np.float32)
    gen = TabularGenerator(dataclasses.replace(SMALL, n_trees=4),
                           cat_cols=[2], int_cols=[1]).fit(X, device="cpu")
    assert gen.artifacts.p == 3 + 3             # numeric + int + one-hot(3)
    Xg, yg = gen.generate(200, seed=1)
    assert Xg.shape == (200, 4) and np.isfinite(Xg).all()
    assert set(np.unique(Xg[:, 2])) <= {10.0, 20.0, 30.0}
    np.testing.assert_array_equal(Xg[:, 1], np.round(Xg[:, 1]))
    assert Xg[:, 1].min() >= 0 and Xg[:, 1].max() <= 4
    loaded = TabularGenerator.load(gen.save(str(tmp_path / "m")),
                                   device="cpu")
    X2, y2 = loaded.generate(200, seed=1)
    np.testing.assert_array_equal(X2, Xg)
    # and the JAX package reads the schema from the same sidecar
    jg = JTabularGenerator.load(str(tmp_path / "m"))
    assert jg.schema.cat_cols == [2] and jg.schema.int_cols == [1]
    assert isinstance(jg.artifacts, JForestArtifacts)
    assert isinstance(loaded.artifacts, ForestArtifacts)
