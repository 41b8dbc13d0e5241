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
from repro_torch.forest.boosting import (fit_boosted, fit_ensemble,
                                         fit_ensembles)
from repro_torch.forest.split import best_splits, ordered_sum, prefix_sum
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


@pytest.mark.parametrize("out", [1, 2, 3, 6, 16, 32])
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


def _chunked_sum(x):
    """ordered_sum's documented order, in numpy: a row of up to 32 left to
    right, a longer one in contiguous chunks of ceil(n / 32) added in
    order, then their partial sums the same way."""
    n = x.shape[-1]
    if n <= 32:
        acc = x[..., 0].copy()
        for k in range(1, n):
            acc = acc + x[..., k]
        return acc
    w = -(-n // 32)
    acc = x[..., :w].copy()
    for start in range(w, n, w):
        part = x[..., start:start + w]
        acc[..., :part.shape[-1]] = acc[..., :part.shape[-1]] + part
    return _chunked_sum(acc)


@pytest.mark.parametrize("n", [1, 7, 32, 33, 37, 64, 368, 1100])
def test_ordered_sum_adds_in_its_documented_order(n):
    """The multi-output gain's sum over outputs runs in a fixed order of
    elementwise adds, so a card and the CPU pick the same splits."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(6, 5, n)) ** 2
         * rng.uniform(0.1, 1e3, size=(6, 5, 1))).astype(np.float32)
    np.testing.assert_array_equal(ordered_sum(t(x)).numpy(), _chunked_sum(x))


@pytest.mark.cuda
@pytest.mark.parametrize("out", [1, 8, 37, 368])
def test_cuda_best_splits_equal_the_cpu(out):
    """The split search on the card picks what the CPU picks, to the bit,
    at every output width (a sum over outputs in Tensor.sum's order did
    not: the card adds a row of 8 in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; python3 chip_smoke.py holds card "
                    "fits against the CPU")
    rng = np.random.default_rng(out)
    sum_g = rng.normal(size=(2, 4, 9, 32, out)).astype(np.float32)
    count = rng.uniform(0, 4, (2, 4, 9, 32)).astype(np.float32)
    cpu = best_splits(t(sum_g), t(count), 1.0, 1e-6)
    card = best_splits(t(sum_g).cuda(), t(count).cuda(), 1.0, 1e-6)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def _host_noise(eid, split, shape, shard=0):
    """Bridge noise drawn on the host, so fits on two devices see the same
    numbers."""
    gen = torch.Generator().manual_seed(1000 * eid + 10 * shard + split)
    return torch.randn(shape, generator=gen), None


def test_wmse_adds_in_one_fixed_order():
    """The validation loss is ordered_sum's float64 sums rounded once: a
    lane's loss does not depend on its batch-mates, and it is within an
    ulp of numpy's float64 sum."""
    from repro_torch.forest.boosting import _wmse
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(3, 1000, 5)).astype(np.float32)
    tgt = rng.normal(size=(3, 1000, 5)).astype(np.float32)
    w = rng.uniform(0, 2, 1000).astype(np.float32)
    got = _wmse(t(pred), t(tgt), t(w))
    sq = (t(w)[None, :, None] * torch.square(t(pred) - t(tgt))).double()
    want = (ordered_sum(sq.flatten(1)).float()
            / (ordered_sum(t(w).double()).float() * 5))
    assert torch.equal(got, want)
    for s in range(3):
        assert torch.equal(_wmse(t(pred[s:s + 1]), t(tgt[s:s + 1]), t(w)),
                           got[s:s + 1])
    num = (w[None, :, None].astype(np.float64)
           * (pred - tgt).astype(np.float64) ** 2).sum(axis=(1, 2))
    np.testing.assert_allclose(got.numpy(), num / (w.astype(np.float64).sum()
                                                   * 5), rtol=2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("mo", [False, True])
def test_cuda_early_stopped_fit_equals_the_cpu(mo):
    """With early stopping on, a fit on the card stops every lane at the
    round the CPU fit stops it (the validation loss adds in one order on
    both), and grows the same trees, from the same noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; python3 chip_smoke.py holds card "
                    "fits against the CPU")
    X, y = two_moons(240, seed=0)
    X, y = np.asarray(X, np.float32), np.asarray(y)
    cfg = TForestConfig(n_t=5, duplicate_k=6, n_trees=20, max_depth=3,
                        n_bins=16, reg_lambda=1.0, multi_output=mo,
                        early_stop_rounds=2)
    card = fit_artifacts(X, y, cfg, device="cuda", noise=_host_noise)
    cpu = fit_artifacts(X, y, cfg, device="cpu", noise=_host_noise)
    assert (cpu.rounds_run < cfg.n_trees).any()      # some lanes stopped
    for f in ("feat", "best_round", "rounds_run"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    for f in ("thr_val", "leaf"):
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f),
                                   rtol=0, atol=1e-4)


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


def _batch_of_ensembles(E, p=3):
    """E ensembles' inputs, each from its own data (and SO validation
    targets with noise of another scale each, so lanes stop apart)."""
    parts = []
    for e in range(E):
        codes, tgt, w, es, vcodes, tgtv, x, xv = boost_inputs(seed=20 + e,
                                                              p=p)
        rng = np.random.default_rng(e)
        tgtv = tgtv + rng.normal(size=tgtv.shape).astype(np.float32) * \
            rng.uniform(0.0, 3.0, p).astype(np.float32)
        parts.append((codes, tgt, w, es, vcodes, tgtv, x, xv))
    return [t(np.stack(a)) for a in zip(*parts)]


@pytest.mark.parametrize("mo", [False, True])
def test_each_ensemble_of_a_batch_equals_it_fitted_alone(mo):
    """fit_ensembles over E = 3 ensembles (lanes stopping at different
    rounds, whole ensembles before others) gives each ensemble's lanes,
    bit for bit, what fit_ensemble gives it alone; a warm start of the
    batch continues to the cold batch."""
    codes, tgt, w, es, vcodes, tgtv, x, xv = _batch_of_ensembles(3)
    cfg = TForestConfig(**dict(BOOST_CFG, n_trees=14, early_stop_rounds=2,
                               multi_output=mo))
    got = fit_ensembles(codes, tgt, w, es, vcodes, tgtv, w, cfg)
    lanes = 1 if mo else 3
    assert got.feat.shape[0] == 3 * lanes
    assert len(set(got.rounds_run.tolist())) > 1, got.rounds_run
    for e in range(3):
        alone = fit_ensemble(codes[e], tgt[e], w[e], es[e], vcodes[e],
                             tgtv[e], w[e], cfg)
        for f in alone._fields:
            assert torch.equal(getattr(got, f)[e * lanes:(e + 1) * lanes],
                               getattr(alone, f)), (e, f)
    base = fit_ensembles(codes, tgt, w, es, vcodes, tgtv, w,
                         dataclasses.replace(cfg, n_trees=5))
    warm = (base.feat, base.thr_val, base.leaf, base.val_curve,
            base.best_round)
    ext = fit_ensembles(codes, tgt, w, es, vcodes, tgtv, w, cfg, warm=warm,
                        x_raw=x, val_raw=xv)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ext, f)), f


def test_fit_boosted_takes_any_lane_map():
    """Lanes of a batch in any order (the map need not be sorted or
    cover every ensemble) each get what their ensemble's lane gets alone;
    the validation loss takes each lane's own ensemble's weights."""
    from repro_torch.forest.boosting import _wmse
    codes, tgt, w, es, vcodes, tgtv, _, _ = _batch_of_ensembles(4)
    w = w.clone()
    w[2, ::3] = 0.0                          # the ensembles' weights differ
    ens = torch.tensor([3, 0, 3, 2, 0])
    out = [1, 0, 2, 2, 1]                    # the output each lane fits
    lanes = torch.stack([tgt[e, :, j] for e, j in zip(ens, out)])[..., None]
    vlanes = torch.stack([tgtv[e, :, j] for e, j in zip(ens, out)])[
        ..., None]
    cfg = TForestConfig(**dict(BOOST_CFG, n_trees=8, early_stop_rounds=2))
    got = fit_boosted(codes, lanes, w, es, vcodes, vlanes, w, cfg, ens=ens)
    for s, e in enumerate(ens.tolist()):
        alone = fit_boosted(codes[e], lanes[s:s + 1], w[e], es[e], vcodes[e],
                            vlanes[s:s + 1], w[e], cfg)
        for f in alone._fields:
            assert torch.equal(getattr(got, f)[s], getattr(alone, f)[0]), \
                (s, f)
    pred = torch.randn(lanes.shape, generator=torch.Generator().manual_seed(0))
    loss = _wmse(pred, lanes, w, ens=ens)
    for s, e in enumerate(ens.tolist()):
        assert torch.equal(loss[s:s + 1],
                           _wmse(pred[s:s + 1], lanes[s:s + 1], w[e]))


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
    monkeypatch.setattr(tfitting, "fit_ensembles", _no_training)
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
    monkeypatch.setattr(tfitting, "fit_ensembles", _no_training)
    tart = fit_artifacts(X, y, SMALL, seed=5, checkpoint_dir=d, resume=True,
                         ensembles_per_batch=2, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tart, f).numpy(),
                                      np.asarray(getattr(jart, f)))


def test_trees_at_best_iteration_matches_jax(tmp_path):
    """Paper Fig. 3's trees per timestep, from a two-moons model the JAX
    package fitted with early stopping and saved: the port's artifacts (and
    the deprecated shim, which delegates to them) give the JAX numbers."""
    from repro.core.forest_flow import ForestGenerativeModel as JShim
    from repro_torch.core.forest_flow import ForestGenerativeModel
    X, y = two_moons(240, seed=0)
    cfg = dict(dataclasses.asdict(SMALL), n_trees=12, early_stop_rounds=2)
    jart = j_fit_artifacts(np.asarray(X), np.asarray(y), ForestConfig(**cfg),
                           seed=0)
    assert (np.asarray(jart.rounds_run) < 12).any()
    path = jart.save(str(tmp_path / "moons"))
    tart = ForestArtifacts.load(path, device="cpu")
    want = jart.trees_at_best_iteration()
    assert want.shape == (SMALL.n_t,)
    np.testing.assert_array_equal(tart.trees_at_best_iteration(), want)
    shim = ForestGenerativeModel(TForestConfig(**cfg))
    shim.artifacts = tart
    jshim = JShim(ForestConfig(**cfg))
    jshim.artifacts = jart
    np.testing.assert_array_equal(shim.trees_at_best_iteration(),
                                  jshim.trees_at_best_iteration())


def test_fit_routes_meshes_and_stores(small_data, tmp_path):
    """What the port used to refuse it now routes: ``mesh="auto"`` on a
    host without GPUs is the single-device fit, a dataset store takes the
    sharded trainer on one rank (its lineage names the store), and a
    malformed mesh or pipeline is refused."""
    from repro_torch.data.store import ingest
    X, y = small_data
    auto = fit_artifacts(X, y, SMALL, mesh="auto", device="cpu")
    assert_same(auto, fit_artifacts(X, y, SMALL, device="cpu"))
    store = ingest([(X, y)], str(tmp_path / "store"), shard_rows=40)
    art = fit_artifacts(store, None, SMALL, device="cpu")
    assert torch.isfinite(art.leaf).all()
    assert art.lineage["store"]["n_rows"] == len(X)
    with pytest.raises(ValueError, match="mesh="):
        fit_artifacts(X, y, SMALL, mesh="4x2", device="cpu")
    with pytest.raises(ValueError, match="pipeline="):
        fit_artifacts(store, None, SMALL, pipeline="fast", device="cpu")


# ---------------------------------------------------------------------------
# a batch of ensembles as one loop
# ---------------------------------------------------------------------------

def test_ensemble_groups_at_photons_width():
    """Hand-reckoned groups under the 8e9-byte cap at CaloForest photons
    width (p = 368, 64 bins, depth 7: 64 nodes at the deepest level): MO
    2,224,816,128 B an ensemble, groups of 3; SO (368 lanes) 4,437,573,632
    B, groups of 1; SO at depth 6 (32 nodes) 2,218,786,816 B, so 2
    ensembles are one group. Small fits are one group."""
    groups = tfitting.ensemble_groups
    assert tfitting.HIST_GROUP_BYTES == 8 * 10 ** 9
    assert groups(8, 1, 368, 64, 368, 7) == [(0, 3), (3, 6), (6, 8)]
    assert groups(6, 1, 368, 64, 368, 7) == [(0, 3), (3, 6)]
    assert groups(2, 1, 368, 64, 368, 7) == [(0, 2)]
    assert groups(8, 368, 368, 64, 1, 7) == [(e, e + 1) for e in range(8)]
    assert groups(2, 368, 368, 64, 1, 6) == [(0, 2)]
    assert groups(8, 2, 2, 16, 1, 3) == [(0, 8)]             # two-moons
    assert groups(6, 8, 8, 32, 1, 4) == [(0, 6)]             # resource arm
    assert groups(3, 1, 10, 16, 10, 3, cap=1) == [(0, 1), (1, 2), (2, 3)]


BATCH_KINDS = {"so": dict(), "mo": dict(multi_output=True),
               "so_es": dict(n_trees=10, early_stop_rounds=2),
               "mo_es": dict(multi_output=True, n_trees=10,
                             early_stop_rounds=2)}


@pytest.fixture(scope="module")
def batch_fits(moons):
    """Two-moons fits (5 timesteps x 2 classes = 10 ensembles) at each
    ``ensembles_per_batch``, and with groups of 2 forced inside each batch
    (a cap of two ensembles' histograms)."""
    X, y = moons
    cache = {}

    def get(kind, bs, cap=None):
        key = (kind, bs, cap)
        if key not in cache:
            cfg = TForestConfig(**dict(MOONS_CFG, **BATCH_KINDS[kind]))
            saved = tfitting.HIST_GROUP_BYTES
            if cap:
                lanes = 1 if cfg.multi_output else 2
                out = 2 if cfg.multi_output else 1
                tfitting.HIST_GROUP_BYTES = cap * lanes * 4 * 2 * 16 * (
                    out + 1) * 4
            try:
                cache[key] = fit_artifacts(X, y, cfg, seed=3, device="cpu",
                                           ensembles_per_batch=bs)
            finally:
                tfitting.HIST_GROUP_BYTES = saved
        return cache[key]
    return get


@pytest.mark.parametrize("bs,cap", [(2, None), (3, None), (0, None),
                                    (0, 2), (3, 2)])
@pytest.mark.parametrize("kind", sorted(BATCH_KINDS))
def test_fit_is_the_same_at_every_batch(batch_fits, kind, bs, cap):
    """fit_artifacts trains each batch's ensembles together; every field
    equals, bit for bit, the fit of one ensemble a batch, whatever the
    batch (2, 3 with a short last batch, the default 8) and its groups."""
    one = batch_fits(kind, 1)
    assert_same(batch_fits(kind, bs, cap), one)
    if kind.endswith("_es"):
        # lanes stop at different rounds, so the batch narrows
        assert len(set(one.rounds_run.flatten().tolist())) > 1


@pytest.mark.parametrize("kind", sorted(BATCH_KINDS))
def test_extension_is_the_same_at_every_batch(batch_fits, moons, kind):
    """A warm-start extension of a batch (each ensemble's base trees
    replayed on its own raw rows) equals the cold fit at any batch."""
    X, y = moons
    cold = batch_fits(kind, 1)
    cfg = cold.config
    base = fit_artifacts(X, y, dataclasses.replace(cfg,
                                                   n_trees=cfg.n_trees - 3),
                         seed=3, device="cpu", ensembles_per_batch=3)
    for bs in (1, 0):
        ext = extend_artifacts(base, X, y, extra_trees=3, seed=3,
                               device="cpu", ensembles_per_batch=bs)
        assert_same(ext, cold)


def test_a_fit_launches_hist_once_a_level_a_group(moons, monkeypatch):
    """Counted calls of the histogram: a fit makes, for each group, (its
    longest lane's rounds) x (depth + 1) of them: one a level and one for
    the leaf sums, not one per ensemble."""
    from repro_torch.forest import hist as fhist
    X, y = moons
    calls = []
    real = fhist.histogram

    def counted(*args, **kwargs):
        calls.append(args[1].shape[0])           # the launch's lanes
        return real(*args, **kwargs)
    monkeypatch.setattr(fhist, "histogram", counted)
    cfg = TForestConfig(**dict(MOONS_CFG, **BATCH_KINDS["so_es"]))
    lanes, n_ens = 2, cfg.n_t * 2
    monkeypatch.setattr(tfitting, "HIST_GROUP_BYTES",
                        3 * lanes * 4 * 2 * 16 * 2 * 4)   # 3 ensembles
    art = fit_artifacts(X, y, cfg, seed=3, device="cpu",
                        ensembles_per_batch=4)
    rounds = art.rounds_run.reshape(n_ens, lanes)
    expect, groups = 0, []
    for b0 in range(0, n_ens, 4):
        for a, b in tfitting.ensemble_groups(min(4, n_ens - b0), lanes, 2,
                                             16, 1, cfg.max_depth):
            groups.append((b0 + a, b0 + b))
            expect += int(rounds[b0 + a:b0 + b].max()) * (cfg.max_depth + 1)
    assert groups == [(0, 3), (3, 4), (4, 7), (7, 8), (8, 10)]
    assert len(calls) == expect
    per_ensemble = int(rounds.max(1).values.sum()) * (cfg.max_depth + 1)
    assert len(calls) < per_ensemble
    assert max(calls) == 3 * lanes                  # a group's lanes at once


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
