"""The port's tree traversal against the JAX package's.

``repro_torch.kernels.tree_predict.ops.forest_predict`` and
``repro_torch.forest.packed.predict_forest`` on the CPU (the plain PyTorch
version) are held against ``repro``'s XLA reference scan and its Pallas
kernel in interpret mode, on forests trained by the JAX package and on random
forests with +inf sentinels and threshold ties, at any depth and tree count.
The CUDA kernels themselves run only on a GPU: their tests here skip unless
one is present.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ForestConfig
from repro.data.tabular import two_moons
from repro.forest.packed import PackedForest as JPackedForest
from repro.forest.packed import predict_forest as j_predict_forest
from repro.kernels.tree_predict.ref import forest_predict_ref as j_ref
from repro.tabgen import fit_artifacts
from repro_torch.forest.packed import PackedForest, predict_forest
from repro_torch.kernels import build
from repro_torch.kernels.tree_predict.ops import (SMEM_PER_BLOCK, SO_WARPS,
                                                  forest_predict, so_plan,
                                                  so_smem_bytes)
from repro_torch.kernels.tree_predict.ref import forest_predict_ref
from repro_torch.tabgen import artifacts_from_numpy

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


def random_forest(rng, B, S, T, depth, p, out, n):
    """Forest and rows on a 1/8 grid (many ties with thresholds) with ~10%
    +inf sentinels, as numpy arrays."""
    H, L = 2 ** depth - 1, 2 ** depth
    x = (np.round(rng.normal(size=(B, n, p)) * 8) / 8).astype(np.float32)
    feat = rng.integers(0, p, (B, S, T, H)).astype(np.int32)
    thr = (np.round(rng.uniform(-1, 1, (B, S, T, H)) * 8) / 8).astype(np.float32)
    thr[rng.random(thr.shape) < 0.1] = np.inf
    leaf = rng.normal(size=(B, S, T, L, out)).astype(np.float32)
    return x, feat, thr, leaf


# ---------------------------------------------------------------------------
# predict_forest on trained forests: port (plain) vs JAX xla and pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n", [1, 64, 97, 130, 300])
@pytest.mark.parametrize("art_name", ["flow_so", "flow_mo"])
def test_predict_forest_matches_jax(request, art_name, n, impl):
    art = request.getfixturevalue(art_name)
    port = to_port(art)
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, (n, art.p)).astype(np.float32)
    ti, yi = 2, 1
    jforest = JPackedForest(art.feat[ti, yi], art.thr_val[ti, yi],
                            art.leaf[ti, yi], art.config.multi_output)
    ref = np.asarray(j_predict_forest(jnp.asarray(x), jforest,
                                      art.config.max_depth, impl=impl))
    got = predict_forest(torch.from_numpy(x)[None], port.class_forest(yi).at(ti),
                         port.config.max_depth)
    assert got.shape == (1, n, art.p)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("art_name", ["flow_so", "flow_mo"])
def test_predict_forest_class_batch_matches_per_class_loop(request, art_name):
    """One call over every class equals one call per class."""
    port = to_port(request.getfixturevalue(art_name))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        rng.uniform(-1, 1, (port.n_y, 97, port.p)).astype(np.float32))
    forest = PackedForest(port.feat[3], port.thr_val[3], port.leaf[3],
                          port.config.multi_output)
    batched = predict_forest(x, forest, port.config.max_depth)
    for yi in range(port.n_y):
        one = predict_forest(x[yi:yi + 1].contiguous(),
                             port.class_forest(yi).at(3), port.config.max_depth)
        torch.testing.assert_close(batched[yi], one[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# forest_predict on random forests: sentinels, ties, SO and MO layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 64, 97, 130, 300])
@pytest.mark.parametrize("B,S,out", [(3, 1, 5), (2, 4, 1)])   # MO-like, SO-like
def test_forest_predict_matches_jax_ref_per_forest(B, S, out, n):
    depth, T, p = 4, 6, 5
    x, feat, thr, leaf = random_forest(np.random.default_rng(n), B, S, T,
                                       depth, p, out, n)
    got = forest_predict(torch.from_numpy(x), torch.from_numpy(feat),
                         torch.from_numpy(thr), torch.from_numpy(leaf), depth)
    assert got.shape == (B, S, n, out)
    for b in range(B):
        for s in range(S):
            ref = np.asarray(j_ref(jnp.asarray(x[b]), jnp.asarray(feat[b, s]),
                                   jnp.asarray(thr[b, s]),
                                   jnp.asarray(leaf[b, s]), depth))
            # same tree order, same fp32 sums: equal to the bit
            np.testing.assert_array_equal(got[b, s].numpy(), ref)


@pytest.mark.parametrize("B,S,out", [(3, 1, 5), (2, 4, 1)])   # MO-like, SO-like
@pytest.mark.parametrize("depth,T", [(9, 3), (10, 2), (2, 400)])
def test_deep_and_many_tree_forests_match_jax_ref(depth, T, B, S, out):
    """Past the old kernel's limits (depth 8, 384 trees): the CPU path takes
    any depth and any number of trees and equals the JAX reference to the
    bit, through forest_predict and predict_forest."""
    n, p = 37, 6
    x, feat, thr, leaf = random_forest(np.random.default_rng(depth * T), B, S,
                                       T, depth, p, out, n)
    got = forest_predict(torch.from_numpy(x), torch.from_numpy(feat),
                         torch.from_numpy(thr), torch.from_numpy(leaf), depth)
    forest = PackedForest(torch.from_numpy(feat), torch.from_numpy(thr),
                          torch.from_numpy(leaf), out > 1)
    packed = predict_forest(torch.from_numpy(x), forest, depth)
    for b in range(B):
        per_output = []
        for s in range(S):
            ref = np.asarray(j_ref(jnp.asarray(x[b]), jnp.asarray(feat[b, s]),
                                   jnp.asarray(thr[b, s]),
                                   jnp.asarray(leaf[b, s]), depth))
            np.testing.assert_array_equal(got[b, s].numpy(), ref)
            per_output.append(ref)
        np.testing.assert_array_equal(packed[b].numpy(),
                                      np.concatenate(per_output, axis=1))


def test_inf_threshold_never_goes_right():
    """+inf is a sentinel: even an +inf feature value stays left (strict >),
    and nothing is clipped (the Pallas kernel clips to 1e30)."""
    depth = 2
    x = torch.tensor([[[np.inf, 2e30], [-1.0, 0.0]]], dtype=torch.float32)
    feat = torch.zeros((1, 1, 1, 3), dtype=torch.int32)
    feat[..., 1] = 1
    thr = torch.tensor([[[[np.inf, 1e30, 0.0]]]], dtype=torch.float32)
    leaf = torch.arange(4, dtype=torch.float32).reshape(1, 1, 1, 4, 1)
    out = forest_predict(x, feat, thr, leaf, depth)
    # row 0: root inf > inf is False -> left; node 1 tests x[1]=2e30 > 1e30
    # -> right -> leaf 1. row 1: left, then 0.0 > 1e30 False -> leaf 0.
    assert out.flatten().tolist() == [1.0, 0.0]


def test_plain_version_sums_trees_in_order():
    """The plain version adds tree 0 first, then 1, … in fp32: a sum whose
    value depends on the order shows it."""
    depth = 1
    x = torch.zeros((1, 1, 1))
    feat = torch.zeros((1, 1, 3, 1), dtype=torch.int32)
    thr = torch.zeros((1, 1, 3, 1))
    big, small = 2.0 ** 24, 1.0
    leaf = torch.tensor([big, small, small]).reshape(1, 1, 3, 1, 1).expand(
        1, 1, 3, 2, 1).contiguous()
    out = forest_predict_ref(x, feat, thr, leaf, depth)
    # ((2^24 + 1) + 1) rounds each step back to 2^24 in fp32
    assert out.item() == big


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "depth",
                                 "device"])
def test_wrapper_rejects_bad_input(bad):
    x, feat, thr, leaf = (torch.from_numpy(a) for a in random_forest(
        np.random.default_rng(0), 2, 1, 3, 3, 4, 2, 10))
    depth = 3
    if bad == "dtype":
        feat = feat.long()
    elif bad == "shape":
        thr = thr[..., :-1].contiguous()
    elif bad == "contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "depth":
        depth = 4
    else:
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        forest_predict(x, feat, thr, leaf, depth)


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tree_predict kernel has no "
                    "CPU mode; python3 chip_smoke.py runs it on the card")
    return torch.device("cuda")


# (B, S, T, depth, p, out, n): depth 1, 7, 9 (leaves through L1) and 16
# (uint16 indices); 1, 20, 400 and 512 trees (400 at n = 8,000 takes two
# chunks of the leaf-index scratch); MO and SO; odd n; up to 15 classes
CUDA_CASES = [(3, 1, 5, 7, 37, 37, n) for n in (1, 97, 130, 8000)]
CUDA_CASES += [(2, 37, 5, 7, 37, 1, n) for n in (1, 97, 130, 8000)]
CUDA_CASES += [(3, 1, 4, 1, 37, 37, 97), (3, 37, 4, 1, 37, 1, 97),
               (15, 1, 20, 7, 368, 368, 130), (15, 368, 20, 7, 368, 1, 130),
               (2, 1, 3, 9, 37, 37, 130), (2, 5, 3, 9, 37, 1, 130),
               (2, 1, 2, 16, 11, 5, 97), (2, 3, 2, 16, 11, 1, 97),
               (15, 1, 400, 2, 37, 37, 8000), (2, 5, 400, 3, 37, 1, 130),
               (3, 1, 512, 3, 37, 37, 130), (3, 1, 1, 7, 37, 2, 97),
               (2, 3, 20, 4, 9, 6, 130)]
# so_kernel's edges: T not a multiple of its 4-tree slices (5, 3, 1; slices
# that start off a 16-byte boundary), n not a multiple of its rows, n = 1,
# S below the sub-forests in flight (2; 17 split into groups of 15, the
# last holding 2 for 15 rings), the pions width, and shapes it cannot stage
# (depth 13 at p = 37, x of 2,000 features), which take so_l1_kernel
SO_CASES = [(2, 20, 5, 7, 368, 1, 300), (2, 37, 3, 7, 37, 1, 130),
            (2, 37, 1, 7, 37, 1, 130), (15, 368, 20, 7, 368, 1, 1000),
            (2, 368, 20, 7, 368, 1, 1), (2, 2, 20, 7, 368, 1, 300),
            (1, 17, 20, 7, 368, 1, 64), (4, 533, 20, 7, 533, 1, 300),
            (2, 3, 4, 13, 37, 1, 97), (2, 5, 6, 4, 2000, 1, 97)]
CUDA_CASES += SO_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,depth,p,out,n", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, B, S, T, depth, p, out, n):
    arrays = random_forest(np.random.default_rng(n + T + depth), B, S, T,
                           depth, p, out, n)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    before = forest_predict.launches
    rings_before = forest_predict.so_ring_launches
    got = forest_predict(*args, depth)
    assert forest_predict.launches == before + 1
    staged = out == 1 and so_plan(B, S, T, depth, p, n) is not None
    assert forest_predict.so_ring_launches == rings_before + staged
    ref = forest_predict_ref(*args, depth)
    torch.cuda.synchronize()
    # the same trees in the same order, in fp32: equal to the bit
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_refuses_depth_past_its_indices(cuda_device):
    """depth 17 needs 17-bit leaf indices: the card raises, naming the
    limit; the CPU path takes it."""
    arrays = random_forest(np.random.default_rng(0), 1, 1, 1, 17, 3, 1, 5)
    with pytest.raises(ValueError, match="depth <= 16"):
        forest_predict(*[torch.from_numpy(a).to(cuda_device)
                         for a in arrays], 17)
    assert forest_predict(*[torch.from_numpy(a) for a in arrays],
                          17).shape == (1, 1, 5, 1)


# ---------------------------------------------------------------------------
# so_kernel's plan (CPU)
# ---------------------------------------------------------------------------

PLAN_SHAPES = sorted({(B, S, T, depth, p, n)
                      for B, S, T, depth, p, out, n in CUDA_CASES if out == 1}
                     | {(15, 368, 20, 7, 368, n) for n in (1, 1024, 8000)}
                     | {(15, 533, 20, 7, 533, n) for n in (1, 1024, 8000)})


@pytest.mark.parametrize("B,S,T,depth,p,n", PLAN_SHAPES)
def test_so_plan_fits_a_block(B, S, T, depth, p, n):
    """Every plan fits a block's shared memory and its threads: rows a
    multiple of 32 and no more than n needs, rings no more than S, slices
    no longer than T, at most SO_WARPS walking warps."""
    plan = so_plan(B, S, T, depth, p, n)
    if plan is None:
        return
    rows, rings, trees = plan
    assert so_smem_bytes(p, depth, rows, rings, trees) <= SMEM_PER_BLOCK
    assert rows % 32 == 0 and 32 <= rows <= max(32, -(-n // 32) * 32)
    assert 1 <= rings <= S and 1 <= trees <= min(T, 4)
    assert rings * rows // 32 <= SO_WARPS


def test_so_plan_at_the_photons_and_pions_widths():
    """The generation path's SO shapes are staged: 96 rows and 5 rings of
    4-tree slices at p = 368, 64 rows and 7 rings at p = 533 (depth 7,
    T = 20), 15 walking warps each."""
    assert so_plan(15, 368, 20, 7, 368, 8000) == (96, 5, 4)
    assert so_plan(15, 533, 20, 7, 533, 8000) == (64, 7, 4)
    for p in (368, 533):
        assert so_smem_bytes(p, 7, *so_plan(15, p, 20, 7, p, 8000)) \
            <= SMEM_PER_BLOCK


@pytest.mark.parametrize("depth", [1, 4, 7, 9, 10, 12, 13, 16])
@pytest.mark.parametrize("p", [2, 37, 368, 533, 1500, 1700, 2000])
def test_so_plan_is_none_exactly_where_no_slice_fits(depth, p):
    """None (the L1 kernel) exactly where 32 rows of x and one ring of
    one-tree slices do not fit a block."""
    fits = so_smem_bytes(p, depth, 32, 1, 1) <= SMEM_PER_BLOCK
    assert (so_plan(2, 5, 20, depth, p, 300) is not None) == fits


def test_so_plan_is_a_pure_function_of_the_shapes():
    """The same shapes give the same plan, whatever was asked before."""
    first = [so_plan(*shape) for shape in PLAN_SHAPES]
    assert [so_plan(*shape) for shape in reversed(PLAN_SHAPES)] == first[::-1]
    assert so_plan(15, 368, 20, 7, 368, 8000) == so_plan(
        15, 368, 20, 7, 368, 8000)


def test_count_launch_counts_kinds_beside_launches():
    """count_launch adds one to launches and to each named counter."""
    def wrapper():
        pass
    wrapper.launches = wrapper.so_ring_launches = 0
    build.count_launch(wrapper)
    build.count_launch(wrapper, "so_ring_launches")
    assert (wrapper.launches, wrapper.so_ring_launches) == (2, 1)
