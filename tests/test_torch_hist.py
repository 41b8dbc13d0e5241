"""The port's histogram build against the JAX package, on the CPU.

The plain PyTorch version (``index_add_`` per feature, rows in order) must
equal ``repro.kernels.hist.ref.histogram_ref`` (``segment_sum``, rows in
order) to the bit, and the Pallas kernel run in interpret mode within 1e-5
(it sums a one-hot matmul, in another order). The CUDA kernel, which also
adds each cell's rows in order, is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hist.hist_kernel import histogram_pallas
from repro.kernels.hist.ref import histogram_ref as jax_histogram_ref
from repro_torch.forest.hist import build_histogram
from repro_torch.kernels.hist.ops import (BYTE_BINS, CHUNK, MAX_SMEM,
                                          bin_windows, blocks, histogram,
                                          narrow_codes, node_layout,
                                          node_order, plan)
from repro_torch.kernels.hist.ref import histogram_ref

CODE_TYPES = {"int8": (np.int8, torch.int8), "int16": (np.int16, torch.int16),
              "int32": (np.int32, torch.int32)}


def inputs(n, p, out, n_nodes, n_bins, seed, lanes=1, zero_every=0,
           edge=None):
    """codes [n, p], node_id [lanes, n], g [lanes, n, out], w [n] (numpy).
    ``edge``: "one_bin" (every code n_bins - 1), "out_of_range" (about one
    code in 8 outside [0, n_bins), both sides, within int8), "empty_nodes"
    (rows only in even nodes)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, p)).astype(np.int32)
    nid = rng.integers(0, n_nodes, (lanes, n)).astype(np.int32)
    g = rng.normal(size=(lanes, n, out)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if zero_every:
        w[::zero_every] = 0.0
    if edge == "one_bin":
        codes[:] = n_bins - 1
    elif edge == "out_of_range":
        bad = np.array([-1, n_bins, n_bins + 37, 127, -128], np.int32)
        pick = rng.integers(0, 8 * len(bad), (n, p))
        codes = np.where(pick < len(bad), bad[np.minimum(pick, len(bad) - 1)],
                         codes).astype(np.int32)
    elif edge == "empty_nodes":
        nid -= nid % 2
    return codes, nid, g, w


def expected(codes, nid, g, w, n_nodes, n_bins):
    """The plain version, with a code outside [0, n_bins) adding its row to
    no cell of its feature (the kernel's spare bin, never written out)."""
    codes = codes.to(torch.int32)            # n_bins may pass int8's range
    spare = torch.where((codes >= 0) & (codes < n_bins), codes, n_bins)
    sums, cnt = histogram_ref(spare, nid, g, w, n_nodes, n_bins + 1)
    return sums[:, :, :, :n_bins], cnt[:, :, :, :n_bins]


def jax_lane(codes, nid, g, w, n_nodes, n_bins, s=0):
    sums, cnt = jax_histogram_ref(jnp.asarray(codes), jnp.asarray(nid[s]),
                                  jnp.asarray(g[s]), jnp.asarray(w), n_nodes,
                                  n_bins)
    return np.asarray(sums), np.asarray(cnt)


def port(codes, nid, g, w, n_nodes, n_bins, code_type="int32"):
    np_t, _ = CODE_TYPES[code_type]
    sums, cnt = histogram(torch.from_numpy(codes.astype(np_t)),
                          torch.from_numpy(nid), torch.from_numpy(g),
                          torch.from_numpy(w), n_nodes, n_bins)
    return sums.numpy(), cnt.numpy()


# the shapes of tests/test_kernels.py's histogram sweep
KERNEL_SHAPES = [
    (256, 3, 1, 1, 8, 128),
    (512, 7, 2, 4, 16, 256),
    (1024, 5, 4, 8, 32, 512),
    (384, 2, 3, 2, 64, 128),
]


@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n,p,out,n_nodes,n_bins,rows_block", KERNEL_SHAPES)
def test_plain_version_equals_jax_ref_to_the_bit(n, p, out, n_nodes, n_bins,
                                                 rows_block, code_type):
    arrays = inputs(n, p, out, n_nodes, n_bins, seed=n)
    sums, cnt = port(*arrays, n_nodes, n_bins, code_type)
    ref_sums, ref_cnt = jax_lane(*arrays, n_nodes, n_bins)
    assert sums.shape == (1,) + ref_sums.shape
    np.testing.assert_array_equal(sums[0], ref_sums)
    np.testing.assert_array_equal(cnt[0], ref_cnt)


@pytest.mark.parametrize("n,p,out,n_nodes,n_bins,rows_block", KERNEL_SHAPES)
def test_plain_version_matches_pallas_interpret(n, p, out, n_nodes, n_bins,
                                                rows_block):
    codes, nid, g, w = inputs(n, p, out, n_nodes, n_bins, seed=n + 1)
    pl_sums, pl_cnt = histogram_pallas(
        jnp.asarray(codes), jnp.asarray(nid[0]), jnp.asarray(g[0]),
        jnp.asarray(w), n_nodes, n_bins, rows_block=rows_block,
        interpret=True)
    sums, cnt = port(codes, nid, g, w, n_nodes, n_bins)
    np.testing.assert_allclose(sums[0], np.asarray(pl_sums), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cnt[0], np.asarray(pl_cnt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n", [1, 97, 130])
def test_odd_row_counts_and_zero_weights(n, code_type):
    """Any n (the Pallas kernel asserts n % rows_block == 0); rows of
    weight 0 take part and add nothing."""
    arrays = inputs(n, 6, 3, 4, 16, seed=n, zero_every=3)
    sums, cnt = port(*arrays, 4, 16, code_type)
    ref_sums, ref_cnt = jax_lane(*arrays, 4, 16)
    np.testing.assert_array_equal(sums[0], ref_sums)
    np.testing.assert_array_equal(cnt[0], ref_cnt)


def test_zero_weight_rows_add_exactly_nothing():
    """Padded rows (w = 0, a copy of a class's first row) change no bit of
    any cell."""
    codes, nid, g, w = inputs(200, 5, 3, 4, 16, seed=3)
    pad = 37
    codes_p = np.concatenate([codes, np.repeat(codes[:1], pad, 0)])
    nid_p = np.concatenate([nid, np.repeat(nid[:, :1], pad, 1)], axis=1)
    g_p = np.concatenate([g, np.repeat(g[:, :1], pad, 1)], axis=1)
    w_p = np.concatenate([w, np.zeros(pad, np.float32)])
    a = port(codes, nid, g, w, 4, 16)
    b = port(codes_p, nid_p, g_p, w_p, 4, 16)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("lanes", [2, 7])
def test_so_lanes_each_equal_their_own_histogram(lanes):
    """SO: one lane per output, each with its own node ids and gradient
    column, all on the same codes: lane s equals the JAX histogram of
    lane s alone."""
    arrays = inputs(150, 4, 1, 8, 16, seed=lanes, lanes=lanes, zero_every=5)
    sums, cnt = port(*arrays, 8, 16)
    assert sums.shape == (lanes, 8, 4, 16, 1)
    for s in range(lanes):
        ref_sums, ref_cnt = jax_lane(*arrays, 8, 16, s=s)
        np.testing.assert_array_equal(sums[s], ref_sums)
        np.testing.assert_array_equal(cnt[s], ref_cnt)


def test_build_histogram_takes_any_int_codes_and_widens():
    codes, nid, g, w = inputs(90, 3, 2, 2, 8, seed=5)
    got = build_histogram(torch.from_numpy(codes.astype(np.int64)),
                          torch.from_numpy(nid.astype(np.int64)),
                          torch.from_numpy(g).double(), torch.from_numpy(w),
                          2, 8)
    ref = jax_lane(codes, nid, g, w, 2, 8)
    np.testing.assert_array_equal(got[0][0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1][0].numpy(), ref[1])


def test_plain_version_adds_rows_in_order():
    """A cell whose value depends on the order of its adds shows it: 2^24,
    then 1, then 1 rounds back to 2^24 at each step in fp32."""
    codes = np.zeros((3, 1), np.int32)
    nid = np.zeros((1, 3), np.int32)
    g = np.array([[[2.0 ** 24], [1.0], [1.0]]], np.float32)
    w = np.ones(3, np.float32)
    sums, _ = port(codes, nid, g, w, 1, 1)
    assert sums.item() == 2.0 ** 24


def test_node_order_groups_rows_by_node_in_row_order():
    rng = np.random.default_rng(0)
    nid = rng.integers(0, 5, (3, 40)).astype(np.int32)
    nid[0, 7] = 9                     # outside [0, n_nodes): in no range
    order, offsets = node_order(torch.from_numpy(nid), 5)
    order, offsets = order.numpy(), offsets.numpy()
    for s in range(3):
        for k in range(5):
            rows = order[s, offsets[s, k]:offsets[s, k + 1]]
            np.testing.assert_array_equal(rows, np.flatnonzero(nid[s] == k))


@pytest.mark.parametrize("lanes,n,n_nodes", [(1, 0, 1), (1, 1, 8), (3, 97, 8),
                                             (2, 500, 1), (4, 300, 64)])
def test_node_layout_starts_every_node_on_a_chunk(lanes, n, n_nodes):
    """Each node's rows, in row order, from a multiple of CHUNK, its range
    whole chunks; -1 everywhere else; rows outside [0, n_nodes) in no
    node."""
    rng = np.random.default_rng(n)
    nid = rng.integers(-1, n_nodes + 1, (lanes, n)).astype(np.int32)
    src, offsets = node_layout(torch.from_numpy(nid), n_nodes)
    src, offsets = src.numpy(), offsets.numpy()
    assert src.shape[1] % CHUNK == 0 and offsets[:, -1].max() <= src.shape[1]
    for s in range(lanes):
        seen = np.zeros(src.shape[1], bool)
        for k in range(n_nodes):
            a, b = offsets[s, k], offsets[s, k + 1]
            assert a % CHUNK == 0 and (b - a) % CHUNK == 0
            rows = np.flatnonzero(nid[s] == k)
            np.testing.assert_array_equal(src[s, a:a + len(rows)], rows)
            assert (src[s, a + len(rows):b] == -1).all()
            assert b - a < len(rows) + CHUNK
            seen[a:b] = True
        assert (src[s, ~seen] == -1).all()


@pytest.mark.parametrize("bad", ["codes_dtype", "node_dtype", "g_dtype",
                                 "rows", "contiguous", "device", "n_bins"])
def test_wrapper_rejects_bad_input(bad):
    codes, nid, g, w = (torch.from_numpy(a) for a in inputs(20, 3, 2, 2, 8, 0))
    n_bins = 8
    if bad == "codes_dtype":
        codes = codes.long()
    elif bad == "node_dtype":
        nid = nid.long()
    elif bad == "g_dtype":
        g = g.double()
    elif bad == "rows":
        w = w[:-1]
    elif bad == "contiguous":
        codes = codes.T.contiguous().T
    elif bad == "device":
        g = g.to("meta")
    else:
        n_bins = 0
    with pytest.raises((TypeError, ValueError)):
        histogram(codes, nid, g, w, 2, n_bins)


# ---------------------------------------------------------------------------
# the launch plan and the narrowed codes (host side of the CUDA path)
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(368, 368, 64), (368, 1, 64), (1, 368, 1), (1, 1, 1),
               (37, 37, 16), (37, 1, 64), (5, 3, 8), (100, 1, 190),
               (13, 2, 150)]


# the default plan, and the tiles the probe compares
PLAN_KINDS = [{}, {"n_nodes": 1}, {"warps": 1}, {"warps": 2},
              {"kind": "columns"}, {"kind": "columns", "per": 1}]


@pytest.mark.parametrize("kw", PLAN_KINDS)
@pytest.mark.parametrize("p,out,n_bins", PLAN_SHAPES)
def test_plan_fits_shared_memory_and_aligns_the_codes(p, out, n_bins, kw):
    pl = plan(p, out, n_bins, **kw)
    assert pl.smem <= MAX_SMEM
    if not kw:
        assert pl.kind == ("features" if out == 1 else "columns")
        # no warp whose features all lie past p
        assert (pl.warps - 1) * pl.feats // pl.warps < p
    assert pl.feats == pl.warps * (pl.per if pl.kind == "columns" else 128)
    assert pl.feature_tiles * pl.feats >= p
    assert pl.tile >= pl.feats
    if pl.kind == "features":
        assert pl.tile % 16 == 0                 # aligned bulk copies
    assert pl.code_stride == pl.feature_tiles * pl.tile
    assert pl.col_tiles * pl.width >= out + 1


@pytest.mark.parametrize("kw", PLAN_KINDS)
@pytest.mark.parametrize("p,out,n_bins", PLAN_SHAPES)
@pytest.mark.parametrize("S,n_nodes", [(1, 1), (2, 4), (3, 1)])
def test_plan_blocks_cover_every_cell_once(p, out, n_bins, S, n_nodes, kw):
    """Every (lane, node, feature, column) cell, the count column
    included, belongs to exactly one block, and a block holds one (lane,
    node): no cell's rows are split between blocks."""
    pl = plan(p, out, n_bins, **kw)
    owner = np.full((S, n_nodes, p, out + 1), -1)
    for i, (s, node, j0, j1, c0, c1) in enumerate(
            blocks(pl, S, p, out, n_nodes)):
        assert 0 <= j0 < j1 <= p and 0 <= c0 < c1 <= out + 1
        cells = owner[s, node, j0:j1, c0:c1]
        assert (cells == -1).all(), "a cell in two blocks"
        owner[s, node, j0:j1, c0:c1] = i
    assert (owner >= 0).all(), "a cell in no block"


def test_plan_refuses_bins_that_do_not_fit():
    with pytest.raises(ValueError):
        plan(10, 10, 300)                        # past one-byte codes


@pytest.mark.parametrize("code_type", ["int16", "int32"])
def test_plain_version_drops_codes_outside_the_bins(code_type):
    """A code of -1, n_bins or 255 adds its row to no cell of its feature,
    as in the kernel; every other (row, feature) adds as before, in row
    order (a loop of float32 adds here)."""
    n, p, out, lanes, n_nodes, n_bins = 40, 3, 2, 2, 2, 16
    codes, nid, g, w = inputs(n, p, out, n_nodes, n_bins, seed=3,
                              lanes=lanes)
    bad = np.array([-1, n_bins, 255])
    codes[::3, 0] = bad[np.arange(len(codes[::3, 0])) % 3]
    codes[1::5, 2] = -1
    sums, cnt = port(codes, nid, g, w, n_nodes, n_bins, code_type)
    want = np.zeros((lanes, n_nodes, p, n_bins, out), np.float32)
    want_c = np.zeros((lanes, n_nodes, p, n_bins), np.float32)
    for s in range(lanes):
        for i in range(n):
            for j in range(p):
                b = codes[i, j]
                if 0 <= b < n_bins:
                    k = nid[s, i]
                    want[s, k, j, b] += g[s, i] * w[i]
                    want_c[s, k, j, b] += w[i]
    np.testing.assert_array_equal(sums, want)
    np.testing.assert_array_equal(cnt, want_c)
    # feature 1 has no code out of range: the JAX reference's bits
    ref_sums, ref_cnt = jax_lane(codes, nid, g, w, n_nodes, n_bins, s=1)
    np.testing.assert_array_equal(sums[1, :, 1], ref_sums[:, 1])
    np.testing.assert_array_equal(cnt[1, :, 1], ref_cnt[:, 1])


@pytest.mark.parametrize("p,out", [(368, 368), (368, 1), (5, 5), (533, 533)])
def test_bin_windows_cover_the_bins(p, out):
    """At each width the kernel takes any n_bins: contiguous, near-equal
    windows cover [0, n_bins) in order, each one pass that plan takes; 255
    bins are one pass and 256 two of 128."""
    for n_bins in (1, 64, 255, 256, 300, 511, 1024):
        for n_nodes in (1, 2, 64):
            wins = bin_windows(p, out, n_bins, n_nodes)
            assert wins[0][0] == 0 and wins[-1][1] == n_bins
            assert all(a[1] == b[0] for a, b in zip(wins, wins[1:]))
            widths = [b1 - b0 for b0, b1 in wins]
            assert max(widths) - min(widths) <= 1
            assert len(wins) == -(-n_bins // BYTE_BINS)
            for w in widths:
                assert plan(p, out, w, n_nodes).smem <= MAX_SMEM
    assert bin_windows(p, out, 255, 2) == [(0, 255)]
    assert bin_windows(p, out, 256, 2) == [(0, 128), (128, 256)]


@pytest.mark.parametrize("multi_output", [False, True])
def test_fit_at_256_bins_needs_no_check(multi_output):
    """A fit takes XGBoost's default of 256 bins on either device: the
    trainer has no bins check left, the card runs it in two windows a
    level, and the plain path on the CPU equals the JAX trainer's."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import fitting
    assert not hasattr(fitting, "check_bins")
    X = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    cfg = ForestConfig(n_t=2, duplicate_k=2, n_trees=2, max_depth=2,
                       n_bins=256, multi_output=multi_output)
    out = 3 if multi_output else 1
    for n_nodes in (1, 2, 4):
        assert len(bin_windows(3, out, 256, n_nodes)) == 2
    art = fitting.fit_artifacts(X, None, cfg, device="cpu")
    assert torch.isfinite(art.leaf).all()
    assert art.thr_val.shape[-1] == 3


@pytest.mark.parametrize("multi_output", [False, True])
def test_windows_placed_at_their_offsets_equal_all_bins(multi_output):
    """What a windowed launch computes, emulated with the plain version:
    per window, the codes shifted by its first bin with the codes outside
    it dropped, placed at its offset, equal the histograms over all 300
    bins to the bit; and the kernel's narrowing of each window (SO) keeps
    exactly those codes."""
    n_bins, n_nodes, p = 300, 4, 9
    out, lanes = (p, 1) if multi_output else (1, p)
    codes, nid, g, w = inputs(400, p, out, n_nodes, n_bins, seed=3,
                              lanes=lanes, zero_every=5)
    t = [torch.from_numpy(a) for a in (codes, nid, g, w)]
    want = histogram_ref(*t, n_nodes, n_bins)
    got = [torch.zeros_like(want[0]), torch.zeros_like(want[1])]
    wins = bin_windows(p, out, n_bins, n_nodes)
    assert len(wins) == 2
    for lo, hi in wins:
        shifted = t[0] - lo
        inside = (shifted >= 0) & (shifted < hi - lo)
        part = histogram_ref(torch.where(inside, shifted, -1), *t[1:],
                             n_nodes, hi - lo)
        got[0][:, :, :, lo:hi] = part[0]
        got[1][:, :, :, lo:hi] = part[1]
        pl = plan(p, out, hi - lo, n_nodes)
        narrow = narrow_codes(t[0], hi - lo, pl, lo)
        cols = [(j // pl.feats) * pl.tile + j % pl.feats for j in range(p)]
        assert torch.equal(narrow[:400, cols].to(torch.int32),
                           torch.where(inside, shifted, hi - lo))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plan_at_photons_width():
    """MO: two blocks of 6 warps × 2 features share an SM; a level of one
    node takes 12 warps × 1 feature (more blocks for its last wave); SO:
    one block of 3 adding warps over all 368 features."""
    mo, root, so = plan(368, 368, 64), plan(368, 368, 64, 1), plan(368, 1, 64)
    assert (mo.kind, mo.warps, mo.per, mo.feats) == ("columns", 6, 2, 12)
    assert 2 * (mo.smem + 1024) <= 228 * 1024
    assert (root.warps, root.per, root.feats) == (12, 1, 12)
    assert (so.kind, so.warps, so.feats, so.feature_tiles) == (
        "features", 3, 384, 1)


@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n_bins", [1, 64, 200])
def test_narrowed_codes_keep_every_histogram_bit(code_type, n_bins):
    """The narrowed codes (one byte; padding and codes outside [0, n_bins)
    at the spare bin n_bins) give the same histograms as the codes they
    come from."""
    np_t, _ = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    codes, nid, g, w = inputs(120, 7, 2, 4, min(n_bins, info.max), seed=9,
                              edge="out_of_range")
    codes = np.clip(codes, info.min, info.max).astype(np_t)
    t = [torch.from_numpy(a) for a in (codes, nid, g, w)]
    pl = plan(7, 1, n_bins)                      # SO: narrowed codes
    narrow = narrow_codes(t[0], n_bins, pl)
    assert narrow.shape == (121, pl.code_stride)
    assert narrow.dtype == torch.uint8
    assert (narrow[120] == n_bins).all()         # the spare row
    wide = narrow[:120].to(torch.int32)
    # feature j at column (j // feats) * tile + j % feats; the rest spare
    where = [(j // pl.feats) * pl.tile + j % pl.feats for j in range(7)]
    rest = sorted(set(range(pl.code_stride)) - set(where))
    assert (wide[:, rest] == n_bins).all()
    wide_codes = t[0].to(torch.int32)        # n_bins may pass int8's range
    inside = (wide_codes >= 0) & (wide_codes < n_bins)
    assert torch.equal(wide[:, where], torch.where(inside, wide_codes,
                                                   n_bins))
    got = histogram_ref(wide[:, where], t[1], t[2], t[3], 4, n_bins + 1)
    ref = expected(*t, 4, n_bins)
    assert torch.equal(got[0][:, :, :, :n_bins], ref[0])
    assert torch.equal(got[1][:, :, :, :n_bins], ref[1])


# ---------------------------------------------------------------------------
# a batch of ensembles in one launch: per-ensemble codes and weights
# ---------------------------------------------------------------------------

def batch_inputs(E, n, p, out, S, n_nodes, n_bins, seed, edge=None):
    """codes [E, n, p], node_id [S, n], g [S, n, out], w [E, n] and a lane
    map ens [S] that is shuffled and narrowed: not sorted, not contiguous,
    ensemble 1 left out (its lanes stopped early) where E > 2."""
    rng = np.random.default_rng(seed)
    codes = np.stack([inputs(n, p, out, n_nodes, n_bins, seed + 10 * e,
                             edge=edge)[0] for e in range(E)])
    nid = rng.integers(0, n_nodes, (S, n)).astype(np.int32)
    g = rng.normal(size=(S, n, out)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (E, n)).astype(np.float32)
    w[:, ::5] = 0.0
    kept = [e for e in range(E) if E <= 2 or e != 1]
    ens = rng.permutation(np.resize(kept, S)).astype(np.int32)
    return codes, nid, g, w, ens


def port_batch(codes, nid, g, w, ens, n_nodes, n_bins, code_type="int32"):
    np_t, _ = CODE_TYPES[code_type]
    sums, cnt = histogram(torch.from_numpy(codes.astype(np_t)),
                          torch.from_numpy(nid), torch.from_numpy(g),
                          torch.from_numpy(w), n_nodes, n_bins,
                          ens=torch.from_numpy(ens))
    return sums.numpy(), cnt.numpy()


def _jax_lanes(impl, **kw):
    """JAX's one-lane histogram under ``jax.vmap`` over the lanes, each
    lane on its ensemble's codes and weights (the reference's vmap of
    ``fit_one`` over a batch, then over the SO outputs)."""
    import jax
    from repro.forest.hist import build_histogram as jax_build_histogram

    def run(codes, nid, g, w, ens, n_nodes, n_bins):
        if impl == "xla":
            def one(c, k, gg, ww):
                return jax_build_histogram(c, k, gg, ww, n_nodes, n_bins,
                                           impl="xla")
        else:
            def one(c, k, gg, ww):
                return histogram_pallas(c, k, gg, ww, n_nodes, n_bins,
                                        interpret=True, **kw)
        sums, cnt = jax.vmap(one)(jnp.asarray(codes[ens]), jnp.asarray(nid),
                                  jnp.asarray(g), jnp.asarray(w[ens]))
        return np.asarray(sums), np.asarray(cnt)
    return run


BATCH_SHAPES = [   # (E, n, p, out, S, n_nodes, n_bins)
    (2, 130, 5, 5, 2, 4, 16),       # MO, one lane an ensemble
    (3, 97, 4, 1, 12, 8, 16),       # SO, 4 lanes an ensemble, one left out
    (6, 64, 3, 1, 9, 2, 8),         # SO lanes of 5 ensembles narrowed to 9
    (3, 256, 7, 2, 5, 4, 32),
]


@pytest.mark.parametrize("E,n,p,out,S,n_nodes,n_bins", BATCH_SHAPES)
def test_batched_plain_version_equals_vmapped_jax_to_the_bit(
        E, n, p, out, S, n_nodes, n_bins):
    """Per-ensemble codes and weights with a shuffled, narrowed lane map:
    every lane equals JAX's ``build_histogram`` (its "xla" path,
    ``segment_sum``) under ``jax.vmap``, bit for bit."""
    arrays = batch_inputs(E, n, p, out, S, n_nodes, n_bins, seed=E + n)
    sums, cnt = port_batch(*arrays, n_nodes, n_bins)
    ref_sums, ref_cnt = _jax_lanes("xla")(*arrays, n_nodes, n_bins)
    assert sums.shape == (S, n_nodes, p, n_bins, out)
    np.testing.assert_array_equal(sums, ref_sums)
    np.testing.assert_array_equal(cnt, ref_cnt)


@pytest.mark.parametrize("E,n,p,out,S,n_nodes,n_bins", BATCH_SHAPES[:3])
def test_batched_plain_version_matches_vmapped_pallas_interpret(
        E, n, p, out, S, n_nodes, n_bins):
    """The Pallas kernel in interpret mode under the same ``jax.vmap``
    (a one-hot product: another order of adds), within the 1e-5 of
    test_plain_version_matches_pallas_interpret."""
    arrays = batch_inputs(E, n, p, out, S, n_nodes, n_bins, seed=E + n + 1)
    sums, cnt = port_batch(*arrays, n_nodes, n_bins)
    pl_sums, pl_cnt = _jax_lanes("pallas", rows_block=n)(*arrays, n_nodes,
                                                         n_bins)
    np.testing.assert_allclose(sums, pl_sums, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cnt, pl_cnt, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("edge", [None, "out_of_range"])
def test_each_lane_equals_its_ensemble_launched_alone(code_type, edge):
    """A lane of a batch equals the same lane in a launch of its ensemble
    alone (codes [n, p], w [n]), to the bit, at int8, int16 and int32
    codes and with codes outside [0, n_bins) (which add to no cell)."""
    np_t, _ = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    E, n, p, out, S, n_nodes, n_bins = 4, 120, 6, 1, 10, 4, 16
    codes, nid, g, w, ens = batch_inputs(E, n, p, out, S, n_nodes, n_bins,
                                         seed=7, edge=edge)
    codes = np.clip(codes, info.min, info.max)
    sums, cnt = port_batch(codes, nid, g, w, ens, n_nodes, n_bins,
                           code_type)
    assert set(ens) == {0, 2, 3}                     # ensemble 1 dropped out
    for s in range(S):
        e = ens[s]
        alone = port(codes[e], nid[s:s + 1], g[s:s + 1], w[e], n_nodes,
                     n_bins, code_type)
        np.testing.assert_array_equal(sums[s], alone[0][0])
        np.testing.assert_array_equal(cnt[s], alone[1][0])
        if edge is None:
            jax_sums, jax_cnt = jax_lane(codes[e], nid[s:s + 1],
                                         g[s:s + 1], w[e], n_nodes, n_bins)
            np.testing.assert_array_equal(sums[s], jax_sums)
            np.testing.assert_array_equal(cnt[s], jax_cnt)


def test_batched_fake_tensor_shapes():
    """The dry run's fake tensors take the batched form too: the outputs'
    shapes come from the lanes, not from E."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        codes = torch.zeros((3, 50, 7), dtype=torch.int8)
        nid = torch.zeros((12, 50), dtype=torch.int32)
        g = torch.zeros((12, 50, 1))
        w = torch.zeros((3, 50))
        ens = torch.zeros((12,), dtype=torch.int32)
        sums, cnt = histogram(codes, nid, g, w, 4, 16, ens=ens)
        assert tuple(sums.shape) == (12, 4, 7, 16, 1)
        assert tuple(cnt.shape) == (12, 4, 7, 16)


@pytest.mark.parametrize("bad", ["dtype", "lanes", "range", "weights"])
def test_wrapper_rejects_a_bad_lane_map(bad):
    codes, nid, g, w, ens = (torch.from_numpy(a) for a in batch_inputs(
        3, 40, 3, 1, 6, 2, 8, seed=1))
    if bad == "dtype":
        ens = ens.long()
    elif bad == "lanes":
        ens = ens[:-1]
    elif bad == "range":
        ens = ens.clone()
        ens[2] = 3
    else:
        w = w[:2]
    with pytest.raises((TypeError, ValueError)):
        histogram(codes, nid, g, w, 2, 8, ens=ens)


def test_narrowed_codes_of_a_batch_are_each_ensembles_own():
    """The SO narrowing of codes [E, n, p] is [E, n + 1, stride]: each
    ensemble's codes narrowed on their own, its own spare row n."""
    codes = torch.from_numpy(batch_inputs(3, 50, 9, 1, 3, 2, 16, seed=2,
                                          edge="out_of_range")[0])
    pl = plan(9, 1, 16)
    narrow = narrow_codes(codes, 16, pl)
    assert narrow.shape == (3, 51, pl.code_stride)
    for e in range(3):
        assert torch.equal(narrow[e], narrow_codes(codes[e], 16, pl))


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hist kernel has no CPU mode; "
                    "python3 chip_smoke.py runs it on the card")
    return torch.device("cuda")


# (n, p, out, lanes, n_nodes, n_bins, edge): odd sizes, and the edges of
# the kernel's design (a node over many chunks and ring stages, one bin,
# codes outside [0, n_bins), the leaf sums' one bin, 16 bins, 368 SO lanes,
# nodes without rows)
CUDA_CASES = [
    (1, 3, 2, 1, 8, 64, None), (130, 37, 37, 1, 8, 64, None),
    (97, 37, 1, 37, 8, 64, None),
    (5000, 37, 37, 1, 1, 64, None), (5000, 37, 1, 3, 2, 64, None),
    (700, 37, 37, 1, 4, 64, "one_bin"), (700, 37, 1, 37, 4, 64, "one_bin"),
    (600, 37, 37, 1, 4, 64, "out_of_range"),
    (600, 37, 1, 37, 4, 64, "out_of_range"),
    (900, 1, 368, 1, 16, 1, None), (900, 1, 1, 368, 16, 1, None),
    (500, 37, 37, 1, 8, 16, None), (500, 37, 1, 37, 8, 16, None),
    (130, 368, 1, 368, 8, 64, None),
    (700, 37, 37, 1, 8, 64, "empty_nodes"),
    (700, 37, 1, 37, 8, 64, "empty_nodes"),
    (600, 37, 37, 1, 4, 256, None), (600, 37, 1, 37, 4, 256, None),
    (600, 37, 37, 1, 4, 300, "out_of_range"),
    (600, 37, 1, 37, 4, 300, "out_of_range"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n,p,out,lanes,n_nodes,n_bins,edge", CUDA_CASES)
def test_cuda_kernel_equals_plain_cpu_version(cuda_device, n, p, out, lanes,
                                              n_nodes, n_bins, edge,
                                              code_type):
    """In row order with separate roundings, the kernel equals the plain
    version on the CPU to the bit (a code outside [0, n_bins) adds to no
    cell), and two launches give the same bits."""
    codes, nid, g, w = inputs(n, p, out, n_nodes, n_bins, seed=n,
                              lanes=lanes, zero_every=4, edge=edge)
    np_t, t_t = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    args = [torch.from_numpy(np.clip(codes, info.min, info.max).astype(np_t)),
            torch.from_numpy(nid), torch.from_numpy(g), torch.from_numpy(w)]
    before = histogram.launches
    dev_args = [a.to(cuda_device) for a in args]
    got = histogram(*dev_args, n_nodes, n_bins)
    again = histogram(*dev_args, n_nodes, n_bins)
    assert histogram.launches == before + 2
    ref = expected(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), r)


@pytest.mark.cuda
def test_cuda_fit_at_256_bins_runs(cuda_device):
    """A card fit at 256 bins runs the kernel (two windows a launch) and
    equals the plain path on the CPU given the same noise."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import fit_artifacts
    X = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    cfg = ForestConfig(n_t=2, duplicate_k=2, n_trees=2, max_depth=2,
                       n_bins=256)

    def noise(eid, split, shape):
        gen = torch.Generator().manual_seed(100 * eid + split)
        return torch.randn(shape, generator=gen), None
    before = histogram.launches
    art = fit_artifacts(X, None, cfg, device=cuda_device, noise=noise)
    assert histogram.launches > before
    ref = fit_artifacts(X, None, cfg, device="cpu", noise=noise)
    assert torch.equal(art.feat.cpu(), ref.feat)
    assert torch.allclose(art.leaf.cpu(), ref.leaf, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n_bins,lo", [(64, 0), (200, 0), (150, 150)])
def test_cuda_narrowing_equals_plain_version(cuda_device, code_type, n_bins,
                                             lo):
    from repro_torch.kernels.hist.ops import _lib
    np_t, _ = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    codes = inputs(333, 29, 1, 2, min(lo + n_bins, info.max), seed=4,
                   edge="out_of_range")[0]
    codes = torch.from_numpy(np.clip(codes, info.min, info.max).astype(np_t))
    pl = plan(29, 1, n_bins)
    ref = narrow_codes(codes, n_bins, pl, lo)
    got = torch.empty_like(ref, device=cuda_device)
    rc = _lib().hist_narrow(codes.to(cuda_device).data_ptr(),
                            codes.element_size(), got.data_ptr(), 1, 333, 29,
                            pl.feats, pl.tile, pl.code_stride, n_bins, lo,
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("E,n,p,out,S,n_nodes,n_bins", BATCH_SHAPES + [
    (6, 700, 37, 1, 37 * 5, 8, 64), (2, 600, 37, 37, 2, 4, 256)])
def test_cuda_batched_launch_equals_plain_cpu_version(
        cuda_device, E, n, p, out, S, n_nodes, n_bins, code_type):
    """A launch over the lanes of several ensembles, with a shuffled,
    narrowed lane map, equals the plain version on the CPU to the bit, and
    each lane equals its ensemble launched alone on the card."""
    np_t, _ = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    codes, nid, g, w, ens = batch_inputs(E, n, p, out, S, n_nodes, n_bins,
                                         seed=n, edge="out_of_range")
    codes = np.clip(codes, info.min, info.max).astype(np_t)
    host = [torch.from_numpy(a) for a in (codes, nid, g, w, ens)]
    dev = [a.to(cuda_device) for a in host]
    got = histogram(*dev[:4], n_nodes, n_bins, ens=dev[4])
    wide = host[0].to(torch.int32)
    spare = torch.where((wide >= 0) & (wide < n_bins), wide, n_bins)
    ref = histogram_ref(spare, *host[1:4], n_nodes, n_bins + 1, host[4])
    assert torch.equal(got[0].cpu(), ref[0][:, :, :, :n_bins])
    assert torch.equal(got[1].cpu(), ref[1][:, :, :, :n_bins])
    for s in range(0, S, max(1, S // 7)):
        e = int(ens[s])
        alone = histogram(dev[0][e], dev[1][s:s + 1], dev[2][s:s + 1],
                          dev[3][e], n_nodes, n_bins)
        assert torch.equal(alone[0][0], got[0][s])
        assert torch.equal(alone[1][0], got[1][s])


@pytest.mark.cuda
@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
def test_cuda_batched_narrowing_equals_plain_version(cuda_device, code_type):
    """The narrowing pass over E = 3 ensembles' codes writes each one's
    [n + 1, stride] block as the plain version narrows it alone."""
    from repro_torch.kernels.hist.ops import _lib
    np_t, _ = CODE_TYPES[code_type]
    info = np.iinfo(np_t)
    codes = batch_inputs(3, 333, 29, 1, 3, 2, min(64, info.max), seed=4,
                         edge="out_of_range")[0]
    codes = torch.from_numpy(np.clip(codes, info.min, info.max).astype(np_t))
    pl = plan(29, 1, 64)
    ref = narrow_codes(codes, 64, pl)
    got = torch.empty_like(ref, device=cuda_device)
    rc = _lib().hist_narrow(codes.to(cuda_device).data_ptr(),
                            codes.element_size(), got.data_ptr(), 3, 333, 29,
                            pl.feats, pl.tile, pl.code_stride, 64, 0,
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
