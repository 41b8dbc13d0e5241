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
from repro_torch.kernels.hist.ops import histogram, node_order
from repro_torch.kernels.hist.ref import histogram_ref

CODE_TYPES = {"int8": (np.int8, torch.int8), "int16": (np.int16, torch.int16),
              "int32": (np.int32, torch.int32)}


def inputs(n, p, out, n_nodes, n_bins, seed, lanes=1, zero_every=0):
    """codes [n, p], node_id [lanes, n], g [lanes, n, out], w [n] (numpy)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, p)).astype(np.int32)
    nid = rng.integers(0, n_nodes, (lanes, n)).astype(np.int32)
    g = rng.normal(size=(lanes, n, out)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if zero_every:
        w[::zero_every] = 0.0
    return codes, nid, g, w


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
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hist kernel has no CPU mode; "
                    "python3 chip_smoke.py runs it on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("code_type", sorted(CODE_TYPES))
@pytest.mark.parametrize("n,p,out,lanes", [(1, 3, 2, 1), (130, 37, 37, 1),
                                           (97, 37, 1, 37)])
def test_cuda_kernel_equals_plain_cpu_version(cuda_device, n, p, out, lanes,
                                              code_type):
    """In row order with separate roundings, the kernel equals the plain
    version on the CPU to the bit."""
    codes, nid, g, w = inputs(n, p, out, 8, 64, seed=n, lanes=lanes,
                              zero_every=4)
    np_t, t_t = CODE_TYPES[code_type]
    args = [torch.from_numpy(codes.astype(np_t)), torch.from_numpy(nid),
            torch.from_numpy(g), torch.from_numpy(w)]
    before = histogram.launches
    got = histogram(*(a.to(cuda_device) for a in args), 8, 64)
    assert histogram.launches == before + 1
    ref = histogram_ref(*args, 8, 64)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
