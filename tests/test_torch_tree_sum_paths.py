"""Which summing kernel a multi-output ``tree_predict`` launch ran, as the
launcher reports it, and the counters that carry the report.

``tree_predict_launch`` (``csrc/tree_predict.cu``) feeds the leaves of an
out > 1 forest by TMA (``sum_tma_kernel``) only where a leaf row is 16-byte
aligned (``out % 4 == 0``) and depth <= 8, else by ``cp.async`` from all
threads (``sum_kernel``): the CaloForest photons width (368) takes the
first, the pions width (533) the second. The launcher counts each summing
launch by kind into an out-parameter, and ``ops.forest_predict`` adds the
counts to ``forest_predict.sum_tma_launches`` / ``.sum_plain_launches``
(:func:`repro_torch.kernels.build.count_launch`), which
:func:`~repro_torch.kernels.build.tallied_launches` also tallies for one
thread's block of work.

The counters' plumbing runs on the CPU. The kernels run only on a card: the
``cuda`` tests skip without one, and import no JAX, so on the card they run
as they are (``python3 -m pytest -q -m cuda`` this file).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.tree_predict.ops import (forest_predict,
                                                  sum_launches)
from repro_torch.kernels.tree_predict.ref import forest_predict_ref


def random_forest(seed, B, T, depth, p, out, n):
    """x ``[B, n, p]`` and one multi-output sub-forest a class: thresholds
    in [-1, 1] with ~10% +inf, leaves N(0, 1)."""
    rng = np.random.default_rng(seed)
    H, L = 2 ** depth - 1, 2 ** depth
    thr = rng.uniform(-1, 1, (B, 1, T, H)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.1] = np.inf
    return (rng.normal(size=(B, n, p)).astype(np.float32),
            rng.integers(0, p, (B, 1, T, H)).astype(np.int32), thr,
            rng.normal(size=(B, 1, T, L, out)).astype(np.float32))


def _kinds():
    return (forest_predict.sum_tma_launches,
            forest_predict.sum_plain_launches)


# ---------------------------------------------------------------------------
# the counters (CPU)
# ---------------------------------------------------------------------------

def test_a_kind_named_twice_counts_twice():
    """A launch of two summing kernels of one kind names the kind twice;
    each naming adds one, and ``launches`` adds one a call."""
    def wrapper():
        pass
    wrapper.launches = wrapper.sum_plain_launches = 0
    build.count_launch(wrapper, "sum_plain_launches", "sum_plain_launches")
    build.count_launch(wrapper)
    assert (wrapper.launches, wrapper.sum_plain_launches) == (2, 2)


def test_a_tally_holds_this_threads_launches_and_replays_alone():
    """Inside ``tallied_launches`` a launch and a replay's added launches
    are tallied; a capture's recorded launches (which run nothing) and
    another thread's launches are not; the counters get all but the
    capture's."""
    before = _kinds()
    other = threading.Thread(target=build.count_launch,
                             args=(forest_predict, "sum_tma_launches"))
    try:
        with build.tallied_launches() as tally:
            build.count_launch(forest_predict, "sum_plain_launches")
            with build.recorded_launches() as rec:
                build.count_launch(forest_predict, "sum_tma_launches")
            build.add_launches(rec)                    # one replay
            other.start()
            other.join(timeout=60)
        assert not other.is_alive()
        assert sum_launches(tally) == {"sum_tma": 1, "sum_plain": 1}
        assert tally[forest_predict, "launches"] == 2
        assert (_kinds()[0] - before[0], _kinds()[1] - before[1]) == (2, 1)
    finally:
        forest_predict.sum_tma_launches, \
            forest_predict.sum_plain_launches = before


def test_the_cpu_path_counts_no_summing_launch():
    args = [torch.from_numpy(a) for a in random_forest(0, 2, 3, 3, 13, 13,
                                                       50)]
    before = _kinds()
    with build.tallied_launches() as tally:
        got = forest_predict(*args, 3)
    assert _kinds() == before
    assert sum_launches(tally) == {"sum_tma": 0, "sum_plain": 0}
    torch.testing.assert_close(got, forest_predict_ref(*args, 3), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the kernels (needs a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tree_predict kernels have no "
                    "CPU mode (pytest -m cuda on the card)")
    return torch.device("cuda")


# out: the pions width and a small odd one take sum_kernel (a leaf row of
# 2,132 or 52 bytes is not 16-byte aligned); the photons width takes
# sum_tma_kernel. B = 3 classes, T = 5 trees of depth 7, n = 300 rows: one
# chunk of trees, so one summing launch a call.
@pytest.mark.cuda
@pytest.mark.parametrize("out, kind", [(533, "sum_plain"), (13, "sum_plain"),
                                       (368, "sum_tma")])
def test_each_width_runs_its_summing_kernel(card, out, kind):
    args = [torch.from_numpy(a).to(card)
            for a in random_forest(out, 3, 5, 7, out, out, 300)]
    before = _kinds()
    with build.tallied_launches() as tally:
        got = forest_predict(*args, 7)
    ref = forest_predict_ref(*args, 7)
    torch.cuda.synchronize()
    want = {"sum_tma": 0, "sum_plain": 0, kind: 1}
    assert sum_launches(tally) == want
    assert (_kinds()[0] - before[0], _kinds()[1] - before[1]) == (
        want["sum_tma"], want["sum_plain"])
    # the same trees added in the same order, in fp32: equal to the bit
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
