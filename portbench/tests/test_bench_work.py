"""The yardstick's bytes, operations and required work against values
worked out by hand at the cells' shapes."""
import pytest

from harness import work

N, P, BINS = 160_000, 368, 64


def test_hist_mo_level6_photons_bytes():
    nbytes, ops = work.hist_bytes_ops(N, P, P, 1, 64, BINS, 4)
    # int32 codes 235.52 MB, node ids + g + w 236.8 MB, histograms 2.224 GB
    assert nbytes == 4 * N * P + 4 * (N + N * P + N) + 4 * 64 * P * BINS * 369
    assert nbytes == pytest.approx(2.697e9, rel=5e-4)
    assert ops == N * P * P
    assert work.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)


def test_predict_photons_full_model_bytes():
    nbytes, ops = work.predict_bytes_ops(15, 1, 20, 7, P, P, 8000)
    assert nbytes == pytest.approx(410.1e6, rel=2e-4)
    assert ops == 15 * 8000 * 20 * (7 + P)


def test_fit_round_least_time_photons():
    # a level writes its histograms and the split search reads them (level
    # 6: 2 x 2.2236 GB), codes at one byte and g are read (294.4 MB), and
    # 21.67 G adds are done (0.3234 ms at 67 TFLOP/s): levels 6, 5, 4 are
    # bound by bytes, 3 ... 0 by the adds; the leaf sums read g (235.5 MB)
    hist6 = 4 * 64 * P * BINS * 369
    per_level = [max((2 * hist6 * 2 ** lv / 64 + 5 * N * P) / 3.35e12,
                     N * P * P / 67e12) for lv in range(7)]
    assert per_level[6] == pytest.approx(1.4161e-3, rel=1e-4)
    assert per_level[3] == per_level[0] == pytest.approx(0.3234e-3,
                                                         rel=1e-3)
    leaves = (4 * N * P + 4 * 128 * 369) / 3.35e12
    assert work.fit_round_s(N, P, P, 7, BINS) == pytest.approx(
        sum(per_level) + leaves, rel=1e-12)
    # 3.95 ms a round: 79 ms an ensemble of 20 rounds
    assert 20 * work.fit_round_s(N, P, P, 7, BINS) == pytest.approx(
        0.0790, rel=0.01)


def test_generate_call_least_time_photons():
    trees = 4 * 15 * 20 * (2 * 127 + 128 * P)
    per_step = 8 * 120_000 * P + trees          # 410.1 MB, as one predict
    assert per_step == pytest.approx(410.1e6, rel=2e-4)
    assert work.generate_call_s(15, 120_000, P, 20, 7, P, 99) == \
        pytest.approx(99 * per_step / 3.35e12)


def test_pions_hist_level6_is_the_group_caps_other_branch():
    nbytes = 4 * 64 * 533 * BINS * 534            # 4.66 GB of histograms
    assert nbytes == pytest.approx(4.663e9, rel=1e-3)
    assert 8e9 // nbytes == 1 and 8e9 // (4 * 64 * P * BINS * 369) == 3
