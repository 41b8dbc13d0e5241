"""The port's numpy copies (quality metrics, data generators, CaloChallenge
metrics) against the JAX package's on the same seeded arrays: equal, bit
for bit (the same numpy and scipy calls in the same order)."""
import numpy as np
import pytest

from repro.data import calorimeter as jcalo
from repro.data import tabular as jtab
from repro.eval import metrics as jmetrics
from repro_torch.data import calorimeter as tcalo
from repro_torch.data import tabular as ttab
from repro_torch.eval import metrics as tmetrics


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(120, 4)).astype(np.float32)
    b = (rng.normal(size=(90, 4)) * 1.3 + 0.2).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name,args", [
    ("w1_per_feature", ()),
    ("sliced_w1", (16, 3)),
    ("coverage", (3,)),
    ("auto_k", ()),
    ("classifier_auc", (1, 50)),
])
def test_metric_matches_jax(arrays, name, args):
    a, b = arrays
    got = getattr(tmetrics, name)(a, b, *args)
    want = getattr(jmetrics, name)(a, b, *args)
    assert type(got) is type(want)
    assert got == want


def test_knn_radius_and_roc_auc_match_jax(arrays):
    a, _ = arrays
    np.testing.assert_array_equal(tmetrics._l1_knn_radius(a, 4),
                                  jmetrics._l1_knn_radius(a, 4))
    rng = np.random.default_rng(1)
    y = (rng.random(200) > 0.4).astype(np.float64)
    score = rng.normal(size=200) + y
    assert tmetrics.roc_auc(y, score) == jmetrics.roc_auc(y, score)
    assert tmetrics.roc_auc(np.ones(5), score[:5]) == 0.5


def test_data_generators_match_jax():
    for got, want in zip(ttab.two_moons_batches(1001, batch_rows=300, seed=4),
                         jtab.two_moons_batches(1001, batch_rows=300,
                                                seed=4)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    Xg, cov_g = ttab.correlated_gaussian(300, 6, seed=2)
    Xw, cov_w = jtab.correlated_gaussian(300, 6, seed=2)
    np.testing.assert_array_equal(Xg, Xw)
    np.testing.assert_array_equal(cov_g, cov_w)
    batches = list(ttab.correlated_gaussian_batches(700, 5, batch_rows=256,
                                                    seed=3))
    assert [len(x) for x in batches] == [256, 256, 188]
    for g, w in zip(batches, jtab.correlated_gaussian_batches(
            700, 5, batch_rows=256, seed=3)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dataset", ["photons_mini", "photons"])
def test_challenge_metrics_match_jax(dataset):
    X, _ = jcalo.generate(dataset, 200, seed=0)
    Y, _ = jcalo.generate(dataset, 150, seed=1)
    got = tcalo.high_level_features(X, dataset)
    want = jcalo.high_level_features(X, dataset)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    other = jcalo.high_level_features(Y, dataset)
    for k in ("e_dep", "ce_eta_l1", "width_phi_l2"):
        assert (tcalo.chi2_separation(want[k], other[k])
                == jcalo.chi2_separation(want[k], other[k]))
    assert tcalo.chi2_separation(np.ones(4), np.ones(3)) == 0.0
