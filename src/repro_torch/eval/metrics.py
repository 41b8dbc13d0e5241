"""Generated-data quality metrics (paper App. D.2).

* Wasserstein-1: exact per-feature W1 (scipy) averaged, plus sliced-W1 over
  random projections (joint-structure sensitive; POT's exact OT is not
  available offline, sliced-W1 is the standard surrogate).
* Coverage (Eq. 8): L1-ball k-NN coverage with k auto-chosen so the train
  set has >= 95% coverage of the test set.
* Classifier two-sample AUC (CaloChallenge metric): logistic regression on
  standardized features, manual ROC-AUC.

A numpy/scipy copy of ``repro.eval.metrics``: the same numbers for the same
arrays. ``coverage`` is an O(n_ref · (n_ref + n_gen)) host k-NN.
"""
from __future__ import annotations

import numpy as np
from scipy import stats


def w1_per_feature(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([stats.wasserstein_distance(a[:, j], b[:, j])
                          for j in range(a.shape[1])]))


def sliced_w1(a: np.ndarray, b: np.ndarray, n_proj: int = 64,
              seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    p = a.shape[1]
    dirs = rng.normal(size=(n_proj, p))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vals = [stats.wasserstein_distance(a @ d, b @ d) for d in dirs]
    return float(np.mean(vals))


def _l1_knn_radius(ref: np.ndarray, k: int) -> np.ndarray:
    """L1 distance of each ref point to its k-th nearest neighbour in ref."""
    n = len(ref)
    rad = np.empty(n)
    for i in range(n):
        d = np.abs(ref - ref[i]).sum(1)
        d[i] = np.inf
        rad[i] = np.partition(d, k - 1)[k - 1]
    return rad


def coverage(gen: np.ndarray, ref: np.ndarray, k: int = 3) -> float:
    """Eq. 8: fraction of ref points with >= 1 generated point inside their
    k-NN L1 ball."""
    rad = _l1_knn_radius(ref, k)
    covered = 0
    for j in range(len(ref)):
        d = np.abs(gen - ref[j]).sum(1)
        covered += bool((d <= rad[j]).any())
    return covered / len(ref)


def auto_k(train: np.ndarray, test: np.ndarray, target: float = 0.95,
           k_max: int = 10) -> int:
    for k in range(1, k_max + 1):
        if coverage(train, test, k) >= target:
            return k
    return k_max


def classifier_auc(real: np.ndarray, gen: np.ndarray, seed: int = 0,
                   steps: int = 400) -> float:
    """Two-sample test AUC: logistic regression real-vs-generated.
    0.5 = indistinguishable (best); 1.0 = trivially separable."""
    rng = np.random.default_rng(seed)
    n = min(len(real), len(gen))
    X = np.concatenate([real[:n], gen[:n]]).astype(np.float64)
    y = np.concatenate([np.ones(n), np.zeros(n)])
    mu, sd = X.mean(0), X.std(0) + 1e-9
    X = (X - mu) / sd
    idx = rng.permutation(2 * n)
    X, y = X[idx], y[idx]
    n_tr = int(0.7 * 2 * n)
    Xtr, ytr, Xte, yte = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    w = np.zeros(X.shape[1])
    b = 0.0
    lr = 0.5
    for _ in range(steps):
        z = Xtr @ w + b
        p = 1 / (1 + np.exp(-np.clip(z, -30, 30)))
        gw = Xtr.T @ (p - ytr) / len(ytr) + 1e-3 * w
        gb = float(np.mean(p - ytr))
        w -= lr * gw
        b -= lr * gb
    score = Xte @ w + b
    return roc_auc(yte, score)


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    order = np.argsort(score)
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    pos = y > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
