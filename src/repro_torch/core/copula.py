"""GaussianCopula baseline (paper Table 2, [45]).

Rank-transform each marginal to standard normal, fit the Gaussian copula
correlation, sample, and map back through the empirical quantiles.

A numpy/scipy copy of ``repro.core.copula``: the same numbers, bit for bit.
"""
from __future__ import annotations

import numpy as np
from scipy import stats


class GaussianCopula:
    def fit(self, X: np.ndarray):
        X = np.asarray(X, np.float64)
        n, p = X.shape
        self._sorted = np.sort(X, axis=0)
        ranks = np.empty_like(X)
        for j in range(p):
            ranks[:, j] = stats.rankdata(X[:, j], method="average")
        u = ranks / (n + 1.0)
        z = stats.norm.ppf(u)
        self._corr = np.corrcoef(z, rowvar=False)
        self._corr = np.atleast_2d(self._corr)
        # regularise to PSD
        w, v = np.linalg.eigh(self._corr)
        w = np.clip(w, 1e-6, None)
        self._chol = v @ np.diag(np.sqrt(w))
        return self

    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        p = self._sorted.shape[1]
        z = rng.normal(size=(n, p)) @ self._chol.T
        u = stats.norm.cdf(z)
        out = np.empty((n, p))
        m = self._sorted.shape[0]
        idx = np.clip((u * (m - 1)).astype(int), 0, m - 1)
        for j in range(p):
            out[:, j] = self._sorted[idx[:, j], j]
        return out.astype(np.float32)
