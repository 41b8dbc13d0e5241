"""Original-style (pre-rework) implementation — the paper's comparison
baseline, with its pathologies faithfully recreated (paper §3.2):

* Issue 1: materialises the full ``X_train`` of shape [n_t, nK, p] up front.
* Issue 2 analogue: stores the noise array X1 (and a duplicate per-ensemble
  *copy* of its training slice, like joblib advanced-indexing copies did).
* Issue 3: keeps every trained ensemble in memory until the end.
* Issue 5: boolean-mask copies of each class's rows.
* Issue 6: refits bin edges / code matrices separately per output column.
* Issue 7: runs the data path in float64.

The PyTorch twin of ``repro.core.naive``. The host side is the same numpy;
each per-output fit copies its class slice to ``device`` and runs the
port's ``fit_bins`` / ``transform`` / ``fit_boosted`` with one lane and one
output, so on the card every fit launches ``hist`` at every level (the copy
per fit is part of the pathology). X1 comes from
``np.random.default_rng(seed)``, as in the JAX package, so the two train on
the same numbers. Used by ``chip_smoke.py``'s resource comparison
(Figures 1/2/4).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ForestConfig
from repro_torch.core import interpolants as itp
from repro_torch.forest.binning import edges_with_sentinel, fit_bins, transform
from repro_torch.forest.boosting import BoostResult, fit_boosted
from repro_torch.kernels.dispatch import Device, resolve_device


class NaiveForestGenerativeModel:
    def __init__(self, fcfg: ForestConfig):
        self.fcfg = fcfg

    def fit(self, X, y=None, *, seed: int = 0,
            device: Optional[Device] = None):
        device = resolve_device(device)
        fcfg = self.fcfg
        X = np.asarray(X, np.float64)                      # Issue 7
        n, p = X.shape
        if y is None:
            y = np.zeros((n,), np.int64)
        classes = np.unique(y)
        mn, mx = X.min(0), X.max(0)
        scale = np.where(mx > mn, mx - mn, 1.0)
        Xs = (X - mn) / scale * 2 - 1
        self._mins, self._maxs = mn, mx
        K = fcfg.duplicate_k
        rng = np.random.default_rng(seed)
        X0 = np.tile(Xs, (K, 1))                           # [nK, p]
        X1 = rng.normal(size=X0.shape)                     # stored noise
        yd = np.tile(np.asarray(y), K)
        ts_t = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff)
        ts = ts_t.numpy()
        # Issue 1: all timesteps at once -> [n_t, nK, p]
        if fcfg.method == "flow":
            X_train = ts[:, None, None] * X1 + (1 - ts[:, None, None]) * X0
            Z = X1 - X0
        else:
            a, s = (c.numpy() for c in itp.vp_alpha_sigma(ts_t))
            X_train = a[:, None, None] * X0 + s[:, None, None] * X1
            Z = None
        self.models = []                                   # Issue 3
        for ti in range(fcfg.n_t):
            for c in classes:
                mask = yd == c                             # boolean-mask copies
                xt_c = X_train[ti][mask]                   # (Issue 5)
                if fcfg.method == "flow":
                    z_c = Z[mask]
                else:
                    _, sig = itp.vp_alpha_sigma(ts_t[ti])
                    z_c = -X1[mask] / float(sig)
                w = torch.ones((xt_c.shape[0],), dtype=torch.float32,
                               device=device)
                for j in range(p):                         # Issue 6: per-output
                    x_d = torch.from_numpy(xt_c.astype(np.float32)).to(device)
                    edges = fit_bins(x_d, fcfg.n_bins)
                    codes = transform(x_d, edges)
                    z_d = torch.from_numpy(
                        z_c[:, j:j + 1].astype(np.float32)).to(device)[None]
                    res = fit_boosted(codes, z_d, w,
                                      edges_with_sentinel(edges), codes, z_d,
                                      w, fcfg)
                    self.models.append(((ti, int(c), j), BoostResult(
                        *(v[0].cpu().numpy() for v in res))))
        self._X_train = X_train     # held live, like the original
        self._X1 = X1
        return self
