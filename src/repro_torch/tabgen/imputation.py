"""Imputation: REPAINT-style clamping of observed features along the
reverse solve.

Observed features are clamped to a fixed-noise bridge at every solver step;
the whole solve is then repeated ``refine_rounds`` times from annealed
restart times (re-noising the previous imputation), so the conditioning —
which only becomes informative at small t — propagates back through the
trajectory.

:func:`clamped_solve` is the per-class solve with its noise passed in as
tensors (so the parity tests can hand it the JAX package's draws);
:func:`impute` draws that noise from a seeded ``torch.Generator``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import interpolants as itp
from repro_torch.forest.packed import PackedForest, predict_forest
from repro_torch.tabgen.artifacts import ForestArtifacts, rescale, unscale
from repro_torch.tabgen.sampling import _IMPUTE_STREAM, stream_seed


def restart_index(ts: np.ndarray, r: int) -> int:
    """Round r restarts at t=1 (r=0), then at ever smaller t."""
    frac = 1.0 if r == 0 else float(ts[-1]) * (0.6 ** r)
    return max(int(np.argmin(np.abs(ts - frac))), 1)


def clamped_solve(forests: PackedForest, obs, mask, eps_fix,
                  eps_rounds: Sequence[torch.Tensor], ts: np.ndarray, *,
                  method: str, depth: int):
    """One class's clamped solve.

    forests ``[n_t, 1, n_sub, ...]``; obs ``[n, p]`` scaled observed values;
    mask ``[n, p]`` bool, True where observed; eps_fix ``[n, p]`` the fixed
    bridge noise; eps_rounds one ``[n, p]`` restart noise per round; ts the
    ``[n_t]`` float32 grid on the host. Returns the scaled estimate
    ``[n, p]`` with observed cells equal to ``obs``.
    """
    x0_est = torch.zeros_like(obs)
    for r, eps_r in enumerate(eps_rounds):
        i_start = restart_index(ts, r)
        t0 = float(ts[i_start])
        if method == "flow":
            x = t0 * eps_r + (1 - t0) * x0_est
        else:
            a0, s0 = itp.vp_alpha_sigma(torch.tensor(t0, dtype=torch.float32))
            x = a0.item() * x0_est + s0.item() * eps_r
        for i in range(i_start, 0, -1):
            t = float(ts[i])
            h_i = float(ts[i] - ts[i - 1])
            f = forests.at(i)
            if method == "flow":
                bridge = t * eps_fix + (1 - t) * obs
                x = torch.where(mask, bridge, x)
                x = x - h_i * predict_forest(x[None], f, depth)[0]
            else:
                a, s_ = (v.item() for v in itp.vp_alpha_sigma(
                    torch.tensor(t, dtype=torch.float32)))
                x = torch.where(mask, a * obs + s_ * eps_fix, x)
                score = predict_forest(x[None], f, depth)[0]
                a2, s2 = (v.item() for v in itp.vp_alpha_sigma(
                    torch.tensor(float(ts[i - 1]), dtype=torch.float32)))
                eps_hat = -s_ * score
                x0_hat = torch.clamp((x - s_ * eps_hat) / a, -1.5, 1.5)
                eps_hat = (x - a * x0_hat) / s_
                x = a2 * x0_hat + s2 * eps_hat
        x0_est = torch.where(mask, obs, x)
    return x0_est


def impute(artifacts: ForestArtifacts, X_missing, y=None, *, seed: int = 0,
           refine_rounds: int = 3) -> np.ndarray:
    """Fill NaNs in ``X_missing``; observed cells are returned untouched."""
    artifacts._require_whole("impute")
    fcfg = artifacts.config
    X_missing = np.asarray(X_missing, np.float32)
    n, p = X_missing.shape
    if y is None:
        if artifacts.n_y != 1:
            raise ValueError("labels required for conditional models")
        y_idx = np.zeros((n,), int)
    else:
        lut = {c: i for i, c in enumerate(np.asarray(artifacts.classes))}
        y_idx = np.asarray([lut[v] for v in np.asarray(y)])
    device = artifacts.device
    out = X_missing.copy()
    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff,
                       fcfg.t_schedule).numpy()
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, _IMPUTE_STREAM))
    for yi in range(artifacts.n_y):
        sel = np.where(y_idx == yi)[0]
        if len(sel) == 0:
            continue
        rows = X_missing[sel]
        mask_np = ~np.isnan(rows)                    # observed
        mins, maxs = artifacts.mins[yi], artifacts.maxs[yi]
        obs = rescale(torch.from_numpy(np.nan_to_num(rows)).to(device),
                      mins, maxs)
        mask = torch.from_numpy(mask_np).to(device)

        def draw():
            return torch.randn((len(sel), p), generator=gen,
                               dtype=torch.float32, device=device)

        # one fixed noise draw: observed coords follow a single consistent
        # bridge path across all solver steps
        eps_fix = draw()
        eps_rounds = [draw() for _ in range(max(1, refine_rounds))]
        x0_est = clamped_solve(artifacts.class_forest(yi), obs, mask, eps_fix,
                               eps_rounds, ts, method=fcfg.method,
                               depth=fcfg.max_depth)
        vals = unscale(x0_est, mins, maxs).cpu().numpy()
        out[sel] = np.where(mask_np, rows, vals)
    return out
