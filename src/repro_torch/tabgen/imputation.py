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

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import interpolants as itp
from repro_torch.forest.packed import PackedForest, predict_forest
from repro_torch.tabgen.artifacts import (ForestArtifacts, class_span,
                                          rescale, unscale)
from repro_torch.tabgen.sampling import (_IMPUTE_STREAM, _gather,
                                         resolve_mesh, stream_seed)


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


def check_impute_inputs(artifacts: ForestArtifacts, X_missing, y=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows as float32 [n, p], each row's class index)``; raises
    ``ValueError`` for rows that are not ``[n, p]``, labels that are missing
    (a conditional model), of another count, or not among the model's
    classes."""
    X = np.asarray(X_missing, np.float32)
    if X.ndim != 2 or X.shape[1] != artifacts.p:
        raise ValueError(f"rows of shape {X.shape}: the model imputes "
                         f"[n, {artifacts.p}]")
    if y is None:
        if artifacts.n_y != 1:
            raise ValueError("labels required for conditional models")
        return X, np.zeros((len(X),), int)
    y = np.asarray(y)
    if y.shape != (len(X),):
        raise ValueError(f"labels of shape {y.shape} for {len(X)} rows")
    lut = {c: i for i, c in enumerate(np.asarray(artifacts.classes).tolist())}
    unknown = sorted({v for v in y.tolist() if v not in lut}, key=str)
    if unknown:
        raise ValueError(f"labels {unknown} are not among the model's "
                         f"classes {list(lut)}")
    return X, np.asarray([lut[v] for v in y.tolist()], dtype=int)


def impute(artifacts: ForestArtifacts, X_missing, y=None, *, seed: int = 0,
           refine_rounds: int = 3, mesh=None,
           noise: Optional[Callable] = None) -> np.ndarray:
    """Fill NaNs in ``X_missing``; observed cells are returned untouched.

    ``mesh`` (``None`` | ``DeviceMesh`` | ``"auto"``) imputes on a mesh of
    ranks, a collective (every rank makes the same call): each model rank
    solves the rows of its classes (:func:`class_span`) from its slice of
    the artifacts, the data ranks of a model group split each class's rows
    between them, and the rows are gathered back to their places on every
    rank. ``artifacts`` is the whole model on the rank's device or its
    :meth:`~ForestArtifacts.shard` slice. The noise is the unsharded call's:
    one generator runs through the classes in order and a rank draws (and
    drops) the classes before its own, so the result equals the unsharded
    call's bit for bit on the same device type. ``noise(yi, (n_c, p))``,
    if given, returns class ``yi``'s ``[1 + refine_rounds, n_c, p]`` noise
    (the fixed bridge noise, then one restart draw a round) in place of
    the generator's, as the parity tests hand over the JAX package's.
    """
    mesh = resolve_mesh(mesh)
    if mesh is None:
        artifacts._require_whole("impute")
    elif mesh.device_type != artifacts.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot impute from "
                         f"artifacts on {artifacts.device}")
    fcfg = artifacts.config
    X_missing, y_idx = check_impute_inputs(artifacts, X_missing, y)
    n, p = X_missing.shape
    n_y = artifacts.n_y
    device = artifacts.device
    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff,
                       fcfg.t_schedule).numpy()
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, _IMPUTE_STREAM))
    if mesh is None:
        c0, c1, sh = 0, n_y, None
        out = X_missing.copy()
    else:
        from repro_torch.forest.distributed import Shards
        c0, c1 = class_span(mesh, n_y)
        sh = Shards.from_mesh(mesh)
        vals = torch.zeros((n, p), dtype=torch.float32, device=device)
        owner = np.zeros((n,), int)          # each row's data rank
    for yi in range(c1):
        sel = np.where(y_idx == yi)[0]
        if len(sel) == 0:
            continue

        if noise is not None:
            if yi < c0:
                continue
            eps_fix, *eps_rounds = noise(yi, (len(sel), p)).to(device)
        else:
            def draw():
                return torch.randn((len(sel), p), generator=gen,
                                   dtype=torch.float32, device=device)

            # one fixed noise draw: observed coords follow a single
            # consistent bridge path across all solver steps
            eps_fix = draw()
            eps_rounds = [draw() for _ in range(max(1, refine_rounds))]
            if yi < c0:
                continue       # another model rank's class: drawn, dropped
        rows_at = slice(None)
        if sh is not None:     # this data rank's share of the class's rows
            k = -(-len(sel) // sh.data_size)
            owner[sel] = np.arange(len(sel)) // k
            rows_at = slice(min(sh.data_rank * k, len(sel)),
                            min((sh.data_rank + 1) * k, len(sel)))
            sel = sel[rows_at]
            if len(sel) == 0:
                continue
        rows = X_missing[sel]
        mask_np = ~np.isnan(rows)                    # observed
        _, _, _, mins, maxs = artifacts.class_tensors(yi, yi + 1)
        mins, maxs = mins[0], maxs[0]
        obs = rescale(torch.from_numpy(np.nan_to_num(rows)).to(device),
                      mins, maxs)
        mask = torch.from_numpy(mask_np).to(device)
        x0_est = clamped_solve(artifacts.class_forest(yi), obs, mask,
                               eps_fix[rows_at],
                               [e[rows_at] for e in eps_rounds], ts,
                               method=fcfg.method, depth=fcfg.max_depth)
        if sh is not None:
            vals[torch.from_numpy(sel).to(device)] = unscale(x0_est, mins,
                                                             maxs)
            continue
        filled = unscale(x0_est, mins, maxs).cpu().numpy()
        out[sel] = np.where(mask_np, rows, filled)
    if sh is None:
        return out
    vals = _pick(_gather(vals, sh.data_group, sh.data_size), owner)
    if c1 - c0 < n_y:                                # classes split
        vals = _pick(_gather(vals, sh.model_group, sh.model_size),
                     y_idx // (c1 - c0))
    return np.where(np.isnan(X_missing), vals.cpu().numpy(), X_missing)


def _pick(stacked: torch.Tensor, owner: np.ndarray) -> torch.Tensor:
    """Row i of rank ``owner[i]``'s part: ``stacked`` is every rank's
    ``[n, p]`` stacked in rank order."""
    n = len(owner)
    at = torch.from_numpy(owner * n + np.arange(n)).to(stacked.device)
    return stacked[at]
