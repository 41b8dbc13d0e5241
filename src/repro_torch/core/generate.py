"""Samplers: Euler and Heun ODE solvers (ForestFlow), DDIM and reverse-SDE
Euler-Maruyama (ForestDiffusion) over stacked per-timestep forests.

Each solver is batched over classes: ``x1`` is ``[B, n, p]`` and the forest
arrays are ``[n_t, B, n_sub, T, ...]``, so every solver step is one
:func:`~repro_torch.forest.packed.predict_forest` call — one kernel launch
on the GPU — for all classes. The JAX package's ``lax.scan`` over timesteps
is a Python loop here; the step indexing is the same (``[::-1][: n_t - 1]``
of the forest stack, paired with the descending intervals).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import interpolants as itp
from repro_torch.forest.packed import PackedForest, predict_forest


def _descending(forests: PackedForest, n_t: int) -> List[int]:
    """Forest indices the solve visits: the stack reversed, first n_t-1."""
    return list(range(forests.feat.shape[0]))[::-1][: n_t - 1]


def _grid(ts, method: str, n_t: int, eps: float, like: torch.Tensor):
    if ts is None:
        ts = itp.timesteps(method, n_t, eps)
    return ts.to(device=like.device, dtype=torch.float32)


def flow_euler(x1, forests: PackedForest, depth: int, n_t: int, ts=None):
    """Integrate dx = v dt from t=1 to t=0 with the learned vector field.

    ``ts`` is the (possibly non-uniform) grid the forests were trained on;
    the step over ``[t_{i-1}, t_i]`` uses the forest at ``t_i``.
    """
    ts = _grid(ts, "flow", n_t, 0.0, x1)
    hs = (ts[1:] - ts[:-1]).flip(0)               # descending intervals
    x = x1
    for h, i in zip(hs, _descending(forests, n_t)):
        x = x - h * predict_forest(x, forests.at(i), depth)
    return x


def flow_heun(x1, forests: PackedForest, depth: int, n_t: int, ts=None):
    """Heun (explicit trapezoid) ODE integration: the forest at t_i predicts
    and the forest at t_{i-1} corrects — two evaluations per step."""
    ts = _grid(ts, "flow", n_t, 0.0, x1)
    hs = (ts[1:] - ts[:-1]).flip(0)
    x = x1
    for h, i in zip(hs, range(n_t - 1, 0, -1)):
        v1 = predict_forest(x, forests.at(i), depth)
        v2 = predict_forest(x - h * v1, forests.at(i - 1), depth)
        x = x - 0.5 * h * (v1 + v2)
    return x


def diffusion_ddim(x1, forests: PackedForest, depth: int, n_t: int,
                   eps: float, clip: float = 1.5, ts=None):
    """Deterministic DDIM / exponential-integrator sampling of the VP process.

    At each grid point the score gives eps_hat = -sigma_t * s(x, t); x0 is
    reconstructed, clamped to the scaled-data range (trees cannot
    extrapolate), and re-noised to the next grid time. A final denoise at
    t = eps uses forest 0.
    """
    ts = _grid(ts, "diffusion", n_t, eps, x1).flip(0)   # descending
    x = x1
    for k, i in enumerate(_descending(forests, n_t)):
        score = predict_forest(x, forests.at(i), depth)
        a_now, s_now = itp.vp_alpha_sigma(ts[k])
        a_next, s_next = itp.vp_alpha_sigma(ts[k + 1])
        eps_hat = -s_now * score
        x0_hat = torch.clamp((x - s_now * eps_hat) / a_now, -clip, clip)
        eps_hat = (x - a_now * x0_hat) / s_now
        x = a_next * x0_hat + s_next * eps_hat
    a, s = itp.vp_alpha_sigma(ts[-1])
    score = predict_forest(x, forests.at(0), depth)
    return (x + s ** 2 * score) / a


def diffusion_em(x1, forests: PackedForest, depth: int, n_t: int,
                 eps: float, ts=None, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Reverse VP-SDE Euler-Maruyama from t=1 to t=eps using the score model.

    Step k's noise is ``noise[k]`` when ``noise`` (``[n_t-1, *x1.shape]``)
    is given, ``noise(k)`` when it is a callable (the sharded solve's slice
    of the unsharded call's draw), else a fresh ``randn`` from
    ``generator``.
    """
    ts = _grid(ts, "diffusion", n_t, eps, x1)
    hs = (ts[1:] - ts[:-1]).flip(0)
    ts = ts.flip(0)                                       # descending
    x = x1
    for k, i in enumerate(_descending(forests, n_t)):
        score = predict_forest(x, forests.at(i), depth)
        beta = itp.vp_beta(ts[k])
        drift = -0.5 * beta * x - beta * score
        if noise is None:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
        else:
            z = noise(k) if callable(noise) else noise[k]
        x = x - drift * hs[k] + torch.sqrt(beta * hs[k]) * z
    return x
