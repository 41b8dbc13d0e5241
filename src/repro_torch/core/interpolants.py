"""Diffusion (VP-SDE) and flow-matching time grids and coefficients.

flow (CFM):        x_t = t x1 + (1-t) x0,             target = x1 - x0
diffusion (VP):    x_t = alpha(t) x0 + sigma(t) x1,   target = -x1 / sigma(t)

Everything is float32, as in the JAX package, so a grid or a coefficient
computed here routes rows through the trees exactly as the JAX one does.
"""
from __future__ import annotations

import math

import torch

BETA_MIN = 0.1
BETA_MAX = 20.0


def vp_alpha_sigma(t):
    """VP-SDE marginal coefficients (Song et al. 2021). ``t``: f32 tensor."""
    log_alpha = -0.25 * t ** 2 * (BETA_MAX - BETA_MIN) - 0.5 * t * BETA_MIN
    alpha = torch.exp(log_alpha)
    sigma = torch.sqrt(torch.clamp(1.0 - alpha ** 2, min=1e-12))
    return alpha, sigma


def vp_beta(t):
    return BETA_MIN + t * (BETA_MAX - BETA_MIN)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32: ``start·(1-step) + stop·step`` with
    ``step = iota·(1/div)`` (XLA turns ``iota/div`` into a multiply by the
    reciprocal). ``torch.linspace`` rounds differently in the last place."""
    lo = torch.tensor(start, dtype=torch.float32)
    hi = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return lo[None]
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) * torch.tensor(
        1.0 / div, dtype=torch.float32)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def timesteps(method: str, n_t: int, eps: float, schedule: str = "uniform",
              device=None) -> torch.Tensor:
    """Timestep grid ``[n_t]`` f32, ascending from ``0`` (flow) or ``eps``
    (diffusion) to 1. ``cosine`` concentrates models near t=0 (data).

    Agreement with ``repro.core.interpolants.timesteps``: bit for bit for
    uniform flow grids, within one ulp for uniform diffusion grids, and for
    cosine grids within one ulp of ``cos`` near 1 (2**-24 absolute), since
    ``1 - cos`` turns the two libraries' last-place cos difference into an
    absolute one.
    """
    lo = 0.0 if method == "flow" else eps
    if schedule == "cosine":
        u = _linspace(0.0, 1.0, n_t)
        t = 1.0 - torch.cos(0.5 * math.pi * u)
        out = lo + (1.0 - lo) * t
    else:
        out = _linspace(lo, 1.0, n_t)
    return out if device is None else out.to(device)
