"""Diffusion (VP-SDE) and flow-matching time grids, coefficients and bridges.

flow (CFM):        x_t = t x1 + (1-t) x0 (+ sigma eps),  target = x1 - x0
diffusion (VP):    x_t = alpha(t) x0 + sigma(t) x1,      target = -x1 / sigma(t)

Everything is float32, as in the JAX package, so a grid or a coefficient
computed here routes rows through the trees exactly as the JAX one does.
The bridges round ``a + b·c`` once (``torch.addcmul``, ``torch.add(...,
alpha=)``), as XLA does on the CPU where it fuses the JAX package's bridge
into fused multiply-adds; where XLA fuses differently the two agree within
an ulp.

Noise comes in as tensors, or is drawn from an explicit ``torch.Generator``;
the port never draws from the global generator.
"""
from __future__ import annotations

import math
from typing import Optional

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


def make_xt_target(method: str, x0, x1, t, sigma_cfm: float = 0.0,
                   jitter: Optional[torch.Tensor] = None):
    """x0: data rows; x1: standard normal noise of the same shape; t: f32
    0-d tensor. ``jitter`` (standard normal, independent of x1) adds the CFM
    bridge noise ``sigma_cfm · jitter`` when ``sigma_cfm > 0``.

    Returns ``(x_t, target)``.
    """
    t = torch.as_tensor(t, dtype=torch.float32, device=x0.device)
    if method == "flow":
        xt = torch.addcmul((1.0 - t) * x0, x1, t)          # t·x1 + (1-t)·x0
        if sigma_cfm > 0.0 and jitter is not None:
            xt = torch.add(xt, jitter, alpha=sigma_cfm)
        return xt, x1 - x0
    if method == "diffusion":
        alpha, sigma = vp_alpha_sigma(t)
        xt = torch.addcmul(sigma * x1, x0, alpha)          # alpha·x0 + sigma·x1
        return xt, -x1 / sigma
    raise ValueError(method)


def sample_bridge(x0, method: str, t, sigma_cfm: float = 0.0, *,
                  generator: Optional[torch.Generator] = None,
                  x1: Optional[torch.Tensor] = None,
                  jitter: Optional[torch.Tensor] = None):
    """Draw noise ``x1`` and the ``(x_t, target)`` training pair.

    ``x1`` and ``jitter`` are taken as given, or drawn from ``generator``:
    x1 first, then (only when ``sigma_cfm > 0``) the jitter, a second draw
    independent of x1, as the JAX package's key split makes it (the two must
    not be one draw: x_t would then be ``(t + sigma)·x1 + (1-t)·x0``).
    Returns ``(x1, x_t, target)``.
    """
    def draw():
        if generator is None:
            raise ValueError("sample_bridge needs x1/jitter or a generator")
        return torch.randn(x0.shape, generator=generator, dtype=torch.float32,
                           device=x0.device)

    if x1 is None:
        x1 = draw()
    if sigma_cfm > 0.0 and jitter is None:
        jitter = draw()
    xt, target = make_xt_target(method, x0, x1, t, sigma_cfm, jitter)
    return x1, xt, target
