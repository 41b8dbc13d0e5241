"""AdamW with a warmup-cosine schedule and global-norm clipping.

What ``repro.train.optim`` computes, operation for operation, on lists of
tensors (a module's parameters in order):

* the step count is incremented *before* the learning rate and the bias
  corrections are taken;
* clipping scales every gradient by ``min(1, clip / max(norm, 1e-9))``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead);
* the schedule warms up linearly over ``warmup_steps`` and decays by a
  cosine to a floor of 0.1 of ``learning_rate`` at ``total_steps``;
* weight decay sits inside the update and is scaled by the learning rate;
* moments may be kept in bf16 (``moment_dtype``); the update math is fp32.

``torch.optim.AdamW`` differs in each of these (and defaults to
``beta2 = 0.999``), so the NN baselines train with :class:`AdamW` here.
Everything stays on the parameters' device: the step count, the learning
rate and the norm are 0-d tensors, and a step never waits for the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.config import TrainConfig


def init_opt_state(params: Sequence[torch.Tensor],
                   moment_dtype=torch.float32) -> Dict:
    """Zero moments (``moment_dtype``: bf16 halves the optimizer's memory)
    and a step count of 0 (int32) on the parameters' device; a DTensor
    parameter's moments are DTensors laid out alike."""
    device = params[0].device if len(params) else None
    return {"m": [torch.zeros_like(p, dtype=moment_dtype,
                                   memory_format=torch.contiguous_format)
                  for p in params],
            "v": [torch.zeros_like(p, dtype=moment_dtype,
                                   memory_format=torch.contiguous_format)
                  for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup, then a cosine to 0.1 × ``learning_rate`` (f32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def adamw_update(grads: Sequence[torch.Tensor], opt_state: Dict,
                 params: Sequence[torch.Tensor], cfg: TrainConfig):
    """Returns ``(new_params, new_opt_state, metrics)``; nothing in place."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else 1.0)
    lr = lr_schedule(step, cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    new_p: List[torch.Tensor] = []
    new_m: List[torch.Tensor] = []
    new_v: List[torch.Tensor] = []
    for g, m, v, p in zip(grads, opt_state["m"], opt_state["v"], params):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})


class AdamW(torch.optim.Optimizer):
    """:func:`adamw_update` as a ``torch.optim.Optimizer``: ``step()``
    applies one update to the parameters in place from their ``.grad``
    (a parameter without one counts as a zero gradient, as a JAX gradient
    of an unused leaf is zero) and returns the metrics."""

    def __init__(self, params, cfg: TrainConfig, moment_dtype=torch.float32):
        super().__init__(params, {})
        self.cfg = cfg
        self.opt_state = init_opt_state(self._params(), moment_dtype)

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = self._params()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        new_p, self.opt_state, metrics = adamw_update(
            grads, self.opt_state, params, self.cfg)
        for p, q in zip(params, new_p):
            p.copy_(q)
        return metrics
