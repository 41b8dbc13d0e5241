"""LM training loop: grad accumulation, checkpoint/restart, failure retry.

A port of ``repro.train.loop``. The model is an :class:`~repro_torch.
models.lm.LM` whose fp32 master weights a step updates in place; the
optimizer is :mod:`repro_torch.train.optim`'s AdamW (the JAX package's,
step for step), its state ``{"m", "v", "step"}`` with one moment per
parameter in ``model.parameters()`` order.

Fault tolerance, as in the JAX package:

* checkpoints are atomic and committed (:mod:`repro_torch.train.
  checkpoint`), written every ``ckpt_every`` steps, in the JAX package's
  layout: the tree ``(params, {"m", "step", "v"})`` of
  :func:`~repro_torch.models.convert.params_to_jax`, so either package
  resumes the other's checkpoint;
* the data pipeline is stateless (batch = f(seed, step)), so a resume from
  the latest commit continues exactly where the run stood;
* :func:`run_with_retries` restarts the loop from the last commit on
  exceptions.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.config import ArchConfig, TrainConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models import lm
from repro_torch.models.convert import jax_leaves, params_to_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import adamw_update, init_opt_state


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    dtype=torch.float32, accum: int = 1) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (opt_state, metrics)``,
    which updates ``model``'s weights in place.

    ``accum > 1`` splits the batch into microbatches and averages their
    gradients (and losses), added in microbatch order from zero in fp32, as
    the JAX package's ``fori_loop`` does.
    """

    def grads_of(params, model, batch):
        loss, _ = lm.loss_fn(model, batch, cfg, dtype=dtype,
                             remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def step(model, opt_state, batch):
        params = list(model.parameters())
        if accum == 1:
            loss, grads = grads_of(params, model, batch)
        else:
            size = next(iter(batch.values())).shape[0] // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for i in range(accum):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                li, gi = grads_of(params, model, mb)
                grads = [a + g for a, g in zip(grads, gi)]
                loss = loss + li
            grads = [g / accum for g in grads]
            loss = loss / accum
        new_params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, tcfg)
        with torch.no_grad():
            for p, q in zip(params, new_params):
                p.copy_(q)
        metrics["loss"] = loss
        return opt_state, metrics

    return step


def state_tree(model: lm.LM, opt_state: Dict) -> tuple:
    """``(params, {"m", "step", "v"})`` in the JAX package's layout: what
    :func:`repro_torch.train.checkpoint.save` writes."""
    return (params_to_jax(model),
            {"m": params_to_jax(model, opt_state["m"]),
             "step": opt_state["step"],
             "v": params_to_jax(model, opt_state["v"])})


def restore_state(directory: str, model: lm.LM, opt_state: Dict,
                  step: Optional[int] = None) -> int:
    """Load a checkpoint of :func:`state_tree`'s layout (written by either
    package) into ``model`` and ``opt_state`` in place; returns its step."""
    (params, opt), step = ckpt.restore(directory,
                                       state_tree(model, opt_state), step)
    with torch.no_grad():
        for p, arr in zip(model.parameters(), jax_leaves(model, params)):
            p.copy_(torch.from_numpy(arr))
        for name in ("m", "v"):
            for t, arr in zip(opt_state[name], jax_leaves(model, opt[name])):
                t.copy_(torch.from_numpy(arr))
        opt_state["step"].copy_(torch.from_numpy(opt["step"]))
    return step


def train(cfg: ArchConfig, tcfg: TrainConfig, data_fn: Callable[[int], Dict],
          *, steps: int, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          accum: int = 1, log_every: int = 10, dtype=torch.float32,
          params: Optional[lm.LM] = None, device: Optional[Device] = None,
          log_fn=print):
    """Run (or resume from ``ckpt_dir``'s latest commit) training to
    ``steps``. ``params`` defaults to ``lm.init_params`` seeded with
    ``tcfg.seed`` on ``device`` (``None``: the GPU, or raise; ``"cpu"``
    runs the plain PyTorch path). ``data_fn(i)`` is step i's batch of
    numpy arrays. Returns ``(params, opt_state, history)``."""
    if params is None:
        params = lm.init_params(cfg, device=resolve_device(device),
                                seed=tcfg.seed)
    device = params.embed.tokens.device
    opt_state = init_opt_state(list(params.parameters()))
    start = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        start = restore_state(ckpt_dir, params, opt_state)
        log_fn(f"[resume] restored step {start} from {ckpt_dir}")
    step_fn = make_train_step(cfg, tcfg, dtype=dtype, accum=accum)
    history: List[Dict] = []
    t0 = time.time()
    for i in range(start, steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data_fn(i).items()}
        opt_state, m = step_fn(params, opt_state, batch)
        if (i + 1) % log_every == 0 or i == steps - 1:
            loss = float(m["loss"])
            history.append({"step": i + 1, "loss": loss,
                            "grad_norm": float(m["grad_norm"]),
                            "lr": float(m["lr"]),
                            "elapsed_s": round(time.time() - t0, 1)})
            log_fn(f"step {i + 1:5d} loss {loss:.4f} "
                   f"gnorm {float(m['grad_norm']):.3f}")
        if ckpt_dir is not None and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, i + 1, state_tree(params, opt_state))
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, steps, state_tree(params, opt_state))
    return params, opt_state, history


def run_with_retries(fn: Callable, max_retries: int = 3, log_fn=print):
    """Restart-on-failure wrapper: the last committed checkpoint is the
    recovery point; transient node failures become retries."""
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except (RuntimeError, OSError) as e:
            if attempt == max_retries:
                raise
            log_fn(f"[retry {attempt + 1}/{max_retries}] {type(e).__name__}:"
                   f" {e}; resuming from last checkpoint")
