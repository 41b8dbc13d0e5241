"""ForestFlow / ForestDiffusion hyperparameters for the PyTorch port.

A field-for-field copy of ``repro.config.ForestConfig`` (the JAX package's
config), so ``ForestConfig(**meta["config"])`` accepts every JSON sidecar the
JAX trainer writes and the port writes sidecars the JAX package reads.

Fields that only steer the JAX trainer or its TPU kernels are kept for that
round trip and ignored here:

* ``predict_impl`` ("xla" | "pallas" | "pallas_interpret") — in the port the
  device of the tensors picks the tree-predict path: a CPU tensor takes the
  plain PyTorch version, a CUDA tensor the hand-written kernel
  (:mod:`repro_torch.kernels.tree_predict.ops`).
* ``split_reduce``, ``hist_bf16``, ``int8_codes`` — training-side settings;
  the port does not train yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """ForestFlow / ForestDiffusion hyperparameters (paper Table 9)."""

    method: str = "flow"       # "flow" (CFM) | "diffusion" (VP-SDE score matching)
    n_t: int = 50              # timestep discretisation
    duplicate_k: int = 100     # K-fold duplication for expectation coverage
    n_trees: int = 100         # max boosting rounds per ensemble
    max_depth: int = 7
    learning_rate: float = 0.3  # eta
    reg_lambda: float = 0.0
    min_child_weight: float = 1e-6
    n_bins: int = 64           # histogram bins
    multi_output: bool = False  # MO trees (vector leaves) vs SO (per-feature ensembles)
    early_stop_rounds: int = 0  # 0 disables (paper n_ES=20 when enabled)
    sigma: float = 0.0          # CFM bridge noise
    eps_diff: float = 1e-3      # diffusion min time (paper epsilon)
    diff_sampler: str = "ddim"  # "ddim" (stable exp-integrator) | "em" (paper)
    per_class_scalers: bool = True
    label_sampler: str = "label"  # "label" (empirical) | "multinomial"
    t_schedule: str = "uniform"  # | "cosine" (denser near t=0)
    split_reduce: str = "allreduce"  # training only; kept for the sidecar
    hist_bf16: bool = False     # training only; kept for the sidecar
    int8_codes: bool = False    # training only; kept for the sidecar
    predict_impl: Optional[str] = None  # ignored: the device picks the path
    seed: int = 0
