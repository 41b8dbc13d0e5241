"""Carry the JAX package's LM weights across to the port.

``params_from_jax`` takes the parameter tree that ``repro.models.lm.
init_params`` builds (or a checkpoint of it), as numpy arrays:

    {"embed": {"tokens": [V, D]},
     "segments": [{"0_dense": {"norm_attn": {"scale": [n, D]},
                               "attn": {"wq": [n, D, H, dh], ...},
                               ...}}],
     "final_norm": {"scale": [D]},
     "lm_head": {"w": [D, V]}}          # only without tied embeddings

with each segment's leaves stacked over its ``n`` groups, and returns the
port's :class:`repro_torch.models.lm.LM` holding the same numbers, so both
packages compute the same function.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models.lm import LM


def _assign(module: nn.Module, tree: Mapping, path: str,
            group: Optional[Tuple[int, int]], seen: set) -> None:
    """Copy ``tree``'s leaves into ``module``'s parameters; ``group`` is
    ``(g, n_groups)`` for a segment's stacked leaves."""
    for name, val in tree.items():
        where = f"{path}.{name}"
        if isinstance(val, Mapping):
            _assign(getattr(module, name), val, where, group, seen)
            continue
        param = getattr(module, name, None)
        if not isinstance(param, nn.Parameter):
            raise KeyError(f"{where}: the port's model has no such weight")
        arr = np.asarray(val)
        if group is not None:
            g, n = group
            if arr.shape[:1] != (n,):
                raise ValueError(f"{where}: leading dim {arr.shape[:1]}, the "
                                 f"segment has {n} groups")
            arr = arr[g]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{where}: shape {arr.shape}, the port expects "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)))
        seen.add(id(param))


def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: Optional[Device] = None,
                    dtype=torch.float32) -> LM:
    """The port's model with the JAX tree's weights, on ``device`` (``None``
    -> the GPU, raising without one)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    model = LM(cfg, gen, device, dtype)
    seen: set = set()
    for name, val in tree.items():
        if name == "segments":
            if len(val) != len(model.segments):
                raise ValueError(f"{len(val)} segments, the port has "
                                 f"{len(model.segments)}")
            for s, (seg_tree, seg) in enumerate(zip(val, model.segments)):
                for g, group in enumerate(seg):
                    _assign(group, seg_tree, f"segments[{s}][{g}]",
                            (g, len(seg)), seen)
        else:
            _assign(getattr(model, name), val, name, None, seen)
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise KeyError(f"the JAX tree has no weights for {missing}")
    return model
