"""Carry the JAX package's LM weights across to the port.

``params_from_jax`` takes the parameter tree that ``repro.models.lm.
init_params`` builds (or a checkpoint of it), as numpy arrays:

    {"embed": {"tokens": [V, D]},
     "segments": [{"0_dense": {"norm_attn": {"scale": [n, D]},
                               "attn": {"wq": [n, D, H, dh], ...},
                               ...}}],
     "final_norm": {"scale": [D]},
     "lm_head": {"w": [D, V]}}          # only without tied embeddings

with each segment's leaves stacked over its ``n`` groups (a layer's keys
are its kind's: ``moe`` {``router``, ``wi``, ``wg``, ``wo``} and
``shared`` for the MoE kinds, MLA's ``attn`` {``wq_a``, ``q_norm``,
``wq_b``, ``wkv_a``, ``kv_norm``, ``wk_rope``, ``wk_b``, ``wv_b``, ``wo``};
deepseek-v2 has two segments; the recurrent kinds' ``rec`` {``wx``,
``wgate``, ``conv`` {``w``, ``b``}, ``wa``, ``wi``, ``lambda``, ``wo``}
and ``block`` {``w_up``, ..., ``b_if``, ``o_norm``, ``w_down``}; whisper
has ``enc_segments``, ``dec_segments`` (``cross`` beside ``attn``) and
``enc_norm`` in place of ``segments``), and returns the port's
:class:`repro_torch.models.lm.LM` holding the same numbers, so both
packages compute the same function. A tree whose experts went through the
JAX package's ``quantize_expert_weights`` (int8 ``wi`` / ``wg`` / ``wo``
beside fp32 ``*_scale`` leaves) gives a model with int8 experts. ``params_to_jax`` goes the other way,
and ``jax_leaves`` maps any tree of that layout (AdamW's moments too) onto
the model's parameters: how a training checkpoint carries across.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models.lm import LM, quantize_experts


# the lists of stacked segments: whisper keeps its encoder's and decoder's
_STACKS = ("segments", "enc_segments", "dec_segments")


def _path(name: str) -> Tuple[tuple, Optional[int]]:
    """A parameter's place in the JAX tree: ``(path, group)``; ``group`` is
    its index in a segment's stacked leaves (``None`` outside segments).
    ``segments.0.3.0_dense.attn.wq`` -> ``(("segments", 0, "0_dense",
    "attn", "wq"), 3)``."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return (parts[0], int(parts[1])) + tuple(parts[3:]), int(parts[2])
    return tuple(parts), None


def _where(path: tuple, group: Optional[int]) -> str:
    where = ".".join(str(k) for k in path)
    return where if group is None else f"{where}[group {group}]"


def jax_leaves(model: LM, tree: Mapping) -> List[np.ndarray]:
    """The arrays of a JAX-layout tree (``model``'s parameters, or
    anything laid out like them: AdamW's moments), one per parameter in
    ``model.parameters()`` order; a segment's stacked leaves are split by
    group. Raises where the tree does not fit the model."""
    out, used = [], set()
    for name, param in model.named_parameters():
        path, group = _path(name)
        node = tree
        for key in path:
            try:
                node = node[key]
            except (KeyError, IndexError, TypeError):
                raise KeyError(f"the JAX tree has no weights for "
                               f"{_where(path, group)}") from None
        arr = np.asarray(node)
        if group is not None:
            n = len(getattr(model, path[0])[path[1]])
            if arr.shape[:1] != (n,):
                raise ValueError(f"{_where(path, group)}: leading dim "
                                 f"{arr.shape[:1]}, the segment has {n} "
                                 "groups")
            arr = arr[group]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{_where(path, group)}: shape {arr.shape}, the "
                             f"port expects {tuple(param.shape)}")
        out.append(arr)
        used.add(path)
    extra = sorted(".".join(map(str, p)) for p in _leaf_paths(tree, ())
                   if p not in used)
    if extra:
        raise KeyError(f"{extra}: the port's model has no such weights")
    return out


def _leaf_paths(tree, prefix: tuple):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (i,))
    else:
        yield prefix


def params_to_jax(model: LM, tensors: Optional[Sequence[torch.Tensor]] = None
                  ) -> dict:
    """The JAX-layout tree of ``model``'s parameters (or of ``tensors``,
    one per parameter in ``model.parameters()`` order) as numpy arrays, a
    segment's groups stacked: what ``repro.models.lm.init_params``
    builds."""
    if tensors is None:
        tensors = list(model.parameters())
    tree: dict = {}
    stacks: Dict[tuple, list] = {}
    for (name, _), t in zip(model.named_parameters(), tensors):
        path, group = _path(name)
        arr = t.detach().cpu().numpy()
        if group is None:
            _put(tree, path, arr)
        else:
            stacks.setdefault(path, []).append(arr)
    for path, arrs in stacks.items():
        _put(tree, path, np.stack(arrs))
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: Optional[Device] = None,
                    dtype=torch.float32) -> LM:
    """The port's model with the JAX tree's weights, on ``device`` (``None``
    -> the GPU, raising without one)."""
    device = resolve_device(device)
    model = LM(cfg, torch.Generator(device=device), device, dtype)
    if any(p[-1].endswith("_scale") for p in _leaf_paths(tree, ())):
        quantize_experts(model)
    with torch.no_grad():
        for param, arr in zip(model.parameters(), jax_leaves(model, tree)):
            param.copy_(torch.from_numpy(np.array(arr)))
    return model
