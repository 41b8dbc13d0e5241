"""Block assembly: per-layer-kind init/apply and the segments of layers.

A port of ``repro.models.blocks`` for the ``dense`` kind (pre-LN GQA +
gated MLP). An architecture is a list of *segments*, each a repeating group
of layer kinds; the JAX package stacks a segment's weights and scans over
them, the port keeps one module per group (``nn.ModuleDict`` keyed
``"{i}_{kind}"``, as the JAX tree is) and loops over them in Python.
Prefill caches are stacked per segment like the JAX package's, ``{key:
{"k": [n_groups, B, Hkv, S, dh], "v": ...}}``, so they compare leaf by leaf.
The training forward, :func:`apply_segment`, recomputes a group's
activations in the backward pass as the remat policy says (``"none"``,
``"full"``, ``"dots"``), as the JAX package's ``jax.checkpoint`` of a
group does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port serves the dense family; the "
        f"others come with a later slice")


def segments_for(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family == "dense":
        return [(("dense",), cfg.n_layers)]
    raise _not_ported(f"family {cfg.family!r}")


def _check_kind(kind: str) -> None:
    if kind != "dense":
        raise _not_ported(f"layer kind {kind!r}")


class DenseLayer(nn.Module):
    """``norm_attn``, ``attn``, ``norm_mlp``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.norm_attn = init_norm(d, cfg.norm, device, dtype)
        self.attn = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, device, dtype)
        self.norm_mlp = init_norm(d, cfg.norm, device, dtype)
        self.mlp = init_mlp(gen, d, cfg.d_ff, cfg.act, device, dtype)


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None,
               dtype=torch.float32) -> DenseLayer:
    _check_kind(kind)
    return DenseLayer(gen, cfg, device, dtype)


def apply_layer(p: DenseLayer, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, *, collect_kv: bool = False,
                attend: Callable = attn.flash_attention):
    """Residual layer body over a full sequence; ``attend`` is the
    attention (the kernel for prefill, :func:`~.attention.mea_attention`
    in training).

    Returns ``(x, aux, kv)``: aux is the layer's auxiliary loss (0.0 for
    the dense kind, which has none), kv its cache contribution ``{"k",
    "v"}`` when ``collect_kv`` (prefill), else None."""
    _check_kind(kind)
    h, kv_pair = attn.apply_gqa(
        p.attn, apply_norm(p.norm_attn, x, cfg.norm), positions,
        theta=cfg.rope_theta, attend=attend)
    x = x + h
    kv = {"k": kv_pair[0], "v": kv_pair[1]} if collect_kv else None
    x = x + apply_mlp(p.mlp, apply_norm(p.norm_mlp, x, cfg.norm), cfg.act)
    return x, 0.0, kv


def apply_layer_decode(p: DenseLayer, x: torch.Tensor, pos: int,
                       cfg: ArchConfig, kind: str, cache: Dict):
    """x: ``[B, 1, D]``; cache: this layer's ``{"k", "v"}``, updated in
    place. Returns ``(x, cache)``."""
    _check_kind(kind)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    h, new_cache = attn.apply_gqa(
        p.attn, apply_norm(p.norm_attn, x, cfg.norm), positions,
        theta=cfg.rope_theta, cache=cache, cache_index=pos)
    x = x + h
    x = x + apply_mlp(p.mlp, apply_norm(p.norm_mlp, x, cfg.norm), cfg.act)
    return x, new_cache


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, size: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    _check_kind(kind)
    return attn.make_kv_cache(batch, cfg.n_kv_heads, size, cfg.d_head, dtype,
                              device)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def init_segment(gen: torch.Generator, cfg: ArchConfig,
                 kinds: Tuple[str, ...], n_groups: int, device=None,
                 dtype=torch.float32) -> nn.ModuleList:
    """One ``nn.ModuleDict`` ``{"{i}_{kind}": layer}`` per group."""
    return nn.ModuleList(
        nn.ModuleDict({f"{i}_{kind}": init_layer(gen, cfg, kind, device,
                                                 dtype)
                       for i, kind in enumerate(kinds)})
        for _ in range(n_groups))


# the matmuls without batch dimensions (projections, MLP), whose outputs the
# "dots" policy keeps: jax.checkpoint_policies.dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the remat policy: ``"none"`` keeps every activation for
    the backward pass, ``"full"`` keeps only ``fn``'s inputs and recomputes
    the rest, ``"dots"`` keeps the matmul outputs and recomputes the rest."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat policy {policy!r}: expected 'none', 'full' or "
                     "'dots'")


def apply_segment(seg: nn.ModuleList, x: torch.Tensor,
                  positions: torch.Tensor, cfg: ArchConfig,
                  kinds: Tuple[str, ...], *, remat_policy: str = "full"):
    """The training forward over the segment's groups, each under
    ``remat_policy``; attention is :func:`~.attention.mea_attention`.
    Returns ``(x, aux)``, aux summed over the layers."""

    def group_body(group, xc):
        aux = 0.0
        for i, kind in enumerate(kinds):
            xc, a, _ = apply_layer(group[f"{i}_{kind}"], xc, positions, cfg,
                                   kind, attend=attn.mea_attention)
            aux = aux + a
        return xc, aux

    body = _remat(group_body, remat_policy)
    aux = 0.0
    for group in seg:
        x, a = body(group, x)
        aux = aux + a
    return x, aux


def apply_segment_prefill(seg: nn.ModuleList, x: torch.Tensor,
                          positions: torch.Tensor, cfg: ArchConfig,
                          kinds: Tuple[str, ...]):
    """Full-sequence forward that also emits the per-layer cache, stacked
    over the segment's groups."""
    kvs: Dict[str, List[Dict]] = {f"{i}_{kind}": []
                                  for i, kind in enumerate(kinds)}
    for group in seg:
        for i, kind in enumerate(kinds):
            key = f"{i}_{kind}"
            x, _, kv = apply_layer(group[key], x, positions, cfg, kind,
                                   collect_kv=True)
            kvs[key].append(kv)
    cache = {key: {name: torch.stack([kv[name] for kv in layers])
                   for name in layers[0]}
             for key, layers in kvs.items()}
    return x, cache


def apply_segment_decode(seg: nn.ModuleList, seg_cache: Dict,
                         x: torch.Tensor, pos: int, cfg: ArchConfig,
                         kinds: Tuple[str, ...]):
    """One decode step over the segment; each layer writes its slice of the
    stacked cache in place. Returns ``(x, seg_cache)``."""
    for g, group in enumerate(seg):
        for i, kind in enumerate(kinds):
            key = f"{i}_{kind}"
            layer_cache = {name: t[g] for name, t in seg_cache[key].items()}
            x, _ = apply_layer_decode(group[key], x, pos, cfg, kind,
                                      layer_cache)
    return x, seg_cache


def init_segment_cache(cfg: ArchConfig, kinds: Tuple[str, ...], n_groups: int,
                       batch: int, size: int, dtype, device=None) -> Dict:
    one = {f"{i}_{kind}": init_layer_cache(cfg, kind, batch, size, dtype,
                                           device)
           for i, kind in enumerate(kinds)}
    return {key: {name: t.expand((n_groups,) + t.shape).clone()
                  for name, t in c.items()}
            for key, c in one.items()}
