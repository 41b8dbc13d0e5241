"""Block assembly: per-layer-kind init/apply and the segments of layers.

A port of ``repro.models.blocks`` for the kinds of the ``dense``, ``moe``
and ``mla_moe`` families:

    dense:        [(("dense",), n_layers)]
    dbrx:         [(("moe",), n_layers)]
    deepseek-v2:  [(("mla_dense",), first_k_dense),
                   (("mla_moe",), n_layers - first_k_dense)]

``dense`` and ``moe`` layers attend with GQA, ``mla_*`` with MLA; the second
half is a gated MLP (``dense``, ``mla_dense``, the latter at ``d_ff_dense``)
or routed experts (``moe``; ``mla_moe`` adds DeepSeek's shared experts). An
architecture is a list of *segments*, each a repeating group of layer
kinds; the JAX package stacks a segment's weights and scans over them, the
port keeps one module per group (``nn.ModuleDict`` keyed ``"{i}_{kind}"``,
as the JAX tree is) and loops over them in Python. Prefill caches are
stacked per segment like the JAX package's, ``{key: {"k": [n_groups, B,
Hkv, S, dh], "v": ...}}`` (MLA: ``{"c": [n_groups, B, S, kv_lora],
"k_rope": [n_groups, B, S, rope]}``), so they compare leaf by leaf. The
training forward, :func:`apply_segment`, recomputes a group's activations
in the backward pass as the remat policy says (``"none"``, ``"full"``,
``"dots"``), as the JAX package's ``jax.checkpoint`` of a group does.

MoE capacity by path, as in the reference: training drops past the default
factor 1.25; prefill uses the no-drop ``E / top_k``; decode routes the
batch's B tokens as one group at ``E / top_k``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.moe import apply_moe, init_moe, init_shared_experts

KINDS = ("dense", "moe", "mla_dense", "mla_moe")
_MLA = ("mla_dense", "mla_moe")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port serves the dense, moe and "
        f"mla_moe families; the others come with a later slice")


def segments_for(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family == "dense":
        return [(("dense",), cfg.n_layers)]
    if cfg.family == "moe":
        return [(("moe",), cfg.n_layers)]
    if cfg.family == "mla_moe":
        segs = []
        if cfg.first_k_dense:
            segs.append((("mla_dense",), cfg.first_k_dense))
        segs.append((("mla_moe",), cfg.n_layers - cfg.first_k_dense))
        return segs
    raise _not_ported(f"family {cfg.family!r}")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise _not_ported(f"layer kind {kind!r}")


class Layer(nn.Module):
    """One layer's weights, named as the JAX tree: ``norm_attn``, ``attn``
    (GQA, or MLA for ``mla_*``), ``norm_mlp``, then ``mlp`` (``dense``,
    ``mla_dense``) or ``moe`` (``moe``, ``mla_moe``; the latter also
    ``shared`` when the config has shared experts)."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig, kind: str,
                 device=None, dtype=torch.float32):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        self.norm_attn = init_norm(d, cfg.norm, device, dtype)
        if kind in _MLA:
            self.attn = attn.init_mla(gen, cfg, device, dtype)
        else:
            self.attn = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.d_head, device, dtype)
        self.norm_mlp = init_norm(d, cfg.norm, device, dtype)
        if kind in ("dense", "mla_dense"):
            ff = (cfg.d_ff_dense if kind == "mla_dense" and cfg.d_ff_dense
                  else cfg.d_ff)
            self.mlp = init_mlp(gen, d, ff, cfg.act, device, dtype)
        else:
            self.moe = init_moe(gen, d, cfg.d_ff_expert, cfg.n_experts,
                                cfg.act, device, dtype)
            if kind == "mla_moe" and cfg.n_shared_experts:
                self.shared = init_shared_experts(
                    gen, d, cfg.d_ff_expert, cfg.n_shared_experts, cfg.act,
                    device, dtype)


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None,
               dtype=torch.float32) -> Layer:
    return Layer(gen, cfg, kind, device, dtype)


def _ffn(p: Layer, x: torch.Tensor, cfg: ArchConfig, kind: str,
         **moe_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's second half (without its residual): ``(y, aux)``."""
    xin = apply_norm(p.norm_mlp, x, cfg.norm)
    if kind in ("dense", "mla_dense"):
        return apply_mlp(p.mlp, xin, cfg.act), 0.0
    y, aux = apply_moe(p.moe, xin, n_experts=cfg.n_experts, top_k=cfg.top_k,
                       act=cfg.act, **moe_kw)
    if hasattr(p, "shared"):
        y = y + apply_mlp(p.shared, xin, cfg.act)
    return y, aux


def apply_layer(p: Layer, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, *, collect_kv: bool = False,
                attend: Callable = attn.flash_attention,
                moe_cf: Optional[float] = None):
    """Residual layer body over a full sequence; ``attend`` is the
    attention (the kernel for prefill, :func:`~.attention.mea_attention`
    in training); ``moe_cf`` overrides the MoE capacity factor (prefill's
    no-drop ``E / top_k``; training keeps the default 1.25).

    Returns ``(x, aux, kv)``: aux is the layer's load-balancing loss (0.0
    for the kinds without experts), kv its cache contribution (``{"k",
    "v"}``, or MLA's ``{"c", "k_rope"}``) when ``collect_kv``, else
    None."""
    _check_kind(kind)
    xin = apply_norm(p.norm_attn, x, cfg.norm)
    if kind in _MLA:
        h, (a, b) = attn.apply_mla(p.attn, xin, positions, cfg, attend=attend)
        names = ("c", "k_rope")
    else:
        h, (a, b) = attn.apply_gqa(p.attn, xin, positions,
                                   theta=cfg.rope_theta, attend=attend)
        names = ("k", "v")
    x = x + h
    kv = dict(zip(names, (a, b))) if collect_kv else None
    y, aux = _ffn(p, x, cfg, kind,
                  **({} if moe_cf is None else {"capacity_factor": moe_cf}))
    return x + y, aux, kv


def no_drop_capacity(cfg: ArchConfig) -> float:
    """The capacity factor at which no routed slot is dropped: E / top_k."""
    return float(cfg.n_experts) / cfg.top_k


def apply_layer_decode(p: Layer, x: torch.Tensor, pos: int,
                       cfg: ArchConfig, kind: str, cache: Dict):
    """x: ``[B, 1, D]``; cache: this layer's ``{"k", "v"}`` (MLA: ``{"c",
    "k_rope"}``), updated in place. The MoE routes the batch's B tokens as
    one group, at the no-drop capacity. MLA takes the absorbed decode where
    ``cfg`` has a true ``mla_absorb`` attribute (set with
    ``object.__setattr__``, as the JAX package's dry-run does). Returns
    ``(x, cache)``."""
    _check_kind(kind)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    xin = apply_norm(p.norm_attn, x, cfg.norm)
    if kind in _MLA:
        h, new_cache = attn.apply_mla(
            p.attn, xin, positions, cfg, cache=cache, cache_index=pos,
            absorb=getattr(cfg, "mla_absorb", False))
    else:
        h, new_cache = attn.apply_gqa(p.attn, xin, positions,
                                      theta=cfg.rope_theta, cache=cache,
                                      cache_index=pos)
    x = x + h
    moe_kw = ({} if kind in ("dense", "mla_dense") else
              {"group_size": x.shape[0],
               "capacity_factor": no_drop_capacity(cfg)})
    y, _ = _ffn(p, x, cfg, kind, **moe_kw)
    return x + y, new_cache


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, size: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    _check_kind(kind)
    if kind in _MLA:
        return attn.make_mla_cache(batch, size, cfg, dtype, device)
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
    over the segment's groups; MoE layers route at the no-drop capacity."""
    no_drop = no_drop_capacity(cfg) if cfg.n_experts else None
    kvs: Dict[str, List[Dict]] = {f"{i}_{kind}": []
                                  for i, kind in enumerate(kinds)}
    for group in seg:
        for i, kind in enumerate(kinds):
            key = f"{i}_{kind}"
            x, _, kv = apply_layer(group[key], x, positions, cfg, kind,
                                   collect_kv=True, moe_cf=no_drop)
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
