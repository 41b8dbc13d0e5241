"""Block assembly: per-layer-kind init/apply and the segments of layers.

A port of ``repro.models.blocks``. An architecture is a list of
*segments*, each a repeating group of layer kinds:

    dense, vlm:      [(("dense",), n_layers)]
    dbrx:            [(("moe",), n_layers)]
    deepseek-v2:     [(("mla_dense",), first_k_dense),
                      (("mla_moe",), n_layers - first_k_dense)]
    xlstm:           [(7 x "mlstm" + "slstm", n_layers // 8)]
    recurrentgemma:  [(("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]
    whisper:         encoder [(("enc",), L)] and decoder [(("dec",), L)]

Attention kinds (``dense``, ``moe``, ``attn``, ``lattn``, ``enc``,
``dec``) attend with GQA, ``mla_*`` with MLA; ``rec`` runs an RG-LRU block,
``mlstm`` / ``slstm`` an xLSTM block (these two have no FFN half). The
second half is a gated MLP or routed experts (``moe``; ``mla_moe`` adds
DeepSeek's shared experts). The JAX package stacks a segment's weights and
scans over them, the port keeps one module per group (``nn.ModuleDict``
keyed ``"{i}_{kind}"``, as the JAX tree is) and loops over them in Python.
Prefill caches are stacked per segment like the JAX package's, ``{key:
{name: [n_groups, ...]}}`` (k/v ``[n_groups, B, Hkv, S, dh]``, MLA's ``c``
and ``k_rope``, the recurrent kinds' states), so they compare leaf by leaf.
The training forward, :func:`apply_segment`, recomputes a group's
activations in the backward pass as the remat policy says (``"none"``,
``"full"``, ``"dots"``), as the JAX package's ``jax.checkpoint`` of a group
does.

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
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.moe import apply_moe, init_moe, init_shared_experts

_MLA = ("mla_dense", "mla_moe")
_GQA = ("dense", "moe", "attn", "lattn", "enc", "dec")
_MLP = ("dense", "enc", "dec", "lattn", "attn", "mla_dense", "rec")
_EXPERTS = ("moe", "mla_moe")
_XLSTM = ("mlstm", "slstm")
KINDS = _GQA + _MLA + ("rec",) + _XLSTM


def segments_for(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family in ("dense", "vlm"):
        return [(("dense",), cfg.n_layers)]
    if cfg.family == "moe":
        return [(("moe",), cfg.n_layers)]
    if cfg.family == "mla_moe":
        segs = []
        if cfg.first_k_dense:
            segs.append((("mla_dense",), cfg.first_k_dense))
        segs.append((("mla_moe",), cfg.n_layers - cfg.first_k_dense))
        return segs
    if cfg.family == "ssm":
        plen = len(cfg.pattern)
        if cfg.n_layers % plen:
            raise ValueError(f"ssm layers must tile the pattern: "
                             f"{cfg.n_layers} layers, pattern of {plen}")
        return [(tuple(cfg.pattern), cfg.n_layers // plen)]
    if cfg.family == "hybrid":
        plen = len(cfg.pattern)
        n_full = cfg.n_layers // plen
        segs = [(tuple(cfg.pattern), n_full)]
        rem = cfg.n_layers - n_full * plen
        if rem:
            segs.append((tuple(cfg.pattern[:rem]), 1))
        return segs
    if cfg.family == "audio_encdec":
        # the model holds the two stacks apart (lm.LM)
        return [(("enc",), cfg.n_layers), (("dec",), cfg.n_layers)]
    raise ValueError(cfg.family)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"layer kind {kind!r}: expected one of {KINDS}")


class Layer(nn.Module):
    """One layer's weights, named as the JAX tree by kind: ``norm_attn``
    and ``attn`` (GQA, or MLA for ``mla_*``), for ``dec`` also
    ``norm_cross`` and ``cross``; ``norm_rec`` and ``rec`` (``rec``);
    ``norm`` and ``block`` (``mlstm``, ``slstm``); ``norm_mlp`` then
    ``mlp`` or ``moe`` (``mla_moe`` also ``shared`` when the config has
    shared experts)."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig, kind: str,
                 device=None, dtype=torch.float32):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        if kind in _GQA:
            self.norm_attn = init_norm(d, cfg.norm, device, dtype)
            self.attn = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.d_head, device, dtype)
        if kind in _MLA:
            self.norm_attn = init_norm(d, cfg.norm, device, dtype)
            self.attn = attn.init_mla(gen, cfg, device, dtype)
        if kind == "dec":
            self.norm_cross = init_norm(d, cfg.norm, device, dtype)
            self.cross = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.d_head, device, dtype)
        if kind == "rec":
            self.norm_rec = init_norm(d, cfg.norm, device, dtype)
            self.rec = rec.init_rglru_block(gen, d, cfg.rnn_width,
                                            cfg.conv1d_width, device, dtype)
        if kind == "mlstm":
            self.norm = init_norm(d, cfg.norm, device, dtype)
            self.block = rec.init_mlstm_block(gen, d, cfg.rnn_width,
                                              cfg.n_heads, cfg.conv1d_width,
                                              device, dtype)
        if kind == "slstm":
            self.norm = init_norm(d, cfg.norm, device, dtype)
            self.block = rec.init_slstm_block(gen, d, cfg.n_heads, device,
                                              dtype)
        if kind in _MLP:
            self.norm_mlp = init_norm(d, cfg.norm, device, dtype)
            ff = (cfg.d_ff_dense if kind == "mla_dense" and cfg.d_ff_dense
                  else cfg.d_ff)
            self.mlp = init_mlp(gen, d, ff, cfg.act, device, dtype)
        if kind in _EXPERTS:
            self.norm_mlp = init_norm(d, cfg.norm, device, dtype)
            self.moe = init_moe(gen, d, cfg.d_ff_expert, cfg.n_experts,
                                cfg.act, device, dtype)
            if kind == "mla_moe" and cfg.n_shared_experts:
                self.shared = init_shared_experts(
                    gen, d, cfg.d_ff_expert, cfg.n_shared_experts, cfg.act,
                    device, dtype)


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None,
               dtype=torch.float32) -> Layer:
    return Layer(gen, cfg, kind, device, dtype)


def _residual(layout, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``; on a mesh reduced to the activations' layout (a
    row-parallel product's partial sum over tp is all-reduced here, as
    Megatron does after each half of a layer)."""
    return x + h if layout is None else layout.activation(x + h)


def _ffn(p: Layer, x: torch.Tensor, cfg: ArchConfig, kind: str,
         layout=None, **moe_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's second half (without its residual): ``(y, aux)``;
    routed experts through ``layout.moe`` on a mesh."""
    xin = apply_norm(p.norm_mlp, x, cfg.norm)
    if kind in _MLP:
        return apply_mlp(p.mlp, xin, cfg.act), 0.0
    moe = (apply_moe if layout is None
           else functools.partial(layout.moe, apply_moe))
    y, aux = moe(p.moe, xin, n_experts=cfg.n_experts, top_k=cfg.top_k,
                 act=cfg.act, **moe_kw)
    if hasattr(p, "shared"):
        y = y + apply_mlp(p.shared, xin, cfg.act)
    return y, aux


def _self_attention(p: Layer, xin, positions, cfg: ArchConfig, kind: str,
                    **kw):
    """The layer's GQA over its own sequence: causal with RoPE but for
    ``enc`` (neither) and ``dec`` (causal, no RoPE); ``lattn`` in its
    window."""
    return attn.apply_gqa(
        p.attn, xin, positions, theta=cfg.rope_theta,
        causal=kind != "enc", rope=kind not in ("enc", "dec"),
        window=cfg.attn_window if kind == "lattn" else 0, **kw)


def apply_layer(p: Layer, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, *, enc_out=None,
                collect_kv: bool = False,
                attend: Callable = attn.flash_attention,
                moe_cf: Optional[float] = None, layout=None):
    """Residual layer body over a full sequence; ``attend`` is the
    attention (the kernel for prefill, :func:`~.attention.mea_attention`
    in training); ``enc_out`` the encoder's output a ``dec`` layer attends
    to; ``moe_cf`` overrides the MoE capacity factor (prefill's no-drop
    ``E / top_k``; training keeps the default 1.25); ``layout`` the
    mesh's :class:`~repro_torch.sharding.dtensor.Layout` (``p`` then holds
    the weights at their point of use; ``attend`` already runs per rank).

    Returns ``(x, aux, kv)``: aux is the layer's load-balancing loss (0.0
    for the kinds without experts), kv its cache contribution when
    ``collect_kv`` (``{"k", "v"}``, ``lattn`` its last ``attn_window``
    keys, ``dec`` also ``{"cross_k", "cross_v"}``, MLA's ``{"c",
    "k_rope"}``, the recurrent kinds' states), else None."""
    _check_kind(kind)
    kv = None
    if kind in _XLSTM:
        body = (rec.apply_mlstm_block if kind == "mlstm"
                else rec.apply_slstm_block)
        res = body(p.block, apply_norm(p.norm, x, cfg.norm), cfg.n_heads,
                   return_state=collect_kv)
        h, kv = res if collect_kv else (res, None)
        return _residual(layout, x, h), 0.0, kv
    if kind == "rec":
        res = rec.apply_rglru_block(p.rec, apply_norm(p.norm_rec, x, cfg.norm),
                                    return_state=collect_kv, layout=layout)
        h, kv = res if collect_kv else (res, None)
        x = _residual(layout, x, h)
    elif kind in _MLA:
        h, (c, k_rope) = attn.apply_mla(
            p.attn, apply_norm(p.norm_attn, x, cfg.norm), positions, cfg,
            attend=attend)
        x = _residual(layout, x, h)
        if collect_kv:
            kv = {"c": c, "k_rope": k_rope}
    else:
        h, (k, v) = _self_attention(p, apply_norm(p.norm_attn, x, cfg.norm),
                                    positions, cfg, kind, attend=attend)
        x = _residual(layout, x, h)
        if collect_kv:
            if kind == "lattn":
                k = k[:, :, -cfg.attn_window:]
                v = v[:, :, -cfg.attn_window:]
            kv = {"k": k, "v": v}
        if kind == "dec":
            ck, cv = attn.encoder_kv(p.cross, enc_out)
            h, _ = attn.apply_gqa(
                p.cross, apply_norm(p.norm_cross, x, cfg.norm), positions,
                theta=cfg.rope_theta, causal=False, rope=False,
                cross_kv=(ck, cv), attend=attend)
            x = _residual(layout, x, h)
            if collect_kv:
                kv["cross_k"], kv["cross_v"] = ck, cv
    y, aux = _ffn(p, x, cfg, kind, layout,
                  **({} if moe_cf is None else {"capacity_factor": moe_cf}))
    return _residual(layout, x, y), aux, kv


def no_drop_capacity(cfg: ArchConfig) -> float:
    """The capacity factor at which no routed slot is dropped: E / top_k."""
    return float(cfg.n_experts) / cfg.top_k


def apply_layer_decode(p: Layer, x: torch.Tensor, pos: int,
                       cfg: ArchConfig, kind: str, cache: Dict, layout=None):
    """x: ``[B, 1, D]``; cache: this layer's cache (``{"k", "v"}``, MLA's
    ``{"c", "k_rope"}``, ``dec``'s with ``cross_k`` / ``cross_v``, a
    recurrent state). Attention caches are written in place; the
    recurrent kinds return their new state. A ``dec`` layer attends to the
    whole cross cache, unmasked, in plain PyTorch. The MoE routes the
    batch's B tokens as one group, at the no-drop capacity. MLA takes the
    absorbed decode where ``cfg`` has a true ``mla_absorb`` attribute (set
    with ``object.__setattr__``, as the JAX package's dry-run does).
    Returns ``(x, new cache)``."""
    _check_kind(kind)
    if kind in _XLSTM:
        step = (rec.apply_mlstm_decode if kind == "mlstm"
                else rec.apply_slstm_decode)
        if layout is not None:
            # the xLSTM blocks run replicated over tp: so do their states
            cache = {k: layout.replicate_tp(t) for k, t in cache.items()}
        h, new_cache = step(p.block, apply_norm(p.norm, x, cfg.norm), cache,
                            cfg.n_heads)
        return _residual(layout, x, h), new_cache
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    if kind == "rec":
        h, new_cache = rec.apply_rglru_decode(
            p.rec, apply_norm(p.norm_rec, x, cfg.norm), cache, layout)
    elif kind in _MLA:
        h, new_cache = attn.apply_mla(
            p.attn, apply_norm(p.norm_attn, x, cfg.norm), positions, cfg,
            cache=cache, cache_index=pos,
            absorb=getattr(cfg, "mla_absorb", False), layout=layout)
    else:
        h, new_cache = _self_attention(
            p, apply_norm(p.norm_attn, x, cfg.norm), positions, cfg, kind,
            cache=cache, cache_index=pos, layout=layout)
    x = _residual(layout, x, h)
    if kind == "dec":
        h, _ = attn.apply_gqa(
            p.cross, apply_norm(p.norm_cross, x, cfg.norm),
            torch.zeros_like(positions), theta=cfg.rope_theta, causal=False,
            rope=False, cross_kv=(cache["cross_k"], cache["cross_v"]),
            attend=(attn.mea_attention if layout is None
                    else layout.attend(attn.mea_attention)))
        x = _residual(layout, x, h)
    moe_kw = ({} if kind in _MLP else
              {"group_size": x.shape[0],
               "capacity_factor": no_drop_capacity(cfg)})
    y, _ = _ffn(p, x, cfg, kind, layout, **moe_kw)
    return _residual(layout, x, y), new_cache


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, size: int, dtype,
                     device=None, enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """One layer's empty decode cache: ``size`` positions of k/v (a
    ``lattn`` layer ``min(size, attn_window)``), ``dec`` also ``enc_len``
    cross positions; the recurrent kinds' initial states. An ``enc`` layer
    (the encoder runs once, in prefill) has none."""
    _check_kind(kind)
    if kind in _MLA:
        return attn.make_mla_cache(batch, size, cfg, dtype, device)
    if kind == "rec":
        return rec.rglru_init_state(batch, cfg.rnn_width, cfg.conv1d_width,
                                    dtype, device)
    if kind == "mlstm":
        return rec.mlstm_init_state(batch, cfg.rnn_width, cfg.n_heads,
                                    cfg.conv1d_width, device)
    if kind == "slstm":
        return rec.slstm_init_state(batch, cfg.d_model, cfg.n_heads, device)
    if kind == "enc":
        raise ValueError("an enc layer has no decode cache")
    if kind == "lattn":
        size = min(size, cfg.attn_window)
    c = attn.make_kv_cache(batch, cfg.n_kv_heads, size, cfg.d_head, dtype,
                           device)
    if kind == "dec":
        cross = attn.make_kv_cache(batch, cfg.n_kv_heads, enc_len, cfg.d_head,
                                   dtype, device)
        c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
    return c


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
                  kinds: Tuple[str, ...], *, remat_policy: str = "full",
                  enc_out=None, attend: Callable = attn.mea_attention,
                  layout=None):
    """The forward over the segment's groups, each under ``remat_policy``,
    without caches: the training forward (attention through
    :func:`~.attention.mea_attention`), or whisper's encoder in a prefill
    (``attend`` the kernel, remat ``"none"``). On a mesh (``layout``) each
    group takes its weights at their point of use inside the remat
    region, so the backward gathers them again. Returns ``(x, aux)``, aux
    summed over the layers."""
    if layout is not None:
        attend = layout.attend(attend)

    def group_body(group, xc, enc):
        aux = 0.0
        if layout is not None:
            group = layout.at_use(group)
        for i, kind in enumerate(kinds):
            xc, a, _ = apply_layer(group[f"{i}_{kind}"], xc, positions, cfg,
                                   kind, enc_out=enc, attend=attend,
                                   layout=layout)
            aux = aux + a
        return xc, aux

    body = _remat(group_body, remat_policy)
    aux = 0.0
    for group in seg:
        x, a = body(group, x, enc_out)
        aux = aux + a
    return x, aux


def apply_segment_prefill(seg: nn.ModuleList, x: torch.Tensor,
                          positions: torch.Tensor, cfg: ArchConfig,
                          kinds: Tuple[str, ...], *, enc_out=None,
                          attend: Callable = attn.flash_attention,
                          layout=None):
    """Full-sequence forward that also emits the per-layer cache, stacked
    over the segment's groups; MoE layers route at the no-drop capacity."""
    no_drop = no_drop_capacity(cfg) if cfg.n_experts else None
    if layout is not None:
        attend = layout.attend(attend)
    kvs: Dict[str, List[Dict]] = {f"{i}_{kind}": []
                                  for i, kind in enumerate(kinds)}
    for group in seg:
        if layout is not None:
            group = layout.at_use(group)
        for i, kind in enumerate(kinds):
            key = f"{i}_{kind}"
            x, _, kv = apply_layer(group[key], x, positions, cfg, kind,
                                   enc_out=enc_out, collect_kv=True,
                                   moe_cf=no_drop, attend=attend,
                                   layout=layout)
            kvs[key].append(kv)
    cache = {key: {name: torch.stack([kv[name] for kv in layers])
                   for name in layers[0]}
             for key, layers in kvs.items()}
    return x, cache


def apply_segment_decode(seg: nn.ModuleList, seg_cache: Dict,
                         x: torch.Tensor, pos: int, cfg: ArchConfig,
                         kinds: Tuple[str, ...], layout=None):
    """One decode step over the segment; each layer's slice of the stacked
    cache is updated in place (an attention layer writes its k/v slot, a
    recurrent layer's new state is copied over the old). Returns ``(x,
    seg_cache)``."""
    for g, group in enumerate(seg):
        if layout is not None:
            group = layout.at_use(group)
        for i, kind in enumerate(kinds):
            key = f"{i}_{kind}"
            layer_cache = {name: t[g] for name, t in seg_cache[key].items()}
            x, new = apply_layer_decode(group[key], x, pos, cfg, kind,
                                        layer_cache, layout)
            for name, t in new.items():
                if t is not layer_cache[name]:
                    layer_cache[name].copy_(t)
    return x, seg_cache


def init_segment_cache(cfg: ArchConfig, kinds: Tuple[str, ...], n_groups: int,
                       batch: int, size: int, dtype, device=None,
                       enc_len: int = 0) -> Dict:
    one = {f"{i}_{kind}": init_layer_cache(cfg, kind, batch, size, dtype,
                                           device, enc_len)
           for i, kind in enumerate(kinds)}
    return {key: {name: t.expand((n_groups,) + t.shape).clone()
                  for name, t in c.items()}
            for key, c in one.items()}
