"""Top-level LM assembly: init, train loss, prefill, decode.

A port of ``repro.models.lm`` for every family: ``dense``, ``moe`` (dbrx),
``mla_moe`` (deepseek-v2), ``ssm`` (xlstm), ``hybrid`` (recurrentgemma),
``vlm`` (llava-next: stub patch embeddings prepended to the tokens) and
``audio_encdec`` (whisper: an encoder over stub frame embeddings, a
decoder that attends to it, sinusoidal positions on both). The training
objective ``loss_fn`` (next-token cross entropy through
:func:`chunked_xent` plus ``aux_weight`` times the MoE load-balancing loss
summed over the layers; attention through ``mea_attention``, which has a
gradient), and the serving steps ``prefill_step`` (full-sequence forward
emitting last-position logits and the caches, attention through the
flash-attention kernel) and ``decode_step`` (one new token against the
caches).

A model whose parameters are DTensors on a mesh
(:mod:`repro_torch.sharding.dtensor`) carries a ``layout``; the same steps
then take its inputs batch-sharded over the data dims and use each layer's
weights as the layout gives them (:func:`input_specs` gives every cell's
inputs on ``meta`` for the dry run).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.moe import quantize_expert_weights
from repro_torch.models.layers import (_normal, apply_norm, embed_tokens,
                                       init_embed, init_norm)


class LM(nn.Module):
    """The parameters of one model, named as the JAX package's tree:
    ``embed.tokens``, ``segments[s][g]["{i}_{kind}"]`` (``audio_encdec``:
    ``enc_segments``, ``dec_segments`` and ``enc_norm`` instead),
    ``final_norm`` and, without tied embeddings, ``lm_head.w``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embed(gen, cfg.vocab, cfg.d_model, device, dtype)
        if cfg.family == "audio_encdec":
            self.enc_segments = nn.ModuleList([blocks.init_segment(
                gen, cfg, ("enc",), cfg.n_layers, device, dtype)])
            self.dec_segments = nn.ModuleList([blocks.init_segment(
                gen, cfg, ("dec",), cfg.n_layers, device, dtype)])
            self.enc_norm = init_norm(cfg.d_model, cfg.norm, device, dtype)
        else:
            self.segments = nn.ModuleList(
                blocks.init_segment(gen, cfg, kinds, n, device, dtype)
                for kinds, n in blocks.segments_for(cfg))
        self.final_norm = init_norm(cfg.d_model, cfg.norm, device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Module()
            self.lm_head.w = _normal(gen, (cfg.d_model, cfg.vocab),
                                     cfg.d_model ** -0.5, device, dtype)


def _stacks(params: LM, cfg: ArchConfig):
    """``(kinds, segment)`` of the decoding stack: the segments, or
    whisper's decoder."""
    if cfg.family == "audio_encdec":
        return [(("dec",), seg) for seg in params.dec_segments]
    return [(kinds, seg) for (kinds, _), seg in zip(blocks.segments_for(cfg),
                                                     params.segments)]


def init_params(cfg: ArchConfig, *, device: Optional[Device] = None,
                dtype=torch.float32, seed: int = 0) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None`` -> the GPU, raising without one; ``"meta"``: shapes
    and dtypes only, no storage)."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return LM(cfg, gen, device, dtype)


def quantize_experts(params: LM) -> LM:
    """Every MoE layer's experts to int8 with per-(expert, out-channel)
    scales (:func:`~.moe.quantize_expert_weights`), in place; returns
    ``params``. Serving only: int8 weights have no gradient."""
    for seg in getattr(params, "segments", []):
        for group in seg:
            for layer in group.values():
                if hasattr(layer, "moe"):
                    layer.moe = quantize_expert_weights(layer.moe)
    return params


def _layout(params: LM):
    """The mesh layout of a sharded model
    (:func:`repro_torch.sharding.dtensor.distribute_model`), else None."""
    return getattr(params, "layout", None)


def _use(params: LM, module):
    """``module``'s weights at their point of use (on a mesh: gathered
    over the dp dims)."""
    layout = _layout(params)
    return module if layout is None else layout.at_use(module)


@contextlib.contextmanager
def _on_mesh(params: LM, inference: bool = False):
    """A step's context: ``inference`` steps run under
    ``torch.inference_mode()``, or on a mesh under ``torch.no_grad()``
    (DTensor cannot take a view of a parameter inside inference mode). On
    a mesh, plain tensors made inside a step (positions, masks, zeros)
    count as replicated beside the DTensors; a sharded step's backward
    pass must run in ``implicit_replication()`` too."""
    if _layout(params) is None:
        with torch.inference_mode() if inference else contextlib.nullcontext():
            yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), \
            torch.no_grad() if inference else contextlib.nullcontext():
        yield


def _sharded(params: LM, t: torch.Tensor) -> torch.Tensor:
    """An input as the model's layout takes it: on a mesh, batch-sharded
    over the dp dims (every rank passing the same values), else as is."""
    layout = _layout(params)
    if layout is None or not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor
    return t if isinstance(t, DTensor) else layout.shard(t)


def _embed(params: LM, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The token embeddings ``[B, S, D]`` in ``dtype``; on a mesh, looked
    up per vocab shard and reduced to batch-sharded, replicated over tp."""
    layout = _layout(params)
    if layout is None:
        return embed_tokens(params.embed, tokens, dtype)
    x = layout.embed(layout.at_use(params.embed).tokens,
                     _sharded(params, tokens))
    return layout.activation(x).to(dtype)


def _head_weight(params: LM, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return _use(params, params.embed).tokens.T
    return _use(params, params.lm_head).w


def _device(params: LM) -> torch.device:
    return params.embed.tokens.device


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent_sums(x, w, labels, mask):
    """``(sum of the masked per-token losses, sum of the mask)`` of one
    slice of the sequence: logits in fp32."""
    logits = (x @ w.to(x.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_xent(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, chunk: int = 2048,
                 sums: Callable = _xent_sums) -> torch.Tensor:
    """Cross entropy without materialising ``[B, S, V]`` logits.

    x ``[B, S, D]`` activations; w ``[D, V]``; labels ``[B, S]`` int; mask
    ``[B, S]``. Past ``chunk`` tokens the sequence goes in ``chunk``-sized
    slices, each recomputed in the backward pass, so at most one slice's
    logits live at a time, forward or backward (the JAX package scans the
    slices). ``sums``: a slice's ``(loss sum, mask sum)`` (on a mesh, the
    vocab-parallel :meth:`~repro_torch.sharding.dtensor.Layout.xent_sums`).
    """
    b, s, _ = x.shape
    if s <= chunk:
        tot, cnt = sums(x, w, labels, mask)
        return tot / torch.clamp(cnt, min=1.0)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        t, n = checkpoint(sums, x[:, c0:c0 + chunk], w,
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


@functools.lru_cache(maxsize=None)
def _sinusoid_frequencies(d: int, device: torch.device) -> torch.Tensor:
    """The reference's frequencies, computed in numpy (float64), used in
    float32; copied to ``device`` once (a copy from pageable host memory
    synchronises the stream)."""
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    with torch.inference_mode(False):
        return torch.from_numpy(freqs.astype(np.float32)).to(device)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings ``[..., d]`` fp32."""
    ang = positions[..., None].float() * _sinusoid_frequencies(
        d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _positions(params: LM, b: int, s: int, device) -> torch.Tensor:
    return _sharded(params, torch.arange(s, dtype=torch.int32,
                                         device=device)[None].expand(b, s))


def _backbone(params: LM, x: torch.Tensor, positions: torch.Tensor,
              cfg: ArchConfig, remat_policy: str, enc_out=None,
              attend: Callable = attn.mea_attention):
    aux = 0.0
    for kinds, seg in _stacks(params, cfg):
        x, a = blocks.apply_segment(seg, x, positions, cfg, kinds,
                                    remat_policy=remat_policy,
                                    enc_out=enc_out, attend=attend,
                                    layout=_layout(params))
        aux = aux + a
    return apply_norm(_use(params, params.final_norm), x, cfg.norm), aux


def _encode(params: LM, frames: torch.Tensor, cfg: ArchConfig,
            remat_policy: str, attend: Callable) -> torch.Tensor:
    """whisper's encoder over ``frames`` ``[B, S_enc, D]`` (already in the
    compute dtype): sinusoidal positions, the ``enc`` layers (not causal,
    no RoPE) attending through ``attend`` under ``remat_policy``,
    ``enc_norm``."""
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)[None]
    x = frames + _sinusoidal(pos, cfg.d_model).to(frames.dtype)
    for seg in params.enc_segments:
        x, _ = blocks.apply_segment(seg, x, pos, cfg, ("enc",),
                                    remat_policy=remat_policy, attend=attend,
                                    layout=_layout(params))
    return apply_norm(_use(params, params.enc_norm), x, cfg.norm)


def _inputs(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            dtype):
    """The decoding stack's input ``[B, S, D]`` in ``dtype`` and the
    number of patch positions before the tokens (``vlm``; else 0):
    ``vlm`` prepends ``batch["patches"]`` to the token embeddings,
    ``audio_encdec`` adds sinusoidal positions to them."""
    dev = _device(params)
    x = _embed(params, batch["tokens"].to(dev), dtype)
    if cfg.family == "vlm":
        patches = _sharded(params, batch["patches"].to(dev, dtype))
        return torch.cat([patches, x], dim=1), patches.shape[1]
    if cfg.family == "audio_encdec":
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)[None]
        x = x + _sinusoidal(pos, cfg.d_model).to(dtype)
    return x, 0


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            dtype=torch.bfloat16, remat_policy: str = "full",
            aux_weight: float = 0.01, attend: Callable = attn.mea_attention):
    """Train objective: the mean next-token cross entropy of
    ``batch["tokens"]`` against ``batch["labels"]`` (``[B, S]``; a negative
    label is masked out), computed in ``dtype`` from the fp32 weights;
    ``vlm`` also takes ``batch["patches"]`` ``[B, n_patches, D]`` (their
    positions carry no label), ``audio_encdec`` ``batch["frames"]`` ``[B,
    S_enc, D]``. ``attend``: the training attention
    (:func:`~.attention.mea_attention`, or the packed form). Returns
    ``(loss, {"xent", "aux"})``; the loss has a gradient.

    A sharded model (its parameters DTensors on a mesh) takes the same
    global batch on every rank, or DTensors; its loss is a DTensor, and
    its backward pass runs under ``implicit_replication()``."""
    with _on_mesh(params):
        return _loss(params, batch, cfg, dtype, remat_policy, aux_weight,
                     attend)


def _loss(params, batch, cfg, dtype, remat_policy, aux_weight, attend):
    dev = _device(params)
    enc_out = None
    if cfg.family == "audio_encdec":
        enc_out = _encode(params,
                          _sharded(params, batch["frames"].to(dev, dtype)),
                          cfg, remat_policy, attend)
    x, n_img = _inputs(params, batch, cfg, dtype)
    b, s = x.shape[:2]
    x, aux = _backbone(params, x, _positions(params, b, s, dev), cfg,
                       remat_policy, enc_out, attend)
    labels = _sharded(params, batch["labels"].to(dev))
    if n_img:
        labels = torch.cat([torch.full((b, n_img), -1, dtype=labels.dtype,
                                       device=dev), labels], dim=1)
    mask = (labels >= 0).float()
    layout = _layout(params)
    xent = chunked_xent(x, _head_weight(params, cfg),
                        torch.clamp(labels, min=0), mask,
                        sums=_xent_sums if layout is None
                        else functools.partial(layout.xent_sums,
                                               plain=_xent_sums))
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def prefill_step(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 *, dtype=torch.bfloat16,
                 attend: Callable = attn.flash_attention):
    """Full forward over ``batch["tokens"]`` ``[B, S]`` (``vlm``: after
    ``batch["patches"]``; ``audio_encdec``: attending to the encoding of
    ``batch["frames"]``); returns the last position's logits ``[B, 1, V]``
    in fp32 and the caches (one stacked dict per segment) for decode.
    ``attend``: the attention (the flash-attention kernel; on a mesh, run
    per rank)."""
    with _on_mesh(params, inference=True):
        enc_out = None
        if cfg.family == "audio_encdec":
            enc_out = _encode(params, _sharded(params, batch["frames"].to(
                _device(params), dtype)), cfg, "none", attend)
        x, _ = _inputs(params, batch, cfg, dtype)
        pos = _positions(params, x.shape[0], x.shape[1], x.device)
        caches: List[Dict] = []
        for kinds, seg in _stacks(params, cfg):
            x, c = blocks.apply_segment_prefill(seg, x, pos, cfg, kinds,
                                                enc_out=enc_out, attend=attend,
                                                layout=_layout(params))
            caches.append(c)
        x = apply_norm(_use(params, params.final_norm), x, cfg.norm)
        w = _head_weight(params, cfg)
        logits = (x[:, -1:] @ w.to(x.dtype)).float()
        return logits, caches


def decode_step(params: LM, cache: List[Dict], tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, *, dtype=torch.bfloat16):
    """One token. tokens: ``[B, 1]``; pos: the token's position; cache from
    :func:`init_cache` / :func:`prefill_step`, updated in place. Returns
    ``(logits [B, 1, V] fp32, cache)``."""
    with _on_mesh(params, inference=True):
        dev = _device(params)
        x = _embed(params, tokens.to(dev), dtype)
        if cfg.family == "audio_encdec":
            x = x + _sinusoidal(torch.full((1, 1), pos, dtype=torch.int32,
                                           device=dev), cfg.d_model).to(dtype)
        for (kinds, seg), c in zip(_stacks(params, cfg), cache):
            x, _ = blocks.apply_segment_decode(seg, c, x, pos, cfg, kinds,
                                               layout=_layout(params))
        x = apply_norm(_use(params, params.final_norm), x, cfg.norm)
        w = _head_weight(params, cfg)
        logits = (x @ w.to(x.dtype)).float()
        return logits, cache


def init_cache(cfg: ArchConfig, batch: int, size: int, dtype=torch.bfloat16,
               device: Optional[Device] = None,
               enc_len: int = 1500) -> List[Dict]:
    """Empty decode caches for ``size`` positions (``audio_encdec``: its
    decoder's, with ``enc_len`` cross positions, by default whisper's
    1,500 frames)."""
    device = resolve_device(device)
    if cfg.family == "audio_encdec":
        return [blocks.init_segment_cache(cfg, ("dec",), cfg.n_layers, batch,
                                          size, dtype, device, enc_len)]
    return [blocks.init_segment_cache(cfg, kinds, n, batch, size, dtype,
                                      device)
            for kinds, n in blocks.segments_for(cfg)]


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins; no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict:
    """Every model input of this cell as a tensor on the ``meta`` device,
    with the JAX package's keys, shapes and dtypes: ``vlm`` puts its
    ``n_patches`` patches before the tokens, ``audio_encdec`` has ``s //
    2`` frames; decode is one new token against a ``seq_len`` cache built
    by :func:`init_cache` (``pos`` a 0-d int32)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def t(shape_, dt=torch.int32):
        return torch.empty(shape_, dtype=dt, device=meta)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            n_img = cfg.n_patches
            out = {"patches": t((b, n_img, cfg.d_model), dtype),
                   "tokens": t((b, s - n_img))}
            n_lab = s - n_img
        elif cfg.family == "audio_encdec":
            out = {"frames": t((b, s // 2, cfg.d_model), dtype),
                   "tokens": t((b, s // 2))}
            n_lab = s // 2
        else:
            out = {"tokens": t((b, s))}
            n_lab = s
        if shape.kind == "train":
            out["labels"] = t((b, n_lab))
        return out
    # decode: one new token against a seq_len cache
    return {"cache": init_cache(cfg, b, s, dtype, device=meta),
            "tokens": t((b, 1)), "pos": t(())}
