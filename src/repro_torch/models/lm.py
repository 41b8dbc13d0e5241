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
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
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
    ``device`` (``None`` -> the GPU, raising without one)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
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


def _head_weight(params: LM, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.tokens.T
    return params.lm_head.w


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
                 mask: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Cross entropy without materialising ``[B, S, V]`` logits.

    x ``[B, S, D]`` activations; w ``[D, V]``; labels ``[B, S]`` int; mask
    ``[B, S]``. Past ``chunk`` tokens the sequence goes in ``chunk``-sized
    slices, each recomputed in the backward pass, so at most one slice's
    logits live at a time, forward or backward (the JAX package scans the
    slices).
    """
    b, s, _ = x.shape
    if s <= chunk:
        tot, cnt = _xent_sums(x, w, labels, mask)
        return tot / torch.clamp(cnt, min=1.0)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        t, n = checkpoint(_xent_sums, x[:, c0:c0 + chunk], w,
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


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _backbone(params: LM, x: torch.Tensor, positions: torch.Tensor,
              cfg: ArchConfig, remat_policy: str, enc_out=None):
    aux = 0.0
    for kinds, seg in _stacks(params, cfg):
        x, a = blocks.apply_segment(seg, x, positions, cfg, kinds,
                                    remat_policy=remat_policy,
                                    enc_out=enc_out)
        aux = aux + a
    return apply_norm(params.final_norm, x, cfg.norm), aux


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
                                    remat_policy=remat_policy, attend=attend)
    return apply_norm(params.enc_norm, x, cfg.norm)


def _inputs(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            dtype):
    """The decoding stack's input ``[B, S, D]`` in ``dtype`` and the
    number of patch positions before the tokens (``vlm``; else 0):
    ``vlm`` prepends ``batch["patches"]`` to the token embeddings,
    ``audio_encdec`` adds sinusoidal positions to them."""
    dev = _device(params)
    x = embed_tokens(params.embed, batch["tokens"].to(dev), dtype)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dev, dtype)
        return torch.cat([patches, x], dim=1), patches.shape[1]
    if cfg.family == "audio_encdec":
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)[None]
        x = x + _sinusoidal(pos, cfg.d_model).to(dtype)
    return x, 0


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            dtype=torch.bfloat16, remat_policy: str = "full",
            aux_weight: float = 0.01):
    """Train objective: the mean next-token cross entropy of
    ``batch["tokens"]`` against ``batch["labels"]`` (``[B, S]``; a negative
    label is masked out), computed in ``dtype`` from the fp32 weights;
    ``vlm`` also takes ``batch["patches"]`` ``[B, n_patches, D]`` (their
    positions carry no label), ``audio_encdec`` ``batch["frames"]`` ``[B,
    S_enc, D]``. Returns ``(loss, {"xent", "aux"})``; the loss has a
    gradient."""
    dev = _device(params)
    enc_out = None
    if cfg.family == "audio_encdec":
        enc_out = _encode(params, batch["frames"].to(dev, dtype), cfg,
                          remat_policy, attn.mea_attention)
    x, n_img = _inputs(params, batch, cfg, dtype)
    b, s = x.shape[:2]
    x, aux = _backbone(params, x, _positions(b, s, dev), cfg, remat_policy,
                       enc_out)
    labels = batch["labels"].to(dev)
    if n_img:
        labels = torch.cat([torch.full((b, n_img), -1, dtype=labels.dtype,
                                       device=dev), labels], dim=1)
    mask = (labels >= 0).float()
    xent = chunked_xent(x, _head_weight(params, cfg),
                        torch.clamp(labels, min=0), mask)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


@torch.inference_mode()
def prefill_step(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 *, dtype=torch.bfloat16):
    """Full forward over ``batch["tokens"]`` ``[B, S]`` (``vlm``: after
    ``batch["patches"]``; ``audio_encdec``: attending to the encoding of
    ``batch["frames"]``); returns the last position's logits ``[B, 1, V]``
    in fp32 and the caches (one stacked dict per segment) for decode."""
    enc_out = None
    if cfg.family == "audio_encdec":
        enc_out = _encode(params, batch["frames"].to(_device(params), dtype),
                          cfg, "none", attn.flash_attention)
    x, _ = _inputs(params, batch, cfg, dtype)
    pos = _positions(x.shape[0], x.shape[1], x.device)
    caches: List[Dict] = []
    for kinds, seg in _stacks(params, cfg):
        x, c = blocks.apply_segment_prefill(seg, x, pos, cfg, kinds,
                                            enc_out=enc_out)
        caches.append(c)
    x = apply_norm(params.final_norm, x, cfg.norm)
    w = _head_weight(params, cfg)
    logits = (x[:, -1:] @ w.to(x.dtype)).float()
    return logits, caches


@torch.inference_mode()
def decode_step(params: LM, cache: List[Dict], tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, *, dtype=torch.bfloat16):
    """One token. tokens: ``[B, 1]``; pos: the token's position; cache from
    :func:`init_cache` / :func:`prefill_step`, updated in place. Returns
    ``(logits [B, 1, V] fp32, cache)``."""
    dev = _device(params)
    x = embed_tokens(params.embed, tokens.to(dev), dtype)
    if cfg.family == "audio_encdec":
        x = x + _sinusoidal(torch.full((1, 1), pos, dtype=torch.int32,
                                       device=dev), cfg.d_model).to(dtype)
    for (kinds, seg), c in zip(_stacks(params, cfg), cache):
        x, _ = blocks.apply_segment_decode(seg, c, x, pos, cfg, kinds)
    x = apply_norm(params.final_norm, x, cfg.norm)
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
