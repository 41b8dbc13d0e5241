"""Top-level LM assembly: init, train loss, prefill, decode.

A port of ``repro.models.lm`` for the ``dense``, ``moe`` (dbrx) and
``mla_moe`` (deepseek-v2) families: the training objective ``loss_fn``
(next-token cross entropy through :func:`chunked_xent` plus ``aux_weight``
times the MoE load-balancing loss summed over the layers; attention
through ``mea_attention``, which has a gradient), and the serving steps
``prefill_step`` (full-sequence forward emitting last-position logits and
the caches, attention through the flash-attention kernel) and
``decode_step`` (one new token against the caches).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models import blocks
from repro_torch.models.moe import quantize_expert_weights
from repro_torch.models.layers import (_normal, apply_norm, embed_tokens,
                                       init_embed, init_norm)


class LM(nn.Module):
    """The parameters of one model, named as the JAX package's tree:
    ``embed.tokens``, ``segments[s][g]["{i}_{kind}"]``, ``final_norm`` and,
    without tied embeddings, ``lm_head.w``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embed(gen, cfg.vocab, cfg.d_model, device, dtype)
        self.segments = nn.ModuleList(
            blocks.init_segment(gen, cfg, kinds, n, device, dtype)
            for kinds, n in blocks.segments_for(cfg))
        self.final_norm = init_norm(cfg.d_model, cfg.norm, device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Module()
            self.lm_head.w = _normal(gen, (cfg.d_model, cfg.vocab),
                                     cfg.d_model ** -0.5, device, dtype)


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
    for seg in params.segments:
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


def _backbone(params: LM, x: torch.Tensor, positions: torch.Tensor,
              cfg: ArchConfig, remat_policy: str):
    aux = 0.0
    for (kinds, _), seg in zip(blocks.segments_for(cfg), params.segments):
        x, a = blocks.apply_segment(seg, x, positions, cfg, kinds,
                                    remat_policy=remat_policy)
        aux = aux + a
    return apply_norm(params.final_norm, x, cfg.norm), aux


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            dtype=torch.bfloat16, remat_policy: str = "full",
            aux_weight: float = 0.01):
    """Train objective: the mean next-token cross entropy of
    ``batch["tokens"]`` against ``batch["labels"]`` (``[B, S]``; a negative
    label is masked out), computed in ``dtype`` from the fp32 weights.
    Returns ``(loss, {"xent", "aux"})``; the loss has a gradient."""
    if cfg.family in ("vlm", "audio_encdec"):
        raise blocks._not_ported(f"the {cfg.family!r} family's loss")
    dev = _device(params)
    tokens = batch["tokens"].to(dev)
    b, s = tokens.shape
    x = embed_tokens(params.embed, tokens, dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    x, aux = _backbone(params, x, pos, cfg, remat_policy)
    labels = batch["labels"].to(dev)
    mask = (labels >= 0).float()
    xent = chunked_xent(x, _head_weight(params, cfg),
                        torch.clamp(labels, min=0), mask)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


@torch.inference_mode()
def prefill_step(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 *, dtype=torch.bfloat16):
    """Full forward over ``batch["tokens"]`` ``[B, S]``; returns the last
    position's logits ``[B, 1, V]`` in fp32 and the caches (one stacked
    dict per segment) for decode."""
    tokens = batch["tokens"].to(_device(params))
    x = embed_tokens(params.embed, tokens, dtype)
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    caches: List[Dict] = []
    for (kinds, _), seg in zip(blocks.segments_for(cfg), params.segments):
        x, c = blocks.apply_segment_prefill(seg, x, pos, cfg, kinds)
        caches.append(c)
    x = apply_norm(params.final_norm, x, cfg.norm)
    w = _head_weight(params, cfg)
    logits = (x[:, -1:] @ w.to(x.dtype)).float()
    return logits, caches


@torch.inference_mode()
def decode_step(params: LM, cache: List[Dict], tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, *, dtype=torch.bfloat16):
    """One token. tokens: ``[B, 1]``; pos: the token's position; cache from
    :func:`init_cache` / :func:`prefill_step`, written in place. Returns
    ``(logits [B, 1, V] fp32, cache)``."""
    x = embed_tokens(params.embed, tokens.to(_device(params)), dtype)
    for (kinds, _), seg, c in zip(blocks.segments_for(cfg), params.segments,
                                  cache):
        x, _ = blocks.apply_segment_decode(seg, c, x, pos, cfg, kinds)
    x = apply_norm(params.final_norm, x, cfg.norm)
    w = _head_weight(params, cfg)
    logits = (x @ w.to(x.dtype)).float()
    return logits, cache


def init_cache(cfg: ArchConfig, batch: int, size: int, dtype=torch.bfloat16,
               device: Optional[Device] = None) -> List[Dict]:
    device = resolve_device(device)
    return [blocks.init_segment_cache(cfg, kinds, n, batch, size, dtype,
                                      device)
            for kinds, n in blocks.segments_for(cfg)]
