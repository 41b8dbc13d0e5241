"""GQA attention: prefill through the flash-attention kernel, cached decode.

A port of the GQA part of ``repro.models.attention``. Where the JAX package
computes prefill attention with its XLA path (``mea_attention``), the port
calls :func:`repro_torch.kernels.flash_attention.ops.flash_attention`, which
computes the same function: the hand-written kernel for a CUDA tensor, the
plain version for a CPU tensor. Decode attends one token against the cache
in plain PyTorch, as the JAX package does outside any Pallas kernel.

Layouts are the JAX package's: ``wq`` ``[D, H, dh]``, ``wk``/``wv``
``[D, Hkv, dh]``, ``wo`` ``[H, dh, D]``, q ``[B, H, S, dh]`` and the KV
cache ``[B, Hkv, S_cache, dh]``. Decode writes the new token's k/v into the
cache tensors in place (the JAX package returns updated copies): a serving
cache is the largest thing on the device, and a copy per token would
double it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import _normal, apply_rope

NEG_INF = -1e30
_LATER = "not ported yet: it comes with the slice of the families that use it"


class GQA(nn.Module):
    """Grouped-query attention weights, in the JAX package's layouts."""

    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 n_kv: int, d_head: int, device=None, dtype=torch.float32):
        super().__init__()
        s = d_model ** -0.5
        so = (n_heads * d_head) ** -0.5
        self.wq = _normal(gen, (d_model, n_heads, d_head), s, device, dtype)
        self.wk = _normal(gen, (d_model, n_kv, d_head), s, device, dtype)
        self.wv = _normal(gen, (d_model, n_kv, d_head), s, device, dtype)
        self.wo = _normal(gen, (n_heads, d_head, d_model), so, device, dtype)


def init_gqa(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
             d_head: int, device=None, dtype=torch.float32) -> GQA:
    return GQA(gen, d_model, n_heads, n_kv, d_head, device, dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, D]`` · w ``[D, H, dh]`` -> ``[B, S, H, dh]``."""
    d, h, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * dh)).reshape(
        x.shape[0], x.shape[1], h, dh)


def apply_gqa(p: GQA, x: torch.Tensor, positions: torch.Tensor, *,
              theta: float, window: int = 0, cache: Optional[Dict] = None,
              cache_index: Optional[int] = None, cross_kv=None):
    """Causal GQA self-attention with RoPE.

    Prefill (``cache is None``): full-sequence attention through
    ``flash_attention``; returns ``(y, (k, v))`` with k, v ``[B, Hkv, S,
    dh]``. Decode (``cache={"k", "v"}`` of ``[B, Hkv, S_cache, dh]``,
    ``cache_index`` the new token's position): writes the token's k/v into
    the cache in place and returns ``(y, cache)``.
    """
    if window > 0:
        raise NotImplementedError(
            f"window > 0 (local attention of the hybrid family) is {_LATER}")
    if cross_kv is not None:
        raise NotImplementedError(
            f"cross_kv (the audio_encdec family's cross-attention) is {_LATER}")
    dt = x.dtype
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    q = q.transpose(1, 2).contiguous()      # [B, H, S, dh]
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()

    if cache is not None:
        # decode: s == 1; insert at cache_index
        ck, cv = cache["k"], cache["v"]
        ck[:, :, cache_index:cache_index + 1].copy_(k)
        cv[:, :, cache_index:cache_index + 1].copy_(v)
        out = _decode_attention(q, ck.to(dt), cv.to(dt), cache_index)
    else:
        out = flash_attention(q, k, v, causal=True)
    hq, dh, d = p.wo.shape
    y = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], hq * dh) @ \
        p.wo.to(dt).reshape(hq * dh, d)
    if cache is not None:
        return y, cache
    return y, (k, v)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache_index: int) -> torch.Tensor:
    """Single-token attention against a cache. q: ``[B, Hq, 1, d]``, k/v:
    ``[B, Hkv, S, d]``; keys at positions ``<= cache_index`` count."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, 1, d).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    scores = scores / (d ** 0.5)
    valid = torch.arange(s, device=q.device) <= cache_index
    scores = scores.masked_fill(~valid, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def make_kv_cache(batch: int, n_kv: int, size: int, d_head: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, n_kv, size, d_head), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv, size, d_head), dtype=dtype,
                         device=device),
    }
