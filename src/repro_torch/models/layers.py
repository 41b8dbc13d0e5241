"""Core layers: norms, MLPs, embeddings, RoPE, the softmax cross entropy.

A port of ``repro.models.layers``. Parameters live in ``nn.Module``s whose
attribute names are the JAX package's dictionary keys (``scale``, ``wi``,
``tokens``, ...) and whose tensors keep its layouts, so a JAX parameter tree
carries across leaf by leaf (:mod:`repro_torch.models.convert`). Weights are
stored in ``param_dtype`` (fp32 master) and cast to the compute dtype at the
point of use; the apply functions are plain functions of a module and a
tensor. Random initialisation draws from an explicit ``torch.Generator``
that lives on the parameters' device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _normal(gen: torch.Generator, shape, scale: float, device,
            dtype) -> nn.Parameter:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return nn.Parameter((scale * w).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, d: int, kind: str, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), device=device, dtype=dtype))
        if kind != "rmsnorm":
            self.bias = nn.Parameter(torch.zeros((d,), device=device,
                                                 dtype=dtype))


def init_norm(d: int, kind: str, device=None, dtype=torch.float32) -> Norm:
    return Norm(d, kind, device, dtype)


def apply_norm(p: Norm, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm with fp32 statistics."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p.scale.float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``wi`` and ``wo`` (and the gate ``wg`` for swiglu / geglu); ``wi``
    and ``wg`` are ``[d, f]``, ``wo`` is ``[f, d]``."""

    def __init__(self, gen: torch.Generator, d: int, f: int, act: str,
                 device=None, dtype=torch.float32):
        super().__init__()
        s_in, s_out = d ** -0.5, f ** -0.5
        self.wi = _normal(gen, (d, f), s_in, device, dtype)
        if act in ("swiglu", "geglu"):
            self.wg = _normal(gen, (d, f), s_in, device, dtype)
        self.wo = _normal(gen, (f, d), s_out, device, dtype)


def init_mlp(gen: torch.Generator, d: int, f: int, act: str, device=None,
             dtype=torch.float32) -> MLP:
    return MLP(gen, d, f, act, device, dtype)


def apply_mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    h = x @ p.wi.to(dt)
    if act == "swiglu":
        h = F.silu(x @ p.wg.to(dt)) * h
    elif act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p.wg.to(dt), approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """``tokens`` ``[vocab, d]``."""

    def __init__(self, gen: torch.Generator, vocab: int, d: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.tokens = _normal(gen, (vocab, d), 1.0, device, dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, device=None,
               dtype=torch.float32) -> Embed:
    return Embed(gen, vocab, d, device, dtype)


def embed_tokens(p: Embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # F.embedding, not indexing: on CUDA its gradient sums each row's
    # contributions in a fixed order (indexing's backward may add them with
    # atomics), so a training step gives the same bits every time it runs
    return F.embedding(tokens.long(), p.tokens).to(dtype)


def unembed(p_embed: Embed, p_head, x: torch.Tensor,
            tie: bool) -> torch.Tensor:
    """Project to logits in fp32 for a stable softmax-xent; ``p_head`` has
    ``w`` ``[d, vocab]`` (unused with tied embeddings)."""
    if tie:
        return (x @ p_embed.tokens.to(x.dtype).T).float()
    return (x @ p_head.w.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _device_frequencies(d_head: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once: a copy
    from pageable host memory synchronises the stream, and one per call
    would keep the host from running ahead of the device."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[..., S, n_heads, d_head]``; positions: ``[..., S]`` int.

    Rotates the two halves of each head (half-split), angles in fp32."""
    d_head = x.shape[-1]
    inv = _device_frequencies(d_head, float(theta), x.device)
    ang = positions.float()[..., None] * inv         # [..., S, d/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy. logits ``[..., V]`` fp32, labels ``[...]`` int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
