"""GQA and MLA attention: training, prefill through the flash-attention
kernel, cached decode.

A port of the GQA and MLA parts of ``repro.models.attention``. Where the
JAX package computes prefill attention with its XLA path
(``mea_attention``), the port calls
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, which
computes the same function: the hand-written kernel for a CUDA tensor, the
plain version for a CPU tensor. That kernel has no backward (nor has the
JAX package's Pallas kernel), so the training objective attends through
:func:`mea_attention`, the JAX package's blocked online-softmax attention
in plain, differentiable PyTorch: its caller passes it to
:func:`apply_gqa` as ``attend``. Decode attends one token against the
cache in plain PyTorch, as the JAX package does outside any Pallas kernel.

Layouts are the JAX package's: ``wq`` ``[D, H, dh]``, ``wk``/``wv``
``[D, Hkv, dh]``, ``wo`` ``[H, dh, D]``, q ``[B, H, S, dh]`` and the KV
cache ``[B, Hkv, S_cache, dh]``. Decode writes the new token's k/v into the
cache tensors in place (the JAX package returns updated copies): a serving
cache is the largest thing on the device, and a copy per token would
double it.

GQA also serves the other families' attention: an encoder's (whisper's
``enc``: not causal, no RoPE), a cross-attention over an encoder's keys
and values (``cross_kv``: not causal, Sq ≠ Skv) and local attention
(``window``: prefill through :func:`mea_attention`'s band, as the
reference's prefill does, since the kernel has no band; decode into a
ring buffer of ``window`` slots).

MLA (DeepSeek-V2's multi-head latent attention) caches the compressed
latent ``c`` ``[B, S, kv_lora]`` and the shared rope key ``k_rope`` ``[B,
S, rope_d]``. Its prefill expands them to per-head keys and values and
attends through ``attend`` at a head width of ``nope + rope`` (v zero-padded
to it, the output sliced back), as the JAX package does, padded further to
the next width the kernel takes where ``nope + rope`` is not one; decode attends in
plain PyTorch, expanded or with the absorbed projections.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.models.layers import (_normal, apply_norm, apply_rope,
                                       init_norm)

NEG_INF = -1e30


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
    return (x @ w.to(x.dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


class _Heads(torch.autograd.Function):
    """``[B, S, H, dh]`` -> ``[B, H, S, dh]``, contiguous; its backward
    gives a contiguous gradient too (a DTensor's local gradient would stay
    transposed, and its view ops refuse such a tensor)."""

    @staticmethod
    def forward(ctx, x):
        return x.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.transpose(1, 2).clone(memory_format=torch.contiguous_format)


def _heads(x: torch.Tensor) -> torch.Tensor:
    return _Heads.apply(x)


def apply_gqa(p: GQA, x: torch.Tensor, positions: torch.Tensor, *,
              theta: float, causal: bool = True, window: int = 0,
              rope: bool = True, cache: Optional[Dict] = None,
              cache_index: Optional[int] = None, cross_kv=None,
              attend: Callable = flash_attention, layout=None):
    """GQA attention, with RoPE on q and k unless ``rope=False``.

    Full sequence (``cache is None``): ``attend(q, k, v, causal=causal)``,
    the kernel (prefill) or :func:`mea_attention` (the training objective,
    whose gradient flows through it); ``window > 0`` (local attention)
    attends through :func:`mea_attention`'s band instead, as the
    reference's prefill does (the kernel has no band). Returns ``(y, (k,
    v))`` with k, v ``[B, Hkv, S, dh]``. ``cross_kv``: an encoder's ``(k,
    v)`` ``[B, Hkv, S_enc, dh]``, attended as they are (no RoPE on q, no
    cache update). Decode (``cache={"k", "v"}`` of ``[B, Hkv, S_cache,
    dh]``, ``cache_index`` the new token's position): writes the token's
    k/v into the cache in place, at ``cache_index % S_cache`` for a window
    (a ring buffer), and returns ``(y, cache)``. ``layout``: a mesh's
    :class:`~repro_torch.sharding.dtensor.Layout`, for DTensor caches.
    """
    dt = x.dtype
    q = _project(x, p.wq)
    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = _project(x, p.wk)
        v = _project(x, p.wv)
        if rope:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
        k = _heads(k)
        v = _heads(v)
    q = _heads(q)                           # [B, H, S, dh]

    if cache is not None and cross_kv is None:
        # decode: s == 1; insert at cache_index (a ring buffer for a window)
        ck, cv = cache["k"], cache["v"]
        idx = cache_index % ck.shape[2] if window > 0 else cache_index
        _write(layout, ck, 2, idx, k)
        _write(layout, cv, 2, idx, v)
        if layout is None:
            out = _decode_attention(q, ck.to(dt), cv.to(dt),
                                    cache_index=cache_index, window=window)
        else:
            out = layout.decode_attend(
                _decode_scores, functools.partial(
                    _decode_finish, d=q.shape[-1], dtype=dt,
                    cache_index=cache_index, window=window),
                q, ck.to(dt), cv.to(dt))
    elif cache is not None:
        out = mea_attention(q, k, v, causal=False)
    elif window > 0:
        out = mea_attention(q, k, v, causal=causal, window=window)
    else:
        out = attend(q, k, v, causal=causal)
    hq, dh, d = p.wo.shape
    y = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], hq * dh) @ \
        p.wo.to(dt).reshape(hq * dh, d)
    if cache is not None:
        return y, cache
    return y, (k, v)


def _write(layout, t: torch.Tensor, dim: int, start: int,
           new: torch.Tensor) -> None:
    """A decode cache's positions from ``start`` along ``dim`` = ``new``,
    in place (on a mesh, each rank writes its shard's part)."""
    if layout is None:
        t.narrow(dim, start, new.shape[dim]).copy_(new)
    else:
        layout.cache_write(t, dim, start, new)


def encoder_kv(p: GQA, enc_out: torch.Tensor):
    """The cross-attention's keys and values of an encoder's output
    ``[B, S_enc, D]``: ``([B, Hkv, S_enc, dh], [B, Hkv, S_enc, dh])`` in
    its dtype."""
    k = _heads(_project(enc_out, p.wk))
    v = _heads(_project(enc_out, p.wv))
    return k, v


# ---------------------------------------------------------------------------
# blocked online-softmax attention (the training path)
# ---------------------------------------------------------------------------

def _attn_reference(q, k, v, causal: bool, window: int,
                    q_offset: int) -> torch.Tensor:
    """Naive attention, for sequences within one block.

    q: ``[B, Hq, Sq, d]``, k/v: ``[B, Hkv, Skv, d]`` with Hq = G·Hkv."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, sq, d).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask, scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def mea_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  q_block: int = 512, kv_block: int = 1024,
                  q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention with GQA head grouping (the JAX package's
    default, blocked form).

    q: ``[B, Hq, Sq, d]``; k, v: ``[B, Hkv, Skv, d]``. An online softmax
    over kv blocks for each q block, fp32 running statistics, so the
    largest live intermediate is one ``[B, Hkv, G, q_block, kv_block]``
    tile. ``window > 0`` adds a sliding-window band to the causal mask.
    Causal, a q block visits only the kv blocks at or before it: the JAX
    package computes the others and discards them, which gives the same
    numbers.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sq <= q_block and skv <= kv_block:
        return _attn_reference(q, k, v, causal, window, q_offset)
    g = hq // hkv
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    n_q, n_kv = -(-sq // q_block), -(-skv // kv_block)
    qp = F.pad(q, (0, 0, 0, n_q * q_block - sq))
    kp = F.pad(k, (0, 0, 0, n_kv * kv_block - skv))
    vp = F.pad(v, (0, 0, 0, n_kv * kv_block - skv))
    qp = qp.reshape(b, hkv, g, n_q, q_block, d)
    kp = kp.reshape(b, hkv, n_kv, kv_block, d)
    vp = vp.reshape(b, hkv, n_kv, kv_block, d)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    outs = []
    for qi in range(n_q):
        qb = (qp[:, :, :, qi] * scale).float()        # [b, hkv, g, qblk, d]
        q_pos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        acc = torch.zeros((b, hkv, g, q_block, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                        device=dev)
        n_needed = n_kv
        if causal and window <= 0:
            n_needed = min(((qi + 1) * q_block + q_offset + kv_block - 1)
                           // kv_block, n_kv)
        for ki in range(n_needed):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                             kp[:, :, ki].float())
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            msk = (k_pos < skv)[None, :]
            if causal:
                msk = msk & (q_pos[:, None] >= k_pos[None, :])
            if window > 0:
                msk = msk & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[..., None])
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", pr, vp[:, :, ki].float())
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs, dim=3)         # [b, hkv, g, n_q, q_block, d]
    return out.reshape(b, hq, n_q * q_block, d)[:, :, :sq]


def mea_attention_packed(q, k, v, *, block: int = 1024) -> torch.Tensor:
    """Causal attention over only the visible block pairs (the JAX
    package's ``packed`` form): the lower triangle ``[(i, j) for i in
    q_blocks for j <= i]``, nq(nq+1)/2 pairs instead of nq·nkv, with fp32
    running statistics for every q block. Needs Sq == Skv, a multiple of
    the block."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    block = min(block, sq)
    if sq % block or k.shape[2] != sq:
        raise ValueError(f"packed attention needs Sq == Skv, a multiple of "
                         f"the block: Sq={sq}, Skv={k.shape[2]}, "
                         f"block={block}")
    nb = sq // block
    qp = q.reshape(b, hkv, g, nb, block, d)
    kp = k.reshape(b, hkv, nb, block, d)
    vp = v.reshape(b, hkv, nb, block, d)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    diag = (torch.arange(block, device=dev)[:, None]
            >= torch.arange(block, device=dev)[None, :])
    acc = [torch.zeros((b, hkv, g, block, d), dtype=torch.float32,
                       device=dev) for _ in range(nb)]
    m = [torch.full((b, hkv, g, block), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(nb)]
    l = [torch.zeros((b, hkv, g, block), dtype=torch.float32, device=dev)
         for _ in range(nb)]
    for i in range(nb):
        qb = qp[:, :, :, i].float() * scale
        for j in range(i + 1):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kp[:, :, j].float())
            if i == j:
                s = torch.where(diag, s, NEG_INF)
            m_new = torch.maximum(m[i], s.amax(dim=-1))
            alpha = torch.exp(m[i] - m_new)
            pr = torch.exp(s - m_new[..., None])
            l[i] = l[i] * alpha + pr.sum(dim=-1)
            acc[i] = acc[i] * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", pr, vp[:, :, j].float())
            m[i] = m_new
    out = torch.stack([a / torch.clamp(li[..., None], min=1e-30)
                       for a, li in zip(acc, l)], dim=3)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _decode_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q ``[B, Hq, 1, d]`` · k ``[B, Hkv, S, d]`` -> ``[B, Hkv, G, 1, S]``
    fp32, unscaled (a sum over d: over a shard of d, a part of it)."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    qf = q.reshape(b, hkv, hq // hkv, 1, d).float()
    return torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())


def _decode_finish(scores: torch.Tensor, v: torch.Tensor, *, d: int, dtype,
                   cache_index: int, window: int = 0) -> torch.Tensor:
    """The rest of :func:`_decode_attention` from its scores: scale by
    ``d`` (the full head width), mask, softmax, ``· v`` -> ``[B, Hq, 1,
    dv]`` in ``dtype``."""
    b, hkv, g, _, s = scores.shape
    scores = scores / (d ** 0.5)
    kpos = torch.arange(s, device=scores.device)
    if window > 0:
        valid = kpos < min(cache_index + 1, s)
    else:
        valid = kpos <= cache_index
    scores = scores.masked_fill(~valid, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float())
    return out.reshape(b, hkv * g, 1, v.shape[-1]).to(dtype)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      cache_index: int, window: int = 0) -> torch.Tensor:
    """Single-token attention against a cache. q: ``[B, Hq, 1, d]``, k/v:
    ``[B, Hkv, S, d]``; keys at positions ``<= cache_index`` count (for a
    window's ring buffer, the slots written so far)."""
    return _decode_finish(_decode_scores(q, k), v, d=q.shape[-1],
                          dtype=q.dtype, cache_index=cache_index,
                          window=window)


def make_kv_cache(batch: int, n_kv: int, size: int, d_head: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, n_kv, size, d_head), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv, size, d_head), dtype=dtype,
                         device=device),
    }


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """MLA weights, in the JAX package's layouts: ``wq_a`` ``[D, q_lora]``,
    ``q_norm``, ``wq_b`` ``[q_lora, H, nope + rope]``, ``wkv_a`` ``[D,
    kv_lora]``, ``kv_norm``, ``wk_rope`` ``[D, rope]``, ``wk_b`` ``[kv_lora,
    H, nope]``, ``wv_b`` ``[kv_lora, H, v]``, ``wo`` ``[H, v, D]``."""

    def __init__(self, gen: torch.Generator, cfg, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        s = d ** -0.5
        self.wq_a = _normal(gen, (d, qr), s, device, dtype)
        self.q_norm = init_norm(qr, "rmsnorm", device, dtype)
        self.wq_b = _normal(gen, (qr, h, nope + rope_d), qr ** -0.5, device,
                            dtype)
        self.wkv_a = _normal(gen, (d, kvr), s, device, dtype)
        self.kv_norm = init_norm(kvr, "rmsnorm", device, dtype)
        self.wk_rope = _normal(gen, (d, rope_d), s, device, dtype)
        self.wk_b = _normal(gen, (kvr, h, nope), kvr ** -0.5, device, dtype)
        self.wv_b = _normal(gen, (kvr, h, vd), kvr ** -0.5, device, dtype)
        self.wo = _normal(gen, (h, vd, d), (h * vd) ** -0.5, device, dtype)


def init_mla(gen: torch.Generator, cfg, device=None,
             dtype=torch.float32) -> MLA:
    return MLA(gen, cfg, device, dtype)


def apply_mla(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg, *,
              cache: Optional[Dict] = None, cache_index: Optional[int] = None,
              absorb: bool = False, attend: Callable = flash_attention,
              layout=None):
    """MLA self-attention, causal, RoPE on the rope part of q and k.

    Full sequence (``cache is None``): ``attend(q, k, v, causal=True)`` at
    head width ``nope + rope`` (its scale ``1/sqrt(nope + rope)``), or, where
    the kernel does not take that width, at the next one in ``HEAD_DIMS``
    with q, k and v zero-padded to it and q scaled by ``sqrt(padded /
    (nope + rope))``; returns ``(y, (c, k_rope))``. Decode (``cache={"c", "k_rope"}``): writes the
    token's latent and rope key into the cache in place and attends against
    positions ``<= cache_index``, scores scaled by ``(nope + rope) ** -0.5``;
    ``absorb`` folds ``wk_b`` into the query and ``wv_b`` into the output,
    so the step works in the latent width instead of expanding K and V.
    Returns ``(y, cache)``."""
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    ql = apply_norm(p.q_norm, x @ p.wq_a.to(dt), "rmsnorm")
    q = _project(ql, p.wq_b)                           # [b, s, h, nope+rope]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c = apply_norm(p.kv_norm, x @ p.wkv_a.to(dt), "rmsnorm")   # [b, s, kvr]
    k_rope = apply_rope((x @ p.wk_rope.to(dt))[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]               # [b, s, rope]
    wk_b, wv_b = p.wk_b.to(dt), p.wv_b.to(dt)

    if cache is not None:
        _write(layout, cache["c"], 1, cache_index, c)
        _write(layout, cache["k_rope"], 1, cache_index, k_rope)
        args = (q_nope, q_rope, cache["c"].to(dt), cache["k_rope"].to(dt),
                wk_b, wv_b)
        kw = dict(cache_index=cache_index, absorb=absorb,
                  scale=(nope + rope_d) ** 0.5)
        out = (_mla_decode(*args, **kw) if layout is None
               else _mla_decode_sharded(layout, args, **kw))
    else:
        # prefill / training: expand k and v, attend at width nope + rope
        k_nope = torch.einsum("bsr,rhk->bshk", c, wk_b)
        v = torch.einsum("bsr,rhv->bshv", c, wv_b)
        k_rope_b = k_rope[:, :, None, :].expand(b, s, h, rope_d)
        # the kernel takes the widths in HEAD_DIMS: pad to the next one
        # (zeros add nothing to q·k) and scale q so that the softmax scale
        # stays 1/sqrt(nope + rope)
        width = nope + rope_d
        dk = min((w for w in HEAD_DIMS if w >= width), default=width)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if dk != width:
            q_full = q_full * (dk / width) ** 0.5
        q_full = _heads(F.pad(q_full, (0, dk - width)))
        k_full = _heads(F.pad(torch.cat([k_nope, k_rope_b], dim=-1),
                              (0, dk - width)))
        v_pad = _heads(F.pad(v, (0, dk - vd)))
        out = attend(q_full, k_full, v_pad, causal=True)
        out = out.transpose(1, 2)[..., :vd]
    y = out.reshape(b, s, h * vd) @ p.wo.to(dt).reshape(h * vd, -1)
    if cache is not None:
        return y, cache
    return y, (c, k_rope)


def _mla_scores(q_nope, q_rope, c_all, kr_all, wk_b, *, absorb: bool,
                scale: float, cache_index: int, first: int = 0):
    """MLA decode's scores ``[B, H, s, T]`` fp32 against the latent cache
    ``c_all`` ``[B, T, kv_lora]`` and rope keys ``kr_all``, scaled, the
    positions past ``cache_index`` masked (``first``: the position of
    ``c_all``'s first row)."""
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, kr_all)
    if absorb:
        # q_nope·(wk_b c) = (wk_b^T q_nope)·c: the latent side is smaller
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
        s_nope = torch.einsum("bshr,btr->bhst", q_eff, c_all)
    else:
        k_nope = torch.einsum("btr,rhk->bthk", c_all, wk_b)
        s_nope = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
    scores = (s_nope + s_rope).float() / scale
    pos = first + torch.arange(c_all.shape[1], device=c_all.device)
    return scores.masked_fill(~(pos <= cache_index), NEG_INF)


def _mla_values(w, c_all, wv_b, *, absorb: bool):
    """Weights ``w`` ``[B, H, s, T]`` (in the compute dtype) over the
    latent cache -> ``[B, s, H, v]``."""
    if absorb:
        ctx = torch.einsum("bhst,btr->bshr", w, c_all)
        return torch.einsum("bshr,rhv->bshv", ctx, wv_b)
    vv = torch.einsum("btr,rhv->bthv", c_all, wv_b)
    return torch.einsum("bhst,bthv->bshv", w, vv)


def _mla_decode(q_nope, q_rope, c_all, kr_all, wk_b, wv_b, *,
                cache_index: int, absorb: bool, scale: float):
    """MLA's decode attention against the latent cache ``c_all`` ``[B, S,
    kv_lora]`` and rope keys ``kr_all``: positions ``<= cache_index``
    count. Returns ``[B, s, H, v]``."""
    scores = _mla_scores(q_nope, q_rope, c_all, kr_all, wk_b, absorb=absorb,
                         scale=scale, cache_index=cache_index)
    w = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    return _mla_values(w, c_all, wv_b, absorb=absorb)


def _mla_decode_sharded(layout, args, *, cache_index: int, absorb: bool,
                        scale: float):
    """:func:`_mla_decode` on a mesh. A latent cache with its positions on
    tp (the rules' choice) stays where it is: each rank scores the
    positions it holds for every head, and the softmax is put together
    from the ranks' row maxima, exp-sums and weighted values (the
    flash-decoding combine), so only ``[B, H]``-sized statistics and the
    ``[B, s, H, v]`` output cross tp. Otherwise the cache is gathered over
    tp and each rank takes its batch rows and (where they divide) its
    heads."""
    from torch.distributed.tensor import Shard
    q_nope, q_rope, c_all, kr_all, wk_b, wv_b = args
    b, h = q_nope.shape[0], q_nope.shape[2]
    rows = 0 if layout.batch_sharded(b) else None
    on_tp = [p for n, p in zip(layout.names, c_all.placements)
             if n == layout.tp]
    if not (on_tp and isinstance(on_tp[0], Shard) and on_tp[0].dim == 1):
        heads = h % layout.tp_size == 0
        qp = layout.pl(rows, 2 if heads else None)
        wp = layout.pl(None, 1 if heads else None)
        cp = layout.pl(rows)
        fn = functools.partial(_mla_decode, cache_index=cache_index,
                               absorb=absorb, scale=scale)
        return layout.per_rank(fn, args, (qp, qp, cp, cp, wp, wp), qp)
    qp, wp = layout.pl(rows), layout.pl()
    cp = layout.pl(rows, 1)
    t_local = c_all.shape[1] // layout.tp_size
    first = layout.mesh.get_local_rank(layout.tp) * t_local
    kw = dict(absorb=absorb, scale=scale, cache_index=cache_index,
              first=first)

    def row_max(qn, qr, c, kr, wk):
        return _mla_scores(qn, qr, c, kr, wk, **kw).amax(-1)

    m = layout.per_rank(row_max, args[:5], (qp, qp, cp, cp, wp),
                        layout.pl(rows, tp_partial="max"))
    m = m.redistribute(layout.mesh, qp)

    def part(qn, qr, c, kr, wk, wv, mm):
        e = torch.exp(_mla_scores(qn, qr, c, kr, wk, **kw) - mm.unsqueeze(-1))
        return (e.sum(-1), _mla_values(e.to(qn.dtype), c, wv, absorb=absorb)
                .float())

    part_pl = layout.pl(rows, tp_partial="sum")
    den, num = layout.per_rank(part, (*args, m),
                               (qp, qp, cp, cp, wp, wp, qp),
                               (part_pl, part_pl))
    den = den.redistribute(layout.mesh, qp)
    num = num.redistribute(layout.mesh, qp)
    return (num / den.transpose(1, 2).unsqueeze(-1)).to(q_nope.dtype)


def make_mla_cache(batch: int, size: int, cfg, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros((batch, size, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, size, cfg.rope_head_dim), dtype=dtype,
                              device=device),
    }
