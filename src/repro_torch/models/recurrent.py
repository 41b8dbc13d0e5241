"""Recurrent blocks: mLSTM / sLSTM (xLSTM) and RG-LRU (RecurrentGemma).

A port of ``repro.models.recurrent``. Every recurrence is in the
reference's parallel form:

* mLSTM: chunkwise-parallel linear attention with a matrix memory and
  stabilised exponential gating (within a chunk a quadratic form, across
  chunks a carried state ``(C, n, m)``).
* sLSTM: the parallelisable approximation (gates from the inputs only), so
  the stabiliser is a max-plus scan and the cell and normaliser are linear
  scans.
* RG-LRU: an input-gated diagonal linear recurrence behind a causal
  depthwise temporal conv.

The scans are :func:`associative_scan`: the odd/even recursion of
``jax.lax.associative_scan``, log2(S) vectorised steps that combine the
elements in the reference's order. The scans and the mLSTM's chunk loop
run under the ``torch.profiler.record_function`` span ``recurrent.scan``,
the temporal conv under ``recurrent.conv``. Every block has a
``*_decode`` form that carries constant-size state. Weights live in ``nn.Module``s named as the
JAX package's keys (RG-LRU's ``lambda`` by ``register_parameter``, a Python
keyword); the sentinels (``-1e30``), clips and dtypes are the reference's.
No kernel runs here: the JAX package runs these through XLA, not Pallas.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.layers import _normal, apply_norm, init_norm

NEG_BIG = -1e30     # the reference's sentinel for "no mass yet"


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _take(x: torch.Tensor, dim: int, start: int, stop, step: int = 1):
    sl = [slice(None)] * x.dim()
    sl[dim] = slice(start, stop, step)
    return x[tuple(sl)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along ``dim``; ``even`` has as
    many elements as ``odd`` or one more."""
    n = odd.shape[dim]
    pairs = torch.stack([_take(even, dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, _take(even, dim, n, None)], dim=dim)
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     dim: int) -> List[torch.Tensor]:
    """Inclusive scan of the associative ``fn`` (lists of tensors -> list)
    along ``dim``, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the half, then fill in the even positions. The
    same elements meet in the same order as in the reference."""
    elems = list(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn([_take(e, dim, 0, -1, 2) for e in elems],
                 [_take(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([_take(e, dim, 0, -1) for e in odd],
                  [_take(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_take(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_take(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _linear_combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return [a1 * a2, a2 * b1 + b2]


def _maxplus_combine(x, y):
    f1, m1 = x
    f2, m2 = y
    return [f1 + f2, torch.maximum(m1 + f2, m2)]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 (time). a, b: [B, S, ...]."""
    with record_function("recurrent.scan"):
        return associative_scan(_linear_combine, (a, b), 1)[1]


def _maxplus_scan(f: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """m_t = max(m_{t-1} + f_t, i_t) along axis 1 (time)."""
    with record_function("recurrent.scan"):
        return associative_scan(_maxplus_combine, (f, i), 1)[1]


# ---------------------------------------------------------------------------
# the temporal conv
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """A depthwise causal conv: ``w`` ``[K, W]``, ``b`` ``[W]``."""

    def __init__(self, gen: torch.Generator, k: int, width: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = _normal(gen, (k, width), 0.5, device, dtype)
        self.b = nn.Parameter(torch.zeros((width,), device=device,
                                          dtype=dtype))


def causal_conv1d(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: ``[B, S, W]``; the taps added
    in the reference's order."""
    k = p.w.shape[0]
    with record_function("recurrent.conv"):
        pad = F.pad(x, (0, 0, k - 1, 0))
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + pad[:, i:i + x.shape[1], :] * p.w[i].to(x.dtype)
        return out + p.b.to(x.dtype)


def conv1d_decode(p: Conv, x_new: torch.Tensor, conv_state: torch.Tensor):
    """One step of the causal conv. conv_state: ``[B, K-1, W]`` of past
    inputs. Returns ``(out [B, W], new_state)``."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # [B, K, W]
    out = torch.einsum("bkw,kw->bw", window, p.w.to(x_new.dtype))
    out = out + p.b.to(x_new.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


class RGLRU(nn.Module):
    """``wx``, ``wgate`` ``[D, W]``, ``conv``, ``wa``, ``wi`` ``[W, W]``,
    ``lambda`` ``[W]``, ``wo`` ``[W, D]``."""

    def __init__(self, gen: torch.Generator, d_model: int, width: int,
                 conv_k: int, device=None, dtype=torch.float32):
        super().__init__()
        s, sw = d_model ** -0.5, width ** -0.5
        self.wx = _normal(gen, (d_model, width), s, device, dtype)
        self.wgate = _normal(gen, (d_model, width), s, device, dtype)
        self.conv = Conv(gen, conv_k, width, device, dtype)
        self.wa = _normal(gen, (width, width), sw, device, dtype)
        self.wi = _normal(gen, (width, width), sw, device, dtype)
        # a = exp(-c * softplus(lambda)) lies in (0.9, 0.999)
        u = 0.9 + 0.099 * torch.rand((width,), generator=gen, device=device)
        lam = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))
        self.register_parameter("lambda", nn.Parameter(lam.to(dtype)))
        self.wo = _normal(gen, (width, d_model), sw, device, dtype)


def init_rglru_block(gen: torch.Generator, d_model: int, width: int,
                     conv_k: int, device=None, dtype=torch.float32) -> RGLRU:
    return RGLRU(gen, d_model, width, conv_k, device, dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def _rglru_coeffs(p: RGLRU, u: torch.Tensor, dt):
    r = torch.sigmoid(u @ p.wa.to(dt))
    i = torch.sigmoid(u @ p.wi.to(dt))
    lam = getattr(p, "lambda").float()
    log_a = -_RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    b = beta * (i.float() * u.float())
    return a, b


def _gate_input(u: torch.Tensor, layout) -> torch.Tensor:
    """The gates' input: on a mesh gathered over tp, as the gate weights'
    output width lies there (else DTensor may shard the positions)."""
    return u if layout is None else layout.replicate_tp(u)


def apply_rglru_block(p: RGLRU, x: torch.Tensor, return_state: bool = False,
                      layout=None):
    """x: ``[B, S, D]`` -> ``[B, S, D]`` (and the state ``{"h", "conv"}``
    after the last position when ``return_state``). ``h`` is rounded to the
    compute dtype before it is kept, as in the reference. ``layout``: a
    mesh's :class:`~repro_torch.sharding.dtensor.Layout`."""
    dt = x.dtype
    u_pre = x @ p.wx.to(dt)
    gate = _gelu(x @ p.wgate.to(dt))
    u = causal_conv1d(p.conv, u_pre)
    a, b = _rglru_coeffs(p, _gate_input(u, layout), dt)
    h = _linear_scan(a, b).to(dt)
    out = (h * gate) @ p.wo.to(dt)
    if return_state:
        k = p.conv.w.shape[0]
        return out, {"h": h[:, -1].float(), "conv": u_pre[:, -(k - 1):, :]}
    return out


def rglru_init_state(batch: int, width: int, conv_k: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_k - 1, width), dtype=dtype,
                            device=device),
    }


def apply_rglru_decode(p: RGLRU, x: torch.Tensor, state: Dict, layout=None):
    """x: ``[B, 1, D]``; state ``{"h": [B, W] fp32, "conv": [B, K-1, W]}``.
    Returns ``(y [B, 1, D], new state)``."""
    dt = x.dtype
    u = x[:, 0] @ p.wx.to(dt)
    gate = _gelu(x[:, 0] @ p.wgate.to(dt))
    u, conv_state = conv1d_decode(p.conv, u, state["conv"])
    a, b = _rglru_coeffs(p, _gate_input(u, layout), dt)
    h = a * state["h"] + b
    y = (h.to(dt) * gate) @ p.wo.to(dt)
    return y[:, None], {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_up``, ``w_gate`` ``[D, W]``, ``conv``, ``wq``, ``wk``, ``wv``
    ``[W, W]``, ``w_if`` ``[W, 2H]``, ``b_if`` ``[2H]`` (input gates 0,
    forget gates 3), ``o_norm``, ``w_down`` ``[W, D]``."""

    def __init__(self, gen: torch.Generator, d_model: int, width: int,
                 n_heads: int, conv_k: int, device=None, dtype=torch.float32):
        super().__init__()
        s, sw = d_model ** -0.5, width ** -0.5
        self.w_up = _normal(gen, (d_model, width), s, device, dtype)
        self.w_gate = _normal(gen, (d_model, width), s, device, dtype)
        self.conv = Conv(gen, conv_k, width, device, dtype)
        self.wq = _normal(gen, (width, width), sw, device, dtype)
        self.wk = _normal(gen, (width, width), sw, device, dtype)
        self.wv = _normal(gen, (width, width), sw, device, dtype)
        self.w_if = _normal(gen, (width, 2 * n_heads), sw, device, dtype)
        self.b_if = _gate_bias(n_heads, device, dtype)
        self.o_norm = init_norm(width, "rmsnorm", device, dtype)
        self.w_down = _normal(gen, (width, d_model), sw, device, dtype)


def _gate_bias(n_heads: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.cat([
        torch.zeros((n_heads,), device=device, dtype=dtype),
        3.0 * torch.ones((n_heads,), device=device, dtype=dtype)]))


def init_mlstm_block(gen: torch.Generator, d_model: int, width: int,
                     n_heads: int, conv_k: int, device=None,
                     dtype=torch.float32) -> MLSTM:
    return MLSTM(gen, d_model, width, n_heads, conv_k, device, dtype)


def _gates(w_if: torch.Tensor, b_if: torch.Tensor, u: torch.Tensor,
           n_heads: int):
    """(log input gate, log forget gate) in fp32: ``[..., H]`` each."""
    gif = (u @ w_if.to(u.dtype)).float() + b_if.float()
    return gif[..., :n_heads], F.logsigmoid(gif[..., n_heads:])


def mlstm_sequence(q, k, v, i_t, f_t, chunk: int = 256,
                   return_state: bool = False):
    """Chunkwise-parallel mLSTM.

    q, k, v: ``[B, H, S, d]``; i_t, f_t: ``[B, H, S]`` (log-space gates).
    Returns h ``[B, H, S, d]`` fp32 (and the final ``{"C", "n", "m"}``
    carry if asked). A chunk's memory update is one scaled ``kᵀ·v`` product
    ``[B, H, d, d]``; no ``[B, H, T, d, d]`` tensor is formed. Runs under
    the ``recurrent.scan`` span, as the scans do."""
    with record_function("recurrent.scan"):
        return _mlstm_chunks(q, k, v, i_t, f_t, chunk, return_state)


def _mlstm_chunks(q, k, v, i_t, f_t, chunk: int, return_state: bool):
    b, h, s, d = q.shape
    q = q.float() / (d ** 0.5)
    k = k.float()
    v = v.float()
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        i_t = F.pad(i_t, (0, pad), value=NEG_BIG)
        f_t = F.pad(f_t, (0, pad))
    qc = q.reshape(b, h, n_chunks, chunk, d)
    kc = k.reshape(b, h, n_chunks, chunk, d)
    vc = v.reshape(b, h, n_chunks, chunk, d)
    ic = i_t.reshape(b, h, n_chunks, chunk)
    fc = f_t.reshape(b, h, n_chunks, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))

    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), NEG_BIG, dtype=torch.float32, device=q.device)
    outs = []
    for idx in range(n_chunks):
        qb, kb, vb = qc[:, :, idx], kc[:, :, idx], vc[:, :, idx]
        ib, fb = ic[:, :, idx], fc[:, :, idx]
        bcum = torch.cumsum(fb, dim=-1)          # inclusive log-forget prefix
        # intra-chunk log weights D[t, s] = bcum[t] - bcum[s] + i[s]
        D = bcum[..., :, None] - bcum[..., None, :] + ib[..., None, :]
        D = torch.where(causal, D, float("-inf"))
        m_intra = D.amax(dim=-1)
        m_inter = m[..., None] + bcum
        m_t = torch.clamp(torch.maximum(m_intra, m_inter), min=NEG_BIG)
        w_intra = torch.exp(D - m_t[..., None])
        scores = (qb @ kb.transpose(-1, -2)) * w_intra
        num = scores @ vb
        den = scores.sum(dim=-1)
        c_inter = torch.exp(m_inter - m_t)
        num = num + c_inter[..., None] * (qb @ C)
        den = den + c_inter * (qb @ n[..., None])[..., 0]
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state at the end of the chunk
        btot = bcum[..., -1]
        tail = btot[..., None] - bcum + ib
        m_new = torch.maximum(m + btot, tail.amax(dim=-1))
        scale_old = torch.exp(m + btot - m_new)
        w_new = torch.exp(tail - m_new[..., None])
        wk = w_new[..., None] * kb
        C = scale_old[..., None, None] * C + wk.transpose(-1, -2) @ vb
        n = scale_old[..., None] * n + wk.sum(dim=-2)
        m = m_new
    out = torch.stack(outs, dim=2).reshape(b, h, n_chunks * chunk, d)
    if return_state:
        return out[:, :, :s], {"C": C, "n": n, "m": m}
    return out[:, :, :s]


def mlstm_decode(q, k, v, i_t, f_t, state: Dict):
    """One step. q, k, v: ``[B, H, d]``; i_t, f_t: ``[B, H]``; state
    ``{"C", "n", "m"}``. Returns ``(h [B, H, d] fp32, new state)``."""
    C, n, m = state["C"], state["n"], state["m"]
    d = q.shape[-1]
    qf = q.float() / (d ** 0.5)
    kf, vf = k.float(), v.float()
    m_new = torch.maximum(f_t + m, i_t)
    sc_old = torch.exp(f_t + m - m_new)
    sc_new = torch.exp(i_t - m_new)
    C = sc_old[..., None, None] * C + sc_new[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = sc_old[..., None] * n + sc_new[..., None] * kf
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = (qf * n).sum(dim=-1)
    out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return out, {"C": C, "n": n, "m": m_new}


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``[B, S, W]`` -> ``[B, H, S, W / H]``."""
    b, s, w = x.shape
    return x.reshape(b, s, n_heads, w // n_heads).transpose(1, 2)


def apply_mlstm_block(p: MLSTM, x: torch.Tensor, n_heads: int,
                      chunk: int = 256, return_state: bool = False):
    """The mLSTM residual block's body. x: ``[B, S, D]`` -> ``[B, S, D]``
    (and the state ``{"C", "n", "m", "conv"}`` when ``return_state``)."""
    dt = x.dtype
    b, s, _ = x.shape
    u = x @ p.w_up.to(dt)
    gate = F.silu(x @ p.w_gate.to(dt))
    uc = F.silu(causal_conv1d(p.conv, u))
    q = _heads(uc @ p.wq.to(dt), n_heads)
    k = _heads(uc @ p.wk.to(dt), n_heads)
    v = _heads(u @ p.wv.to(dt), n_heads)
    i_t, f_t = _gates(p.w_if, p.b_if, uc, n_heads)
    res = mlstm_sequence(q, k, v, i_t.transpose(1, 2), f_t.transpose(1, 2),
                         chunk=chunk, return_state=return_state)
    h, state = res if return_state else (res, None)
    width = u.shape[-1]
    h = h.transpose(1, 2).reshape(b, s, width).to(dt)
    h = apply_norm(p.o_norm, h, "rmsnorm")
    out = (h * gate) @ p.w_down.to(dt)
    if return_state:
        kk = p.conv.w.shape[0]
        state["conv"] = u[:, -(kk - 1):, :].float()
        return out, state
    return out


def mlstm_init_state(batch: int, width: int, n_heads: int, conv_k: int,
                     device=None) -> Dict[str, torch.Tensor]:
    hd = width // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), **f32),
        "n": torch.zeros((batch, n_heads, hd), **f32),
        "m": torch.full((batch, n_heads), NEG_BIG, **f32),
        "conv": torch.zeros((batch, conv_k - 1, width), **f32),
    }


def apply_mlstm_decode(p: MLSTM, x: torch.Tensor, state: Dict, n_heads: int):
    """x: ``[B, 1, D]``; the conv runs in fp32 (its state is fp32)."""
    dt = x.dtype
    b = x.shape[0]
    u = x[:, 0] @ p.w_up.to(dt)
    gate = F.silu(x[:, 0] @ p.w_gate.to(dt))
    uconv, conv_state = conv1d_decode(p.conv, u.float(), state["conv"])
    uc = F.silu(uconv).to(dt)
    width = u.shape[-1]
    hd = width // n_heads
    q = (uc @ p.wq.to(dt)).reshape(b, n_heads, hd)
    k = (uc @ p.wk.to(dt)).reshape(b, n_heads, hd)
    v = (u @ p.wv.to(dt)).reshape(b, n_heads, hd)
    i_t, f_t = _gates(p.w_if, p.b_if, uc, n_heads)
    h, new_state = mlstm_decode(q, k, v, i_t, f_t, state)
    h = apply_norm(p.o_norm, h.reshape(b, width).to(dt), "rmsnorm")
    y = (h * gate) @ p.w_down.to(dt)
    new_state["conv"] = conv_state
    return y[:, None], new_state


# ---------------------------------------------------------------------------
# sLSTM (parallelisable approximation; gates from the inputs)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wz``, ``wo_gate`` ``[D, D]``, ``w_if`` ``[D, 2H]``, ``b_if``,
    ``o_norm``, ``w_down`` ``[D, D]``."""

    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        s = d_model ** -0.5
        self.wz = _normal(gen, (d_model, d_model), s, device, dtype)
        self.wo_gate = _normal(gen, (d_model, d_model), s, device, dtype)
        self.w_if = _normal(gen, (d_model, 2 * n_heads), s, device, dtype)
        self.b_if = _gate_bias(n_heads, device, dtype)
        self.o_norm = init_norm(d_model, "rmsnorm", device, dtype)
        self.w_down = _normal(gen, (d_model, d_model), s, device, dtype)


def init_slstm_block(gen: torch.Generator, d_model: int, n_heads: int,
                     device=None, dtype=torch.float32) -> SLSTM:
    return SLSTM(gen, d_model, n_heads, device, dtype)


def _slstm_parts(p: SLSTM, x: torch.Tensor, n_heads: int):
    dt = x.dtype
    z = torch.tanh(x @ p.wz.to(dt)).float()
    o = torch.sigmoid(x @ p.wo_gate.to(dt)).float()
    i_t, f_t = _gates(p.w_if, p.b_if, x, n_heads)
    return z, o, i_t, f_t


def apply_slstm_block(p: SLSTM, x: torch.Tensor, n_heads: int,
                      return_state: bool = False):
    """x: ``[B, S, D]`` -> ``[B, S, D]``; three scans (m, c, n)."""
    b, s, d = x.shape
    hd = d // n_heads
    z, o, i_t, f_t = _slstm_parts(p, x, n_heads)
    m = _maxplus_scan(f_t, i_t)                                  # [B, S, H]
    m_prev = torch.cat([torch.full((b, 1, n_heads), NEG_BIG,
                                   dtype=torch.float32, device=x.device),
                        m[:, :-1]], dim=1)
    a = torch.exp(torch.clamp(f_t + m_prev - m, -60.0, 0.0))
    w_in = torch.exp(i_t - m)
    zz = z.reshape(b, s, n_heads, hd)
    c = _linear_scan(a[..., None], w_in[..., None] * zz)
    n = _linear_scan(a, w_in)
    h = c / torch.clamp(n[..., None], min=1e-6)
    hflat = (o.reshape(b, s, n_heads, hd) * h).reshape(b, s, d).to(x.dtype)
    hflat = apply_norm(p.o_norm, hflat, "rmsnorm")
    out = hflat @ p.w_down.to(x.dtype)
    if return_state:
        return out, {"c": c[:, -1], "n": n[:, -1], "m": m[:, -1]}
    return out


def slstm_init_state(batch: int, d_model: int, n_heads: int,
                     device=None) -> Dict[str, torch.Tensor]:
    hd = d_model // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, n_heads, hd), **f32),
        "n": torch.zeros((batch, n_heads), **f32),
        "m": torch.full((batch, n_heads), NEG_BIG, **f32),
    }


def apply_slstm_decode(p: SLSTM, x: torch.Tensor, state: Dict, n_heads: int):
    """One step; unlike the sequence form, the decay is not clipped (as in
    the reference)."""
    b, _, d = x.shape
    hd = d // n_heads
    z, o, i_t, f_t = _slstm_parts(p, x[:, 0:1], n_heads)
    z, o, i_t, f_t = z[:, 0], o[:, 0], i_t[:, 0], f_t[:, 0]
    m_new = torch.maximum(f_t + state["m"], i_t)
    a = torch.exp(f_t + state["m"] - m_new)
    w_in = torch.exp(i_t - m_new)
    c = a[..., None] * state["c"] + w_in[..., None] * z.reshape(b, n_heads, hd)
    n = a * state["n"] + w_in
    h = c / torch.clamp(n[..., None], min=1e-6)
    h = (o.reshape(b, n_heads, hd) * h).reshape(b, d).to(x.dtype)
    h = apply_norm(p.o_norm, h, "rmsnorm")
    y = h @ p.w_down.to(x.dtype)
    return y[:, None], {"c": c, "n": n, "m": m_new}
