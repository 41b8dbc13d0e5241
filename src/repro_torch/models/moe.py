"""Mixture-of-Experts: top-k routing with grouped capacity dispatch.

A port of ``repro.models.moe``. Tokens are split into groups of
``group_size``; each expert takes at most ``capacity`` tokens of a group,
the earlier tokens (and, within a token, the earlier of its k slots) first.
The JAX package builds one-hot ``[G, S_g, E, C]`` dispatch and combine
tensors and contracts them with einsums; the port computes the same
function with an index copy into the experts' ``[E, G, C, D]`` buffer and a
gather out of it. Both run the experts over every slot of that buffer,
empty slots included: at the no-drop capacity of prefill (``E / top_k``)
that is ``E / top_k`` times the routed work, as in the reference.

Layouts are the JAX package's: ``router`` ``[D, E]``, ``wi`` / ``wg``
``[E, D, F]``, ``wo`` ``[E, F, D]``. Int8 experts
(:func:`quantize_expert_weights`) hold ``wi`` / ``wg`` / ``wo`` as int8 with
a per-(expert, out-channel) fp32 ``*_scale``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.layers import _normal, init_mlp

_EXPERT_WEIGHTS = ("wi", "wg", "wo")


class MoE(nn.Module):
    """``router``, ``wi``, ``wo`` and, for swiglu / geglu, the gate ``wg``;
    int8 experts (:func:`quantize_expert_weights`) also hold ``wi_scale``,
    ``wg_scale`` and ``wo_scale``."""

    def __init__(self, router: torch.Tensor, experts: dict,
                 scales: Optional[dict] = None):
        super().__init__()
        self.router = nn.Parameter(router)
        for name, w in experts.items():
            setattr(self, name, nn.Parameter(
                w, requires_grad=w.is_floating_point()))
        for name, sc in (scales or {}).items():
            setattr(self, name + "_scale",
                    nn.Parameter(sc, requires_grad=False))


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             act: str, device=None, dtype=torch.float32) -> MoE:
    """Draws ``router``, ``wi``, ``wg`` (gated acts only), ``wo`` in that
    order (the JAX package's key order)."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    router = _normal(gen, (d_model, n_experts), s_in, device, dtype)
    experts = {"wi": _normal(gen, (n_experts, d_model, d_ff), s_in, device,
                             dtype)}
    if act in ("swiglu", "geglu"):
        experts["wg"] = _normal(gen, (n_experts, d_model, d_ff), s_in,
                                device, dtype)
    experts["wo"] = _normal(gen, (n_experts, d_ff, d_model), s_out, device,
                            dtype)
    return MoE(router.data, {k: w.data for k, w in experts.items()})


def init_shared_experts(gen: torch.Generator, d_model: int, d_ff: int,
                        n_shared: int, act: str, device=None,
                        dtype=torch.float32):
    """DeepSeek's shared experts: one dense gated MLP of width
    ``n_shared * d_ff``."""
    return init_mlp(gen, d_model, n_shared * d_ff, act, device, dtype)


# ---------------------------------------------------------------------------
# int8 weight-only experts
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_expert_weights(p: MoE) -> MoE:
    """A copy of ``p`` with ``wi`` / ``wg`` / ``wo`` as symmetric int8 per
    (expert, out-channel) and their fp32 scales ``*_scale`` ``[E, 1, out]``
    (``max |w|`` over the in-channel axis / 127). Batch decode of a large
    MoE reads every expert every step, so its step is bound by the experts'
    bytes: int8 halves them against bf16."""
    experts, scales = {}, {}
    for name in _EXPERT_WEIGHTS:
        if not hasattr(p, name):
            continue
        w = getattr(p, name).detach()
        scale = torch.amax(torch.abs(w), dim=-2, keepdim=True) / 127.0
        codes = torch.clamp(torch.round(w / torch.clamp(scale, min=1e-12)),
                            -127, 127)
        experts[name] = codes.to(torch.int8)
        scales[name] = scale.float()
    return MoE(p.router.detach().clone(), experts, scales)


def _dequant(p: MoE, name: str, dt) -> torch.Tensor:
    w = getattr(p, name)
    if hasattr(p, name + "_scale"):
        return w.to(dt) * getattr(p, name + "_scale").to(dt)
    return w.to(dt)


def expert_ffn(p: MoE, x: torch.Tensor, act: str) -> torch.Tensor:
    """x ``[E, N, D]`` -> ``[E, N, D]``: each expert's gated MLP over its
    N slots (int8 experts dequantised to x's dtype first)."""
    dt = x.dtype
    h = torch.matmul(x, _dequant(p, "wi", dt))
    if act == "swiglu":
        h = F.silu(torch.matmul(x, _dequant(p, "wg", dt))) * h
    elif act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.matmul(x, _dequant(p, "wg", dt)),
                   approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return torch.matmul(h, _dequant(p, "wo", dt))


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

def apply_moe(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              act: str, group_size: int = 512,
              capacity_factor: float = 1.25,
              experts: Optional[Tuple[int, int]] = None,
              return_stats: bool = False):
    """x ``[B, S, D]`` -> ``(y [B, S, D], aux)``, aux the Switch
    load-balancing loss (fp32 scalar).

    The B·S tokens are cut into ``n_groups = B·S // g`` groups of ``g =
    min(group_size, B·S)``; tokens past the last whole group pass through
    unchanged (``y = x`` there, as in the reference). Router logits are
    computed in x's dtype and softmaxed in fp32; each token's top-k gates
    (``torch.topk``'s order: descending) are renormalised to sum to 1. A
    group's slots take places in their experts' buffers in (token, slot)
    order, up to ``capacity = max(1, int(g * top_k / n_experts *
    capacity_factor))`` a group and expert; a slot past it is dropped.

    Its three parts run under ``torch.profiler.record_function`` spans,
    ``moe.route`` (router, top-k, places, the index copy into the experts'
    buffer), ``moe.experts`` (the expert products over the whole buffer)
    and ``moe.combine`` (the gather and the gate-weighted sum), so a
    profile splits a MoE layer's device time among them.

    ``experts=(first, n)``: ``p`` holds only experts ``first`` … ``first +
    n - 1`` (expert parallelism): the tokens are routed over all
    ``n_experts``, only those experts' slots run, and ``y`` is their part
    of the sum (the tokens past the last group pass through on the part
    with ``first == 0``). ``return_stats``: return the routing statistics
    ``(top-1 share, mean prob)`` per expert instead of aux (a sharded
    caller averages them over its ranks before taking aux)."""
    dt = x.dtype
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    g_size = min(group_size, t)
    n_groups = t // g_size
    xt = tokens[:n_groups * g_size].reshape(n_groups, g_size, d)

    with record_function("moe.route"):
        logits = (xt @ p.router.to(dt)).float()              # [G, g, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        capacity = max(1, int(g_size * top_k / n_experts * capacity_factor))
        # each slot's place in its expert's buffer: the slots of the group
        # before it, in (token, k) order, that chose the same expert
        onehot = F.one_hot(expert_idx, n_experts)            # [G, g, k, E]
        flat = onehot.reshape(n_groups, g_size * top_k, n_experts)
        before = torch.cumsum(flat, dim=1) - flat
        pos = torch.gather(before, 2, expert_idx.reshape(
            n_groups, g_size * top_k, 1)).reshape(n_groups, g_size, top_k)
        keep = pos < capacity                                # [G, g, k]
        first, n_local = (0, n_experts) if experts is None else experts
        if experts is not None:
            keep = keep & (expert_idx >= first) & (expert_idx < first + n_local)

        # the experts' buffer [E, G, C, D]: slot (e, grp, c) holds the
        # token whose k-th choice went there, or zeros; a dropped slot
        # goes to one spare row past the buffer (static shapes: no mask)
        grp = torch.arange(n_groups, device=x.device)[:, None, None]
        slot = ((expert_idx - first) * n_groups + grp) * capacity + pos
        n_slots = n_local * n_groups * capacity
        src = xt[:, :, None, :].expand(n_groups, g_size, top_k, d).reshape(
            -1, d)
        expert_in = torch.zeros((n_slots + 1, d), dtype=dt, device=x.device)
        expert_in.index_copy_(0, torch.where(keep, slot, n_slots).reshape(-1),
                              src)
        slot = torch.where(keep, slot, 0).reshape(-1)
    with record_function("moe.experts"):
        expert_out = expert_ffn(
            p, expert_in[:n_slots].reshape(n_local, n_groups * capacity, d),
            act)

    with record_function("moe.combine"):
        # each token's kept slots weighted by their gates (rounded to x's
        # dtype, as the reference's combine tensor is), summed in fp32
        weight = torch.where(keep, gate_vals.to(dt).float(), 0.0)
        picked = expert_out.reshape(-1, d)[slot].reshape(
            n_groups, g_size, top_k, d)
        yt = torch.einsum("gsk,gskd->gsd", weight, picked.float()).to(dt)

    y = yt.reshape(n_groups * g_size, d)
    if n_groups * g_size < t:
        tail = tokens[n_groups * g_size:]
        y = torch.cat([y, tail if first == 0 else torch.zeros_like(tail)],
                      dim=0)
    # Switch's load-balancing loss: E · sum_e(top-1 share_e · mean prob_e)
    frac = torch.mean(onehot[:, :, 0].float().sum(dim=1) / g_size, dim=0)
    mean_p = torch.mean(probs, dim=(0, 1))
    if return_stats:
        return y.reshape(b, s, d), (frac, mean_p)
    aux = torch.sum(frac * mean_p) * n_experts
    return y.reshape(b, s, d), aux
