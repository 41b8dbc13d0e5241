"""Analytic cost model: FLOPs / HBM bytes / collective bytes per cell.

A port of ``repro.analysis.flops``, term by term: FLOPs, HBM bytes and
collective bytes count the work of a step and are hardware-free, so they
equal the JAX package's numbers. What changes is the machine they are
held against: one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet) —
989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s, 450e9 NVLink bytes/s each
way, 80 GB of HBM. ``chip_smoke.py``'s kernel bounds take the same peaks
from here.

Why analytic: the JAX package's compiled cost analysis counts a scanned
layer once; the port's loops are unrolled in Python, and its counterpart,
:func:`traced_flops` (``torch.utils.flop_counter.FlopCounterMode`` over a
step, with a formula registered for the flash-attention operator, which
the counter cannot see into), checks the model on probes
(``tests/test_torch_flops.py``) and sits beside it in the dry run's
artifacts.

Conventions: one MAC = 2 FLOPs; attention is counted at full S^2 (the
blocked path computes masked full blocks); bf16 activations / fp32
master + optimizer states.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models import blocks

# NVIDIA H100 SXM (H100 80GB HBM3) at 700 W, from its data sheet
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
PEAK_FLOPS_FP32 = 67e12      # fp32 FLOP/s per card (CUDA cores)
HBM_BW = 3.35e12             # HBM3 bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s per card, each way
HBM_BYTES = 80e9             # HBM per card


_FORMULAS_REGISTERED = []


def _register_formulas() -> None:
    """FlopCounter formulas for the port's operators, which the counter
    cannot see into: ``repro_torch::flash_attention`` (q·kᵀ and p·v at full
    Sq × Skv, the analytic model's convention) and
    ``repro_torch::histogram``."""
    if _FORMULAS_REGISTERED:
        return
    import torch
    from torch.utils.flop_counter import register_flop_formula
    # each operator is defined where its wrapper is
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.kernels.hist.ops  # noqa: F401

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs):
        b, hq, sq, d = q_shape
        skv = k_shape[2]
        return 2 * b * hq * sq * skv * d * 2

    @register_flop_formula(torch.ops.repro_torch.histogram)
    def _hist_flops(codes_shape, node_shape, g_shape, *args, out_shape=None,
                    **kwargs):
        # forest_cost's accumulation term: g·w and w into every feature's
        # bin, for each lane's rows
        s, n, out = g_shape
        return 2 * s * n * codes_shape[1] * (out + 1)

    _FORMULAS_REGISTERED.append(True)


def traced_flops(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` counting the FLOPs of the ops this
    process runs by ``torch.utils.flop_counter``'s formulas (on a mesh:
    one rank's ops — DTensor ops reach DTensor first, as in
    ``CommDebugMode``, and are counted by their local shards; ``local_map``
    bodies too). Returns ``{"flops": total, "by_op": {op: flops}}``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    _register_formulas()
    by_op: Dict[str, float] = {}

    class RankFlops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                key = str(func._overloadpacket)
                by_op[key] = by_op.get(key, 0) + formula(*args, **kwargs,
                                                         out_val=out)
            return out

    with RankFlops():
        fn(*args, **kwargs)
    return {"flops": float(sum(by_op.values())), "by_op": by_op}


def _attn_proj_flops(cfg, n_tok):
    h, kv, d, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.d_head
    return 2 * n_tok * d * (h * hd) + 2 * n_tok * d * (kv * hd) * 2 \
        + 2 * n_tok * (h * hd) * d


def _mlp_flops(cfg, n_tok, ff):
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * n_tok * cfg.d_model * ff * mats


def _moe_flops(cfg, n_tok, group=512, cf=1.25):
    d, e, k, ffe = cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    expert = 2 * n_tok * k * cf * d * ffe * mats
    router = 2 * n_tok * d * e
    # dispatch + combine einsums: 2 * G*S*E*C*D each, C = S*k/E*cf
    dispatch = 2 * (2 * n_tok * group * k * cf * d)
    return expert + router + dispatch


def _layer_fwd_flops(cfg: ArchConfig, kind: str, n_tok: int, s_ctx: int,
                     mla_absorb: bool = False, decode: bool = False,
                     attn_packed: bool = False) -> float:
    d = cfg.d_model
    # packed causal attention computes S^2/2 + one diagonal block
    ctx_fac = 0.5 + 1024.0 / max(s_ctx, 1024) / 2 if attn_packed else 1.0
    f = 0.0
    if kind in ("dense", "moe", "enc", "attn"):
        f += _attn_proj_flops(cfg, n_tok)
        eff = s_ctx * (ctx_fac if kind != "enc" else 1.0)
        f += 2 * n_tok * eff * cfg.n_heads * cfg.d_head * 2  # qk + pv
    if kind == "lattn":
        f += _attn_proj_flops(cfg, n_tok)
        win = min(cfg.attn_window, s_ctx)
        f += 2 * n_tok * win * cfg.n_heads * cfg.d_head * 2
    if kind in ("mla_dense", "mla_moe"):
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rp, vd, h = (cfg.nope_head_dim, cfg.rope_head_dim,
                           cfg.v_head_dim, cfg.n_heads)
        f += 2 * n_tok * d * qr + 2 * n_tok * qr * h * (nope + rp)
        f += 2 * n_tok * d * kvr + 2 * n_tok * d * rp
        if decode and mla_absorb:
            # fold wk_b into q, wv_b into out: per-token work scales with kvr
            f += 2 * n_tok * h * nope * kvr * 2      # q absorb + out absorb
            f += 2 * n_tok * s_ctx * h * kvr * 2     # scores + context on latent
            f += 2 * n_tok * s_ctx * h * rp          # rope scores
        else:
            # expand k/v from the latent for the whole context
            ctx_tok = n_tok if not decode else n_tok * s_ctx
            f += 2 * ctx_tok * kvr * h * nope + 2 * ctx_tok * kvr * h * vd
            eff = s_ctx * (ctx_fac if not decode else 1.0)
            f += 2 * n_tok * eff * h * (nope + rp) + 2 * n_tok * eff * h * vd
        f += 2 * n_tok * h * vd * d
    if kind == "dec":
        f += _attn_proj_flops(cfg, n_tok) * 2          # self + cross projs
        f += 2 * n_tok * s_ctx * cfg.n_heads * cfg.d_head * 2        # self
        f += 2 * n_tok * 1500 * cfg.n_heads * cfg.d_head * 2         # cross
    if kind == "rec":
        w = cfg.rnn_width
        f += 2 * n_tok * d * w * 2 + 2 * n_tok * cfg.conv1d_width * w
        f += 2 * n_tok * w * w * 2 + 10 * n_tok * w + 2 * n_tok * w * d
    if kind == "mlstm":
        w = cfg.rnn_width
        hd = w // cfg.n_heads
        chunk = min(256, s_ctx)
        f += 2 * n_tok * d * w * 2 + 2 * n_tok * cfg.conv1d_width * w
        f += 2 * n_tok * w * w * 3                      # q, k, v
        f += 2 * n_tok * chunk * w * 2                  # intra-chunk quadratic
        f += 2 * n_tok * hd * w * 2 * 2                 # state update + query
        f += 2 * n_tok * w * d
    if kind == "slstm":
        f += 2 * n_tok * d * d * 3 + 12 * n_tok * d
    # FFN halves
    if kind in ("dense", "enc", "dec", "lattn", "attn"):
        f += _mlp_flops(cfg, n_tok, cfg.d_ff)
    if kind == "mla_dense":
        f += _mlp_flops(cfg, n_tok, cfg.d_ff_dense or cfg.d_ff)
    if kind == "rec":
        f += _mlp_flops(cfg, n_tok, cfg.d_ff)
    if kind == "moe":
        f += _moe_flops(cfg, n_tok)
    if kind == "mla_moe":
        f += _moe_flops(cfg, n_tok)
        if cfg.n_shared_experts:
            f += _mlp_flops(cfg, n_tok, cfg.n_shared_experts * cfg.d_ff_expert)
    return f


def _all_kinds(cfg: ArchConfig):
    out = []
    for kinds, n in blocks.segments_for(cfg):
        out += list(kinds) * n
    return out


@functools.lru_cache(maxsize=None)
def param_count(cfg: ArchConfig) -> float:
    """Exact parameter count: the port's model built on ``meta`` (no
    storage), every parameter's elements summed."""
    from repro_torch.models import lm
    model = lm.init_params(cfg, device="meta")
    return float(sum(p.numel() for p in model.parameters()))


def _non_expert_params(cfg: ArchConfig) -> float:
    """Params outside routed-expert stacks (attention, norms, embeddings...)."""
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_expert = mats * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(1 for k in _all_kinds(cfg) if k in ("moe", "mla_moe"))
    return param_count(cfg) - n_moe_layers * cfg.n_experts * per_expert


def active_param_count(cfg: ArchConfig) -> float:
    """Params touched per token (MoE: top-k experts only)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    # subtract inactive expert weights
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_expert = mats * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(1 for k in _all_kinds(cfg) if k in ("moe", "mla_moe"))
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


@dataclasses.dataclass
class CellCost:
    fwd_flops: float
    total_flops: float          # incl. bwd + remat for train
    hbm_bytes: float            # global bytes moved per step
    coll_bytes: float           # global collective payload bytes per step
    model_flops: float          # 6 N D (dense) / 6 N_active D


def cell_cost(cfg: ArchConfig, shape: ShapeConfig, *, chips: int,
              dp_size: int, tp_size: int, remat_policy: str = "full",
              mla_absorb: bool = False, attn_packed: bool = False,
              moe_w8: bool = False) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    kinds = _all_kinds(cfg)

    if shape.kind == "decode":
        n_tok = b  # one token per sequence
        s_ctx = s
        decode = True
    else:
        if cfg.family == "audio_encdec":
            n_tok = b * (s // 2)
        else:
            n_tok = b * s
        s_ctx = s if cfg.family != "audio_encdec" else s // 2
        decode = False

    fwd = 0.0
    if cfg.family == "audio_encdec":
        for _ in range(cfg.n_layers):
            fwd += _layer_fwd_flops(cfg, "enc", n_tok, s_ctx)
        for _ in range(cfg.n_layers):
            fwd += _layer_fwd_flops(cfg, "dec", n_tok, s_ctx, decode=decode,
                                    attn_packed=attn_packed)
    else:
        for k in kinds:
            fwd += _layer_fwd_flops(cfg, k, n_tok, s_ctx,
                                    mla_absorb=mla_absorb, decode=decode,
                                    attn_packed=attn_packed)
    # unembed
    fwd += 2 * n_tok * cfg.d_model * cfg.vocab

    p_total = param_count(cfg)
    if shape.kind == "train":
        mult = {"full": 4.0, "dots": 3.3, "none": 3.0}[remat_policy]
        total = fwd * mult
        # bytes: params bf16 fwd+bwd reads, fp32 master/m/v r+w, grads,
        # activations r/w ~ 12 tensors of [n_tok, d] per layer + remat reread
        act_bytes = len(kinds) * n_tok * cfg.d_model * 2 * 12
        if remat_policy == "full":
            act_bytes *= 1.5
        hbm = p_total * (2 + 2 + 2) + p_total * 4 * 6 + act_bytes
        # collectives: grad psum over dp (ring 2(n-1)/n), fsdp weight
        # all-gather fwd+bwd, per-layer TP activation reduces (2 per layer)
        dp_fac = 2 * (dp_size - 1) / dp_size
        ag_fac = (dp_size - 1) / dp_size
        coll = p_total * 4 * dp_fac                      # grad all-reduce fp32
        coll += p_total * 2 * ag_fac * 2                 # fsdp AG fwd + bwd
        coll += len(kinds) * 2 * n_tok * cfg.d_model * 2 * (tp_size - 1) / tp_size
    elif shape.kind == "prefill":
        total = fwd
        act_bytes = len(kinds) * n_tok * cfg.d_model * 2 * 8
        hbm = p_total * 2 + act_bytes
        ag_fac = (dp_size - 1) / dp_size
        coll = p_total * 2 * ag_fac
        coll += len(kinds) * 2 * n_tok * cfg.d_model * 2 * (tp_size - 1) / tp_size
    else:  # decode
        total = fwd
        cache = _cache_bytes(cfg, b, s)
        # batch decode touches ~E*(1-(1-k/E)^(B)) experts per MoE layer
        if cfg.n_experts:
            frac = 1.0 - (1.0 - cfg.top_k / cfg.n_experts) ** b
            expert_read = frac * (param_count(cfg) - active_param_count(cfg)) \
                + (active_param_count(cfg) - _non_expert_params(cfg))
            dense_read = _non_expert_params(cfg)
            # int8 weight-only experts: 1 byte/weight instead of bf16's 2
            hbm_w = expert_read * (1 if moe_w8 else 2) + dense_read * 2
        else:
            hbm_w = param_count(cfg) * 2
        hbm = hbm_w + cache + n_tok * cfg.d_model * 2 * 8
        coll = len(kinds) * 2 * n_tok * cfg.d_model * 2 * (tp_size - 1) / tp_size
    # 6ND counts fwd+bwd (train); inference steps are forward-only: 2ND
    nd_factor = 6 if shape.kind == "train" else 2
    model_flops = nd_factor * active_param_count(cfg) * n_tok
    return CellCost(fwd, total, hbm, coll, model_flops)


def _cache_bytes(cfg: ArchConfig, b: int, s: int) -> float:
    kinds = _all_kinds(cfg)
    total = 0.0
    for k in kinds:
        if k in ("dense", "moe", "attn", "enc"):
            total += b * cfg.n_kv_heads * s * cfg.d_head * 2 * 2
        elif k == "dec":
            total += b * cfg.n_kv_heads * (s + 1500) * cfg.d_head * 2 * 2
        elif k == "lattn":
            total += b * cfg.n_kv_heads * min(s, cfg.attn_window) \
                * cfg.d_head * 2 * 2
        elif k in ("mla_dense", "mla_moe"):
            total += b * s * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
        elif k == "rec":
            total += b * cfg.rnn_width * 4
        elif k == "mlstm":
            hd = cfg.rnn_width // cfg.n_heads
            total += b * cfg.n_heads * (hd * hd + hd) * 4
        elif k == "slstm":
            total += b * cfg.d_model * 4
    return total * 2  # read + write


def forest_cost(*, n_rows: int, p: int, fcfg, chips: int, data_shards: int,
                out_dim: int = 1) -> CellCost:
    """Analytic cost of ONE distributed SO boosting round (one tree for each
    of the 16 ensembles in a model-axis slice, vmapped over p outputs).

    FLOPs: histogram accumulation (n*(out+1) adds per feature per level) +
    split search (nodes*p*bins*out) + traversal compares. Bytes: codes read
    per level + gradient vectors. Collectives: per-level histogram reduction
    (all-reduce = 2(n-1)/n * size; reduce-scatter = (n-1)/n * size + tiny
    argmax gather) summed over levels and outputs.
    """
    n_local_rows = n_rows // data_shards * fcfg.duplicate_k
    n_global = n_rows * fcfg.duplicate_k
    depth, bins = fcfg.max_depth, fcfg.n_bins
    n_ens_slice = 16  # one model-axis slice
    n_sub = p if not fcfg.multi_output else 1
    o = out_dim if not fcfg.multi_output else p
    flops = 0.0
    hist_coll = 0.0
    hbm = 0.0
    hist_elem_bytes = 2 if fcfg.hist_bf16 else 4
    code_bytes = 1 if getattr(fcfg, "int8_codes", False) else 4
    for level in range(depth):
        nodes = 2 ** level
        flops += n_global * p * (o + 1) * 2          # hist accumulation
        flops += nodes * p * bins * o * 6            # split search
        flops += n_global * 4                        # node-id update
        hbm += n_global * p * code_bytes + n_global * (o + 2) * 4
        size = nodes * p * bins * (o + 1) * hist_elem_bytes
        if fcfg.split_reduce == "reduce_scatter":
            hist_coll += size * (data_shards - 1) / data_shards
            hist_coll += nodes * 3 * 4 * data_shards  # argmax gather
        else:
            hist_coll += 2 * size * (data_shards - 1) / data_shards
    per_tree = CellCost(flops, flops, hbm, hist_coll, flops)
    scale = n_sub * n_ens_slice * fcfg.n_trees
    return CellCost(per_tree.fwd_flops * scale, per_tree.total_flops * scale,
                    per_tree.hbm_bytes * scale, per_tree.coll_bytes * scale,
                    per_tree.model_flops * scale)


def chip_memory_estimate(cfg: ArchConfig, shape: ShapeConfig, *, chips: int,
                         remat_policy: str = "full",
                         moe_w8: bool = False,
                         opt_bf16: bool = False) -> Dict[str, float]:
    """Analytic peak HBM per card (the fits-in-80-GB argument): sharded
    params + optimizer states + grads + checkpointed residuals (+ cache
    for decode), divided across the cards; the JAX package's terms, held
    against the H100's 80 GB instead of v5e's 16 GiB. The dry run puts
    ``MemTracker``'s traced per-rank peak beside it."""
    p_total = param_count(cfg)
    kinds = _all_kinds(cfg)
    b, s = shape.global_batch, shape.seq_len
    n_tok = b * s if shape.kind != "decode" else b
    if shape.kind == "train":
        params_b = p_total * 4                     # fp32 master
        opt_b = p_total * (4 if opt_bf16 else 8)   # m + v
        grads_b = p_total * 4
        # checkpointed residual per layer: the scan carry in bf16
        resid = len(kinds) * n_tok * cfg.d_model * 2
        if remat_policy == "dots":
            resid *= 2.2                           # saved matmul outputs
        # live working set during one layer's bwd: ~8 activation tensors
        work = n_tok * cfg.d_model * 2 * 8
        # one chunked-loss logits tile in fp32
        loss_tile = b * min(2048, s) * cfg.vocab * 4
        total = params_b + opt_b + grads_b + resid + work + loss_tile
    elif shape.kind == "prefill":
        params_b = p_total * 2                     # bf16 serving weights
        resid = len(kinds) * n_tok * cfg.d_model * 2
        work = n_tok * cfg.d_model * 2 * 8
        cache = _cache_bytes(cfg, b, s) / 2        # one copy (no rw double)
        total = params_b + resid + work + cache
    else:
        params_b = p_total * (1.2 if moe_w8 else 2)
        cache = _cache_bytes(cfg, b, s) / 2        # donated in/out alias
        work = n_tok * cfg.d_model * 2 * 16
        total = params_b + cache + work
    per_chip = total / chips
    return {"per_chip_bytes": per_chip,
            "per_chip_gib": per_chip / 2 ** 30,
            "fits_80GB": bool(per_chip < HBM_BYTES)}


def roofline(cost: CellCost, chips: int) -> Dict[str, float]:
    t_comp = cost.total_flops / (chips * PEAK_FLOPS)
    t_mem = cost.hbm_bytes / (chips * HBM_BW)
    t_coll = cost.coll_bytes / (chips * LINK_BW)
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])
    bound = max(t_comp, t_mem, t_coll)
    t_model = cost.model_flops / (chips * PEAK_FLOPS)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant[0],
        # fraction of the step the chips could spend doing compiled compute
        "roofline_fraction": t_comp / bound if bound > 0 else 0.0,
        # upper bound on model-FLOPs utilisation (the reported perf score)
        "mfu_bound": t_model / bound if bound > 0 else 0.0,
        "useful_flops_ratio": (cost.model_flops / cost.total_flops
                               if cost.total_flops else 0.0),
    }
