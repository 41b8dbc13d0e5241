"""Dry run: trace every (arch x shape x mesh) cell of the LM on a fake mesh.

The JAX package lowers and compiles each cell for 256 or 512 virtual
devices. The port runs each cell's step once on a ``"fake"`` process
group of 256 (16x16) or 512 (2x16x16) ranks in this process, with every
tensor a fake one (``FakeTensorMode``: shapes and dtypes, no storage),
the way torchtitan estimates memory. The fake tensors sit on ``cuda``
where this build of PyTorch has CUDA, else on ``cpu``: a CPU-only build's
autograd engine cannot run a backward pass over CUDA tensors, even fake
ones. For each cell it

  1. builds the production mesh and the model on ``meta``, then makes its
     parameters DTensors laid out by :mod:`repro_torch.sharding.rules`;
  2. runs the cell's step — train: ``loss_fn``, the backward pass and
     AdamW (fp32 or ``--opt-bf16`` moments); prefill; decode — with the
     flash-attention operator answering fake tensors from their shapes;
  3. records the per-rank peak from ``MemTracker`` beside
     ``chip_memory_estimate``, the collectives by kind and bytes a rank
     sends or receives (local result sizes, as the JAX package's HLO
     inventory counts them), ``FlopCounterMode``'s FLOPs beside
     ``cell_cost`` and the roofline at the H100's peaks;
  4. writes ``{arch}_{shape}_{single|multi}[_tag].json`` to ``--out``.

A cell that raises is recorded as ``failed`` with its error, and the sweep
goes on. ``--arch caloforest`` traces one slice of the sharded forest
trainer (``forest/distributed.py``'s ``make_distributed_fit``) instead.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import flops as fl
from repro_torch.config import (LM_SHAPES, SHAPES_BY_NAME, ForestConfig,
                                ShapeConfig, TrainConfig, shape_applicable)
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.sharding import rules
from repro_torch.sharding.dtensor import Layout, distribute_model
from repro_torch.train.optim import adamw_update, init_opt_state



# ---------------------------------------------------------------------------
# the fake process group and the recorders
# ---------------------------------------------------------------------------

def fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process (rank
    0): collectives return at once, touching no data. Re-made when the
    world size changes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _collective_mode():
    """A dispatch mode that sums the result bytes of every collective a
    rank runs, by kind. DTensor ops pass through to DTensor first (the
    mode returns ``NotImplemented`` for them, as ``CommDebugMode`` does),
    so the collectives DTensor issues on local tensors are seen."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes: Dict[str, int] = {}
            self.counts: Dict[str, int] = {}
            self.inside_alltoall = 0

        def add(self, kind: str, res) -> None:
            self.bytes[kind] = self.bytes.get(kind, 0) + _nbytes(res)
            self.counts[kind] = self.counts.get(kind, 0) + 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            ns = func.namespace
            if ns in ("_c10d_functional", "c10d") and \
                    not self.inside_alltoall:
                kind = _COLLECTIVES.get(func._opname)
                if kind is not None:
                    self.add(kind, out[0] if ns == "c10d" and
                             isinstance(out, tuple) else out)
            return out

    return Collectives()


@contextlib.contextmanager
def _alltoall_counted(coll):
    """DTensor moves a shard from one tensor dim to another with an
    all-to-all; on a CPU mesh (gloo has none) it all-gathers and chunks
    instead. Count it as the all-to-all a GPU mesh runs, by its result's
    bytes, whichever way it runs here."""
    import torch.distributed.tensor.placement_types as pt
    real = getattr(pt, "shard_dim_alltoall", None)
    if real is None:
        yield
        return

    def counted(*args, **kwargs):
        coll.inside_alltoall += 1
        try:
            out = real(*args, **kwargs)
        finally:
            coll.inside_alltoall -= 1
        coll.add("all-to-all", out)
        return out

    pt.shard_dim_alltoall = counted
    try:
        yield
    finally:
        pt.shard_dim_alltoall = real


@contextlib.contextmanager
def _quiet_propagation():
    """DTensor infers an op's output layout by running the op on fake
    tensors of the global shapes, in the active fake mode — here the
    trace's own, under the recorders, which would count those runs as the
    rank's memory and FLOPs. Run that inference with every mode set aside
    (it then makes a fake mode of its own), so the recorders see only the
    ops a rank runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return real(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def _peak(tracker) -> Tuple[int, Dict[str, int]]:
    """The tracked peak (bytes) and its parts (parameters, gradients,
    activations, optimizer state, ...) on the device with the most."""
    snap = tracker.get_tracker_snapshot("peak")
    if not snap:
        return 0, {}
    parts = max(snap.values(), key=lambda v: v.get("Total", 0))
    return int(parts.get("Total", 0)), {str(k): int(v)
                                        for k, v in parts.items()}


def _packed(q, k, v, causal: bool = True):
    """``--attn packed``: causal self-attention over the visible block
    pairs (``mea_attention_packed``); the rest through ``mea_attention``."""
    block = min(1024, q.shape[2])
    if causal and q.shape[2] == k.shape[2] and q.shape[2] % block == 0:
        return attn.mea_attention_packed(q, k, v, block=block)
    return attn.mea_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# one LM cell
# ---------------------------------------------------------------------------

def default_device() -> str:
    """The fake tensors' device unless ``--fake-device`` says: ``cuda``
    where PyTorch has CUDA."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh_for(multi_pod: bool, debug_mesh: Optional[Tuple[int, int]],
              dev: str):
    if debug_mesh is not None:
        fake_group(debug_mesh[0] * debug_mesh[1])
        return make_debug_mesh(*debug_mesh, device=dev)
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device=dev)


def _fake_inputs(tree, dev: str):
    """``input_specs``' meta tensors as fake tensors on ``dev`` (ids 0)."""
    if isinstance(tree, dict):
        return {k: _fake_inputs(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_inputs(v, dev) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             remat_policy: str = "full", mla_absorb: bool = False,
             attn_impl: str = "blocked", layout: str = "2d",
             moe_w8: bool = False, opt_bf16: bool = False, tag: str = "",
             *, reduced: bool = False, shape: Optional[ShapeConfig] = None,
             debug_mesh: Optional[Tuple[int, int]] = None,
             fake_device: Optional[str] = None) -> dict:
    """Trace one cell; returns its record (``status`` ``ok``, ``skipped``
    or ``failed``). ``reduced``, ``shape`` and ``debug_mesh`` cut a cell
    down for tests; ``fake_device``: the fake tensors' device type."""
    t0 = time.time()
    cfg = get_arch(arch_id, reduced=reduced)
    if mla_absorb:
        # frozen dataclass; the decode path reads getattr(cfg, "mla_absorb")
        object.__setattr__(cfg, "mla_absorb", True)
    shape = shape or SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    mesh_name = ("x".join(map(str, debug_mesh)) if debug_mesh
                 else "2x16x16" if multi_pod else "16x16")
    rec = {"arch": arch_id, "shape": shape.name, "mesh": mesh_name,
           "remat": remat_policy, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    try:
        rec.update(_trace_cell(cfg, shape, multi_pod, remat_policy,
                               mla_absorb, attn_impl, layout, moe_w8,
                               opt_bf16, debug_mesh,
                               fake_device or default_device()))
    except Exception as e:  # noqa - record the failure, don't stop the sweep
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        return rec
    rec["compile_s"] = round(time.time() - t0, 1)
    return rec


def _trace_cell(cfg, shape, multi_pod, remat_policy, mla_absorb, attn_impl,
                layout_name, moe_w8, opt_bf16, debug_mesh, dev) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = _mesh_for(multi_pod, debug_mesh, dev)
    chips = mesh.size()
    dp, tp = rules.axes_for_mesh(len(mesh.mesh_dim_names) == 3)
    tp_size = mesh.size(mesh.mesh_dim_names.index(tp))
    dp_size = chips // tp_size
    if layout_name == "dp_only":
        # pure data parallel: batch and FSDP over every dim, no TP
        dp, dp_size, tp_size = dp + (tp,), chips, 1
    dtype = torch.bfloat16
    model = lm.init_params(cfg, device="meta")
    if moe_w8:
        lm.quantize_experts(model)
    specs = rules.param_specs(model, cfg, dp, tp, dp_size, tp_size)
    inputs = lm.input_specs(cfg, shape, dtype)
    train_attend = _packed if attn_impl == "packed" else attn.mea_attention
    tcfg = TrainConfig(remat_policy=remat_policy)

    with FakeTensorMode(allow_non_fake_inputs=True):
        model = model.to_empty(device=dev)
        lay = Layout(mesh, dp)
        distribute_model(model, lay, specs)
        params = list(model.parameters())
        opt = None
        if shape.kind == "train":
            opt = init_opt_state(params, torch.bfloat16 if opt_bf16
                                 else torch.float32)
        batch = _fake_inputs({k: v for k, v in inputs.items()
                              if k != "cache"}, dev)
        cache = None
        if shape.kind == "decode":
            with torch.no_grad():
                cache_specs = rules.cache_specs(inputs["cache"], dp, tp,
                                                dp_size, tp_size)
                cache = lay.shard_tree(_fake_inputs(inputs["cache"], dev),
                                       cache_specs)

        def step():
            if shape.kind == "train":
                loss, _ = lm.loss_fn(model, batch, cfg, dtype=dtype,
                                     remat_policy=remat_policy,
                                     attend=train_attend)
                with implicit_replication():
                    grads = torch.autograd.grad(loss, params,
                                                allow_unused=True)
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)]
                    new, _, _ = adamw_update(grads, opt, params, tcfg)
                    with torch.no_grad():
                        for p, q in zip(params, new):
                            p.copy_(q)
            elif shape.kind == "prefill":
                lm.prefill_step(model, batch, cfg, dtype=dtype,
                                **({"attend": _packed}
                                   if attn_impl == "packed" else {}))
            else:
                lm.decode_step(model, cache, batch["tokens"], 0, cfg,
                               dtype=dtype)

        coll = _collective_mode()
        tracker = MemTracker()
        tracker.track_external(model, *(opt["m"] + opt["v"] if opt else []),
                               *([t for seg in cache for d in seg.values()
                                  for t in d.values()] if cache else []))
        with _quiet_propagation(), _alltoall_counted(coll), tracker, coll:
            traced = fl.traced_flops(step)
        peak, parts = _peak(tracker)

    acost = fl.cell_cost(cfg, shape, chips=chips, dp_size=dp_size,
                         tp_size=tp_size, remat_policy=remat_policy,
                         mla_absorb=mla_absorb,
                         attn_packed=(attn_impl == "packed"), moe_w8=moe_w8)
    est = fl.chip_memory_estimate(cfg, shape, chips=chips,
                                  remat_policy=remat_policy, moe_w8=moe_w8,
                                  opt_bf16=opt_bf16)
    return dict(
        status="ok", chips=chips, layout=layout_name,
        memory_analysis={
            "peak_bytes_per_device": peak,
            "peak_parts": parts,
            "analytic_per_chip_bytes": est["per_chip_bytes"],
            "fits_80GB": bool(peak < fl.HBM_BYTES),
            "source": "MemTracker over the traced step (fake tensors: "
                      "parameters, optimizer state, cache, activations, "
                      "gradients of this rank)",
        },
        cost_analysis_raw={"flops": traced["flops"] * chips,
                           "flops_per_rank": traced["flops"]},
        flops_by_op=traced["by_op"],
        collective_inventory=dict(coll.bytes),
        collective_counts=dict(coll.counts),
        collective_bytes_hlo_scaled=sum(coll.bytes.values()),
        scan_trip_count=1,
        analytic={
            "fwd_flops": acost.fwd_flops,
            "total_flops": acost.total_flops,
            "hbm_bytes": acost.hbm_bytes,
            "coll_bytes": acost.coll_bytes,
            "model_flops": acost.model_flops,
        },
        roofline=fl.roofline(acost, chips),
    )


# ---------------------------------------------------------------------------
# the forest slice
# ---------------------------------------------------------------------------

def run_forest_cell(dataset: str, multi_pod: bool,
                    split_reduce: str = "allreduce", hist_bf16: bool = False,
                    int8_codes: bool = False, tag: str = "", *,
                    n_rows: int = 122880, p: Optional[int] = None,
                    fcfg: Optional[ForestConfig] = None,
                    debug_mesh: Optional[Tuple[int, int]] = None,
                    fake_device: Optional[str] = None) -> dict:
    """caloforest: one sharded boosting slice at CaloChallenge scale (16
    ensembles over the model dim, the rows over the data dims), traced on
    the fake mesh with fake tensors (``hist`` answers from its shapes)."""
    t0 = time.time()
    p = p or {"photons": 368, "pions": 533}[dataset]
    fcfg = fcfg or ForestConfig(n_t=100, duplicate_k=20, n_trees=2,
                                max_depth=7, learning_rate=1.5, n_bins=64,
                                reg_lambda=1.0, split_reduce=split_reduce,
                                hist_bf16=hist_bf16, int8_codes=int8_codes)
    mesh_name = ("x".join(map(str, debug_mesh)) if debug_mesh
                 else "2x16x16" if multi_pod else "16x16")
    rec = {"arch": "caloforest", "shape": dataset, "mesh": mesh_name,
           "tag": tag, "split_reduce": fcfg.split_reduce,
           "hist_bf16": fcfg.hist_bf16}
    try:
        rec.update(_trace_forest(multi_pod, n_rows, p, fcfg, debug_mesh,
                                 fake_device or default_device()))
    except Exception as e:  # noqa - record the failure
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        return rec
    rec["compile_s"] = round(time.time() - t0, 1)
    return rec


def _trace_forest(multi_pod, n_rows, p, fcfg, debug_mesh, dev) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.forest.distributed import Shards, make_distributed_fit

    mesh = _mesh_for(multi_pod, debug_mesh, dev)
    chips = mesh.size()
    names = mesh.mesh_dim_names
    if len(names) == 3:
        # the sharded trainer's (data, model) view: pod and data fold into
        # the data ranks
        mesh = DeviceMesh(dev, mesh.mesh.reshape(-1, mesh.size(2)),
                          mesh_dim_names=("data", "model"))
    shards = Shards.from_mesh(mesh)
    n_ens = shards.model_size
    n_local = n_rows // shards.data_size

    dev = torch.device(dev)

    def noise(eid, split, shape, shard):
        return torch.randn(shape, device=dev), None

    with FakeTensorMode(allow_non_fake_inputs=True):
        fit = make_distributed_fit(shards, fcfg, seed=0, stream=0,
                                   device=dev, noise=noise)
        x0 = torch.randn((n_local, p), device=dev)
        w = torch.ones((n_local,), device=dev)
        cid = torch.zeros((n_local,), dtype=torch.int32, device=dev)
        ts = [0.5] * n_ens
        ys = [0] * n_ens
        eids = list(range(n_ens))
        coll = _collective_mode()
        tracker = MemTracker()
        tracker.track_external(x0, w, cid)
        with _quiet_propagation(), _alltoall_counted(coll), tracker, coll:
            traced = fl.traced_flops(fit, x0, w, cid, ts, ys, eids)
        peak, parts = _peak(tracker)
    acost = fl.forest_cost(n_rows=n_rows, p=p, fcfg=fcfg, chips=chips,
                           data_shards=shards.data_size, out_dim=1)
    return dict(
        status="ok", chips=chips,
        memory_analysis={"peak_bytes_per_device": peak, "peak_parts": parts},
        cost_analysis_raw={"flops": traced["flops"] * chips,
                           "flops_per_rank": traced["flops"]},
        collective_inventory=dict(coll.bytes),
        collective_counts=dict(coll.counts),
        analytic={"total_flops": acost.total_flops,
                  "hbm_bytes": acost.hbm_bytes,
                  "coll_bytes": acost.coll_bytes},
        roofline=fl.roofline(acost, chips),
        note=("one 2-round ensemble slice a model rank; the full run loops "
              "n_t*n_y/16 slices; the histogram reduction over the data "
              "ranks is the only hot-loop collective"),
    )


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn", default="blocked",
                    choices=("blocked", "packed"))
    ap.add_argument("--layout", default="2d", choices=("2d", "dp_only"))
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--split-reduce", default="allreduce",
                    choices=("allreduce", "reduce_scatter"))
    ap.add_argument("--hist-bf16", action="store_true")
    ap.add_argument("--int8-codes", action="store_true")
    ap.add_argument("--moe-w8", action="store_true",
                    help="int8 weight-only routed experts (decode cells)")
    ap.add_argument("--opt-bf16", action="store_true",
                    help="bf16 AdamW moments (halves optimizer HBM)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--fake-device", default=None, choices=("cuda", "cpu"),
                    help="the fake tensors' device (default: cuda where "
                         "PyTorch has CUDA)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in LM_SHAPES:
                cells.append((arch, shape.name))
        cells.append(("caloforest", "photons"))
        cells.append(("caloforest", "pions"))
    else:
        cells.append((args.arch, args.shape))

    try:
        for mp in meshes:
            for arch, shape in cells:
                if arch == "caloforest":
                    rec = run_forest_cell(shape, mp,
                                          split_reduce=args.split_reduce,
                                          hist_bf16=args.hist_bf16,
                                          int8_codes=args.int8_codes,
                                          tag=args.tag,
                                          fake_device=args.fake_device)
                else:
                    rec = run_cell(arch, shape, mp, remat_policy=args.remat,
                                   mla_absorb=args.mla_absorb,
                                   attn_impl=args.attn, layout=args.layout,
                                   moe_w8=args.moe_w8, opt_bf16=args.opt_bf16,
                                   tag=args.tag,
                                   fake_device=args.fake_device)
                suffix = "multi" if mp else "single"
                if args.tag:
                    suffix += f"_{args.tag}"
                path = out_dir / f"{arch}_{shape}_{suffix}.json"
                path.write_text(json.dumps(rec, indent=1, default=str))
                status = rec["status"]
                extra = ""
                if status == "ok" and "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" mfu_bound={r['mfu_bound']:.3f}")
                    peak = rec["memory_analysis"]["peak_bytes_per_device"]
                    extra += f" peak={peak / 1e9:.2f}GB"
                print(f"[{status}] {arch} x {shape} x {rec['mesh']}"
                      f" ({rec.get('compile_s', '-')}s){extra}", flush=True)
                if status == "failed":
                    print(rec["error"], flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
