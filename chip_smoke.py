#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the ``tree_predict`` CUDA kernel from the sources in this checkout.
3. Holds the kernel against its plain PyTorch version on the card, at the
   shapes the generation path gives it (MO at CaloForest photons width, SO
   at one step's shape, odd row counts, +inf sentinels and threshold ties),
   to a max abs difference of 1e-6 (both sum the trees in the same order);
   times kernel and plain version at the main path's shape.
4. Drives the port's generation path through ``TabularGenerator`` at the
   full width of the CaloForest photons model (method=flow, MO trees,
   n_t=100, n_trees=20, max_depth=7, p=368, n_y=15; random weights from a
   seed, built on the device): euler with two padding buckets, heun, euler
   at n=120,000, ddim and em on the same arrays as a diffusion model, and an
   impute of 512 rows. Checks shapes, finiteness, padding invariance,
   observed cells and the kernel's launch count per call.
5. Checks the path against the plain PyTorch version on the CPU at a small
   size, and a save -> load round trip.

Exits non-zero on any failure and when no CUDA device is present. The line
before the last is a JSON object with the kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-6             # kernel and plain version sum in the same order
# whole solve, GPU vs CPU, same inputs: expf/sqrtf differ in the last place
# between the two, and DDIM divides by alpha(t=1) ~ 0.0066
SMALL_TOL = 1e-4

# CaloForest photons (examples/calorimeter_pipeline.py --full)
P, N_Y, N_T, N_TREES, DEPTH, N_ROWS = 368, 15, 100, 20, 7, 120_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def kernel_inputs(B, S, T, depth, p, out, n, seed, device):
    """Random forests whose values sit on a 1/8 grid, so that many rows tie
    with their thresholds (the compare must stay strict), with ~10% +inf
    sentinels."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    H, L = 2 ** depth - 1, 2 ** depth
    x = torch.round(torch.randn((B, n, p), generator=g, device=device) * 8) / 8
    feat = torch.randint(0, p, (B, S, T, H), generator=g, device=device,
                         dtype=torch.int32)
    thr = torch.round((torch.rand((B, S, T, H), generator=g, device=device)
                       * 2 - 1) * 8) / 8
    thr[torch.rand(thr.shape, generator=g, device=device) < 0.1] = math.inf
    leaf = torch.randn((B, S, T, L, out), generator=g, device=device)
    return x, feat, thr, leaf


def predict_bytes_ops(B, S, T, depth, p, out, n):
    """Bytes the function must move (each input read once, the output written
    once) and the compares and adds it does."""
    H, L = 2 ** depth - 1, 2 ** depth
    nbytes = 4 * (B * n * p + 2 * B * S * T * H + B * S * T * L * out
                  + B * S * n * out)
    ops = B * S * n * T * (depth + out)
    return nbytes, ops


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(device, cases):
    """Kernel vs plain on every case; returns the largest abs difference."""
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.kernels.tree_predict.ref import forest_predict_ref
    worst = 0.0
    for i, (name, shape) in enumerate(cases):
        args = kernel_inputs(*shape, seed=100 + i, device=device)
        depth = shape[3]
        got = forest_predict(*args, depth)
        ref = forest_predict_ref(*args, depth)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got - ref).abs().max().item() if ref.numel() else 0.0
        log(f"kernel vs plain {name} (B,S,T,depth,p,out,n)={shape}: "
            f"max abs diff {err!r}")
        if not (got.shape == ref.shape and err <= KERNEL_TOL):
            raise AssertionError(f"tree_predict disagrees on {name}: {err}")
        worst = max(worst, err)
    return worst


def time_kernel(device, shape):
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.kernels.tree_predict.ref import forest_predict_ref
    args = kernel_inputs(*shape, seed=7, device=device)
    depth = shape[3]
    ms = cuda_ms(lambda: forest_predict(*args, depth), 50)
    plain_ms = cuda_ms(lambda: forest_predict_ref(*args, depth), 5)
    nbytes, ops = predict_bytes_ops(*shape)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes)


# ---------------------------------------------------------------------------
# the generation path
# ---------------------------------------------------------------------------

def random_artifacts(cfg, n_y, p, rows_per_class, seed, device):
    """Artifacts of ``cfg``'s shape with random, seeded weights: features
    in [0, p), thresholds in [-1, 1] with ~10% +inf, small leaves so the
    flow stays bounded."""
    from repro_torch.tabgen import ForestArtifacts
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_t, T, depth = cfg.n_t, cfg.n_trees, cfg.max_depth
    H, L = 2 ** depth - 1, 2 ** depth
    S, out = (1, p) if cfg.multi_output else (p, 1)
    feat = torch.randint(0, p, (n_t, n_y, S, T, H), generator=g,
                         device=device, dtype=torch.int32)
    thr = torch.rand((n_t, n_y, S, T, H), generator=g, device=device) * 2 - 1
    thr[torch.rand(thr.shape, generator=g, device=device) < 0.1] = math.inf
    leaf = torch.randn((n_t, n_y, S, T, L, out), generator=g,
                       device=device).mul_(0.05)
    mins = torch.rand((n_y, p), generator=g, device=device)
    maxs = mins + 0.5 + 1.5 * torch.rand((n_y, p), generator=g, device=device)
    return ForestArtifacts(
        feat=feat, thr_val=thr, leaf=leaf,
        best_round=torch.full((n_t, n_y, S), T - 1, dtype=torch.int32,
                              device=device),
        rounds_run=torch.full((n_t, n_y, S), T, dtype=torch.int32,
                              device=device),
        val_curve=torch.zeros((n_t, n_y, S, T), device=device),
        mins=mins, maxs=maxs, classes=np.arange(n_y),
        counts=np.full(n_y, rows_per_class), config=cfg)


def generator_for(art):
    from repro_torch.tabgen import TabularGenerator
    gen = TabularGenerator(art.config)
    gen.artifacts = art
    return gen


def impute_launches(art) -> int:
    """Kernel launches one class's clamped solve makes (3 refine rounds)."""
    from repro_torch.core.interpolants import timesteps
    from repro_torch.tabgen.imputation import restart_index
    cfg = art.config
    ts = timesteps(cfg.method, cfg.n_t, cfg.eps_diff, cfg.t_schedule).numpy()
    return sum(restart_index(ts, r) for r in range(3))


def drive_main_path(flow, n_rows, n_small, pad_small):
    """Serve the requests of the main path; returns launches per call."""
    from repro_torch.kernels.tree_predict.ops import forest_predict
    diffusion = dataclasses.replace(
        flow, config=dataclasses.replace(flow.config, method="diffusion"))
    gen_flow, gen_diff = generator_for(flow), generator_for(diffusion)
    n_t, p = flow.n_t, flow.p
    counts = {}
    outputs = {}

    def call(label, gen, n, expect, **kw):
        """One request; returns whether the device was still busy when
        generate_async returned (it must not wait for the device)."""
        forest_predict.launches = 0
        t0 = time.perf_counter()
        handle = gen.generate_async(n, **kw)
        busy = (flow.device.type == "cuda"
                and not torch.cuda.current_stream().query())
        X, y = handle.result()
        dt = time.perf_counter() - t0
        got = forest_predict.launches
        if X.shape != (n, p) or y.shape != (n,) or not np.isfinite(X).all():
            raise AssertionError(f"{label}: bad output {X.shape} {y.shape}")
        if got != expect:
            raise AssertionError(f"{label}: {got} launches, expected {expect}")
        counts[label] = got
        outputs[label] = (X, y)
        log(f"{label}: n={n} {dt:.4f} s, {n / dt:.1f} rows/s, "
            f"{got} launches")
        return busy

    small, big = f"euler pad_to={pad_small}", f"euler pad_to={4 * pad_small}"
    call(small, gen_flow, n_small, n_t - 1, sampler="euler", seed=1,
         pad_to=pad_small)
    call(big, gen_flow, n_small, n_t - 1, sampler="euler", seed=1,
         pad_to=4 * pad_small)
    (Xa, ya), (Xb, yb) = outputs[small], outputs[big]
    if not (np.array_equal(Xa, Xb) and np.array_equal(ya, yb)):
        raise AssertionError("padding changed the generated rows")
    log(f"padding invariance: rows equal at pad_to={pad_small} and "
        f"{4 * pad_small}")
    call("heun", gen_flow, n_rows, 2 * (n_t - 1), sampler="heun", seed=2)
    busy = call("euler", gen_flow, n_rows, n_t - 1, sampler="euler", seed=3)
    if flow.device.type == "cuda":
        if not busy:
            raise AssertionError("generate_async waited for the device")
        log("euler: generate_async returned while the device was still busy")
    call("ddim", gen_diff, n_rows, n_t, sampler="ddim", seed=4)
    call("em", gen_diff, n_rows, n_t - 1, sampler="em", seed=5)

    # impute 512 generated rows with half the cells missing
    X, y = outputs["euler"]
    rng = np.random.default_rng(0)
    X_obs, y_obs = X[:512], y[:512]
    X_missing = np.where(rng.random(X_obs.shape) < 0.5, np.nan, X_obs)
    forest_predict.launches = 0
    t0 = time.perf_counter()
    filled = gen_flow.impute(X_missing, y_obs, seed=6)
    dt = time.perf_counter() - t0
    expect = len(np.unique(y_obs)) * impute_launches(flow)
    observed = ~np.isnan(X_missing)
    if (filled.shape != X_obs.shape or not np.isfinite(filled).all()
            or not np.array_equal(filled[observed], X_missing[observed])):
        raise AssertionError("impute: bad output or observed cells changed")
    if forest_predict.launches != expect:
        raise AssertionError(f"impute: {forest_predict.launches} launches, "
                             f"expected {expect}")
    counts["impute"] = forest_predict.launches
    log(f"impute: {len(X_obs)} rows, {dt:.4f} s, {len(X_obs) / dt:.1f} rows/s, "
        f"{counts['impute']} launches")
    return counts


def check_small(device, seed=11):
    """Reduced-size checks: the solve on the card equals the plain PyTorch
    path on the CPU with the same x1, and a save -> load round trip
    generates identical rows."""
    from repro_torch.config import ForestConfig
    from repro_torch.core.interpolants import timesteps
    from repro_torch.tabgen import TabularGenerator, get_sampler
    from repro_torch.tabgen.sampling import solve_all_classes
    cfg = ForestConfig(method="flow", n_t=5, n_trees=4, max_depth=DEPTH,
                       multi_output=True)
    art = random_artifacts(cfg, 3, P, 100, seed, device)
    for method, sampler in (("flow", "euler"), ("diffusion", "ddim")):
        a = dataclasses.replace(art, config=dataclasses.replace(
            cfg, method=method))
        x1 = torch.randn((3, 97, P), generator=torch.Generator().manual_seed(seed))
        outs = []
        for d in (device, torch.device("cpu")):
            ad = a.to(d)
            ts = timesteps(method, cfg.n_t, cfg.eps_diff, device=d)
            outs.append(solve_all_classes(
                ad.feat, ad.thr_val, ad.leaf, x1.to(d), ad.mins, ad.maxs, ts,
                solver_fn=get_sampler(sampler).fn, depth=DEPTH, n_t=cfg.n_t,
                multi_output=True, eps=cfg.eps_diff).cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        log(f"{sampler} on {device.type} vs plain on cpu: max abs diff {err!r}")
        if err > SMALL_TOL:
            raise AssertionError(f"{sampler}: device and plain path disagree")
    with tempfile.TemporaryDirectory() as d:
        gen = generator_for(art)
        base = gen.save(os.path.join(d, "model"))
        loaded = TabularGenerator.load(base, device=device)
        X1, y1 = gen.generate(300, seed=1)
        X2, y2 = loaded.generate(300, seed=1)
        if not (np.array_equal(X1, X2) and np.array_equal(y1, y2)):
            raise AssertionError("save -> load changed the generated rows")
    log("save -> load round trip: identical rows")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.config import ForestConfig
    from repro_torch.kernels.tree_predict import build
    from repro_torch.kernels.tree_predict.ops import forest_predict
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    _, build_log = build.build()
    build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  {line.strip()}")

    m = N_ROWS // N_Y
    mo = (N_Y, 1, N_TREES, DEPTH, P, P, m)
    cases = [("MO full width", mo),
             ("SO one step", (N_Y, P, N_TREES, DEPTH, P, 1, 1024))]
    for n in (1, 97, 130):
        cases.append((f"MO n={n}", (N_Y, 1, N_TREES, DEPTH, P, P, n)))
        cases.append((f"SO n={n}", (2, P, N_TREES, DEPTH, P, 1, n)))
    worst = check_kernel(device, cases)
    timing = time_kernel(device, mo)
    log(f"tree_predict at MO full width: kernel {timing['ms']!r} ms, plain "
        f"{timing['plain_ms']!r} ms, bound {timing['bound_ms']!r} ms "
        f"({timing['bytes']} bytes at 3.35 TB/s); no single PyTorch call "
        f"traverses trees, so there is no library yardstick")

    cfg = ForestConfig(method="flow", n_t=N_T, duplicate_k=20,
                       n_trees=N_TREES, max_depth=DEPTH, learning_rate=1.5,
                       n_bins=64, reg_lambda=1.0, multi_output=True)
    flow = random_artifacts(cfg, N_Y, P, m, seed=0, device=device)
    log(f"artifacts: leaf {tuple(flow.leaf.shape)}, "
        f"{flow.leaf.numel() * 4 / 1e9:.2f} GB on the device")
    forest_predict.launches = 0
    counts = drive_main_path(flow, N_ROWS, 1000, 1024)
    del flow
    torch.cuda.empty_cache()

    check_small(device)

    kernels = [{
        "name": "tree_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
        "replaces": "src/repro/kernels/tree_predict/tree_kernel.py:54",
        "launches": sum(counts.values()), "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    print(json.dumps({"kernels": kernels, "launches_per_call": counts}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
