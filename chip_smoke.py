#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the ``tree_predict`` and ``hist`` CUDA kernels from the sources in
   this checkout, one nvcc each, in parallel, and prints ptxas's lines.
3. Holds ``tree_predict`` against its plain PyTorch version on the card, at
   the shapes the generation path gives it (MO at CaloForest photons width,
   SO at one step's shape, odd row counts, +inf sentinels and threshold
   ties), to a max abs difference of 1e-6 (both sum the trees in the same
   order); times kernel and plain version at the main path's shape.
4. Holds ``hist`` against its plain version: bit for bit against the plain
   version on the CPU (odd n, int8/int16/int32 codes with zero weights,
   SO lanes), and within 1e-5 of each cell's sum of |g·w| against the plain
   version on the card at full width (MO level 0 and 6, SO with 368 lanes
   at level 6), whose float atomics add in another order; two launches on
   the same inputs must give the same bits. Times kernel and plain version
   at both MO levels.
5. Drives the port's generation path through ``TabularGenerator`` at the
   full width of the CaloForest photons model (method=flow, MO trees,
   n_t=100, n_trees=20, max_depth=7, p=368, n_y=15; random weights from a
   seed, built on the device): euler with two padding buckets, heun, euler
   at n=120,000, ddim and em on the same arrays as a diffusion model, and an
   impute of 512 rows. Checks shapes, finiteness, padding invariance,
   observed cells and the kernel's launch count per call.
6. Drives the training path through ``TabularGenerator.fit`` at the same
   width (p=368, duplicate_k=20, n_trees=20, max_depth=7, n_bins=64,
   learning_rate=1.5, reg_lambda=1.0) on calorimeter-like showers made here
   from a seed: MO on a grid cut to n_t=3 x 2 classes of 8,000 rows (6
   ensembles of 160,000 rows) and SO on n_t=2 x 1 class (368 lanes). Checks
   the ``hist`` launch count, that a resume from the checkpoint launches
   nothing, and generates 1,000 rows from the trained MO model.
7. Checks both paths against the plain PyTorch path on the CPU at a small
   size (a solve, a save -> load round trip, a two-moons fit with the same
   noise) and that a warm-start extension on the card equals a cold fit
   bit for bit.

Exits non-zero on any failure and when no CUDA device is present. The line
before the last is a JSON object with the kernels' numbers; the last line is
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
# hist vs the plain version on the card, whose index_add_ adds with float
# atomics in another order: relative to each cell's sum of |g·w|
HIST_TOL = 1e-5
# whole solve, GPU vs CPU, same inputs: expf/sqrtf differ in the last place
# between the two, and DDIM divides by alpha(t=1) ~ 0.0066
SMALL_TOL = 1e-4

# CaloForest photons (examples/calorimeter_pipeline.py --full)
P, N_Y, N_T, N_TREES, DEPTH, N_ROWS = 368, 15, 100, 20, 7, 120_000
K_DUP, N_BINS, CLASS_ROWS = 20, 64, 8_000
FIT_ROWS = CLASS_ROWS * K_DUP     # rows of one ensemble


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


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


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


# ---------------------------------------------------------------------------
# hist: kernel vs plain
# ---------------------------------------------------------------------------

def hist_inputs(n, p, out, S, n_nodes, n_bins, code_dtype, seed, device):
    """codes, node ids, gradients and weights, ~5% of the weights zero (the
    padded rows of a class block)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    codes = torch.randint(0, n_bins, (n, p), generator=g, device=device,
                          dtype=torch.int32).to(code_dtype)
    nid = torch.randint(0, n_nodes, (S, n), generator=g, device=device,
                        dtype=torch.int32)
    grad = torch.randn((S, n, out), generator=g, device=device)
    w = (torch.rand((n,), generator=g, device=device) > 0.05).float()
    return codes, nid, grad, w


def hist_bytes_ops(n, p, out, S, n_nodes, n_bins, code_bytes):
    """Bytes the function must move (each input read once, each output
    written once) and the adds it does (one per row, feature and column)."""
    nbytes = (n * p * code_bytes + 4 * (S * n + S * n * out + n)
              + 4 * S * n_nodes * p * n_bins * (out + 1))
    return nbytes, n * p * S * out


def check_hist(device, exact_cases, card_cases):
    """hist vs plain on every case; returns the largest abs difference.

    ``exact_cases`` run the kernel on the card and the plain version on the
    CPU: they must agree to the bit. ``card_cases`` run both on the card at
    full width: within HIST_TOL of each cell's sum of |g·w|."""
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.hist.ref import histogram_ref
    cpu = torch.device("cpu")
    worst = 0.0
    for i, (name, shape) in enumerate(exact_cases + card_cases):
        exact = i < len(exact_cases)
        args = hist_inputs(*shape, seed=200 + i, device=device)
        nn, nb = shape[4], shape[5]
        got = histogram(*args, nn, nb)
        again = histogram(*args, nn, nb)
        ref_args = [a.to(cpu) for a in args] if exact else args
        ref = histogram_ref(*ref_args, nn, nb)
        sync(device)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"hist {name}: two launches differ")
        err = max((a.to(ref[0].device) - b).abs().max().item()
                  if b.numel() else 0.0 for a, b in zip(got, ref))
        if exact:
            ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
            rule = "bit-equal to the plain version on the CPU"
        else:
            scale = histogram_ref(args[0], args[1], args[2].abs(), args[3],
                                  nn, nb)
            ok = all(bool(((a - b).abs() <= HIST_TOL * s).all())
                     for a, b, s in zip(got, ref, scale))
            del scale
            rule = f"within {HIST_TOL} of sum |g·w| of the plain version " \
                   f"on the card"
        log(f"hist vs plain {name} (n,p,out,S,nodes,bins,codes)={shape}: "
            f"max abs diff {err!r}, {rule}: {ok}; repeat bit-equal")
        if not ok:
            raise AssertionError(f"hist disagrees on {name}")
        worst = max(worst, err)
        del got, again, ref
    return worst


def time_hist(device, shape):
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.hist.ref import histogram_ref
    args = hist_inputs(*shape, seed=7, device=device)
    nn, nb = shape[4], shape[5]
    ms = cuda_ms(lambda: histogram(*args, nn, nb), 10)
    plain_ms = cuda_ms(lambda: histogram_ref(*args, nn, nb), 2)
    nbytes, ops = hist_bytes_ops(*shape[:6], args[0].element_size())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, ops=ops)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def calo_photons(y, seed):
    """Voxelised showers of the CaloChallenge photons geometry (5 layers x 8
    radial x 9 angular voxels + 8 summary features, p = 368) for the given
    energy classes: a copy of the JAX package's synthetic calorimeter
    generator (repro/data/calorimeter.py), zero-heavy voxels included."""
    layers, nr, na = 5, 8, 9
    n = len(y)
    rng = np.random.default_rng(seed)
    e_inc = 2.0 ** (y + 8)
    depth = np.arange(layers)[None, :]
    peak = 1.0 + 0.15 * y[:, None] + 0.3 * rng.normal(size=(n, 1))
    long_prof = np.exp(-0.5 * ((depth - peak) / 1.2) ** 2)
    long_prof /= long_prof.sum(1, keepdims=True)
    r = np.arange(nr)[None, :]
    rad_prof = np.exp(-r / (1.0 + 0.05 * y[:, None]))
    rad_prof /= rad_prof.sum(1, keepdims=True)
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    ang = 1.0 + 0.3 * np.cos(np.linspace(0, 2 * np.pi, na)[None, :] + phase)
    ang /= ang.sum(1, keepdims=True)
    vox = (e_inc[:, None, None, None] * long_prof[:, :, None, None]
           * rad_prof[:, None, :, None] * ang[:, None, None, :])
    vox = vox * rng.lognormal(0.0, 0.35, size=vox.shape)
    vox[vox < 0.01 * e_inc[:, None, None, None] / vox.shape[1]] = 0.0
    X = vox.reshape(n, -1).astype(np.float32)
    pad = np.zeros((n, P - X.shape[1]), np.float32)
    pad[:, 0] = X.sum(1)
    pad[:, 1] = (X > 0).sum(1)
    return np.concatenate([X, pad], axis=1), y.astype(np.int64)


def photons_config(**kw):
    from repro_torch.config import ForestConfig
    return ForestConfig(method="flow", duplicate_k=K_DUP, n_trees=N_TREES,
                        max_depth=DEPTH, learning_rate=1.5, n_bins=N_BINS,
                        reg_lambda=1.0, **kw)


def expected_hist_launches(art) -> int:
    """One launch per level and one for the leaf sums, per round the
    ensemble's loop ran (its longest lane), per ensemble."""
    rounds = art.rounds_run.amax(dim=2).sum().item()
    return int(rounds) * (art.config.max_depth + 1)


def drive_training(device, ckpt_root):
    """Fit MO and SO at full width; returns (hist launches, MO generator)."""
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.tabgen import TabularGenerator
    launches = 0
    fits = (("MO", photons_config(n_t=3, multi_output=True), (3, 10)),
            ("SO", photons_config(n_t=2, multi_output=False), (6,)))
    log("training cuts: the grid n_t=100 x 15 classes becomes 3 x 2 (MO) "
        "and 2 x 1 (SO), to keep the phase near three minutes; rows per "
        f"class ({CLASS_ROWS}), duplicate_k, p, depth, bins and trees are "
        "the photons model's")
    trained = {}
    for label, cfg, classes in fits:
        X, y = calo_photons(np.repeat(np.array(classes), CLASS_ROWS), seed=1)
        ckpt = os.path.join(ckpt_root, label)
        n_ens = cfg.n_t * len(classes)
        histogram.launches = 0
        t0 = time.perf_counter()
        gen = TabularGenerator(cfg).fit(X, y, checkpoint_dir=ckpt,
                                        device=device)
        sync(device)
        dt = time.perf_counter() - t0
        got, expect = histogram.launches, expected_hist_launches(gen.artifacts)
        launches += got
        log(f"fit {label}: {n_ens} ensembles of {FIT_ROWS} rows x {P} "
            f"features, {dt:.2f} s, {dt / n_ens:.2f} s per ensemble, "
            f"{got} hist launches (expected {expect})")
        on_card = device.type == "cuda"    # the CPU path launches nothing
        if on_card and (got != expect or got == 0):
            raise AssertionError(f"fit {label}: {got} hist launches, "
                                 f"expected {expect}")
        if not all(torch.isfinite(getattr(gen.artifacts, f)).all()
                   for f in ("leaf", "mins", "maxs")):
            raise AssertionError(f"fit {label}: non-finite model")
        histogram.launches = 0
        again = TabularGenerator(cfg).fit(X, y, checkpoint_dir=ckpt,
                                          resume=True, device=device)
        if histogram.launches != 0 or not torch.equal(
                again.artifacts.leaf, gen.artifacts.leaf):
            raise AssertionError(f"resume {label}: {histogram.launches} "
                                 "launches or another model")
        log(f"resume {label}: 0 hist launches, the same model")
        trained[label] = gen
    gen = trained["MO"]
    forest_predict.launches = 0
    Xg, _ = gen.generate(1000, seed=1)
    n_t = gen.artifacts.n_t
    if (Xg.shape != (1000, P) or not np.isfinite(Xg).all()
            or (on_card and forest_predict.launches != n_t - 1)):
        raise AssertionError(f"generate from the trained model: {Xg.shape}, "
                             f"{forest_predict.launches} launches")
    log(f"generate 1000 rows from the trained MO model: finite, "
        f"{forest_predict.launches} tree_predict launches (n_t - 1)")
    return launches


def two_moons(n, seed):
    """Two interleaved half circles with noise (the repo's toy dataset)."""
    rng = np.random.default_rng(seed)
    n2 = n // 2
    t = np.pi * rng.random(n2)
    a = np.stack([np.cos(t), np.sin(t)], 1)
    b = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    X = np.concatenate([a, b]) + 0.08 * rng.normal(size=(2 * n2, 2))
    y = np.concatenate([np.zeros(n2), np.ones(n2)]).astype(np.int64)
    perm = rng.permutation(len(X))
    return X[perm].astype(np.float32), y[perm]


def cpu_noise(eid, split, shape):
    """Bridge noise drawn on the host, so fits on two devices see the same
    numbers."""
    gen = torch.Generator().manual_seed(1000 * eid + split)
    return torch.randn(shape, generator=gen), None


def check_training_small(device):
    """A two-moons fit on the card equals the plain path on the CPU (tree
    structure equal, leaves within SMALL_TOL); a warm-start extension on
    the card equals a cold fit there bit for bit."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import extend_artifacts, fit_artifacts
    X, y = two_moons(240, seed=0)
    for mo in (False, True):
        cfg = ForestConfig(n_t=5, duplicate_k=6, n_trees=8, max_depth=3,
                           n_bins=16, reg_lambda=1.0, multi_output=mo,
                           early_stop_rounds=2)
        a = fit_artifacts(X, y, cfg, device=device, noise=cpu_noise)
        b = fit_artifacts(X, y, cfg, device="cpu", noise=cpu_noise)
        same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                   for f in ("feat", "best_round", "rounds_run"))
        err = max((getattr(a, f).cpu() - getattr(b, f)).abs().max().item()
                  for f in ("leaf", "thr_val"))
        log(f"fit {'MO' if mo else 'SO'} two-moons on {device.type} vs "
            f"plain on cpu: structure equal {same}, leaves and thresholds "
            f"max abs diff {err!r}")
        if not same or err > SMALL_TOL:
            raise AssertionError("training: device and plain path disagree")
        cold = fit_artifacts(X, y, cfg, seed=5, device=device)
        base = fit_artifacts(X, y, dataclasses.replace(cfg, n_trees=5),
                             seed=5, device=device)
        ext = extend_artifacts(base, X, y, extra_trees=3, seed=5,
                               device=device)
        fields = ("feat", "thr_val", "leaf", "best_round", "rounds_run",
                  "val_curve", "mins", "maxs")
        if not all(torch.equal(getattr(cold, f), getattr(ext, f))
                   for f in fields):
            raise AssertionError("extend on the card differs from the cold "
                                 "fit")
        log(f"extend {'MO' if mo else 'SO'} 5 -> 8 rounds on {device.type}: "
            f"bit-identical to the cold fit of 8 rounds")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.config import ForestConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.tree_predict.ops import forest_predict
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    built = build.build(["tree_predict", "hist"])
    for name in built:
        build.load(name)
    log(f"kernel build (both in parallel): {time.perf_counter() - t0:.2f} s")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- kernels against their plain versions -------------------------------
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

    i32 = torch.int32
    mo0 = (FIT_ROWS, P, P, 1, 1, N_BINS, i32)
    mo6 = (FIT_ROWS, P, P, 1, 64, N_BINS, i32)
    exact = [(f"{name} n={n}", (n, 37, out, S, 8, N_BINS, dt))
             for n in (1, 97, 130)
             for name, out, S in (("MO", 37, 1), ("SO", 1, 37))
             for dt in (torch.int8, torch.int16, i32)]
    exact.append(("MO 2,000 rows level 6", (2000, P, P, 1, 64, N_BINS, i32)))
    full = [("MO level 0", mo0), ("MO level 6", mo6),
            ("SO level 6", (FIT_ROWS, P, 1, P, 64, N_BINS, i32))]
    hist_worst = check_hist(device, exact, full)
    hist_timing = {}
    for level, shape in ((0, mo0), (6, mo6)):
        ht = time_hist(device, shape)
        hist_timing[level] = ht
        log(f"hist at MO level {level} full width: kernel {ht['ms']!r} ms, "
            f"plain {ht['plain_ms']!r} ms, bound {ht['bound_ms']!r} ms "
            f"({ht['bound_by']}: {ht['bytes']} bytes at 3.35 TB/s, "
            f"{ht['ops']} adds at 67 TFLOP/s)")
    log("hist has no library yardstick: no single PyTorch call builds the "
        "histograms of all features without an [n*p, out] copy of g "
        "(87 GB at full width)")

    # -- the generation path -----------------------------------------------
    cfg = ForestConfig(method="flow", n_t=N_T, duplicate_k=K_DUP,
                       n_trees=N_TREES, max_depth=DEPTH, learning_rate=1.5,
                       n_bins=N_BINS, reg_lambda=1.0, multi_output=True)
    flow = random_artifacts(cfg, N_Y, P, m, seed=0, device=device)
    log(f"artifacts: leaf {tuple(flow.leaf.shape)}, "
        f"{flow.leaf.numel() * 4 / 1e9:.2f} GB on the device")
    forest_predict.launches = histogram.launches = 0
    counts = drive_main_path(flow, N_ROWS, 1000, 1024)
    del flow
    torch.cuda.empty_cache()

    # -- the training path -------------------------------------------------
    forest_predict.launches = histogram.launches = 0
    with tempfile.TemporaryDirectory() as ckpt_root:
        hist_launches = drive_training(device, ckpt_root)
    torch.cuda.empty_cache()

    check_small(device)
    check_training_small(device)

    ht = hist_timing[6]
    kernels = [{
        "name": "tree_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
        "replaces": "src/repro/kernels/tree_predict/tree_kernel.py:54",
        "launches": sum(counts.values()), "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "hist", "route": "cuda",
        "source": "src/repro_torch/kernels/hist/csrc/hist.cu",
        "replaces": "src/repro/kernels/hist/hist_kernel.py:52",
        "launches": hist_launches, "max_abs_err": hist_worst,
        "ms": ht["ms"], "plain_ms": ht["plain_ms"],
        "bound_ms": ht["bound_ms"], "bound_by": ht["bound_by"],
        "library_ms": None}]
    print(json.dumps({"kernels": kernels, "launches_per_call": counts,
                      "hist_level0": hist_timing[0]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
