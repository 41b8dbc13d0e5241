#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the ``tree_predict``, ``hist`` and ``flash_attention`` CUDA
   kernels from the sources in this checkout, one nvcc each, in parallel,
   and prints ptxas's lines.
3. Holds ``tree_predict`` against its plain PyTorch version on the card, at
   the shapes the generation path gives it (MO and SO at CaloForest photons
   width, the latency shapes, pions width, odd row counts, +inf sentinels
   and threshold ties) and at the kernels' edges (depth 1, 8, 9 and 16, 400
   and 512 trees) and at phase 12's (depth 4, T=15, p=2, 3, 6, SO and MO),
   bit for bit (both sum the trees in the same order);
   times kernel and plain version at MO and SO full width, MO at n=1,024
   and 4,096 a class and pions width.
4. Holds ``hist`` against its plain version: bit for bit against the plain
   version on the CPU (odd n, int8/int16/int32 codes with zero weights,
   SO lanes, and the kernel's edges: every row in one bin, a node over many
   chunks, codes outside [0, n_bins), 1 and 16 bins, 368 SO lanes at a
   small n, nodes without rows; phase 12's fits at 32 bins: p=8 at 5,210,
   52,000 and 520,000 rows with out=1 S=1, S=8 and out=8, the quality
   table's p=2, 3, 6, their leaf sums), and within 1e-5 of each cell's sum of
   |g·w| against the plain version on the card at full width (MO level 0
   and 6, SO with 368 lanes at level 6), whose float atomics add in another
   order; two launches on the same inputs must give the same bits. Times
   kernel and plain version at MO levels 0 and 6, SO level 6 and MO level
   6 with int8 codes and at 256 bins (two bin windows a launch; 256 and
   300 bins are among the bit-equal cases). Then launches over the lanes
   of a batch of ensembles (each with its own codes and weights; E = 2 and
   6, MO and SO, shuffled and narrowed lane maps, int8 codes, codes
   outside the bins, 256 bins, the leaf sums, the resource arm's batch):
   bit for bit against the plain version on the CPU, and each lane equal
   to its ensemble launched alone; times one launch over 3 MO ensembles
   at level 6 and over 2 SO ensembles at level 6 against as many launches
   of one, each beside its bound.
5. Holds ``flash_attention`` against its plain version on the card (fp32
   within 2e-5, rtol = atol as tests/test_kernels.py; bf16 within atol
   1e-3 plus rtol 1e-2, about an ulp),
   at the serving shape (B=8, Hq=9, Hkv=3, S=2,048, d=64, causal), ragged
   lengths (Sq and Skv not multiples of the bf16 kernel's 128-row tiles),
   one KV head per query head, non-causal with Skv > Sq, every other
   head size and the MoE prefills' shapes (dbrx-132b: B=4, Hq=48, Hkv=8,
   S=1,024, d=128; deepseek-v2-236b's MLA: B=2, Hq=Hkv=128, S=1,024,
   d=192; d=192 at S=300) and the recurrent and encoder families' (phase
   10c: recurrentgemma-9b's MQA 16:1 at d=256, llava-next-34b's GQA 7:1
   at S=1,600, whisper-tiny's encoder, non-causal at S=1,500, and its
   cross-attention, Sq=64, Skv=1,500) and one query over 1,500 keys at
   d=192 (the fp32 plan's key splits); two launches must give the same
   bits. Checks that the bf16 instances run on the tensor cores and load
   by TMA (``HGMMA`` and ``UTMALDG`` in each one's SASS) and logs their
   registers; fails if an fp32 instance spills (ptxas), and logs each fp32
   instance's resident warps. Times kernel,
   plain version and ``scaled_dot_product_attention`` at the serving shape
   and the two MoE prefills' shapes in fp32 and bf16.
6. Drives the port's generation path through ``TabularGenerator`` at the
   full width of the CaloForest photons model (method=flow, MO trees,
   n_t=100, n_trees=20, max_depth=7, p=368, n_y=15; random weights from a
   seed, built on the device): euler with two padding buckets, heun, euler
   at n=120,000, ddim and em on the same arrays as a diffusion model, and an
   impute of 512 rows. Checks shapes, finiteness, padding invariance,
   observed cells and the kernel's launch count per call.
7. Drives the forest serving plane at the same width: a ``ModelRegistry``
   of three seeded photons models (leaves 5.65 GB each) with a device
   budget of two, acquired A, B, C, A (each demotion must free >= 0.95 of
   a model's bytes, the hot set's ``registry_hot_bytes`` must equal its
   tensor bytes, promotions timed); 48 euler requests of 64-4,000 rows from
   4 threads (about 2/3 interactive) through the ``InflightScheduler`` (a
   first, warm-up run of it checked, not kept) and through its drain arm
   (``sync_resolve=True``), in turns: every request bit-equal
   to a ``sample()`` replay of its batch, >= 2 batches in flight, 99
   ``tree_predict`` launches a batch, rows/s, queue wait and device time
   from the spans, and how many batches' copies finished while the next
   batch's device work had not; a swap of A for A' (seed 3) under 16
   requests (none dropped, the batches after it bit-equal on A', no
   kernel library built or loaded: the leg runs under ``build_budget(0)``);
   ``serve_http`` in a thread (generate,
   impute, trace, ``/metrics`` with the device gauges, a profiler capture);
   and the refresh loop on a two-moons model (ingest, train_forest,
   serve_http, refresh: append, extend on the card, reload to version 2).
7b. Drives sharded sampling and sharded serving at the same width on a
   one-rank NCCL group's 1x1 ``DeviceMesh``: ``sample(mesh=)`` at
   n=120,000, euler in turns with the unsharded call (a first call of each
   not kept, then unsharded, mesh, mesh, unsharded twice) and from the
   ``shard(mesh)`` slice, and em (unsharded, mesh, mesh, unsharded), every
   call bit-equal to the unsharded one with 99 ``tree_predict`` launches;
   an impute of 512 of those rows (half the cells missing) with
   ``impute(mesh=)`` in turns with the unsharded impute and through the
   mesh registry, bit-equal, with its ``tree_predict`` launch count;
   the first 16 requests of phase 7's burst through a ``ModelRegistry(mesh=)``
   and an unsharded registry in turns (a warm-up burst each first), every
   request bit-equal to the unsharded replay of its batch, rows/s of each,
   and from them the per-batch cost of the command stream's failure check
   (on one rank it exchanges nothing; its gloo exchange is also timed
   alone, on a one-rank group);
   ``serve_forest --mesh 1x1 --demo`` and ``serve_http --mesh 1x1`` (a
   generate, an impute, a reload to version 2, SIGINT)
   as subprocesses.
8. Drives the training path through ``TabularGenerator.fit`` at the same
   width (p=368, duplicate_k=20, n_trees=20, max_depth=7, n_bins=64,
   learning_rate=1.5, reg_lambda=1.0) on calorimeter-like showers made here
   from a seed: MO on a grid cut to n_t=3 x 2 classes of 8,000 rows (6
   ensembles of 160,000 rows) and SO on n_t=2 x 1 class (368 lanes). A
   batch trains as one loop a group (``fitting.ensemble_groups``: MO
   groups of 3, SO of 1 at this width). Checks the ``hist`` launch count
   (one a level and one for the leaf sums, a round of a group), that a
   resume from the checkpoint launches nothing, and generates 1,000 rows
   from the trained MO model. Then fits at the default batch and at
   ``ensembles_per_batch=1`` must be equal on every field: MO n_t=1 over
   2 classes with 5 trees and SO n_t=2 on 1 class at depth 6 with 4 trees
   (each one group of two); logs seconds an ensemble and the device peak.
9. Drives the out-of-core sharded training path at the same width (MO,
   n_t=2 x 2 classes of 8,000 rows: 4 ensembles of 320,000 weight-masked
   rows): ``ingest`` into a store of 4,096-row shards, a store fit under a
   one-rank NCCL group on a 1x1 ``DeviceMesh`` (pipelined, checkpointed;
   hist launch count checked), a resume that launches nothing, the same
   rows in memory (serial) and the store without a process group, all bit-
   equal; generates 1,000 rows from the store model; runs the ingest and
   training CLIs on a small store against the API fit. Logs rows/s of the
   ingest and seconds per ensemble of each fit.
10. Serves smollm-135m at its full width (30 layers, d_model 576, 9/3
   heads, vocab 49,152; random weights from a seed, built on the device)
   through ``serve_batch``: 8 prompts of 2,048 tokens, 64 new tokens, fp32.
   Checks the tokens, 30 kernel launches (one per prefill layer) and none
   in decode, finite logits; profiles one prefill for the kernel's share
   of device time. Then bf16, the prefill entry point's default: 30
   launches per prefill and none in two decode steps; one prefill timed
   (seconds, tokens/s) and one profiled for the kernel's share.
10a. Serves the MoE families at their published widths, the depth cut to
   2 layers each: dbrx-132b (d_model 6,144, 48/8 heads, 16 experts top-4,
   d_ff 10,752, vocab 100,352; 2 of 40 layers, 7.75 B parameters) with 4
   prompts of 1,024 tokens and deepseek-v2-236b (d_model 5,120, 128 heads,
   MLA q_lora 1,536 / kv_lora 512 / rope 64 / nope 128, 160 routed experts
   top-6 + 2 shared, d_ff_dense 12,288, vocab 102,400; its dense first
   layer and one of 59 MoE layers) with 2, through ``serve_batch``: 32
   greedy tokens at fp32 and at bf16, one flash-attention launch a prefill
   layer (d = 128 GQA 6:1 and MLA's d = 192) and none in decode; prefill
   seconds, decode ms a step, tokens/s, device peak; a profiled prefill
   each (the experts' products, dispatch + combine, the kernel's share).
   deepseek also decodes 8 tokens with the absorbed MLA (equal to the
   expanded decode's) and 4 steps with int8 experts (their bytes against
   bf16, ms a step). Then each family at reduced() (B = 2, S = 600: 1,200
   tokens, two groups and a tail of 176) on the card against the CPU:
   prefill logits within 1e-4, 8 greedy tokens equal, a training step's
   loss within 1e-5 relative, aux within 1e-5, every gradient within 1e-4
   of its leaf's largest entry.
10c. Serves the recurrent and encoder families at their published widths
   (``drive_recurrent_encdec_serving``): xlstm-1.3b cut to 8 layers (one
   group of 7 mLSTM + 1 sLSTM; B=4, S=2,048), recurrentgemma-9b to 5 (a
   (rec, rec, attn) group and the trailing (rec, rec), as 38 = 12 x 3 + 2;
   B=2, S=2,048), llava-next-34b to 2 (B=2, 576 patch embeddings + 1,024
   tokens) and whisper-tiny at full depth (4 + 4; B=8, 1,500 frames, 64
   tokens), seeded weights: ``lm.prefill_step`` then 16 greedy
   ``lm.decode_step`` steps at fp32 and at bf16 (xLSTM and recurrentgemma
   also through ``serve_batch``, tokens equal), prefill seconds, decode ms
   a step, device peak, one flash-attention launch a prefill attention
   layer (whisper: encoder, self and cross) and none in decode, a profiled
   prefill split into scans, conv, projections, ``flash_attention`` and the
   rest; ``flash_attention`` timed at the families' shapes against its
   plain version and ``scaled_dot_product_attention``; then each family at
   reduced() on the card against the CPU: prefill logits within 1e-4 of
   the largest, 4 greedy decode tokens equal, a training step's loss
   within 1e-5 relative and every gradient within 1e-4 of its leaf's
   largest entry.
10b. Trains smollm-135m at its published width and depth (seeded weights)
   through ``repro_torch.train.loop.train`` on ``FastTokenStream``
   batches of 8 x 2,048 tokens, remat "full", fp32 masters, AdamW: 4 steps
   at bf16 compute and 3 at fp32 (steps/s, tokens/s, device peak bytes;
   the loss must go down), and the bf16 run again with a commit at step 2
   and a second call resuming it from other weights, its losses equal to
   the uninterrupted run's bit for bit. No kernel of the three launches
   (training attends through ``mea_attention``, as the JAX package does).
11. Checks every path against the plain PyTorch path on the CPU at a small
   size (a solve, a save -> load round trip, and logs whether one seed
   gives the card and the CPU different rows, a two-moons fit with the same
   noise and early stopping on (best_round and the trees equal), on one
   device and on the sharded route's one rank, a 2-layer
   smollm-135m-width prefill and 8 greedy tokens, and a 2-layer
   smollm-135m-width training step: loss within 1e-5 relative, parameters
   after one AdamW step within 1e-4), that a warm-start extension on
   the card equals a cold fit bit for bit, and that the two-moons fits on
   the card at the default batch (groups of 8 and 2) equal, on every
   field, the same fits at ``ensembles_per_batch=1``.

12. Drives the comparison plane (``drive_comparison``, budgeted at 120 s):
   (a) NN-flow, NN-diffusion, TVAE and CTGAN on the card against the plain
   path on the CPU on two-moons (20 steps, the same initial weights and
   per-step draws, TF32 off): parameters within 1e-4, losses within 1e-5
   relative, ``generate`` from the same noise within 1e-4; the
   Original-style trainer (n_t=2, K=4, T=4, depth 3): tree structure equal,
   thresholds and leaves within 1e-5, and ours-SO and ours-MO fits at
   (c)'s configuration (n=1,000) the same way;
   ``sample_loop_reference`` from the same x1 within SMALL_TOL. Phase 3's
   kernel checks hold hist and tree_predict to their plain versions at
   this phase's shapes too (32 bins at p=2, 3, 6 and 8 up to ~520,000 rows
   a class; depth 4, T=15). (b) The quality table of paper Table 2 / 7 at
   ``benchmarks/bench_quality.py``'s quick sizes (two-moons, a 3-class
   Gaussian mixture, a 6-D correlated Gaussian, n=600, 80/20 split; FF-SO,
   FF-MO, FD-SO, copula, TVAE, NN-flow, NN-diffusion, CTGAN): W1 and sliced
   W1 to the test split, coverage, mean rank, seconds; gated on shape and
   finiteness only. (c) The resource comparison of Figures 1/2/4 at
   ``bench_resource_scaling.py``'s configuration (p=8, n_y=2, n_t=3, K=10,
   T=10, depth 4, 32 bins): the Original-style arm at n=200 and 1,000,
   ours-SO and ours-MO up to n=100,000, the early-stopping arms at 1,000,
   each in a fresh subprocess importing only the port with the kernels
   built: wall seconds, peak RSS, RSS above the post-init baseline, device
   peak, hist launches (each must launch hist). (d) NN-flow (hidden 256,
   depth 3, batch 256), TVAE, CTGAN and the copula at photons width on
   16,000 seeded showers with 4,000 held out: steps/s, ``generate`` rows/s
   at n=120,000 (NN: 50 steps), device peak; W1 and classifier AUC logged,
   and an output whose every column is constant marked degenerate.
   Cuts, to keep the phase near two minutes: (a) holds the Original-style
   trainer against the CPU on two-moons only, not at (c)'s configuration;
   (b) trains the NN baselines 200 steps (bench_quality.py's quick sizes:
   600); (d) trains 300 steps a model (the benchmarks train 2,000-2,500),
   reads its metrics on the first 4,000 generated rows (as many as are
   held out), and leaves out coverage (an O(n^2) host k-NN at p=368).

13. The LM scale-out plane (``drive_scaleout_plane``). (a) The dry run:
   ``python -m repro_torch.launch.dryrun`` traces smollm-135m x {train_4k,
   prefill_32k, decode_32k} and the caloforest photons slice on the 16x16
   fake mesh of 256 ranks, fake tensors on ``cuda``; one process a cell,
   started before the first phase (niced, one thread each: CPU work beside
   the card's phases) and collected here; each must be ``ok``; their
   per-rank peaks, collectives and rooflines are printed. (b) On the card:
   a one-rank NCCL group and ``make_debug_mesh(1, 1)``; smollm-135m at
   full width with seeded weights, saved unsharded, restored and resharded
   by the rules (``checkpoint.reshard``, ``load_sharded``); bf16 and fp32
   prefills of 8 x 2,048 through the DTensor model, ``flash_attention``
   under the per-rank attention at 30 launches a prefill, logits within
   1e-6 of the largest of the unsharded prefill on the card; one training
   step (bf16, remat full, AdamW) whose loss equals the unsharded model's.
   (c) The model-FLOPs share of phase 10b's bf16 training step:
   ``cell_cost``'s ``model_flops`` over (seconds a step x 989e12).

Exits non-zero on any failure and when no CUDA device is present. The line
before the last is a JSON object with the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
# H100 SXM peaks (NVIDIA's data sheet), the port's cost model's
from repro_torch.analysis.flops import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.analysis.flops import PEAK_FLOPS as BF16_OPS_PER_S  # noqa: E402,E501
from repro_torch.analysis.flops import PEAK_FLOPS_FP32 as FP32_OPS_PER_S  # noqa: E402,E501

KERNEL_TOL = 0.0              # kernel and plain version sum in the same order
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

# flash attention vs its plain version, (atol, rtol): the kernel scales q
# before the product where the plain version divides the scores, and sums
# in another order. fp32 at tests/test_kernels.py's 2e-5. Both sides sum in
# fp32 and round once to bf16, so bf16 outputs differ by about an ulp, at
# most 2^-7 of the value: rtol 1e-2 covers that, atol 1e-3 the outputs
# near 0
FA_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 1e-2)}
# smollm-135m serving: 8 prompts of 2,048 tokens, 64 new tokens
SERVE_B, SERVE_S, SERVE_NEW = 8, 2048, 64
FA_SERVE = (SERVE_B, 9, 3, SERVE_S, SERVE_S, 64)   # (B, Hq, Hkv, Sq, Skv, d)


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


# tree_predict at the generation path's shapes (B, S, T, depth, p, out, n),
# n rows a class: CaloForest photons MO and SO, the latency shapes (n = 1,000
# and 4,000 rows a call, padded to 1,024 and 4,096 a class), pions width
TREE_TIMED = [("MO full width", (N_Y, 1, N_TREES, DEPTH, P, P, 8000)),
              ("SO full width", (N_Y, P, N_TREES, DEPTH, P, 1, 8000)),
              ("MO n=1024", (N_Y, 1, N_TREES, DEPTH, P, P, 1024)),
              ("MO n=4096", (N_Y, 1, N_TREES, DEPTH, P, P, 4096)),
              ("pions width", (N_Y, 1, N_TREES, DEPTH, 533, 533, 8000))]


def tree_predict_cases():
    """tree_predict's check cases: the timed shapes, odd row counts, and the
    kernels' edges: depth 1, 9 (leaves read through L1) and 16 (the deepest,
    uint16 indices), 400 and 512 trees (400 at n=8,000 a class takes two
    chunks of the leaf-index scratch), odd widths."""
    cases = list(TREE_TIMED)
    for n in (1, 97, 130):
        cases.append((f"MO n={n}", (N_Y, 1, N_TREES, DEPTH, P, P, n)))
        cases.append((f"SO n={n}", (2, P, N_TREES, DEPTH, P, 1, n)))
    cases += [("MO depth 1", (3, 1, 5, 1, 37, 37, 97)),
              ("SO depth 1", (3, 37, 5, 1, 37, 1, 97)),
              ("MO depth 8", (N_Y, 1, N_TREES, 8, P, P, 1000)),
              ("MO depth 9", (N_Y, 1, N_TREES, 9, P, P, 1000)),
              ("SO depth 9", (2, 37, N_TREES, 9, 37, 1, 1000)),
              ("MO depth 16", (2, 1, 2, 16, 37, 5, 300)),
              ("SO depth 16", (2, 3, 2, 16, 37, 1, 300)),
              ("MO T=400", (N_Y, 1, 400, 2, P, P, 8000)),
              ("SO T=400", (2, 37, 400, 3, 37, 1, 130)),
              ("MO T=512, out 37", (3, 1, 512, 3, 37, 37, 130)),
              ("MO T=1, out 2", (2, 1, 1, 7, 5, 2, 97)),
              ("MO S=3, out 6", (2, 3, 5, 4, 9, 6, 130))]
    # the comparison phase's quality table: depth 4, T = 15, p = 2, 3, 6
    # (240, 164 and 480 rows a class), and the loop reference's one class
    for p, b, n in ((2, 2, 240), (3, 3, 164), (6, 1, 480)):
        cases += [(f"quality SO p={p}", (b, p, 15, 4, p, 1, n)),
                  (f"quality MO p={p}", (b, 1, 15, 4, p, p, n))]
    cases.append(("loop reference one class", (1, 1, 4, 3, 2, 2, 200)))
    return cases


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
                bytes=nbytes, ops=ops)


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
        # a seed is reproducible on one device type; the card's generator
        # (Philox) and the CPU's (Mersenne Twister) draw different noise
        X3, _ = TabularGenerator.load(base, device="cpu").generate(300, seed=1)
    log("save -> load round trip: identical rows")
    log(f"seed 1 on {device.type} vs on cpu: rows "
        f"{'identical' if np.array_equal(X1, X3) else 'differ'} (the two "
        f"devices draw different noise for one seed, by design), max abs "
        f"diff {np.abs(X1 - X3).max()!r}")


# ---------------------------------------------------------------------------
# the forest serving plane
# ---------------------------------------------------------------------------

# 48 euler requests of 64-4,000 rows from 4 client threads, ~2/3 interactive
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_ROWS = 48, 4, (64, 4000)
SWAP_REQUESTS = 16
FOREST_BUCKETS = (64, 256, 1024)   # rows a class


def _probe_scheduler():
    """An InflightScheduler that counts the batches whose rows reached the
    host while the next batch was still being enqueued or running on the
    device: the overlap that a copy enqueued at resolve time, behind the
    next batch's kernels, would have removed. ``compared`` counts the
    batches whose successor's dispatch had begun when their wait ended."""
    from repro_torch.serving import InflightScheduler

    class Probe(InflightScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._probe_lock = threading.Lock()
            self._records = []            # one per dispatch begun
            self.copy_before_next = 0
            self.compared = 0

        def _dispatch(self, batch):
            rec = {"sample": None}
            with self._probe_lock:
                self._records.append(rec)
            inflight = super()._dispatch(batch)
            with self._probe_lock:
                if inflight is None:
                    self._records.remove(rec)
                else:
                    rec["sample"] = inflight.sample
            return inflight

        def _resolve(self, inflight):
            ready = inflight.sample.ready
            if ready is not None:
                ready.synchronize()
                with self._probe_lock:
                    i = next(k for k, r in enumerate(self._records)
                             if r["sample"] is inflight.sample)
                    nxt = (self._records[i + 1]
                           if i + 1 < len(self._records) else None)
                    if nxt is not None:
                        self.compared += 1
                        self.copy_before_next += int(
                            nxt["sample"] is None
                            or not nxt["sample"].ready.query())
            super()._resolve(inflight)

    return Probe


def replay_served(tracer, futures, handles, sampler="euler"):
    """Hold every served request against ``sample()`` of its batch (batch
    membership from the ``serve.device`` spans' links), bit for bit, on
    one of ``handles`` (a batch dispatched across a swap may have run on
    either version). Returns {batch_id: index of the handle it matched}."""
    from repro_torch.serving.scheduler import BATCH_SEED_BASE
    from repro_torch.tabgen import sample
    by_id = {f.request_id: f for f in futures}
    matched, seen = {}, set()
    for span in tracer.spans(name="serve.device"):
        if not any(r in by_id for r in span.links):
            continue
        total = span.attrs["rows"]
        seed = BATCH_SEED_BASE + span.attrs["batch_id"]
        served = [by_id[r].result(timeout=0) for r in span.links]
        for k, h in enumerate(handles):
            X, y = sample(h.artifacts, total, sampler=sampler, seed=seed,
                          pad_to=h.bucket(total, seed))
            off, same = 0, True
            for Xr, yr in served:
                same &= (np.array_equal(Xr, X[off:off + len(Xr)])
                         and np.array_equal(yr, y[off:off + len(Xr)]))
                off += len(Xr)
            if same and off == total:
                matched[span.attrs["batch_id"]] = k
                break
        else:
            raise AssertionError(
                f"batch {span.attrs['batch_id']} ({total} rows): served rows "
                "differ from the sample() replay of the batch")
        seen.update(span.links)
    if seen != set(by_id):
        raise AssertionError(f"{len(set(by_id) - seen)} requests in no batch")
    return matched


def _median(xs):
    return float(np.median(xs)) if len(xs) else None


def drive_forest_serving(device, tmp):
    """The forest serving plane at photons width: a registry of three
    models under a two-model budget (LRU promotions and demotions), the
    in-flight scheduler against its drain arm (rows bit-equal to a replay
    of each batch), a hot swap under traffic, the HTTP front end, and the
    refresh loop on a two-moons model. Returns (tree_predict launches,
    hist launches, numbers)."""
    from repro_torch.analysis.runtime import build_budget
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.launch.serve_http import ServingApp, serve_in_thread
    from repro_torch.obs import (MetricsRegistry, Profiler, ResourceMonitor,
                                 Tracer)
    from repro_torch.serving import AdmissionController, ModelRegistry
    from repro_torch.serving.registry import artifacts_nbytes
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    cfg = photons_config(n_t=N_T, multi_output=True)
    m = N_ROWS // N_Y
    out = {}
    tp_launches = 0

    # -- registry: 3 models, a budget of 2, acquired A, B, C, A -------------
    metrics = MetricsRegistry()
    reg = None
    for name, seed in (("A", 0), ("B", 1), ("C", 2)):
        art = random_artifacts(cfg, N_Y, P, m, seed=seed, device=device)
        if reg is None:
            nbytes = artifacts_nbytes(art)
            reg = ModelRegistry(device=device, buckets=FOREST_BUCKETS,
                                device_budget_bytes=2 * nbytes,
                                metrics=metrics)
        t0 = time.perf_counter()
        reg.register(name, art, hot=False)
        log(f"registry: {name} registered cold, host copy "
            f"{'pinned ' if on_card else ''}in "
            f"{time.perf_counter() - t0:.3f} s")
        del art
    if on_card:
        torch.cuda.empty_cache()
    log(f"registry: {nbytes} bytes ({nbytes / 1e9:.2f} GB) a model, device "
        f"budget {2 * nbytes} bytes (two models)")
    promote_s, drops = [], []
    for name in ("A", "B", "C", "A"):
        sync(device)
        before = torch.cuda.memory_allocated(device) if on_card else 0
        ev0 = reg.describe()
        t0 = time.perf_counter()
        reg.acquire(name)                 # no handle kept: none in flight
        sync(device)                      # the promotion's copies are async
        dt = time.perf_counter() - t0
        after = torch.cuda.memory_allocated(device) if on_card else 0
        ev1 = reg.describe()
        promoted = ev1[name]["promotions"] - ev0[name]["promotions"]
        demoted = [n for n in ev1
                   if ev1[n]["demotions"] > ev0[n]["demotions"]]
        if promoted != 1:
            raise AssertionError(f"acquire {name}: not promoted")
        promote_s.append(dt)
        msg = f"acquire {name}: promoted in {dt!r} s"
        if demoted:
            # the promotion allocated at least nbytes: what the demotion
            # freed is at least before + nbytes - after
            drop = before + nbytes - after
            drops.append(drop)
            msg += (f", demoted {demoted}; memory_allocated {before} -> "
                    f"{after}: the demotion freed >= {drop} bytes")
            if on_card and drop < 0.95 * nbytes:
                raise AssertionError(f"demotion of {demoted} freed {drop} "
                                     f"bytes, < 0.95 x {nbytes}")
        log(msg)
    hot = reg.hot_names()
    hot_sum = sum(artifacts_nbytes(reg.peek(n).artifacts) for n in hot)
    gauge = metrics.gauge("registry_hot_bytes").get()
    if hot != ["A", "C"] or gauge != hot_sum or hot_sum != 2 * nbytes:
        raise AssertionError(f"hot set {hot}, registry_hot_bytes {gauge}, "
                             f"leaf bytes {hot_sum}")
    cold = reg.peek("B").artifacts
    if on_card and not (cold.device.type == "cpu" and cold.leaf.is_pinned()
                        and reg.peek("A").artifacts.device.type == "cuda"):
        raise AssertionError("hot models not on the card or cold ones not "
                             "in pinned host memory")
    # a cold model still serves, on the card: its tensors are copied there
    # for the call
    forest_predict.launches = 0
    Xc, _ = reg.peek("B").generate(64, seed=0)
    tp_launches += forest_predict.launches
    if not np.isfinite(Xc).all() or (on_card and forest_predict.launches
                                     != N_T - 1):
        raise AssertionError(f"cold B: {forest_predict.launches} launches")
    log(f"cold B served 64 rows on {device.type}: "
        f"{forest_predict.launches} tree_predict launches, still cold "
        f"({reg.hot_names()} hot)")
    d = reg.describe()
    log(f"registry: hot {hot}, registry_hot_bytes {gauge} = summed tensor "
        f"bytes of the hot models; events " + ", ".join(
            f"{n}: {d[n]['promotions']} promotions / {d[n]['demotions']} "
            "demotions" for n in sorted(d)))
    out.update(model_bytes=nbytes, promote_s=promote_s,
               demotion_freed_bytes=drops)

    # -- scheduler: in-flight arm and drain arm ------------------------------
    rng = np.random.default_rng(7)
    sizes = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1,
                         size=SERVE_REQUESTS)
    prios = np.where(rng.random(SERVE_REQUESTS) < 2 / 3, "interactive",
                     "bulk")
    forest_predict.launches = 0
    warm_s = reg.warmup("A")
    tp_launches += forest_predict.launches
    log(f"warmup of A (euler x buckets {FOREST_BUCKETS}): {warm_s!r} s, "
        f"{forest_predict.launches} tree_predict launches")
    Probe = _probe_scheduler()
    handle = reg.peek("A")
    runs = []
    # the two arms in turns (ABBA): host-clock numbers move between runs.
    # An in-flight run first, checked but not kept: a process's first run
    # is its slowest while the allocators grow, and then each batch may
    # resolve before the next is formed (one in flight)
    for arm, sync_resolve in (("warm-up", False), ("inflight", False),
                              ("drain", True), ("drain", True),
                              ("inflight", False)):
        tracer = Tracer(capacity=4096)
        sched = Probe(reg, AdmissionController(), sync_resolve=sync_resolve,
                      max_coalesce_rows=N_Y * FOREST_BUCKETS[-1],
                      coalesce_window_s=0.002, tracer=tracer)
        futs, lock = [], threading.Lock()

        def client(part):
            for n, pr in part:
                f = sched.submit(int(n), model="A", sampler="euler",
                                 priority=str(pr))
                with lock:
                    futs.append(f)

        jobs = list(zip(sizes, prios))
        threads = [threading.Thread(target=client,
                                    args=(jobs[i::SERVE_CLIENTS],))
                   for i in range(SERVE_CLIENTS)]
        forest_predict.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for f in futs:
            f.result(timeout=300)
        wall = time.perf_counter() - t0
        launches = forest_predict.launches
        tp_launches += launches
        sched.stop()
        stats = sched.stats_snapshot()
        replay_served(tracer, futs, [handle])
        rows = int(sizes.sum())
        queue = {s.trace_id: s.duration_s
                 for s in tracer.spans(name="serve.queue")}
        dev = tracer.spans(name="serve.device")
        dev_of = {r: s.duration_s for s in dev for r in s.links}
        shares = [queue[r] / (queue[r] + dev_of[r]) for r in queue]
        per_batch = launches / max(stats["batches"], 1)
        a = dict(rows=rows, wall_s=wall, rows_per_s=rows / wall,
                 batches=stats["batches"],
                 coalesced=stats["coalesced_requests"],
                 queue_wait_median_s=_median(list(queue.values())),
                 device_median_s=_median([s.duration_s for s in dev]),
                 queue_share_median=_median(shares),
                 queue_share_total=sum(queue.values()) / sum(
                     queue[r] + dev_of[r] for r in queue),
                 max_inflight=stats["max_inflight_observed"],
                 tree_predict_per_batch=per_batch,
                 copy_before_next=sched.copy_before_next,
                 compared=sched.compared)
        if arm != "warm-up":
            runs.append((arm, a))
        log(f"scheduler {arm}: {len(futs)} requests, {rows} rows in "
            f"{a['batches']} batches ({a['coalesced']} coalesced), "
            f"{wall!r} s, {a['rows_per_s']!r} rows/s; median queue wait "
            f"{a['queue_wait_median_s']!r} s, median device span "
            f"{a['device_median_s']!r} s, queue wait a median "
            f"{a['queue_share_median']!r} of a request's latency; peak "
            f"{a['max_inflight']} in flight; {per_batch!r} tree_predict "
            f"launches a batch; rows on the host while the next batch was "
            f"still being enqueued or on the device: {a['copy_before_next']}"
            f" of the {a['compared']} batches whose successor had begun; "
            "every request bit-equal to the sample() replay of its batch")
        if on_card and per_batch != N_T - 1:
            raise AssertionError(f"{arm}: {per_batch} launches a batch")
    # the CPU computes inside sample_async: only the card has two batches
    # in flight
    for arm, a in runs:
        if (arm == "drain" and a["max_inflight"] > 1) or (
                on_card and arm == "inflight" and a["max_inflight"] < 2):
            raise AssertionError(f"{arm}: peak {a['max_inflight']} in flight")
    for arm in ("inflight", "drain"):
        mine = [a for k, a in runs if k == arm]
        out[arm] = {key: [a[key] for a in mine] for key in mine[0]}
    log("rows/s in turns (in-flight, drain, drain, in-flight): "
        + ", ".join(f"{a['rows_per_s']!r}" for _, a in runs))

    # -- swap A for A' (seed 3) under traffic --------------------------------
    new = random_artifacts(cfg, N_Y, P, m, seed=3, device=device)
    old_handle = reg.peek("A")
    tracer = Tracer(capacity=4096)
    sched = Probe(reg, AdmissionController(), tracer=tracer,
                  max_coalesce_rows=N_Y * FOREST_BUCKETS[-1])
    futs, errors, lock = [], [], threading.Lock()

    def swap_client(part):
        for n in part:
            try:
                f = sched.submit(int(n), model="A")
                with lock:
                    futs.append(f)
            except Exception as exc:   # noqa: BLE001 — counted, then raised
                errors.append(exc)
            time.sleep(0.1)

    swap_sizes = sizes[:SWAP_REQUESTS]
    before_swap = swap_sizes[:SWAP_REQUESTS - 4]
    forest_predict.launches = 0
    # the whole leg, traffic included, builds and loads no kernel library
    with build_budget(0) as watch:
        threads = [threading.Thread(target=swap_client,
                                    args=(before_swap[i::2],))
                   for i in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        t0 = time.perf_counter()
        new_handle = reg.swap("A", new)
        swap_s = time.perf_counter() - t0
        t_swapped = time.monotonic()           # the spans' clock
        del new
        swap_client(swap_sizes[SWAP_REQUESTS - 4:])    # dispatched after it
        for t in threads:
            t.join(timeout=300)
        for f in futs:
            f.result(timeout=300)
        sched.stop()
    tp_launches += forest_predict.launches
    if errors or len(futs) != SWAP_REQUESTS:
        raise AssertionError(f"swap: {len(futs)} of {SWAP_REQUESTS} served, "
                             f"errors {errors}")
    matched = replay_served(tracer, futs, [old_handle, new_handle])
    after = [s.attrs["batch_id"] for s in tracer.spans(name="serve.device")
             if s.t_start > t_swapped]
    if not after or any(matched[b] != 1 for b in after):
        raise AssertionError(f"swap: batches dispatched after it {after} "
                             f"matched {matched}")
    log(f"swap A -> A' (seed 3) in {swap_s!r} s under traffic: "
        f"{SWAP_REQUESTS} requests served, none dropped; "
        f"{len(after)} batches dispatched after the swap replay bit-equal "
        f"on A' ({sum(v == 0 for v in matched.values())} on A); "
        f"kernel libraries built or loaded {watch.libraries} (budget 0)")
    out["swap"] = dict(swap_s=swap_s, requests=SWAP_REQUESTS,
                       batches_after=len(after),
                       version=new_handle.version)
    del old_handle, handle

    # -- HTTP ------------------------------------------------------------------
    admission = AdmissionController(metrics=metrics)
    monitor = ResourceMonitor(metrics, interval_s=60.0, admission=admission,
                              registry=reg)
    app = ServingApp(reg, admission, metrics=metrics,
                     tracer=Tracer(capacity=4096), monitor=monitor,
                     profiler=Profiler(os.path.join(tmp, "profiles")))
    monitor.sample()
    httpd, thread = serve_in_thread(app)
    base = "http://%s:%d" % httpd.server_address[:2]
    forest_predict.launches = 0
    try:
        calls = {}
        t0 = time.perf_counter()
        status, body = http_call("POST", f"{base}/v1/generate",
                                 {"model": "A", "n": 1000})
        calls["generate"] = (status, time.perf_counter() - t0)
        X = np.asarray(body["rows"], np.float32)
        if X.shape != (1000, P) or not np.isfinite(X).all():
            raise AssertionError(f"/v1/generate: rows {X.shape}")
        rid = body["request_id"]
        Xm = np.where(np.random.default_rng(0).random((64, P)) < 0.5,
                      np.nan, X[:64])
        rows = [[None if np.isnan(v) else float(v) for v in r] for r in Xm]
        t0 = time.perf_counter()
        status, ibody = http_call("POST", f"{base}/v1/impute", {
            "model": "A", "rows": rows, "labels": body["labels"][:64]})
        calls["impute"] = (status, time.perf_counter() - t0)
        filled = np.asarray(ibody.get("rows", []), np.float32)
        obs = ~np.isnan(Xm)
        if (filled.shape != (64, P) or not np.isfinite(filled).all()
                or not np.array_equal(filled[obs], Xm[obs].astype(
                    np.float32))):
            raise AssertionError("/v1/impute: bad rows or observed cells "
                                 "changed")
        status, tbody = http_call("GET", f"{base}/v1/trace/{rid}")
        calls["trace"] = (status, None)
        if tbody.get("summary", {}).get("rows") != 1000:
            raise AssertionError(f"/v1/trace: {tbody.get('summary')}")
        status, text = http_call("GET", f"{base}/metrics")
        calls["metrics"] = (status, None)
        gauges = [g for g in ("resource_device_memory_bytes{",
                              "resource_device_buffer_bytes{",
                              "resource_kernel_libraries ")
                  if g in text]
        if on_card and len(gauges) != 3:
            raise AssertionError(f"/metrics: device gauges {gauges}")
        status, pbody = http_call("POST", f"{base}/debug/profile",
                                  {"duration_ms": 200})
        calls["profile"] = (status, None)
        if not os.path.exists(pbody.get("trace", "")):
            raise AssertionError(f"/debug/profile: no trace file {pbody}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.stop()
        thread.join(timeout=30)
    tp_launches += forest_predict.launches
    if any(s != 200 for s, _ in calls.values()):
        raise AssertionError(f"HTTP: {calls}")
    log(f"HTTP on {base}: " + ", ".join(
        f"{k} {s}" + (f" in {dt!r} s" if dt is not None else "")
        for k, (s, dt) in calls.items())
        + f"; resource gauges on /metrics: {gauges}; profiler trace "
        f"{os.path.getsize(pbody['trace'])} bytes")
    out["http"] = {k: dict(status=s, s=dt) for k, (s, dt) in calls.items()}
    del reg, app, monitor
    if on_card:
        torch.cuda.empty_cache()

    # -- refresh: ingest -> train_forest -> serve_http -> refresh ----------
    hist_launches, launches, refresh = drive_refresh(device, tmp)
    tp_launches += launches
    out["refresh"] = refresh
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"forest serving phase: {out['phase_s']!r} s")
    return tp_launches, hist_launches, out


def release_pinned() -> None:
    """Hand the caching host allocator's free pinned blocks back (the
    registry's host copies), where this PyTorch has the call."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def http_call(method, url, body=None):
    """(status, parsed JSON or text) of one request, error statuses too."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw, status, kind = (resp.read(), resp.status,
                                 resp.headers.get("Content-Type"))
    except urllib.error.HTTPError as err:
        raw, status, kind = err.read(), err.code, err.headers.get(
            "Content-Type")
    if kind == "application/json":
        return status, json.loads(raw)
    return status, raw.decode()


def drive_refresh(device, tmp):
    """The refresh loop on a two-moons model (an extension at photons width
    takes hours): ingest, train_forest, a serve_http plane, then refresh
    appends, extends on the card and reloads while /v1/generate keeps
    answering. Returns (hist launches, tree_predict launches, numbers)."""
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.launch import ingest as ingest_cli
    from repro_torch.launch import refresh, train_forest
    from repro_torch.launch.serve_http import ServingApp, serve_in_thread
    from repro_torch.serving import AdmissionController, ModelRegistry
    d = os.path.join(tmp, "refresh")
    os.makedirs(d)
    for name, seed in (("rows", 0), ("more", 1)):
        X, y = two_moons(1200, seed=seed)
        np.savez(os.path.join(d, f"{name}.npz"), X=X, y=y)
    store, base, v2 = (os.path.join(d, k) for k in ("store", "v1", "v2"))
    dev = "cuda" if device.type == "cuda" else "cpu"
    histogram.launches = forest_predict.launches = 0
    ingest_cli.main(["--out", store, "--npz", os.path.join(d, "rows.npz"),
                     "--shard-rows", "512", "--batch-rows", "256"])
    train_forest.main(["--data-dir", store, "--mesh", "none", "--device",
                       dev, "--n-t", "5", "--duplicate-k", "6", "--n-trees",
                       "8", "--max-depth", "3", "--n-bins", "16",
                       "--out", base])
    registry = ModelRegistry(device=device, buckets=(64, 256))
    registry.register("moons", path=base)
    app = ServingApp(registry, AdmissionController(),
                     model_paths={"moons": base})
    httpd, thread = serve_in_thread(app)
    url = "http://%s:%d" % httpd.server_address[:2]
    stop, codes = threading.Event(), []

    def traffic():
        while not stop.is_set():
            codes.append(http_call("POST", f"{url}/v1/generate",
                                   {"model": "moons", "n": 200})[0])

    client = threading.Thread(target=traffic)
    client.start()
    try:
        t0 = time.perf_counter()
        summary = refresh.main([
            "--store", store, "--artifacts", base, "--out", v2,
            "--npz", os.path.join(d, "more.npz"), "--batch-rows", "256",
            "--extra-trees", "3", "--device", dev, "--server", url,
            "--model", "moons"])
        wall = time.perf_counter() - t0
        time.sleep(0.2)
        status, models = http_call("GET", f"{url}/v1/models")
    finally:
        stop.set()
        client.join(timeout=120)
        httpd.shutdown()
        httpd.server_close()
        app.stop()
        thread.join(timeout=30)
    version = models["models"]["moons"]["version"]
    hist_launches = histogram.launches
    if (status != 200 or version != 2 or summary["served_version"] != 2
            or not codes or set(codes) != {200}):
        raise AssertionError(f"refresh: /v1/models {status} version "
                             f"{version}, generate statuses {set(codes)}")
    if device.type == "cuda" and hist_launches == 0:
        raise AssertionError("refresh: no hist launch on the card")
    log(f"refresh: ingest 1,200 rows, train_forest, serve, refresh "
        f"(+{summary['rows_appended']} rows, {summary['n_trees']} trees) "
        f"in {wall!r} s; /v1/models version {version}; {len(codes)} "
        f"/v1/generate calls across the swap, all 200; {hist_launches} "
        "hist launches")
    return hist_launches, forest_predict.launches, dict(
        wall_s=wall, version=version, generates=len(codes),
        hist_launches=hist_launches)


# ---------------------------------------------------------------------------
# sharded sampling and sharded serving
# ---------------------------------------------------------------------------

SHARD_REQUESTS = 16              # the mesh burst: the first 16 of the 48


def _burst(reg, sizes, prios):
    """The requests ``sizes`` through an InflightScheduler over ``reg``'s
    model A from SERVE_CLIENTS threads, every request checked bit-equal to
    the unsharded replay of its batch. Returns (rows/s, tree_predict
    launches, batches)."""
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.obs import Tracer
    from repro_torch.serving import AdmissionController, InflightScheduler
    tracer = Tracer(capacity=4096)
    sched = InflightScheduler(reg, AdmissionController(), tracer=tracer,
                              max_coalesce_rows=N_Y * FOREST_BUCKETS[-1])
    futs, lock = [], threading.Lock()

    def client(part):
        for n, pr in part:
            f = sched.submit(int(n), model="A", priority=str(pr))
            with lock:
                futs.append(f)

    jobs = list(zip(sizes, prios))
    threads = [threading.Thread(target=client, args=(jobs[i::SERVE_CLIENTS],))
               for i in range(SERVE_CLIENTS)]
    forest_predict.launches = 0
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for f in futs:
            f.result(timeout=300)
    finally:
        sched.stop()
    wall = time.perf_counter() - t0
    launches = forest_predict.launches
    if len(futs) != len(sizes):
        raise AssertionError(f"burst: {len(futs)} of {len(sizes)} submitted")
    replay_served(tracer, futs, [reg.peek("A")])
    return int(np.sum(sizes)) / wall, launches, \
        sched.stats_snapshot()["batches"]


def _mesh_cli(tmp, dev):
    """``serve_forest --mesh 1x1 --demo`` and ``serve_http --mesh 1x1``
    (generate, a reload to version 2, SIGINT) as subprocesses, at once."""
    import signal
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    forest = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_forest", "--mesh",
         "1x1", "--demo", "--device", dev, "--requests", "8", "--buckets",
         "32,128"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=tmp)
    http = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_http", "--mesh",
         "1x1", "--demo", "--device", dev, "--port", "0",
         "--resource-interval-s", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=tmp)
    lines, out = [], {}
    watchdog = threading.Timer(300, http.kill)   # a start-up that hangs
    watchdog.start()
    try:
        for line in http.stdout:              # until it serves
            lines.append(line.rstrip())
            if line.startswith("serving on "):
                break
        else:
            raise AssertionError("serve_http --mesh 1x1 did not start:\n"
                                 + "\n".join(lines[-30:]))
        url = line.split()[-1]
        path = next(x.split(" to ")[-1] for x in lines
                    if x.startswith("demo artifacts saved to"))
        t0 = time.perf_counter()
        gen = http_call("POST", f"{url}/v1/generate",
                        {"model": "demo", "n": 100})
        out["generate_s"] = time.perf_counter() - t0
        rows = [[r[0], None] if i % 2 else [None, r[1]]
                for i, r in enumerate(gen[1]["rows"][:8])]
        imp = http_call("POST", f"{url}/v1/impute",
                        {"model": "demo", "rows": rows,
                         "labels": gen[1]["labels"][:8]})
        filled = np.asarray(imp[1].get("rows", []), np.float64)
        if (imp[0] != 200 or filled.shape != (8, 2)
                or not np.isfinite(filled).all()
                or any(filled[i, 1 - i % 2] != rows[i][1 - i % 2]
                       for i in range(8))):
            raise AssertionError(f"serve_http --mesh 1x1: impute {imp}")
        reload = http_call("POST", f"{url}/v1/models/demo/reload",
                           {"path": path})
        again = http_call("POST", f"{url}/v1/generate",
                          {"model": "demo", "n": 50})
        if (gen[0] != 200 or len(gen[1]["rows"]) != 100 or reload[0] != 200
                or reload[1]["version"] != 2 or again[0] != 200
                or again[1]["version"] != 2):
            raise AssertionError(f"serve_http --mesh 1x1: generate {gen[0]}"
                                 f", reload {reload}, again {again[0]}")
        http.send_signal(signal.SIGINT)
        tail, _ = http.communicate(timeout=120)
        if http.returncode != 0 or "bye" not in tail:
            raise AssertionError(f"serve_http --mesh 1x1 exited "
                                 f"{http.returncode}:\n{tail[-3000:]}")
        ftail, _ = forest.communicate(timeout=300)
        if forest.returncode != 0 or "served 8 requests" not in ftail:
            raise AssertionError(f"serve_forest --mesh 1x1 exited "
                                 f"{forest.returncode}:\n{ftail[-3000:]}")
        log("serve_forest --mesh 1x1 --demo: " + next(
            x for x in ftail.splitlines() if x.startswith("served ")))
        log(f"serve_http --mesh 1x1: generate 200 in {out['generate_s']!r} "
            "s, impute 200 (observed cells kept), reload to version 2, "
            "generate 200 on version 2, SIGINT -> exit 0")
        return out
    finally:
        watchdog.cancel()
        for proc in (forest, http):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def settle_cost(reps: int = 200) -> float:
    """Seconds of one failure-check exchange (``CommandStream.settle``'s
    all_reduce of a flag on a gloo group, waited on) on a one-rank group:
    the host cost a batch pays on a mesh of more ranks, before any peer's
    latency. On one rank the stream has no side group and skips it."""
    import torch.distributed as dist
    from repro_torch.serving.spmd import SETTLE_TIMEOUT
    group = dist.new_group(backend="gloo")
    flag = torch.zeros(1, dtype=torch.int32)
    dist.all_reduce(flag, group=group, async_op=True).wait(SETTLE_TIMEOUT)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(flag, group=group, async_op=True).wait(SETTLE_TIMEOUT)
    return (time.perf_counter() - t0) / reps


def drive_sharded(device, tmp):
    """Sharded sampling and sharded serving at photons width on a one-rank
    mesh (NCCL on the card): ``sample(mesh=)`` at n=120,000 with euler (in
    turns with the unsharded call, and from a pre-sharded slice) and em,
    bit-equal to ``sample()``; a ``ModelRegistry(mesh=1x1)`` and an
    unsharded one serving the same burst in turns, every row bit-equal to
    its batch's replay; the ``serve_forest`` and ``serve_http`` CLIs with
    ``--mesh 1x1``. Returns (tree_predict launches, numbers)."""
    import torch.distributed as dist
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.launch.mesh import forest_mesh
    from repro_torch.serving import ModelRegistry
    from repro_torch.tabgen import impute, sample
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    cfg = photons_config(n_t=N_T, multi_output=True)
    out = {"wall_s": {}, "first_s": {}}
    tp_launches = 0
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = forest_mesh(1, 1, device)
        flow = random_artifacts(cfg, N_Y, P, N_ROWS // N_Y, seed=0,
                                device=device)
        diff = dataclasses.replace(flow, config=dataclasses.replace(
            cfg, method="diffusion"))
        refs = {}

        def call(label, art, sampler, seed, on_mesh, keep=True):
            nonlocal tp_launches
            forest_predict.launches = 0
            t0 = time.perf_counter()
            X, y = sample(art, N_ROWS, sampler=sampler, seed=seed,
                          mesh=mesh if on_mesh else None)
            dt = time.perf_counter() - t0
            got = forest_predict.launches
            tp_launches += got
            if X.shape != (N_ROWS, P) or not np.isfinite(X).all():
                raise AssertionError(f"{label}: bad output {X.shape}")
            if on_card and got != N_T - 1:
                raise AssertionError(f"{label}: {got} tree_predict launches")
            ref = refs.setdefault(sampler, (X, y))
            if not (np.array_equal(X, ref[0]) and np.array_equal(y, ref[1])):
                raise AssertionError(f"{label}: rows differ from the "
                                     f"unsharded {sampler} call")
            out["wall_s" if keep else "first_s"].setdefault(
                label, []).append(dt)
            log(f"{label}{'' if keep else ', first call'}: n={N_ROWS} "
                f"{dt!r} s, {N_ROWS / dt!r} rows/s, {got} tree_predict "
                "launches, rows equal to the unsharded call")

        # a first call each, checked, not kept (the allocators grow; the
        # first sharded call starts the NCCL communicator); then in turns
        for keep, turns in ((False, (False, True)),
                            (True, (False, True, True, False) * 2)):
            for on_mesh in turns:
                call("euler, 1x1 mesh" if on_mesh else "euler", flow,
                     "euler", 3, on_mesh, keep)
        sliced = flow.shard(mesh)
        if sliced.class_range != (0, N_Y) or (
                on_card and sliced.leaf.data_ptr() != flow.leaf.data_ptr()):
            raise AssertionError("shard() on a 1x1 mesh moved the weights")
        call("euler, 1x1 mesh, pre-sharded", sliced, "euler", 3, True)
        del sliced
        for on_mesh in (False, True, True, False):
            call("em, 1x1 mesh" if on_mesh else "em", diff, "em", 5, on_mesh)
        del diff

        # -- impute on the mesh: 512 of the euler rows, half the cells gone --
        X, y = refs["euler"]
        X_missing = np.where(np.random.default_rng(0).random((512, P)) < 0.5,
                             np.nan, X[:512])
        y_missing = y[:512]
        expect = len(np.unique(y_missing)) * impute_launches(flow)

        def impute_call(label, fn):
            nonlocal tp_launches
            forest_predict.launches = 0
            t0 = time.perf_counter()
            filled = fn()
            dt = time.perf_counter() - t0
            got = forest_predict.launches
            tp_launches += got
            if on_card and got != expect:
                raise AssertionError(f"{label}: {got} tree_predict launches, "
                                     f"expected {expect}")
            out["impute_s"].setdefault(label, []).append(dt)
            log(f"{label}: 512 rows {dt!r} s, {got} tree_predict launches")
            return filled

        out["impute_s"] = {}
        ref_fill = None
        for on_mesh in (False, True, True, False):
            label = "impute, 1x1 mesh" if on_mesh else "impute"
            filled = impute_call(label, lambda: impute(
                flow, X_missing, y_missing, seed=6,
                mesh=mesh if on_mesh else None))
            ref_fill = filled if ref_fill is None else ref_fill
            if not np.array_equal(filled, ref_fill):
                raise AssertionError(f"{label}: rows differ from the "
                                     "unsharded impute")
        obs = ~np.isnan(X_missing)
        if (not np.isfinite(ref_fill).all()
                or not np.array_equal(ref_fill[obs], X_missing[obs])):
            raise AssertionError("impute: bad rows or observed cells changed")

        # -- the registry on the mesh against the unsharded one ----------------
        rng = np.random.default_rng(7)
        sizes = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1,
                             size=SERVE_REQUESTS)[:SHARD_REQUESTS]
        prios = np.where(rng.random(SERVE_REQUESTS) < 2 / 3, "interactive",
                         "bulk")[:SHARD_REQUESTS]
        regs = {"mesh": ModelRegistry(device=device, mesh=mesh,
                                      buckets=FOREST_BUCKETS),
                "unsharded": ModelRegistry(device=device,
                                           buckets=FOREST_BUCKETS)}
        for arm, reg in regs.items():
            t0 = time.perf_counter()
            reg.register("A", flow)
            log(f"registry ({arm}): A registered hot in "
                f"{time.perf_counter() - t0!r} s")
        d = regs["mesh"].describe()["A"]
        log(f"mesh registry: {d['nbytes']} model bytes counted against the "
            f"budget, {d['rank_nbytes']} on this rank")
        filled = impute_call("impute, mesh registry", lambda: regs[
            "mesh"].handle("A").impute(X_missing, y_missing, seed=6))
        if not np.array_equal(filled, ref_fill):
            raise AssertionError("the mesh registry's impute differs from "
                                 "the unsharded impute")
        log("impute: sharded (1x1 mesh) and through the mesh registry "
            "bit-equal to the unsharded impute")
        del flow
        if on_card:
            torch.cuda.empty_cache()
        rates = {"mesh": [], "unsharded": []}
        batch_s = {"mesh": [], "unsharded": []}
        # a warm-up burst each, checked, not kept; then in turns
        for i, arm in enumerate(("mesh", "unsharded", "mesh", "unsharded",
                                 "unsharded", "mesh")):
            rate, launches, batches = _burst(regs[arm], sizes, prios)
            tp_launches += launches
            if on_card and launches != batches * (N_T - 1):
                raise AssertionError(f"{arm} burst: {launches} launches in "
                                     f"{batches} batches")
            if i >= 2:
                rates[arm].append(rate)
                batch_s[arm].append(int(sizes.sum()) / rate / batches)
            log(f"burst ({arm}{', warm-up' if i < 2 else ''}): "
                f"{SHARD_REQUESTS} requests, {int(sizes.sum())} rows in "
                f"{batches} batches, {rate!r} rows/s, {launches} "
                "tree_predict launches; every request bit-equal to the "
                "unsharded replay of its batch")
        regs["mesh"].close()
        check = settle_cost()
        out.update(burst_rows_per_s=rates, burst_rows=int(sizes.sum()),
                   model_bytes=d["nbytes"], rank_bytes=d["rank_nbytes"],
                   burst_batch_s=batch_s, failure_check_s=check,
                   check_cost_per_batch_s=(_median(batch_s["mesh"])
                                           - _median(batch_s["unsharded"])))
        log(f"failure check: a batch on the mesh {_median(batch_s['mesh'])!r}"
            f" s against {_median(batch_s['unsharded'])!r} s unsharded (the "
            "burst's wall over its batches; on one rank the check exchanges "
            f"nothing); its gloo exchange alone on a one-rank group {check!r}"
            " s")
        del regs
    finally:
        dist.destroy_process_group()
    release_pinned()
    if on_card:
        torch.cuda.empty_cache()
    out["cli"] = _mesh_cli(tmp, device.type)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded phase: {out['phase_s']!r} s, {tp_launches} tree_predict "
        "launches")
    return tp_launches, out


# ---------------------------------------------------------------------------
# hist: kernel vs plain
# ---------------------------------------------------------------------------

def hist_inputs(n, p, out, S, n_nodes, n_bins, code_dtype, seed, device,
                edge=None):
    """codes, node ids, gradients and weights, ~5% of the weights zero (the
    padded rows of a class block). ``edge`` bends them to one edge of the
    kernel: ``"one_bin"`` (every row in bin n_bins - 1 of every feature),
    ``"out_of_range"`` (about 1 code in 8 outside [0, n_bins), both sides),
    ``"empty_nodes"`` (rows only in the even nodes: the odd ones have
    none)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    codes = torch.randint(0, n_bins, (n, p), generator=g, device=device,
                          dtype=torch.int32)
    nid = torch.randint(0, n_nodes, (S, n), generator=g, device=device,
                        dtype=torch.int32)
    grad = torch.randn((S, n, out), generator=g, device=device)
    w = (torch.rand((n,), generator=g, device=device) > 0.05).float()
    if edge == "one_bin":
        codes.fill_(n_bins - 1)
    elif edge == "out_of_range":
        hi = torch.iinfo(code_dtype).max
        bad = torch.tensor([-1, n_bins, min(hi, n_bins + 37), hi,
                            torch.iinfo(code_dtype).min], dtype=torch.int32,
                           device=device)
        pick = torch.randint(0, 8 * len(bad), (n, p), generator=g,
                             device=device)
        codes = torch.where(pick < len(bad), bad[pick.clamp(max=len(bad) - 1)],
                            codes)
    elif edge == "empty_nodes":
        nid = nid - nid % 2
    elif edge is not None:
        raise ValueError(f"unknown edge {edge!r}")
    return codes.to(code_dtype), nid, grad, w


def hist_expected(codes, nid, g, w, n_nodes, n_bins, ens=None):
    """What the kernel computes: the plain version, with a code outside
    [0, n_bins) adding its row to no cell of that feature (the kernel's
    spare bin, never written out)."""
    from repro_torch.kernels.hist.ref import histogram_ref
    wide = codes.to(torch.int32)             # n_bins may pass int8's range
    inside = (wide >= 0) & (wide < n_bins)
    if bool(inside.all()):
        return histogram_ref(codes, nid, g, w, n_nodes, n_bins, ens)
    spare = torch.where(inside, wide, n_bins)
    sums, cnt = histogram_ref(spare, nid, g, w, n_nodes, n_bins + 1, ens)
    return (sums[:, :, :, :n_bins].contiguous(),
            cnt[:, :, :, :n_bins].contiguous())


def hist_cases():
    """(exact, full): cases bit-equal to the plain version on the CPU, and
    the three full-width shapes of the training path, each ``(name,
    (n, p, out, S, n_nodes, n_bins, code dtype)[, edge])``."""
    i8, i16, i32 = torch.int8, torch.int16, torch.int32
    exact = [(f"{name} n={n}", (n, 37, out, S, 8, N_BINS, dt))
             for n in (1, 97, 130)
             for name, out, S in (("MO", 37, 1), ("SO", 1, 37))
             for dt in (i8, i16, i32)]
    exact += [
        ("MO 2,000 rows level 6", (2000, P, P, 1, 64, N_BINS, i32)),
        ("MO every row in one bin", (3000, 37, 37, 1, 4, N_BINS, i32),
         "one_bin"),
        ("SO every row in one bin", (3000, 37, 1, 37, 4, N_BINS, i32),
         "one_bin"),
        ("MO 20,000 rows in one node", (20000, 37, 37, 1, 1, N_BINS, i32)),
        ("SO 20,000 rows in two nodes", (20000, 37, 1, 5, 2, N_BINS, i32)),
        ("MO codes outside [0, n_bins), int8",
         (600, 37, 37, 1, 4, N_BINS, i8), "out_of_range"),
        ("MO codes outside [0, n_bins), int32",
         (600, 37, 37, 1, 4, N_BINS, i32), "out_of_range"),
        ("SO codes outside [0, n_bins), int16",
         (600, 37, 1, 37, 4, N_BINS, i16), "out_of_range"),
        ("MO leaf sums, n_bins = 1", (3000, 1, P, 1, 128, 1, i8)),
        ("SO leaf sums, n_bins = 1", (3000, 1, 1, P, 128, 1, i8)),
        ("MO n_bins = 16", (500, 37, 37, 1, 8, 16, i32)),
        ("SO n_bins = 16", (500, 37, 1, 37, 8, 16, i8)),
        ("SO 368 lanes, small n", (130, P, 1, P, 8, N_BINS, i32)),
        ("MO empty nodes", (700, 37, 37, 1, 8, N_BINS, i32), "empty_nodes"),
        ("SO empty nodes", (700, 37, 1, 37, 8, N_BINS, i32), "empty_nodes"),
        # more bins than a one-byte code: two windows a launch
        ("MO 256 bins", (2000, 37, 37, 1, 8, 256, i32)),
        ("SO 256 bins", (2000, 37, 1, 37, 8, 256, i16)),
        ("MO 300 bins, codes outside", (600, 37, 37, 1, 4, 300, i32),
         "out_of_range"),
        ("SO 300 bins, codes outside", (600, 37, 1, 37, 4, 300, i32),
         "out_of_range"),
        ("MO 256 bins level 6", (3000, 37, 37, 1, 64, 256, i32)),
    ]
    # the comparison phase's fits (32 bins, depth 4, levels 0 and 3, and
    # the leaf sums): the resource arms at p = 8, n = 1,000, 10,000 and
    # 100,000 (5,210, 52,000 and ~520,000 rows a class), the quality
    # table's datasets at p = 2, 3 and 6
    exact += [(f"{arm} {rows:,} rows level {lv}", (rows, 8, out, S, 2 ** lv,
                                                   32, i32))
              for arm, out, S, sizes in (
                  ("Original-style", 1, 1, (5210, 52_000)),
                  ("ours-SO", 1, 8, (5210, 52_000, 520_000)),
                  ("ours-MO", 8, 1, (5210, 52_000, 520_000)))
              for rows in sizes for lv in (0, 3)]
    exact += [
        ("ours-SO-ES 7 lanes level 2", (5210, 8, 1, 7, 4, 32, i32)),
        ("ours-SO leaf sums", (520_000, 1, 1, 8, 16, 1, i8)),
        ("ours-MO leaf sums", (520_000, 1, 8, 1, 16, 1, i8)),
        ("Original-style leaf sums", (5210, 1, 1, 1, 16, 1, i8))]
    exact += [(f"quality {kind} p={p} level {lv}", (rows, p, out, S, 2 ** lv,
                                                    32, i32))
              for p, rows in ((2, 2400), (3, 1640), (6, 4800))
              for kind, out, S in (("SO", 1, p), ("MO", p, 1))
              for lv in (0, 3)]
    exact += [("quality SO p=6 5 lanes", (4800, 6, 1, 5, 8, 32, i32)),
              ("quality MO p=6 leaf sums", (4800, 1, 6, 1, 16, 1, i8)),
              ("quality SO p=3 leaf sums", (1640, 1, 1, 3, 16, 1, i8))]
    full = [("MO level 0", (FIT_ROWS, P, P, 1, 1, N_BINS, i32)),
            ("MO level 6", (FIT_ROWS, P, P, 1, 64, N_BINS, i32)),
            ("SO level 6", (FIT_ROWS, P, 1, P, 64, N_BINS, i32))]
    return exact, full


def hist_bytes_ops(n, p, out, S, n_nodes, n_bins, code_bytes, E=1):
    """Bytes the function must move (each input read once, each output
    written once: E ensembles' codes and weights, S lanes' node ids,
    gradients and histograms) and the adds it does (one per row, feature
    and column of each lane)."""
    nbytes = (E * n * p * code_bytes + 4 * (S * n + S * n * out + E * n)
              + 4 * S * n_nodes * p * n_bins * (out + 1))
    return nbytes, n * p * S * out


def hist_batch_inputs(E, n, p, out, S, n_nodes, n_bins, code_dtype, seed,
                      device, edge=None):
    """A batch of E ensembles' codes [E, n, p] and weights [E, n], S lanes'
    node ids and gradients, and the lane map ens [S]: shuffled, and where
    E > 2 narrowed as the boosting loop narrows it (ensemble 1's lanes have
    all stopped). ``edge`` as in :func:`hist_inputs`."""
    parts = [hist_inputs(n, p, out, 1, n_nodes, n_bins, code_dtype,
                         seed + 10 * e, device, edge) for e in range(E)]
    codes = torch.stack([c for c, _, _, _ in parts])
    w = torch.stack([ww for _, _, _, ww in parts])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nid = torch.randint(0, n_nodes, (S, n), generator=gen, device=device,
                        dtype=torch.int32)
    if edge == "empty_nodes":
        nid = nid - nid % 2
    grad = torch.randn((S, n, out), generator=gen, device=device)
    kept = torch.tensor([e for e in range(E) if E <= 2 or e != 1],
                        device=device, dtype=torch.int32)
    order = torch.randperm(S, generator=gen, device=device)
    ens = kept.repeat(-(-S // len(kept)))[:S][order].contiguous()
    return codes, nid, grad, w, ens


def hist_batch_cases():
    """Launches over the lanes of E ensembles (a batch of the fit), each
    ``(name, (E, n, p, out, S, n_nodes, n_bins, code dtype)[, edge])``:
    MO and SO, E = 2 and 6, shuffled and narrowed lane maps, int8 codes,
    codes outside the bins, two bin windows, the leaf sums, and the
    resource arm's batch (6 ensembles at p = 8, 32 bins)."""
    i8, i16, i32 = torch.int8, torch.int16, torch.int32
    return [
        ("MO E=2, 2,000 rows level 6", (2, 2000, P, P, 2, 64, N_BINS, i32)),
        ("MO E=6 narrowed to 4 lanes, int8",
         (6, 3000, 37, 37, 4, 8, N_BINS, i8)),
        ("SO E=2, 37 lanes each, int8", (2, 700, 37, 1, 74, 8, N_BINS, i8)),
        ("SO E=6 shuffled, narrowed, codes outside",
         (6, 600, 37, 1, 150, 4, N_BINS, i32), "out_of_range"),
        ("SO E=2, 368 lanes each, small n", (2, 130, P, 1, 2 * P, 8, N_BINS,
                                              i8)),
        ("MO E=6 256 bins", (6, 600, 37, 37, 6, 4, 256, i16)),
        ("SO E=6 empty nodes", (6, 700, 37, 1, 100, 8, N_BINS, i8),
         "empty_nodes"),
        ("SO E=6 leaf sums", (6, 3000, 1, 1, 48, 16, 1, i8)),
        ("MO E=6 leaf sums", (6, 3000, 1, 37, 6, 16, 1, i8)),
        ("ours-SO batch of 6, level 3", (6, 5210, 8, 1, 48, 8, 32, i32)),
        ("ours-MO batch of 6, level 3", (6, 5210, 8, 8, 6, 8, 32, i8)),
    ]


def check_hist_batches(device, cases, histogram=None):
    """hist over a batch of ensembles: bit-equal to the plain version on the
    CPU, two launches bit-equal, and each lane equal to its ensemble
    launched alone (one launch an ensemble, over its lanes in the batch).
    Returns the largest abs difference (0.0)."""
    if histogram is None:
        from repro_torch.kernels.hist.ops import histogram
    cpu = torch.device("cpu")
    worst = 0.0
    for i, (name, shape, *edge) in enumerate(cases):
        E, n, p, out, S, nn, nb, dt = shape
        args = hist_batch_inputs(*shape, seed=900 + 20 * i, device=device,
                                 edge=edge[0] if edge else None)
        codes, nid, g, w, ens = args
        got = histogram(codes, nid, g, w, nn, nb, ens=ens)
        again = histogram(codes, nid, g, w, nn, nb, ens=ens)
        ref = hist_expected(*[a.to(cpu) for a in args[:4]], nn, nb,
                            args[4].to(cpu))
        alone_ok = True
        for e in range(E):
            lanes = (ens == e).nonzero()[:, 0]
            if lanes.numel() == 0:
                continue
            alone = histogram(codes[e], nid[lanes].contiguous(),
                              g[lanes].contiguous(), w[e], nn, nb)
            alone_ok &= all(torch.equal(a, b[lanes])
                            for a, b in zip(alone, got))
        sync(device)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        err = max((a.cpu() - b).abs().max().item() if b.numel() else 0.0
                  for a, b in zip(got, ref))
        log(f"hist batch {name} (E,n,p,out,S,nodes,bins,codes)={shape}: max "
            f"abs diff {err!r}, bit-equal to the plain version on the CPU: "
            f"{ok}; repeat bit-equal {repeat}; each lane equal to its "
            f"ensemble launched alone: {alone_ok}")
        if not (ok and repeat and alone_ok):
            raise AssertionError(f"hist batch {name} disagrees")
        worst = max(worst, err)
        del got, again, ref
    return worst


def time_hist_batch(device, E, shape):
    """One launch over E ensembles' lanes against E launches of one
    ensemble each, at a full-width level: (n, p, out, lanes an ensemble,
    n_nodes, n_bins, code dtype). Times in alternating rounds, with each
    one's bound from :func:`hist_bytes_ops`."""
    from repro_torch.kernels.hist.ops import histogram
    n, p, out, lanes, nn, nb, dt = shape
    codes, nid, g, w, _ = hist_batch_inputs(E, n, p, out, E * lanes, nn,
                                            nb, dt, seed=11, device=device)
    ens = torch.arange(E, device=device,
                       dtype=torch.int32).repeat_interleave(lanes)
    singles = [(codes[e], nid[e * lanes:(e + 1) * lanes],
                g[e * lanes:(e + 1) * lanes], w[e]) for e in range(E)]
    histogram(codes, nid, g, w, nn, nb, ens=ens)        # warm-up
    batched, alone = [], []
    for _ in range(3):
        batched.append(cuda_ms(
            lambda: histogram(codes, nid, g, w, nn, nb, ens=ens), 3))
        alone.append(cuda_ms(lambda: [histogram(*a, nn, nb)
                                      for a in singles], 3))
    nbytes, ops = hist_bytes_ops(n, p, out, E * lanes, nn, nb,
                                 codes.element_size(), E)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    one_bytes, one_ops = hist_bytes_ops(n, p, out, lanes, nn, nb,
                                        codes.element_size())
    return dict(E=E, shape=[n, p, out, lanes, nn, nb], ms=min(batched),
                singles_ms=min(alone), single_ms=min(alone) / E,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                single_bound_ms=max(one_bytes / HBM_BYTES_PER_S,
                                    one_ops / FP32_OPS_PER_S) * 1e3,
                bytes=nbytes, ops=ops)


def check_hist(device, exact_cases, card_cases, histogram=None):
    """hist vs plain on every case; returns the largest abs difference.

    ``exact_cases`` run the kernel on the card and the plain version on the
    CPU: they must agree to the bit. ``card_cases`` run both on the card at
    full width: within HIST_TOL of each cell's sum of |g·w|. ``histogram``
    is the function under test, by default the port's wrapper."""
    from repro_torch.kernels.hist.ref import histogram_ref
    if histogram is None:
        from repro_torch.kernels.hist.ops import histogram
    cpu = torch.device("cpu")
    worst = 0.0
    for i, (name, shape, *edge) in enumerate(exact_cases + card_cases):
        exact = i < len(exact_cases)
        args = hist_inputs(*shape, seed=200 + i, device=device, edge=(
            edge[0] if edge else None))
        nn, nb = shape[4], shape[5]
        got = histogram(*args, nn, nb)
        again = histogram(*args, nn, nb)
        if exact:
            ref = hist_expected(*[a.to(cpu) for a in args], nn, nb)
        else:
            ref = histogram_ref(*args, nn, nb)
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


def fit_groups(art, batch: int = 0):
    """The groups of ensembles (``[(start, stop), ...]`` in grid order)
    that the single-device route trained as one loop each: batches of
    ``ensembles_per_batch`` (``batch``; 0, the default: 8, or the whole
    grid if smaller), each cut by ``fitting.ensemble_groups``."""
    from repro_torch.tabgen.fitting import ensemble_groups
    cfg = art.config
    n_ens = art.n_t * art.n_y
    bs = batch or max(1, min(n_ens, 8))
    lanes, p = art.rounds_run.shape[2], art.p
    out = p if cfg.multi_output else 1
    return [(b0 + a, b0 + b) for b0 in range(0, n_ens, bs)
            for a, b in ensemble_groups(min(bs, n_ens - b0), lanes, p,
                                        cfg.n_bins, out, cfg.max_depth)]


def expected_hist_launches(art, groups=None) -> int:
    """One launch per level and one for the leaf sums, per round a loop ran
    (its longest lane), per loop: per group of ``groups`` (the
    single-device route: :func:`fit_groups`), or per ensemble (None: the
    sharded route, which fits one ensemble at a time)."""
    rounds = art.rounds_run.reshape(art.n_t * art.n_y, -1)
    if groups is None:
        groups = [(e, e + 1) for e in range(rounds.shape[0])]
    loops = sum(int(rounds[a:b].max()) for a, b in groups)
    return loops * (art.config.max_depth + 1)


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
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = TabularGenerator(cfg).fit(X, y, checkpoint_dir=ckpt,
                                        device=device)
        sync(device)
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else None)
        groups = fit_groups(gen.artifacts)
        got = histogram.launches
        expect = expected_hist_launches(gen.artifacts, groups)
        launches += got
        log(f"fit {label}: {n_ens} ensembles of {FIT_ROWS} rows x {P} "
            f"features in groups {groups}, {dt:.2f} s, {dt / n_ens:.2f} s "
            f"per ensemble, device peak {peak} B, {got} hist launches "
            f"(expected {expect}: one a "
            f"level and one for the leaf sums, a round of a group; "
            f"{expected_hist_launches(gen.artifacts)} one ensemble at a "
            f"time)")
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
    return launches + check_batches_at_width(device)


# fits at photons width, each at the default batch and one ensemble a
# batch: (label, the photons config's changes, classes); each default batch
# is one group of 2 (SO at depth 7 would be groups of 1)
BATCH_FITS = (("MO n_t=1 x 2 classes, 5 trees",
               dict(n_t=1, multi_output=True, n_trees=5), (3, 10)),
              ("SO n_t=2 x 1 class, depth 6, 4 trees",
               dict(n_t=2, multi_output=False, max_depth=6, n_trees=4),
               (6,)))


def check_batches_at_width(device):
    """The batch of a fit trains as one loop at photons width too: each
    fit of BATCH_FITS at the default batch (one group of two ensembles)
    equals, on every field, the same fit at ensembles_per_batch=1, and
    launches hist once a level a round of the group. Logs seconds an
    ensemble and the device peak of each. Returns the hist launches."""
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.tabgen import fit_artifacts
    on_card = device.type == "cuda"
    launches = 0
    for label, kw, classes in BATCH_FITS:
        cfg = dataclasses.replace(photons_config(), **kw)
        X, y = calo_photons(np.repeat(np.array(classes), CLASS_ROWS), seed=3)
        n_ens = cfg.n_t * len(classes)
        fits = {}
        for bs in (0, 1):
            histogram.launches = 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            art = fit_artifacts(X, y, cfg, seed=4, device=device,
                                ensembles_per_batch=bs)
            sync(device)
            dt = time.perf_counter() - t0
            groups = fit_groups(art, bs)
            expect = expected_hist_launches(art, groups)
            got = histogram.launches
            launches += got
            peak = torch.cuda.max_memory_allocated() if on_card else None
            fits[bs] = art
            log(f"batch check {label}, ensembles_per_batch={bs or 'default'}"
                f": groups {groups}, {dt!r} s, {dt / n_ens!r} s per ensemble, "
                f"device peak {peak} B, {got} hist launches (expected "
                f"{expect})")
            if bs == 0 and max(b - a for a, b in groups) < 2:
                raise AssertionError(f"batch check {label}: no group of "
                                     f"two ensembles: {groups}")
            if on_card and got != expect:
                raise AssertionError(f"batch check {label}: {got} hist "
                                     f"launches, expected {expect}")
        if not same_model(fits[0], fits[1]):
            raise AssertionError(f"batch check {label}: the batched fit "
                                 "differs from one ensemble a batch")
        log(f"batch check {label}: default batch == one ensemble a batch, "
            "bit for bit on every field")
        del fits
        if on_card:
            torch.cuda.empty_cache()
    return launches


SCALE_CLASSES = (3, 10)        # 2 of photons' 15 energy classes
SCALE_SHARD_ROWS = 4096


def same_model(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
        "mins", "maxs"))


def drive_scaleout(device, tmp):
    """The out-of-core sharded training path at photons width: ingest a
    store, fit from it under a one-rank NCCL group (pipelined, with a
    checkpoint), resume, hold it against the same rows in memory (serial)
    and against the group-free store route, generate from it, and run the
    ingest and training CLIs. Returns the hist launches of its fits."""
    import torch.distributed as dist
    from repro_torch.data.store import DatasetStore, ingest
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.tree_predict.ops import forest_predict
    from repro_torch.launch import ingest as ingest_cli
    from repro_torch.launch import train_forest
    from repro_torch.launch.mesh import forest_mesh
    from repro_torch.tabgen import TabularGenerator, fit_artifacts
    on_card = device.type == "cuda"    # the CPU path launches nothing
    cfg = photons_config(n_t=2, multi_output=True)
    X, y = calo_photons(np.repeat(np.array(SCALE_CLASSES), CLASS_ROWS),
                        seed=2)
    n_ens = cfg.n_t * len(SCALE_CLASSES)
    masked = len(X) * cfg.duplicate_k
    log(f"scale-out cuts: the grid n_t=100 x 15 classes becomes "
        f"{cfg.n_t} x {len(SCALE_CLASSES)}: {n_ens} ensembles of {masked} "
        f"masked rows (each trains on every class's rows, weight 0 outside "
        f"its class); p, duplicate_k, depth, trees and bins are photons'")

    t0 = time.perf_counter()
    store = ingest(((X[i:i + SCALE_SHARD_ROWS], y[i:i + SCALE_SHARD_ROWS])
                    for i in range(0, len(X), SCALE_SHARD_ROWS)),
                   os.path.join(tmp, "store"), shard_rows=SCALE_SHARD_ROWS)
    dt = time.perf_counter() - t0
    ingest_rate = store.n_rows / dt
    log(f"ingest: {store.n_rows} rows x {store.p} in {store.n_shards} shards "
        f"of {SCALE_SHARD_ROWS}, {dt:.3f} s, {ingest_rate!r} rows/s")

    launches = 0
    times = {}

    def timed_fit(label, data, labels, **kw):
        nonlocal launches
        histogram.launches = 0
        t0 = time.perf_counter()
        art = fit_artifacts(data, labels, cfg, device=device, **kw)
        sync(device)
        dt = time.perf_counter() - t0
        got = histogram.launches
        launches += got
        times[label] = dt
        log(f"fit {label}: {n_ens} ensembles of {masked} rows x {P}, "
            f"{dt:.2f} s, {dt / n_ens:.2f} s per ensemble, {got} hist "
            f"launches")
        return art, got

    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = forest_mesh(1, 1, device)
        ckpt = os.path.join(tmp, "ckpt")
        art, got = timed_fit(f"store, 1x1 {backend} mesh, pipelined", store,
                             None, mesh=mesh, pipeline="auto",
                             checkpoint_dir=ckpt)
        expect = expected_hist_launches(art)
        if on_card and (got != expect or got == 0):
            raise AssertionError(f"store fit: {got} hist launches, expected "
                                 f"{expect}")
        if not torch.isfinite(art.leaf).all():
            raise AssertionError("store fit: non-finite model")
        histogram.launches = 0
        again = fit_artifacts(store, None, cfg, mesh=mesh,
                              checkpoint_dir=ckpt, resume=True,
                              device=device)
        if histogram.launches != 0 or not same_model(art, again):
            raise AssertionError(f"store resume: {histogram.launches} "
                                 "launches or another model")
        log("store resume: 0 hist launches, the same model")
        mem, _ = timed_fit(f"in memory, 1x1 {backend} mesh, serial", X, y,
                           mesh=mesh, pipeline=None)
        if not same_model(art, mem):
            raise AssertionError("the store fit differs from the in-memory "
                                 "fit of the same rows")
        log("store fit (pipelined) == in-memory fit (serial): bit-equal")
    finally:
        dist.destroy_process_group()
    free, _ = timed_fit("store, no process group, serial", store, None,
                        pipeline=None)
    if not same_model(art, free):
        raise AssertionError("the group-free store route differs")
    log(f"store fit on the {backend} mesh == store fit without a group: "
        "bit-equal")
    log(f"pipelined vs serial on the store: "
        f"{times[f'store, 1x1 {backend} mesh, pipelined']!r} s vs "
        f"{times['store, no process group, serial']!r} s")

    forest_predict.launches = 0
    gen = TabularGenerator(cfg)
    gen.artifacts = art
    Xg, _ = gen.generate(1000, seed=1)
    if (Xg.shape != (1000, P) or not np.isfinite(Xg).all()
            or (on_card and forest_predict.launches != cfg.n_t - 1)):
        raise AssertionError(f"generate from the store model: {Xg.shape}, "
                             f"{forest_predict.launches} launches")
    log(f"generate 1000 rows from the store model: finite, "
        f"{forest_predict.launches} tree_predict launches (n_t - 1)")

    small = os.path.join(tmp, "small")
    ingest_cli.main(["--out", small, "--synthetic", "4096x16x2",
                     "--shard-rows", "1024", "--batch-rows", "500"])
    flags = ["--n-t", "2", "--duplicate-k", "4", "--n-trees", "5",
             "--max-depth", "4", "--n-bins", "32", "--multi-output",
             "--device", device.type]
    histogram.launches = 0
    cli = train_forest.main(["--data-dir", small, "--mesh", "none"] + flags)
    from repro_torch.config import ForestConfig
    api = fit_artifacts(DatasetStore(small), None, ForestConfig(
        n_t=2, duplicate_k=4, n_trees=5, max_depth=4, n_bins=32,
        reg_lambda=1.0, multi_output=True), device=device)
    launches += histogram.launches
    if not same_model(cli, api):
        raise AssertionError("the training CLI's model differs from the "
                             "API fit of the same store")
    log("CLIs: ingest -> train_forest --mesh none equals the API fit")
    return launches, dict(ingest_rows_per_s=ingest_rate, fit_s=times,
                          ensembles=n_ens, masked_rows=masked)


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


def cpu_noise(eid, split, shape, shard=0):
    """Bridge noise drawn on the host, so fits on two devices see the same
    numbers (the sharded route passes the data rank too)."""
    gen = torch.Generator().manual_seed(1000 * eid + 10 * shard + split)
    return torch.randn(shape, generator=gen), None


def check_training_small(device):
    """A two-moons fit on the card equals the plain path on the CPU (tree
    structure equal, leaves within SMALL_TOL); a warm-start extension on
    the card equals a cold fit there bit for bit."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import extend_artifacts, fit_artifacts
    X, y = two_moons(240, seed=0)
    for mo in (False, True):
        # 20 rounds with a patience of 2: most lanes stop early, so the
        # card's best_round is held to the CPU's where it decides something
        cfg = ForestConfig(n_t=5, duplicate_k=6, n_trees=20, max_depth=3,
                           n_bins=16, reg_lambda=1.0, multi_output=mo,
                           early_stop_rounds=2)
        a = fit_artifacts(X, y, cfg, device=device, noise=cpu_noise)
        b = fit_artifacts(X, y, cfg, device="cpu", noise=cpu_noise)
        same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                   for f in ("feat", "best_round", "rounds_run"))
        err = max((getattr(a, f).cpu() - getattr(b, f)).abs().max().item()
                  for f in ("leaf", "thr_val"))
        stopped = int((b.rounds_run < cfg.n_trees).sum())
        log(f"fit {'MO' if mo else 'SO'} two-moons on {device.type} vs "
            f"plain on cpu, early stopping on ({stopped} of "
            f"{b.rounds_run.numel()} lanes stopped early): structure and "
            f"best_round equal {same}, leaves and thresholds max abs diff "
            f"{err!r}")
        if not same or err > SMALL_TOL or stopped == 0:
            raise AssertionError("training: device and plain path disagree")
        one = fit_artifacts(X, y, cfg, device=device, noise=cpu_noise,
                            ensembles_per_batch=1)
        if not same_model(a, one):
            raise AssertionError("training: the default batch differs from "
                                 "one ensemble a batch")
        log(f"fit {'MO' if mo else 'SO'} two-moons on {device.type}, early "
            f"stopping on: default batch (groups {fit_groups(a)}) == one "
            "ensemble a batch, bit for bit on every field")
        cfg = dataclasses.replace(cfg, n_trees=8)
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
    # the sharded trainer on one rank (a store fit, no process group)
    from repro_torch.data.store import ingest
    with tempfile.TemporaryDirectory() as d:
        store = ingest([(X, y)], os.path.join(d, "store"), shard_rows=100)
        for mo in (False, True):
            cfg = ForestConfig(n_t=5, duplicate_k=6, n_trees=8, max_depth=3,
                               n_bins=16, reg_lambda=1.0, multi_output=mo)
            a = fit_artifacts(store, None, cfg, device=device,
                              noise=cpu_noise)
            b = fit_artifacts(store, None, cfg, device="cpu",
                              noise=cpu_noise)
            same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                       for f in ("feat", "best_round", "rounds_run"))
            err = max((getattr(a, f).cpu() - getattr(b, f)).abs().max()
                      .item() for f in ("leaf", "thr_val"))
            log(f"sharded one-rank fit {'MO' if mo else 'SO'} two-moons on "
                f"{device.type} vs plain on cpu: structure equal {same}, "
                f"leaves and thresholds max abs diff {err!r}")
            if not same or err > SMALL_TOL:
                raise AssertionError("sharded training: device and plain "
                                     "path disagree")


# ---------------------------------------------------------------------------
# the comparison plane: baselines, the Original-style trainer, quality
# ---------------------------------------------------------------------------

BASELINE_STEPS = 20            # card vs CPU at a small size
PARAM_TOL, LOSS_RTOL = 1e-4, 1e-5
GRAD_RTOL = 1e-4               # an LM gradient, of its leaf's largest entry
QUALITY_STEPS = 200            # bench_quality.py's quick=True: 600
QUALITY_FOREST = dict(n_t=8, duplicate_k=10, n_trees=15, max_depth=4,
                      n_bins=32, reg_lambda=1.0, early_stop_rounds=5)
# benchmarks/bench_resource_scaling.py's configuration
RESOURCE = dict(p=8, n_y=2, n_t=3, K=10, T=10)
RESOURCE_ARMS = ([("original", n) for n in (200, 500, 1000)]
                 + [(arm, n) for arm in ("ours-SO", "ours-MO")
                    for n in (200, 500, 1000, 10_000, 100_000)]
                 + [("ours-SO-ES", 1000), ("ours-MO-ES", 1000)])
PHOTONS_FIT, PHOTONS_HELD, PHOTONS_STEPS = 16_000, 4_000, 300
METRIC_ROWS = PHOTONS_HELD     # generated rows the photons metrics read


def numpy_mlp(sizes, rng):
    """Initial weights in the JAX package's layout, from a numpy stream."""
    return [{"w": (a ** -0.5 * rng.normal(size=(a, b))).astype(np.float32),
             "b": np.zeros((b,), np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def host_draws(kinds, n, seed):
    """``draws(step)`` for a baseline's fit, drawn on the host from a
    generator seeded by (seed, step), so both devices see the same numbers.
    ``kinds``: ``("idx", k)`` row indices into n rows, ``("t", k, lo)``
    uniform on [lo, 1), ``("randn", shape)`` standard normals."""
    def draws(step):
        g = torch.Generator().manual_seed(seed * 100_003 + step)
        out = []
        for kind, shape, *lo in kinds:
            if kind == "idx":
                out.append(torch.randint(0, n, (shape,), generator=g))
            elif kind == "t":
                out.append(lo[0] + (1.0 - lo[0]) * torch.rand(
                    (shape,), generator=g))
            else:
                out.append(torch.randn(shape, generator=g))
        return tuple(out)
    return draws


def small_baselines(n, p, n_y):
    """(label, constructor, init, draws, noise shape) of each NN baseline
    at the card-vs-CPU size."""
    from repro_torch.config import ForestConfig
    from repro_torch.core.ctgan import CTGANBaseline
    from repro_torch.core.nn_baselines import NNGenerativeModel, TVAEBaseline
    rng = np.random.default_rng(7)
    hid, batch, lat = 64, 64, 4
    out = []
    for i, method in enumerate(("flow", "diffusion")):
        lo = 1e-3 if method == "diffusion" else 0.0
        out.append((f"nn-{method}", lambda m=method: NNGenerativeModel(
            ForestConfig(method=m), hidden=hid, depth=2,
            steps=BASELINE_STEPS, batch=batch),
            numpy_mlp([p + 32 + n_y, hid, hid, p], rng),
            host_draws((("idx", batch), ("t", batch, lo),
                        ("randn", (batch, p))), n, i), (50, p)))
    out.append(("tvae", lambda: TVAEBaseline(
        latent=lat, hidden=hid, steps=BASELINE_STEPS, batch=batch),
        {"enc": numpy_mlp([p, hid, 2 * lat], rng),
         "dec": numpy_mlp([lat, hid, p], rng)},
        host_draws((("idx", batch), ("randn", (batch, lat))), n, 2),
        (50, lat)))
    out.append(("ctgan", lambda: CTGANBaseline(
        latent=lat, hidden=hid, steps=BASELINE_STEPS, batch=batch),
        {"gen": numpy_mlp([lat + n_y, hid, hid, p], rng),
         "dis": numpy_mlp([p + n_y, hid, hid, 1], rng)},
        host_draws((("idx", batch), ("randn", (batch, lat))) * 2, n, 3),
        (50, lat)))
    return out


def model_params(model):
    nets = [getattr(model, k) for k in ("net", "enc", "dec", "gen", "dis")
            if hasattr(model, k)]
    return torch.cat([q.detach().flatten().cpu() for net in nets
                      for q in net.parameters()])


def model_losses(model):
    if hasattr(model, "losses"):
        return model.losses
    return np.concatenate([model.d_losses, model.g_losses])


def forests_differ(a, b):
    """(structure equal, largest |difference| of thresholds and leaves) of
    two lists of forests with fields feat, thr_val, leaf, best_round and
    rounds_run (numpy arrays or tensors); +inf thresholds compare equal."""
    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    same = len(a) == len(b) and all(
        np.array_equal(host(getattr(x, f)), host(getattr(z, f)))
        for x, z in zip(a, b) for f in ("feat", "best_round", "rounds_run"))
    with np.errstate(invalid="ignore"):     # inf - inf at the sentinels
        err = max(float(np.nan_to_num(np.abs(
            host(getattr(x, f)) - host(getattr(z, f))), nan=0.0).max())
            for x, z in zip(a, b) for f in ("thr_val", "leaf"))
    return same, err


def check_resource_fits(device):
    """ours-SO and ours-MO at the resource comparison's configuration (p =
    8, two classes, n = 1,000, depth 4, 32 bins) on the card against the
    plain path on the CPU, noise drawn on the host: tree structure equal,
    thresholds and leaves within 1e-5. (The Original-style arm's fits are
    one-lane fits of the same trainer, held on two-moons above; at this
    configuration its 240 host-bound per-output fits on each device would
    add no shape: phase 4 holds hist at its 32-bin, p = 8 shapes.)"""
    from repro_torch.config import ForestConfig
    from repro_torch.data.tabular import synthetic_resource_dataset
    from repro_torch.tabgen import fit_artifacts
    X, y = synthetic_resource_dataset(1000, RESOURCE["p"], RESOURCE["n_y"],
                                      seed=0)
    worst = {}
    for arm in ("ours-SO", "ours-MO"):
        cfg = ForestConfig(n_t=RESOURCE["n_t"], duplicate_k=RESOURCE["K"],
                           n_trees=RESOURCE["T"], max_depth=4, n_bins=32,
                           reg_lambda=1.0, multi_output=arm == "ours-MO")
        same, err = forests_differ(
            *[[fit_artifacts(X, y, cfg, device=d, noise=cpu_noise)]
              for d in (device, torch.device("cpu"))])
        log(f"{arm} fit at the resource configuration (n = 1,000) on "
            f"{device.type} vs plain on cpu: structure equal {same}, "
            f"thresholds and leaves max abs diff {err!r}")
        if not same or err > 1e-5:
            raise AssertionError(f"{arm} at the resource configuration: "
                                 "card and CPU disagree")
        worst[arm] = err
    return worst


def check_comparison_small(device):
    """(a) Each NN baseline on the card against the plain path on the CPU
    (same initial weights, the same draws, 20 steps, TF32 off); the
    Original-style trainer on two-moons (structure equal, thresholds and
    leaves within 1e-5); sample_loop_reference from the same x1."""
    from repro_torch.config import ForestConfig
    from repro_torch.core.naive import NaiveForestGenerativeModel
    from repro_torch.tabgen import fit_artifacts, sample_loop_reference
    X, y = two_moons(240, seed=0)
    worst = {}
    for label, make, init, draws, noise_shape in small_baselines(240, 2, 2):
        fits = [make().fit(X, y, seed=0, device=d, draws=draws, init=init)
                for d in (device, torch.device("cpu"))]
        p_err = (model_params(fits[0]) - model_params(fits[1])).abs().max()
        l0, l1 = model_losses(fits[0]), model_losses(fits[1])
        l_err = float(np.max(np.abs(l0 - l1) / np.abs(l1)))
        noise = torch.randn(noise_shape,
                            generator=torch.Generator().manual_seed(5))
        kw = {"x1": noise} if label.startswith("nn") else {"z": noise}
        gens = [m.generate(50, seed=4, **kw) for m in fits]
        gens = [g if label == "tvae" else g[0] for g in gens]
        g_err = float(np.abs(gens[0] - gens[1]).max())
        worst[label] = dict(params=p_err.item(), loss_rel=l_err,
                            generate=g_err)
        log(f"{label} on {device.type} vs plain on cpu after "
            f"{BASELINE_STEPS} steps: params max abs diff {p_err.item()!r}, "
            f"losses max rel diff {l_err!r}, generate max abs diff "
            f"{g_err!r}")
        if p_err > PARAM_TOL or l_err > LOSS_RTOL or g_err > PARAM_TOL:
            raise AssertionError(f"{label}: card and CPU disagree")
    cfg = ForestConfig(n_t=2, duplicate_k=4, n_trees=4, max_depth=3,
                       n_bins=16, reg_lambda=1.0)
    Xs, ys = two_moons(60, seed=0)
    fits = [NaiveForestGenerativeModel(cfg).fit(Xs, ys, seed=0, device=d)
            for d in (device, torch.device("cpu"))]
    keys = [[k for k, _ in m.models] for m in fits]
    same, err = forests_differ(*[[f for _, f in m.models] for m in fits])
    same = same and keys[0] == keys[1]
    log(f"Original-style trainer on {device.type} vs plain on cpu "
        f"({len(keys[0])} per-output fits): keys and structure equal "
        f"{same}, thresholds and leaves max abs diff {err!r}")
    if not same or err > 1e-5:
        raise AssertionError("Original-style trainer: card and CPU disagree")
    worst["original"] = err
    worst["resource_config"] = check_resource_fits(device)
    art = fit_artifacts(X, y, ForestConfig(n_t=5, duplicate_k=4, n_trees=4,
                                           max_depth=3, n_bins=16),
                        device="cpu", noise=cpu_noise)
    x1 = {yi: torch.randn((n, 2), generator=torch.Generator().manual_seed(yi))
          for yi, n in ((0, 200), (1, 200))}
    outs = [sample_loop_reference(art.to(d), 137, seed=3,
                                  x1=lambda yi, shape: x1[yi][:shape[0]])
            for d in (device, torch.device("cpu"))]
    err = float(np.abs(outs[0][0] - outs[1][0]).max())
    log(f"sample_loop_reference on {device.type} vs plain on cpu, same x1: "
        f"max abs diff {err!r}")
    if err > SMALL_TOL or not np.array_equal(outs[0][1], outs[1][1]):
        raise AssertionError("sample_loop_reference: card and CPU disagree")
    worst["loop_reference"] = err
    return worst


def quality_datasets(n=600, seed=0):
    """bench_quality.py's datasets: two-moons, a 3-class Gaussian mixture
    and a 6-D correlated Gaussian (unlabelled)."""
    from repro_torch.data.tabular import correlated_gaussian
    rng = np.random.default_rng(seed)
    X, y = two_moons(n, seed=seed)
    mus = np.array([[-2, 0, 1], [2, 1, -1], [0, -2, 2]], np.float32)
    Xg = np.concatenate([m + 0.5 * rng.normal(size=(n // 3, 3))
                         for m in mus]).astype(np.float32)
    yg = np.repeat(np.arange(3), n // 3)
    perm = rng.permutation(len(Xg))
    Xc, _ = correlated_gaussian(n, 6, seed=seed)
    return {"two_moons": (X, y), "gauss_mix": (Xg[perm], yg[perm]),
            "corr_gauss": (Xc, None)}


def quality_methods():
    """bench_quality.py's methods at its quick sizes."""
    from repro_torch.config import ForestConfig
    from repro_torch.core.copula import GaussianCopula
    from repro_torch.core.ctgan import CTGANBaseline
    from repro_torch.core.nn_baselines import NNGenerativeModel, TVAEBaseline
    from repro_torch.tabgen import TabularGenerator
    fc = QUALITY_FOREST
    return {
        "FF-SO": lambda: TabularGenerator(ForestConfig(method="flow", **fc)),
        "FF-MO": lambda: TabularGenerator(
            ForestConfig(method="flow", multi_output=True, **fc)),
        "FD-SO": lambda: TabularGenerator(
            ForestConfig(method="diffusion", **fc)),
        "copula": GaussianCopula,
        "tvae": lambda: TVAEBaseline(steps=QUALITY_STEPS),
        "nn-flow": lambda: NNGenerativeModel(ForestConfig(method="flow"),
                                             steps=QUALITY_STEPS),
        "nn-diff": lambda: NNGenerativeModel(
            ForestConfig(method="diffusion"), steps=QUALITY_STEPS),
        "ctgan": lambda: CTGANBaseline(steps=QUALITY_STEPS),
    }


def quality_table(device):
    """(b) Paper Table 2 / 7 at bench_quality.py's quick sizes, on the card:
    W1 to the test split (per feature and sliced), coverage of the test
    split, mean rank by sliced W1, fit + generate seconds. Gated on shape
    and finiteness; the ordering is logged."""
    from repro_torch.core.copula import GaussianCopula
    from repro_torch.eval import metrics as M
    rows = {}
    for ds, (X, y) in quality_datasets().items():
        n = len(X)
        tr, te = X[: int(0.8 * n)], X[int(0.8 * n):]
        ytr = y[: int(0.8 * n)] if y is not None else None
        k = M.auto_k(tr, te)
        for name, make in quality_methods().items():
            t0 = time.perf_counter()
            model = make()
            if isinstance(model, GaussianCopula):
                G = model.fit(tr).generate(len(tr), seed=1)
            elif name == "tvae":
                G = model.fit(tr, device=device).generate(len(tr), seed=1)
            else:
                G, _ = model.fit(tr, ytr, seed=0, device=device).generate(
                    len(tr), seed=1)
            sync(device)
            wall = time.perf_counter() - t0
            if G.shape != tr.shape or not np.isfinite(G).all():
                raise AssertionError(f"quality {ds}/{name}: {G.shape}, "
                                     "not finite or not the train shape")
            rows[ds, name] = dict(
                w1_test=M.w1_per_feature(G, te), sliced_w1_test=M.sliced_w1(
                    G, te), coverage_test=M.coverage(G, te, k), seconds=wall)
    names = list(quality_methods())
    ranks = {m: [] for m in names}
    for ds in quality_datasets():
        order = sorted(names, key=lambda m: rows[ds, m]["sliced_w1_test"])
        for r, m in enumerate(order, start=1):
            ranks[m].append(r)
    table = {}
    for m in names:
        table[m] = dict(mean_rank=float(np.mean(ranks[m])), datasets={
            ds: rows[ds, m] for ds in quality_datasets()})
        log(f"quality {m:8s} mean rank {table[m]['mean_rank']:.2f}: " + "; "
            .join(f"{ds} W1 {r['w1_test']:.4f} sliced {r['sliced_w1_test']:.4f}"
                  f" cov {r['coverage_test']:.3f} {r['seconds']:.2f} s"
                  for ds, r in table[m]["datasets"].items()))
    return table


_ARM = r"""
import dataclasses, json, os, sys, threading, time
import torch
from repro_torch.config import ForestConfig
from repro_torch.core.naive import NaiveForestGenerativeModel
from repro_torch.data.tabular import synthetic_resource_dataset
from repro_torch.kernels import build
from repro_torch.kernels.hist.ops import histogram
from repro_torch.tabgen import TabularGenerator

arm, sizes, p, n_y, n_t, K, T = ({arm!r}, {sizes!r}, {p}, {n_y}, {n_t}, {K},
                                 {T})
device = torch.device({device!r})
on_card = device.type == "cuda"
fcfg = ForestConfig(n_t=n_t, duplicate_k=K, n_trees=T, max_depth=4,
                    n_bins=32, reg_lambda=1.0,
                    multi_output=arm.startswith("ours-MO"),
                    early_stop_rounds=5 if arm.endswith("-ES") else 0)
Model = NaiveForestGenerativeModel if arm == "original" else TabularGenerator
PAGE = os.sysconf("SC_PAGE_SIZE")


def fit(X, y, cfg):
    Model(cfg).fit(X, y, seed=0, device=device)
    if on_card:
        torch.cuda.synchronize()


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


class PeakRSS(threading.Thread):   # samples the RSS every 2 ms
    def __init__(self):
        super().__init__(daemon=True)
        self.lock = threading.Lock()
        self.peak = rss()

    def run(self):
        while True:
            time.sleep(0.002)
            now = rss()
            with self.lock:
                self.peak = max(self.peak, now)

    def reset(self):
        with self.lock:
            self.peak = rss()
            return self.peak

    def read(self):
        now = rss()
        with self.lock:
            return max(self.peak, now)


# one sampler for the process, started before the warm-up, so that no fit
# pays for its thread
sampler = PeakRSS()
sampler.start()
# CUDA init and kernel load: one-round fits at the smallest and the largest
# size load the kernels (and the CUDA modules, loaded lazily, some only
# past a size) that this arm's fits run
for n in (sizes[0], sizes[-1]):
    fit(*synthetic_resource_dataset(n, p, n_y, seed=1),
        dataclasses.replace(fcfg, n_t=1, n_trees=1))
print(json.dumps(dict(ready=True)), flush=True)
sys.stdin.readline()        # the parent's go: no two arms' fits overlap
for n in sizes:
    histogram.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base_rss = sampler.reset()
    X, y = synthetic_resource_dataset(n, p, n_y, seed=0)
    t0 = time.perf_counter()
    fit(X, y, fcfg)
    wall = time.perf_counter() - t0
    peak = sampler.read()
    del X, y
    print(json.dumps(dict(
        arm=arm, n=n, wall_s=wall, peak_rss_bytes=peak,
        base_rss_bytes=base_rss, rss_over_base_bytes=peak - base_rss,
        max_device_bytes=(torch.cuda.max_memory_allocated() if on_card
                          else None),
        hist_launches=histogram.launches)), flush=True)
print(json.dumps(dict(
    nvcc_runs=sum(c for (kind, _), c in build.events().items()
                  if kind == "build"))))
"""


def resource_comparison(device, tmp):
    """(c) Paper Figures 1/2/4 at bench_resource_scaling.py's configuration.
    Each arm runs in a fresh subprocess that imports only the port, with
    the kernels already built. The arms start together; each fits its sizes
    in increasing order when the one before it has finished: wall
    seconds, peak RSS and RSS above the baseline before the fit (after CUDA
    init and kernel load: one-round fits at the arm's smallest and largest
    size first load what it runs; a thread samples the RSS every 2 ms;
    freed blocks go back to the system at once), peak device bytes, hist
    launches. Gate: every arm exits 0, every fit
    launched hist, and no arm ran nvcc."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    # glibc's malloc: blocks over 64 KB are mapped and unmapped, and the
    # heap is trimmed on free, so what one fit freed is not the next fit's
    # free memory and the RSS follows the live data
    env = dict(os.environ, PYTHONPATH=src, MALLOC_MMAP_THRESHOLD_="65536",
               MALLOC_TRIM_THRESHOLD_="0")
    on_card = device.type == "cuda"    # the CPU path launches nothing
    arms = {}
    for arm, n in RESOURCE_ARMS:
        arms.setdefault(arm, []).append(n)
    procs = {}
    try:
        for arm, sizes in arms.items():    # start-ups overlap, fits do not
            path = os.path.join(tmp, f"arm_{arm}.py")
            with open(path, "w") as f:
                f.write(_ARM.format(arm=arm, sizes=tuple(sizes),
                                    device=str(device), **RESOURCE))
            err = open(path + ".err", "w")
            procs[arm] = (subprocess.Popen(
                [sys.executable, path], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True, env=env), err)
        records = []
        for arm, (proc, err) in procs.items():
            ready = proc.stdout.readline()
            if not ready.startswith('{"ready"'):
                raise AssertionError(f"resource arm {arm} did not start: "
                                     f"{ready!r}")
        for arm, (proc, err) in procs.items():
            t0 = time.perf_counter()
            out, _ = proc.communicate("go\n", timeout=600)
            err.close()
            if proc.returncode != 0:
                with open(err.name) as f:
                    raise AssertionError(f"resource arm {arm} exited "
                                         f"{proc.returncode}:\n"
                                         f"{f.read()[-4000:]}")
            lines = [json.loads(line) for line in out.strip().splitlines()]
            recs, tail = lines[:-1], lines[-1]
            if (len(recs) != len(arms[arm]) or tail["nvcc_runs"] != 0
                    or (on_card and any(x["hist_launches"] == 0
                                        for x in recs))):
                raise AssertionError(f"resource arm {arm}: {lines}")
            for rec in recs:
                log(f"resource {arm:10s} n={rec['n']:>7,}: fit "
                    f"{rec['wall_s']!r} s, peak RSS {rec['peak_rss_bytes']} "
                    f"B ({rec['rss_over_base_bytes']} over the "
                    f"{rec['base_rss_bytes']} B before the fit), device peak "
                    f"{rec['max_device_bytes']} B, {rec['hist_launches']} "
                    "hist launches")
            log(f"resource {arm}: {time.perf_counter() - t0:.1f} s after its "
                "go")
            records += recs
        return records
    finally:
        for proc, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()


def photons_baselines(device):
    """(d) The NN baselines and the copula at CaloForest photons width
    (p = 368, 15 classes): 16,000 seeded showers to train on and 4,000
    held out; 300 training steps each; generate 120,000 rows (NN: 50
    steps). Training steps/s (after a 3-step fit of the same shapes, in
    which cuBLAS picks and loads its kernels), generate rows/s, peak device
    bytes; the per-feature W1 and classifier AUC against the held-out
    showers (on the first 4,000 generated rows) are logged, not gated.
    Coverage is left out: its host k-NN is O(n^2) at this width. Each
    record counts the generated columns that hold one value and marks an
    output with every column constant as degenerate."""
    from repro_torch.config import ForestConfig
    from repro_torch.core.copula import GaussianCopula
    from repro_torch.core.ctgan import CTGANBaseline
    from repro_torch.core.nn_baselines import NNGenerativeModel, TVAEBaseline
    from repro_torch.eval import metrics as M
    rng = np.random.default_rng(3)
    X, y = calo_photons(rng.integers(0, N_Y, PHOTONS_FIT + PHOTONS_HELD),
                        seed=3)
    tr, ytr = X[:PHOTONS_FIT], y[:PHOTONS_FIT]
    held = X[PHOTONS_FIT:]
    makers = {
        "nn-flow": lambda steps: NNGenerativeModel(
            ForestConfig(method="flow"), hidden=256, depth=3, steps=steps,
            batch=256),
        "tvae": lambda steps: TVAEBaseline(steps=steps),
        "ctgan": lambda steps: CTGANBaseline(steps=steps),
        "copula": lambda steps: GaussianCopula()}
    out = {}
    on_card = device.type == "cuda"
    for name, make in makers.items():
        if name != "copula":    # cuBLAS picks and loads its kernels
            make(3).fit(tr, ytr, seed=0, device=device)
        model = make(PHOTONS_STEPS)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "copula":
            model.fit(tr)
        else:
            model.fit(tr, ytr, seed=0, device=device)
        sync(device)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        G = model.generate(N_ROWS, seed=1)
        G = G if name in ("copula", "tvae") else G[0]
        gen_s = time.perf_counter() - t0
        if G.shape != (N_ROWS, P) or not np.isfinite(G).all():
            raise AssertionError(f"photons {name}: {G.shape} or not finite")
        # columns of the generated rows that hold one value: all P of them
        # make a degenerate output (the copula's, where constant training
        # columns leave NaNs in its correlation), whose W1 is no result
        const = int((G.min(0) == G.max(0)).sum())
        rec = dict(fit_s=fit_s, generate_s=gen_s, constant_columns=const,
                   degenerate=const == P,
                   generate_rows_per_s=N_ROWS / gen_s,
                   max_device_bytes=(torch.cuda.max_memory_allocated()
                                     if on_card else None),
                   w1=M.w1_per_feature(G[:METRIC_ROWS], held),
                   classifier_auc=M.classifier_auc(held, G[:METRIC_ROWS]))
        if name != "copula":
            rec["train_steps_per_s"] = PHOTONS_STEPS / fit_s
        out[name] = rec
        log(f"photons {name}: fit {fit_s:.3f} s"
            + (f" ({rec['train_steps_per_s']:.1f} steps/s)"
               if name != "copula" else "")
            + f", generate {N_ROWS} rows {gen_s:.3f} s "
            f"({rec['generate_rows_per_s']:.0f} rows/s), device peak "
            f"{rec['max_device_bytes']} B, W1 {rec['w1']:.4g}, "
            f"classifier AUC {rec['classifier_auc']:.4f}, {const} of {P} "
            "generated columns constant"
            + (" (a degenerate output)" if rec["degenerate"] else ""))
    return out


def drive_comparison(device, tmp):
    """Phase 12: (a) card against CPU at a small size, (b) the quality
    table, (c) the resource comparison in subprocesses, (d) the baselines
    at photons width. Returns the numbers and the hist launches of (c)'s
    subprocesses."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["card_vs_cpu"] = check_comparison_small(device)
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["quality"] = quality_table(device)
    out["quality_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["resource"] = resource_comparison(device, tmp)
    out["resource_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["photons"] = photons_baselines(device)
    out["photons_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"comparison phase: {out['seconds']:.1f} s (card vs cpu "
        f"{out['card_vs_cpu_s']:.1f}, quality {out['quality_s']:.1f}, "
        f"resource {out['resource_s']:.1f}, photons {out['photons_s']:.1f})")
    return out, sum(a["hist_launches"] for a in out["resource"])


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain
# ---------------------------------------------------------------------------

def flash_inputs(b, hq, hkv, sq, skv, d, dtype, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


def flash_bytes_ops(b, hq, hkv, sq, skv, d, causal, elem):
    """Bytes the function must move (q, k, v read once, o written once) and
    its operations: 4·d per (query, visible key) pair and head, two for the
    score's multiply-adds and two for P·V's."""
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * elem
    return nbytes, 4 * b * hq * d * pairs


def check_flash(device, cases):
    """Kernel vs plain version on the card at every case and dtype; two
    launches must give the same bits. Returns the largest abs difference
    per dtype."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    worst = {}
    for i, (name, shape, causal) in enumerate(cases):
        for dtype, (atol, rtol) in FA_TOL.items():
            q, k, v = flash_inputs(*shape, dtype, seed=300 + i, device=device)
            got = flash_attention(q, k, v, causal=causal)
            again = flash_attention(q, k, v, causal=causal)
            ref = attention_ref(q, k, v, causal)
            sync(device)
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention {name}: two launches "
                                     f"differ")
            diff = (got.float() - ref.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            log(f"flash_attention vs plain {name} (B,Hq,Hkv,Sq,Skv,d)="
                f"{shape} causal={causal} {str(dtype)[6:]}: max abs diff "
                f"{err!r}, within atol {atol} + rtol {rtol}: {ok}; repeat "
                f"bit-equal")
            if not ok:
                raise AssertionError(f"flash_attention disagrees on {name}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del q, k, v, got, again, ref, diff
    return worst


def ptxas_lines(build_log):
    """ptxas -v's stack, spill and register lines, keyed by the function
    they describe."""
    props, name = {}, None
    for line in build_log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
        elif name and ("registers" in line or "spill" in line):
            props.setdefault(name, []).append(line.strip())
    return props


def spills(lines) -> bool:
    """Whether ptxas's lines of one function report spill stores or loads."""
    return any(int(n) for line in lines
               for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                   line))


def check_tensor_cores(lib_path):
    """Every bf16 instance of flash_attention (``fa_wgmma_kernel<d>``) must
    hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads) in its SASS. Returns
    {d: (HGMMA count, UTMALDG count)}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        found = re.match(r"\S*fa_wgmma_kernelILi(\d+)E", part)
        if found:
            counts[int(found.group(1))] = (part.count("HGMMA"),
                                           part.count("UTMALDG"))
    if (sorted(counts) != sorted(HEAD_DIMS)
            or not all(h and t for h, t in counts.values())):
        raise AssertionError(f"bf16 flash_attention does not run wgmma fed "
                             f"by TMA at every d: {counts}")
    return counts


def fp32_residency():
    """Warps resident on a SM of each fp32 flash_attention instance, as the
    card reports them (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the
    kernel's query tile, threads, shared memory and ring slots must be
    fp32_plan's."""
    from repro_torch.kernels.flash_attention.ops import (
        FP32_TILES, fp32_config, fp32_plan)
    out = {}
    for d, (_, _, _, bq) in FP32_TILES.items():
        plan = fp32_plan(1, 1, bq * 132, 4096, d, False)
        cfg = fp32_config(d)
        if (cfg["bq"], cfg["threads"], cfg["smem_bytes"], cfg["stages"]) != (
                plan.bq, plan.threads, plan.smem_bytes, plan.stages):
            raise AssertionError(f"fp32 flash_attention d={d}: the kernel's "
                                 f"{cfg} is not the plan's {plan}")
        if cfg["blocks_per_sm"] < 1:
            raise AssertionError(f"fp32 flash_attention d={d} fits no SM: "
                                 f"{cfg}")
        out[f"d={d} stages={plan.stages}"] = (
            f"{cfg['warps_per_sm']} warps ({cfg['blocks_per_sm']} x "
            f"{cfg['threads']} threads, {cfg['smem_bytes']} B)")
    return out


def time_flash(device, shape, dtype, causal=True):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = flash_inputs(*shape, dtype, seed=7, device=device)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal), 10)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal), 3)
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                      enable_gqa=True), 10)
    nbytes, ops = flash_bytes_ops(*shape, causal, q.element_size())
    rate = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, ops=ops)


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

def prefill_kernel_share(params, cfg, prompts, device, dtype):
    """Profile one prefill in ``dtype``: the device's busy time, the
    flash-attention kernel's part of it (the fp32 ``fa_kernel`` or the bf16
    ``fa_wgmma_kernel``), and the logits."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, _ = lm.prefill_step(params, {"tokens": prompts}, cfg,
                                    dtype=dtype)
        sync(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    fa_us = sum(e.device_time_total for e in kernels
                if "fa_kernel" in e.name or "fa_wgmma_kernel" in e.name)
    return logits, busy_us / 1e6, fa_us / 1e6


def drive_serving(device):
    """Serve smollm-135m at full width; returns (kernel launches of the
    serve_batch run, its stats)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import merge_caches, serve_batch
    from repro_torch.models import lm
    cfg = get_arch("smollm-135m")
    params = lm.init_params(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device=device)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), generator=g,
                            device=device)
    cache_size = SERVE_S + SERVE_NEW
    cache_gb = (2 * cfg.n_layers * SERVE_B * cfg.n_kv_heads * cache_size
                * cfg.d_head * 4 / 1e9)
    log(f"smollm-135m: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters ({n_params * 4 / 1e9:.3f} GB fp32) on the "
        f"device; KV cache of {SERVE_B} x {cache_size} positions, "
        f"{cache_gb:.3f} GB")
    # warm-up of cuBLAS and the allocator; its launches are not counted
    serve_batch(cfg, params, prompts[:1, :64], 2, cache_size=65)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve_batch(cfg, params, prompts, SERVE_NEW, cache_size)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    if (gen.shape != (SERVE_B, SERVE_NEW) or gen.min() < 0
            or gen.max() >= cfg.vocab):
        raise AssertionError(f"serve_batch: bad tokens {gen.shape}")
    # the CPU path launches nothing; the launch checks run on the card
    on_card = device.type == "cuda"
    expect = cfg.n_layers if on_card else 0
    if launches != expect:
        raise AssertionError(f"serve_batch: {launches} flash_attention "
                             f"launches, expected {cfg.n_layers}")
    prefill_tok_s = SERVE_B * SERVE_S / stats["prefill_s"]
    log(f"serve_batch B={SERVE_B} prompt={SERVE_S} new={SERVE_NEW} fp32: "
        f"{wall:.3f} s; prefill {stats['prefill_s']!r} s, {prefill_tok_s!r} "
        f"tok/s; decode {stats['decode_s']!r} s for {SERVE_NEW - 1} steps, "
        f"{stats['tok_per_s']!r} tok/s; {launches} flash_attention launches")

    flash_attention.launches = 0
    logits, busy_s, fa_s = prefill_kernel_share(params, cfg, prompts, device,
                                                torch.float32)
    if flash_attention.launches != expect:
        raise AssertionError("prefill: wrong flash_attention launch count")
    if logits.shape != (SERVE_B, 1, cfg.vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError("prefill fp32: bad logits")
    share = fa_s / busy_s if busy_s > 0 else float("nan")
    log(f"prefill fp32 profiled: device busy {busy_s!r} s, flash_attention "
        f"{fa_s!r} s ({share!r} of the device time); logits finite")
    del logits

    flash_attention.launches = 0
    logits, pc = lm.prefill_step(params, {"tokens": prompts}, cfg)
    prefill_launches = flash_attention.launches
    cache = merge_caches(lm.init_cache(cfg, SERVE_B, cache_size,
                                       torch.bfloat16, device), pc)
    del pc
    flash_attention.launches = 0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(2):
        logits, cache = lm.decode_step(params, cache, tok, SERVE_S + i, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync(device)
    decode_launches = flash_attention.launches
    if (prefill_launches != expect or decode_launches != 0
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bf16: {prefill_launches} prefill and "
                             f"{decode_launches} decode launches, or "
                             f"non-finite logits")
    log(f"prefill bf16: {prefill_launches} flash_attention launches, "
        f"logits finite; 2 bf16 decode steps: {decode_launches} launches")
    del cache, logits

    # the bf16 prefill timed as serve_batch times the fp32 one (host clock
    # around the call, synchronised), after the warm call above
    sync(device)
    t0 = time.perf_counter()
    lm.prefill_step(params, {"tokens": prompts}, cfg)
    sync(device)
    bf16_s = time.perf_counter() - t0
    flash_attention.launches = 0
    logits, bf16_busy_s, bf16_fa_s = prefill_kernel_share(
        params, cfg, prompts, device, torch.bfloat16)
    if flash_attention.launches != expect or not torch.isfinite(logits).all():
        raise AssertionError("prefill bf16: wrong flash_attention launch "
                             "count or non-finite logits")
    bf16_share = bf16_fa_s / bf16_busy_s if bf16_busy_s > 0 else float("nan")
    bf16_tok_s = SERVE_B * SERVE_S / bf16_s
    log(f"prefill bf16 B={SERVE_B} prompt={SERVE_S}: {bf16_s!r} s, "
        f"{bf16_tok_s!r} tok/s; profiled: device busy {bf16_busy_s!r} s, "
        f"flash_attention {bf16_fa_s!r} s ({bf16_share!r} of the device "
        f"time)")
    del params, logits
    stats.update(prefill_tok_per_s=prefill_tok_s, device_busy_s=busy_s,
                 flash_attention_s=fa_s, flash_attention_share=share,
                 bf16_prefill_s=bf16_s, bf16_prefill_tok_per_s=bf16_tok_s,
                 bf16_device_busy_s=bf16_busy_s,
                 bf16_flash_attention_s=bf16_fa_s,
                 bf16_flash_attention_share=bf16_share)
    return launches, stats


# smollm-135m training: B=8 sequences of 2,048 tokens, remat "full", fp32
# masters. The run with a commit trains to TRAIN_SPLIT, then a second call
# resumes it to TRAIN_STEPS. The learning rate is 1e-4 from the first step:
# at the JAX launcher's 1e-3 (set for reduced configs) the seeded 30-layer
# model's loss rises over the first steps (77 -> 116 on the card), and on
# the CPU's plain fp32 path alike (scripts/check_torch_lm_lr.py)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_SPLIT, TRAIN_LR = 8, 2048, 4, 2, 1e-4
TRAIN_FP32_STEPS = 3


def lm_train_run(cfg, tcfg, steps, dtype, device, seed=0, ckpt_dir=None,
                 params=None):
    """``repro_torch.train.loop.train`` on FastTokenStream batches from
    seeded weights; returns (losses by step, host seconds at each logged
    step, device peak bytes)."""
    from repro_torch.data.tokens import FastTokenStream
    from repro_torch.models import lm
    from repro_torch.train.loop import train
    if params is None:
        params = lm.init_params(cfg, device=device, seed=seed)
    stream = FastTokenStream(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    stamps = []

    def stamp(line):
        if line.startswith("step"):
            stamps.append(time.perf_counter())
        log(f"  {line}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, _, history = train(cfg, tcfg, stream.batch_at, steps=steps,
                          ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
                          log_every=1, dtype=dtype, params=params,
                          log_fn=stamp)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return {h["step"]: h["loss"] for h in history}, stamps, peak


def drive_lm_training(device, tmp):
    """Train smollm-135m at its published width and depth (30 layers,
    d_model 576, vocab 49,152; seeded weights) through
    ``repro_torch.train.loop.train``: TRAIN_STEPS steps at bf16 compute
    with fp32 masters, uninterrupted, timed; the same run with a commit at
    TRAIN_SPLIT and a second call that resumes it (from other weights: the
    restore must overwrite them), its losses equal to the uninterrupted
    run's bit for bit; TRAIN_FP32_STEPS steps at fp32. The loss must go
    down. Attention is mea_attention (the kernel has no backward): no
    kernel of the three launches here. Returns the numbers."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch
    cfg = get_arch("smollm-135m")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_STEPS, remat_policy="full")
    tokens = TRAIN_B * TRAIN_S
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "remat": "full"}
    t_phase = time.perf_counter()
    for name, dtype, steps in (("bf16", torch.bfloat16, TRAIN_STEPS),
                               ("fp32", torch.float32, TRAIN_FP32_STEPS)):
        t0 = time.perf_counter()
        losses, stamps, peak = lm_train_run(cfg, tcfg, steps, dtype, device)
        wall = time.perf_counter() - t0
        rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        first, last = losses[1], losses[steps]
        if not all(math.isfinite(v) for v in losses.values()) or \
                not last < first:
            raise AssertionError(f"training {name}: losses {losses}")
        out[name] = {"losses": losses, "steps_per_s": rate,
                     "tokens_per_s": rate * tokens, "peak_bytes": peak,
                     "first_step_s": stamps[0] - t0, "wall_s": wall}
        log(f"smollm-135m training, {name} compute, fp32 masters, B="
            f"{TRAIN_B}, S={TRAIN_S}, remat full: loss {first!r} -> "
            f"{last!r} over {steps} steps; {rate!r} steps/s, "
            f"{rate * tokens!r} tokens/s after the first step "
            f"({stamps[0] - t0!r} s to it); device peak {peak} bytes")
        if name == "bf16":
            uninterrupted = losses
        if device.type == "cuda":
            torch.cuda.empty_cache()
    # the same bf16 run, committed at TRAIN_SPLIT, resumed in a second call
    ckpt_dir = os.path.join(tmp, "lm_ckpt")
    t0 = time.perf_counter()
    lm_train_run(cfg, tcfg, TRAIN_SPLIT, torch.bfloat16, device,
                 ckpt_dir=ckpt_dir)
    saved = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed, _, _ = lm_train_run(cfg, tcfg, TRAIN_STEPS, torch.bfloat16,
                                 device, seed=1, ckpt_dir=ckpt_dir)
    want = {k: v for k, v in uninterrupted.items() if k > TRAIN_SPLIT}
    if resumed != want:
        raise AssertionError(f"resume: losses {resumed}, the uninterrupted "
                             f"run's {want}")
    out["resume"] = {"losses": resumed, "to_commit_s": saved,
                     "resumed_s": time.perf_counter() - t0}
    log(f"checkpoint at step {TRAIN_SPLIT} ({saved!r} s with the commit), "
        f"resumed from other weights to step {TRAIN_STEPS}: losses "
        f"{resumed} equal the uninterrupted run's bit for bit")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"LM training phase: {out['phase_s']!r} s")
    return out


def check_training_lm_small(device):
    """A 2-layer smollm-135m-width model (vocab 49,152) on the card against
    the plain path on the CPU, fp32, TF32 off, from the same weights and
    batch: the loss within LOSS_RTOL relative, every parameter's gradient
    within GRAD_RTOL of its largest entry on the CPU (and the step's
    grad_norm within GRAD_RTOL relative), the parameters after one AdamW
    step within PARAM_TOL. The gradients are held on their own: Adam's
    first step moves a parameter by about lr·sign(g), whatever g's size,
    so the parameters alone would not show a gradient off by a factor. At
    TrainConfig's default learning rate a gradient at rounding level whose
    sign differs between the devices moves a parameter by up to 2·lr (a
    float32 and a float64 step on the CPU differ by 2.4e-5 there, by 8e-5
    at lr 1e-3)."""
    import copy
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import FastTokenStream
    from repro_torch.models import lm
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import init_opt_state
    cfg = dataclasses.replace(get_arch("smollm-135m"), n_layers=2)
    tcfg = TrainConfig(warmup_steps=1, total_steps=4, remat_policy="full")
    card = lm.init_params(cfg, device=device, seed=3)
    cpu = copy.deepcopy(card).to("cpu")
    batch = FastTokenStream(cfg.vocab, 128, 2, seed=5).batch_at(0)
    got, norms, grads = {}, {}, {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = model.embed.tokens.device
        on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = list(model.parameters())
        loss, _ = lm.loss_fn(model, on_dev, cfg, dtype=torch.float32,
                             remat_policy=tcfg.remat_policy)
        grads[name] = [torch.zeros(p.shape) if g is None else g.cpu()
                       for p, g in zip(params, torch.autograd.grad(
                           loss, params, allow_unused=True))]
        opt = init_opt_state(params)
        _, m = make_train_step(cfg, tcfg, dtype=torch.float32)(
            model, opt, on_dev)
        got[name], norms[name] = m["loss"].item(), m["grad_norm"].item()
    rel = abs(got["card"] - got["cpu"]) / abs(got["cpu"])
    norm_rel = abs(norms["card"] - norms["cpu"]) / abs(norms["cpu"])
    grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(grads["card"], grads["cpu"]))
    err = max((a.cpu() - b).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    log(f"LM training step, 2-layer smollm-135m width, {device.type} vs "
        f"plain on cpu: loss {got['card']!r} vs {got['cpu']!r} (relative "
        f"{rel!r}), gradients worst leaf {grad_rel!r} of its largest entry, "
        f"grad_norm {norms['card']!r} vs {norms['cpu']!r} (relative "
        f"{norm_rel!r}), parameters after one AdamW step max abs diff "
        f"{err!r}")
    if (rel > LOSS_RTOL or grad_rel > GRAD_RTOL or norm_rel > GRAD_RTOL
            or err > PARAM_TOL):
        raise AssertionError("LM training: device and plain path disagree")
    return {"loss_rel": rel, "grad_rel": grad_rel, "grad_norm_rel": norm_rel,
            "param_err": err}


def check_serving_small(device):
    """smollm-135m width with 2 layers and a 512-token vocabulary, the same
    weights on both sides: prefill logits and caches on the card within
    SMALL_TOL of the plain path on the CPU, and 8 greedy tokens equal."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_arch("smollm-135m"), n_layers=2, vocab=512)
    cpu = torch.device("cpu")
    on_cpu = lm.init_params(cfg, device=cpu, seed=3)
    on_card = copy.deepcopy(on_cpu).to(device)
    prompts = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 300)))
    (lg, cg), (lc, cc) = [
        lm.prefill_step(p, {"tokens": prompts.to(d)}, cfg, dtype=torch.float32)
        for p, d in ((on_card, device), (on_cpu, cpu))]
    pairs = [(lg, lc)] + [(cg[0]["0_dense"][n], cc[0]["0_dense"][n])
                          for n in ("k", "v")]
    err = max((a.cpu() - b).abs().max().item() for a, b in pairs)
    ok = all(torch.allclose(a.cpu(), b, rtol=SMALL_TOL, atol=SMALL_TOL)
             for a, b in pairs)
    log(f"prefill 2-layer smollm width B=2 S=300 on {device.type} vs plain "
        f"on cpu: logits and caches max abs diff {err!r}, within "
        f"{SMALL_TOL} (rtol = atol): {ok}")
    if not ok:
        raise AssertionError("serving: device and plain path disagree")
    toks = [serve_batch(cfg, p, prompts, 8, cache_size=308)[0]
            for p in (on_card, on_cpu)]
    if not np.array_equal(*toks):
        raise AssertionError(f"greedy tokens differ: {toks}")
    log("8 greedy tokens on the card equal the plain path's on the cpu")


# ---------------------------------------------------------------------------
# the MoE families' serving path
# ---------------------------------------------------------------------------

# dbrx-132b and deepseek-v2-236b at their published widths, cut to 2 layers
# (one dbrx layer is 3.26 B parameters, 13 GB at fp32: the published 132 B
# does not fit one card; deepseek's 2 are its dense first layer and one
# mla_moe layer): (B, prompt tokens) each, 32 greedy tokens
MOE_SERVE = {"dbrx-132b": (4, 1024), "deepseek-v2-236b": (2, 1024)}
MOE_LAYERS, MOE_NEW, MOE_ABSORB_STEPS, MOE_INT8_STEPS = 2, 32, 8, 4
MOE_SMALL = (2, 600)    # card vs CPU at reduced(): 1,200 tokens, a tail of 176
# one apply_moe at deepseek-v2's published MoE width against a plain
# token-by-token version on the CPU: (B, S), two groups of 512, a tail of 76
MOE_DISPATCH = (2, 550)
MOE_MARGIN = 1e-5       # a top-k boundary closer than this may route apart
# the shapes of the two prefills' attention (B, Hq, Hkv, Sq, Skv, d)
FA_DBRX = (4, 48, 8, 1024, 1024, 128)
FA_DEEPSEEK = (2, 128, 128, 1024, 1024, 192)


def moe_config(arch):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), n_layers=MOE_LAYERS)


def prefill_breakdown(params, cfg, prompts, device, dtype):
    """Profile one prefill in ``dtype``: the device's busy time, and the
    parts of it in the flash-attention kernel, in the MoE's expert
    products (its ``moe.experts`` span), and in its routing, dispatch and
    combine (``moe.route`` + ``moe.combine``); seconds."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    spans = ("moe.route", "moe.experts", "moe.combine")
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, _ = lm.prefill_step(params, {"tokens": prompts}, cfg,
                                    dtype=dtype)
        sync(device)
    events = prof.events()
    # the device's kernels; a span's own device-side marker is no kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in spans]
    part = {name: sum(e.device_time_total for e in events
                      if e.name == name
                      and e.device_type == torch.autograd.DeviceType.CPU)
            / 1e6 for name in spans}
    busy = sum(e.device_time_total for e in kernels) / 1e6
    fa = sum(e.device_time_total for e in kernels
             if "fa_kernel" in e.name or "fa_wgmma_kernel" in e.name) / 1e6
    out = {"device_busy_s": busy, "flash_attention_s": fa,
           "experts_s": part["moe.experts"],
           "dispatch_combine_s": part["moe.route"] + part["moe.combine"]}
    out["rest_s"] = busy - fa - out["experts_s"] - out["dispatch_combine_s"]
    out["prefill_kernel_share"] = fa / busy if busy > 0 else float("nan")
    return logits, out


def timed_decode(params, cfg, cache, tok, pos, steps, dtype, device):
    """``steps`` decode steps from ``pos``; host seconds a step (the
    device synchronised at both ends) and the last logits."""
    from repro_torch.models import lm
    sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = lm.decode_step(params, cache, tok, pos + i, cfg,
                                       dtype=dtype)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync(device)
    return (time.perf_counter() - t0) / steps, logits


def blocks_of(cfg):
    from repro_torch.models import blocks
    return " + ".join(f"{n} x {'/'.join(kinds)}"
                      for kinds, n in blocks.segments_for(cfg))


def expert_bytes(params):
    return sum(t.numel() * t.element_size()
               for name, t in params.named_parameters()
               if ".moe.w" in name)


def serve_moe(arch, device):
    """Serve one MoE family (``moe_config``): a warm-up, then
    ``serve_batch`` at fp32 and at bf16 (tokens in range, one
    flash-attention launch a prefill layer and none in decode), each with a
    profiled prefill; deepseek-v2 also decodes MOE_ABSORB_STEPS tokens with
    the absorbed MLA (equal to the expanded fp32 decode's) and
    MOE_INT8_STEPS steps with int8 experts. Returns (kernel launches of the
    serve_batch runs, numbers)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import merge_caches, serve_batch
    from repro_torch.models import lm
    cfg = moe_config(arch)
    b, s = MOE_SERVE[arch]
    t0 = time.perf_counter()
    params = lm.init_params(cfg, device=device, seed=0)
    sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    out = {"layers": cfg.n_layers, "batch": b, "prompt": s, "new": MOE_NEW,
           "parameters": n_params, "init_s": time.perf_counter() - t0}
    log(f"{arch}: {cfg.n_layers} layers ({blocks_of(cfg)}), d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, vocab "
        f"{cfg.vocab}: {n_params} parameters ({n_params * 4 / 1e9:.2f} GB "
        f"fp32) seeded on {device.type} in {out['init_s']:.2f} s")
    g = torch.Generator(device=device)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=g, device=device)
    cache_size = s + MOE_NEW
    expect = cfg.n_layers
    serve_batch(cfg, params, prompts[:1, :64], 2, cache_size=65)   # warm-up
    launches = 0
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        torch.cuda.reset_peak_memory_stats(device)
        flash_attention.launches = 0
        gen, stats = serve_batch(cfg, params, prompts, MOE_NEW, cache_size,
                                 dtype=dtype)
        n = flash_attention.launches
        peak = torch.cuda.max_memory_allocated(device)
        if (gen.shape != (b, MOE_NEW) or gen.min() < 0
                or gen.max() >= cfg.vocab or n != expect):
            raise AssertionError(f"{arch} serve_batch {name}: tokens "
                                 f"{gen.shape}, {n} flash_attention "
                                 f"launches (expected {expect})")
        launches += n
        flash_attention.launches = 0
        logits, parts = prefill_breakdown(params, cfg, prompts, device, dtype)
        if (flash_attention.launches != expect
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} prefill {name}: wrong launch "
                                 f"count or non-finite logits")
        decode_ms = stats["decode_s"] / (MOE_NEW - 1) * 1e3
        out[name] = dict(prefill_s=stats["prefill_s"],
                         prefill_tok_per_s=b * s / stats["prefill_s"],
                         decode_ms_per_step=decode_ms,
                         decode_tok_per_s=stats["tok_per_s"],
                         peak_bytes=peak, flash_attention_launches=n, **parts)
        log(f"{arch} serve_batch B={b} prompt={s} new={MOE_NEW} {name}: "
            f"prefill {stats['prefill_s']!r} s ({b * s / stats['prefill_s']!r}"
            f" tok/s), decode {decode_ms!r} ms a step ({stats['tok_per_s']!r}"
            f" tok/s), device peak {peak} bytes, {n} flash_attention "
            f"launches; profiled prefill: busy {parts['device_busy_s']!r} s, "
            f"experts {parts['experts_s']!r}, dispatch/combine "
            f"{parts['dispatch_combine_s']!r}, flash_attention "
            f"{parts['flash_attention_s']!r} "
            f"(prefill_kernel_share {parts['prefill_kernel_share']!r}), rest "
            f"{parts['rest_s']!r}")
        if name == "fp32":
            fp32_tokens = gen
        del logits
    if cfg.family == "mla_moe":
        absorbed = copy.copy(cfg)
        object.__setattr__(absorbed, "mla_absorb", True)
        gen, _ = serve_batch(absorbed, params, prompts, MOE_ABSORB_STEPS,
                             s + MOE_ABSORB_STEPS)
        if not np.array_equal(gen, fp32_tokens[:, :MOE_ABSORB_STEPS]):
            raise AssertionError(f"absorbed MLA decode: tokens {gen}, the "
                                 f"expanded decode's "
                                 f"{fp32_tokens[:, :MOE_ABSORB_STEPS]}")
        log(f"{arch}: {MOE_ABSORB_STEPS} greedy tokens with the absorbed MLA "
            f"decode (fp32) equal the expanded decode's")
        # bf16 decode steps with the experts as they are, then int8
        logits, pc = lm.prefill_step(params, {"tokens": prompts}, cfg)
        cache = merge_caches(lm.init_cache(cfg, b, cache_size, torch.bfloat16,
                                           device), pc)
        del pc
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        bf16_bytes = expert_bytes(params) // 2
        bf16_s, _ = timed_decode(params, cfg, cache, tok, s, MOE_INT8_STEPS,
                                 torch.bfloat16, device)
        lm.quantize_experts(params)
        int8_bytes = expert_bytes(params)
        int8_s, logits = timed_decode(params, cfg, cache, tok, s,
                                      MOE_INT8_STEPS, torch.bfloat16, device)
        if not torch.isfinite(logits).all():
            raise AssertionError("int8 experts: non-finite logits")
        out["int8"] = {"expert_bytes": int8_bytes,
                       "bf16_expert_bytes": bf16_bytes,
                       "decode_ms_per_step": int8_s * 1e3,
                       "bf16_decode_ms_per_step": bf16_s * 1e3}
        log(f"{arch}: int8 experts {int8_bytes} bytes (scales included) "
            f"against {bf16_bytes} at bf16 ({int8_bytes / bf16_bytes!r}); "
            f"bf16 decode {int8_s * 1e3!r} ms a step with int8 experts, "
            f"{bf16_s * 1e3!r} with fp32 experts cast to bf16 "
            f"({MOE_INT8_STEPS} steps each)")
        del cache, logits
    del params
    torch.cuda.empty_cache()
    return launches, out


def check_moe_small(device):
    """Each MoE family at reduced(), B, S = MOE_SMALL (1,200 tokens: two
    groups of 512 and a tail of 176), the same weights on the card and on
    the CPU, fp32, TF32 off: prefill logits within SMALL_TOL (rtol = atol)
    and 8 greedy tokens equal; one training step's loss within LOSS_RTOL
    relative, aux within 1e-5 and every gradient within GRAD_RTOL of its
    leaf's largest entry on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    cpu = torch.device("cpu")
    b, s = MOE_SMALL
    out = {}
    for arch in MOE_SERVE:
        cfg = get_arch(arch, reduced=True)
        on_cpu = lm.init_params(cfg, device=cpu, seed=3)
        on_card = copy.deepcopy(on_cpu).to(device)
        rng = np.random.default_rng(3)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
        logits = [lm.prefill_step(p, {"tokens": prompts.to(d)}, cfg,
                                  dtype=torch.float32)[0].cpu()
                  for p, d in ((on_card, device), (on_cpu, cpu))]
        err = (logits[0] - logits[1]).abs().max().item()
        ok = torch.allclose(*logits, rtol=SMALL_TOL, atol=SMALL_TOL)
        toks = [serve_batch(cfg, p, prompts, 8, cache_size=s + 8)[0]
                for p in (on_card, on_cpu)]
        seqs = rng.integers(0, cfg.vocab, (b, s + 1))
        batch = {"tokens": torch.from_numpy(seqs[:, :-1]),
                 "labels": torch.from_numpy(seqs[:, 1:])}
        got = {}
        for name, model in (("card", on_card), ("cpu", on_cpu)):
            dev = model.embed.tokens.device
            params = list(model.parameters())
            loss, m = lm.loss_fn(model, {k: v.to(dev)
                                         for k, v in batch.items()}, cfg,
                                 dtype=torch.float32)
            grads = torch.autograd.grad(loss, params)
            got[name] = (loss.item(), m["aux"].item(),
                         [g.cpu() for g in grads])
        (l_card, a_card, g_card), (l_cpu, a_cpu, g_cpu) = (got["card"],
                                                          got["cpu"])
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        aux_err = abs(a_card - a_cpu)
        grad_rel = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                       .item() for a, c in zip(g_card, g_cpu))
        out[arch] = {"logits_err": err, "loss_rel": rel, "aux_err": aux_err,
                     "grad_rel": grad_rel}
        log(f"{arch} reduced() B={b} S={s} on {device.type} vs plain on cpu: "
            f"prefill logits max abs diff {err!r} (within {SMALL_TOL}: {ok}), "
            f"8 greedy tokens equal: {np.array_equal(*toks)}; training step "
            f"loss {l_card!r} vs {l_cpu!r} (relative {rel!r}), aux {a_card!r}"
            f" vs {a_cpu!r}, gradients worst leaf {grad_rel!r} of its largest"
            f" entry")
        if (not ok or not np.array_equal(*toks) or rel > LOSS_RTOL
                or aux_err > 1e-5 or grad_rel > GRAD_RTOL):
            raise AssertionError(f"{arch}: the card and the plain path "
                                 f"disagree")
    return out


def plain_moe(x, router, wi, wg, wo, top_k, g_size):
    """The swiglu MoE with no slot dropped, token by token: each token of a
    whole group of ``g_size`` sums its top-k experts' outputs weighted by
    its top-k probabilities renormalised; the tokens past the last whole
    group pass through. ``wi`` / ``wg`` / ``wo`` are callables giving an
    expert's weights on x's device. Returns (y, aux, each grouped token's
    margin: its k-th less its (k+1)-th probability)."""
    t, _ = x.shape
    n = t // g_size * g_size
    e_count = router.shape[1]
    probs = torch.softmax((x[:n] @ router).float(), dim=-1)
    top, idx = torch.topk(probs, top_k + 1, dim=-1)
    gates = top[:, :top_k] / top[:, :top_k].sum(-1, keepdim=True)
    y = x.clone()
    y[:n] = 0
    for e in range(e_count):
        tok, slot = torch.nonzero(idx[:, :top_k] == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = torch.nn.functional.silu(xe @ wg(e)) * (xe @ wi(e))
        y.index_add_(0, tok, gates[tok, slot, None] * (h @ wo(e)))
    top1 = torch.nn.functional.one_hot(idx[:, 0], e_count).float()
    frac = (top1.reshape(-1, g_size, e_count).sum(1) / g_size).mean(0)
    aux = (frac * probs.mean(0)).sum() * e_count
    return y, aux, top[:, top_k - 1] - top[:, top_k]


def check_moe_dispatch(device):
    """One ``apply_moe`` at deepseek-v2's published MoE width (160 experts,
    top-6, D = 5,120, d_ff 1,536) and prefill's no-drop capacity, fp32,
    on B, S = MOE_DISPATCH tokens (two groups of 512 and a tail), held
    against ``plain_moe`` on the CPU with the same weights: y within
    SMALL_TOL (rtol = atol) at every token but those whose top-k boundary
    is within MOE_MARGIN (the two devices may route them apart; counted),
    aux within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.models.blocks import no_drop_capacity
    from repro_torch.models.moe import apply_moe, init_moe
    cfg = get_arch("deepseek-v2-236b")
    b, s = MOE_DISPATCH
    g = torch.Generator(device=device)
    g.manual_seed(5)
    p = init_moe(g, cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.act,
                 device=device)
    x = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        y, aux = apply_moe(p, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           act=cfg.act,
                           capacity_factor=no_drop_capacity(cfg))
    sync(device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, want_aux, margin = plain_moe(
        x.reshape(b * s, -1).cpu(), p.router.detach().cpu(),
        lambda e: p.wi[e].detach().cpu(), lambda e: p.wg[e].detach().cpu(),
        lambda e: p.wo[e].detach().cpu(), cfg.top_k, 512)
    plain_s = time.perf_counter() - t0
    got = y.reshape(b * s, -1).cpu()
    held = torch.ones(b * s, dtype=torch.bool)
    held[:margin.shape[0]] = margin >= MOE_MARGIN
    err = (got[held] - want[held]).abs().max().item()
    ok = torch.allclose(got[held], want[held], rtol=SMALL_TOL,
                        atol=SMALL_TOL)
    aux_err = abs(aux.item() - want_aux.item())
    log(f"apply_moe at deepseek-v2's published width (E={cfg.n_experts}, "
        f"top-{cfg.top_k}, D={cfg.d_model}, d_ff {cfg.d_ff_expert}), "
        f"{b * s} tokens, no-drop capacity, fp32: card {card_s!r} s vs a "
        f"plain token-by-token version on the cpu ({plain_s!r} s): y max abs"
        f" diff {err!r} over {int(held.sum())} tokens ({int((~held).sum())} "
        f"with a top-k margin under {MOE_MARGIN} left out; within "
        f"{SMALL_TOL}: {ok}), aux {aux.item()!r} vs {want_aux.item()!r}")
    if not ok or aux_err > 1e-5 or (~held).sum() > 8:
        raise AssertionError("apply_moe at published width disagrees with "
                             "the plain version")
    del p, x, y
    torch.cuda.empty_cache()
    return {"y_err": err, "aux_err": aux_err, "left_out": int((~held).sum()),
            "card_s": card_s, "plain_s": plain_s}


def drive_moe_serving(device):
    """The MoE serving phase: both families at published width
    (``serve_moe``), one ``apply_moe`` at deepseek-v2's published MoE width
    against a plain version (``check_moe_dispatch``), then card against CPU
    at reduced() (``check_moe_small``). Returns (flash_attention launches of the
    serve_batch runs, numbers)."""
    t0 = time.perf_counter()
    launches, out = 0, {}
    for arch in MOE_SERVE:
        n, out[arch] = serve_moe(arch, device)
        launches += n
    out["dispatch_published"] = check_moe_dispatch(device)
    out["card_vs_cpu"] = check_moe_small(device)
    out["phase_s"] = time.perf_counter() - t0
    log(f"MoE serving phase: {out['phase_s']!r} s")
    return launches, out


# ---------------------------------------------------------------------------
# the recurrent and encoder families
# ---------------------------------------------------------------------------

# each family at its published widths, the depth cut to fit the phase:
# (layers, B, prompt tokens); llava prepends its 576 patch embeddings,
# whisper's decoder attends to 1,500 frames (its 30 s window)
FAMILY_SERVE = {
    "xlstm-1.3b": (8, 4, 2048),          # one group: 7 mLSTM + 1 sLSTM
    "recurrentgemma-9b": (5, 2, 2048),   # (rec, rec, attn) + (rec, rec)
    "llava-next-34b": (2, 2, 1024),      # + 576 patches
    "whisper-tiny": (4, 8, 64),          # full depth, 4 + 4; 1,500 frames
}
FAMILY_NEW = 16                          # decode steps after the prefill
WHISPER_FRAMES = 1500
FAMILY_SMALL = (2, 40)                   # card vs CPU at reduced(): B, S
# flash_attention at the families' prefill shapes (B, Hq, Hkv, Sq, Skv, d)
FA_FAMILIES = {
    "recurrentgemma-9b attn (MQA 16:1)": ((2, 16, 1, 2048, 2048, 256), True),
    "llava-next-34b (GQA 7:1)": ((2, 56, 8, 1600, 1600, 128), True),
    "whisper-tiny encoder": ((8, 6, 6, 1500, 1500, 64), False),
    "whisper-tiny cross": ((8, 6, 6, 64, 1500, 64), False),
}
_SPANS = ("recurrent.scan", "recurrent.conv")
_PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def family_config(arch):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch),
                               n_layers=FAMILY_SERVE[arch][0])


def family_batch(cfg, b, s, device, seed=1, frames=WHISPER_FRAMES):
    """A seeded prompt on ``device``: tokens, and llava's stub patch
    embeddings or whisper's ``frames`` stub frames (N(0, 1), as the
    launchers draw them)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device=device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                       generator=g, device=device)
    if cfg.family == "audio_encdec":
        batch["frames"] = torch.randn((b, frames, cfg.d_model), generator=g,
                                      device=device)
    return batch


def flash_launches_per_prefill(cfg):
    """flash_attention launches of one prefill: one per attention layer
    (recurrentgemma's attn, llava's dense layers), whisper's encoder
    layers, decoder self- and cross-attention; none for xLSTM."""
    from repro_torch.models import blocks
    if cfg.family == "audio_encdec":
        return 3 * cfg.n_layers
    return sum(n * sum(k in ("attn", "dense") for k in kinds)
               for kinds, n in blocks.segments_for(cfg))


def prefill_decode(params, cfg, batch, new, dtype, device):
    """What ``serve_batch`` does, for any family: ``lm.prefill_step``, the
    caches merged into decode caches of prompt + new positions (whisper:
    one cross slot a frame), the argmax token, then ``new`` greedy decode
    steps. Returns (tokens [B, new + 1], prefill seconds, decode seconds a
    step, the prefill's flash_attention launches, the decode's)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import merge_caches
    from repro_torch.models import lm
    b = batch["tokens"].shape[0]
    s = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm"
                                    else 0)
    kw = ({"enc_len": batch["frames"].shape[1]}
          if cfg.family == "audio_encdec" else {})
    flash_attention.launches = 0
    sync(device)
    t0 = time.perf_counter()
    logits, pc = lm.prefill_step(params, batch, cfg, dtype=dtype)
    cache = merge_caches(lm.init_cache(cfg, b, s + new, dtype, device, **kw),
                         pc)
    del pc
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    out = [tok]
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(new):
        logits, cache = lm.decode_step(params, cache, tok, s + i, cfg,
                                       dtype=dtype)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    sync(device)
    decode_s = (time.perf_counter() - t0) / max(new, 1)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    return (torch.cat(out, dim=1).cpu().numpy(), prefill_s, decode_s,
            prefill_launches, flash_attention.launches)


def _under(event, names):
    parent = event.cpu_parent
    while parent is not None:
        if parent.name in names:
            return True
        parent = parent.cpu_parent
    return False


def family_breakdown(params, cfg, batch, device, dtype):
    """Profile one prefill: the device's busy seconds split into the scans
    (the ``recurrent.scan`` span: the associative scans and the mLSTM's
    chunk loop), the temporal conv (``recurrent.conv``), the projections
    (matrix products outside those spans: every projection, the MLPs, the
    head), ``flash_attention`` and the rest (norms, gates, casts, the
    embedding, elementwise work)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, _ = lm.prefill_step(params, batch, cfg, dtype=dtype)
        sync(device)
    events = prof.events()
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in _SPANS]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    fa = sum(e.device_time_total for e in kernels
             if "fa_kernel" in e.name or "fa_wgmma_kernel" in e.name) / 1e6
    spans = {name: sum(e.device_time_total for e in cpu if e.name == name
                       and not _under(e, _SPANS)) / 1e6 for name in _SPANS}
    products = sum(e.device_time_total for e in cpu if e.name in _PRODUCTS
                   and not _under(e, _SPANS + _PRODUCTS)) / 1e6
    out = {"device_busy_s": busy, "scans_s": spans["recurrent.scan"],
           "conv_s": spans["recurrent.conv"], "projections_s": products,
           "flash_attention_s": fa}
    out["rest_s"] = busy - sum(v for k, v in out.items()
                               if k != "device_busy_s")
    return logits, out


def serve_family(arch, device):
    """One family at published width (``family_config``): a short warm-up
    in each dtype, then at fp32 and at bf16 ``prefill_decode`` (FAMILY_NEW greedy steps;
    the prefill's flash_attention launches as ``flash_launches_per_prefill``
    says, none in decode; tokens in range) with the device peak, and a
    profiled prefill (``family_breakdown``). xLSTM and recurrentgemma (their
    prompt is tokens alone) are also served through ``serve_batch``, whose
    fp32 tokens must equal ``prefill_decode``'s. Returns (kernel launches
    of the timed runs, numbers)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    cfg = family_config(arch)
    _, b, s = FAMILY_SERVE[arch]
    t0 = time.perf_counter()
    params = lm.init_params(cfg, device=device, seed=0)
    sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    out = {"layers": cfg.n_layers, "batch": b, "prompt": s,
           "new": FAMILY_NEW, "parameters": n_params,
           "init_s": time.perf_counter() - t0}
    log(f"{arch}: {cfg.n_layers} layers ({blocks_of(cfg)}), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters "
        f"({n_params * 4 / 1e9:.2f} GB fp32) seeded on {device.type} in "
        f"{out['init_s']:.2f} s")
    batch = family_batch(cfg, b, s, device)
    if "frames" in batch:
        out["frames"] = batch["frames"].shape[1]
    expect = flash_launches_per_prefill(cfg)
    # a warm-up in each dtype (cuBLAS picks its bf16 paths at first use)
    warm = {k: v[:1, :64] if k == "tokens" else v[:1]
            for k, v in batch.items()}
    for dtype in (torch.float32, torch.bfloat16):
        prefill_decode(params, cfg, warm, 2, dtype, device)
    launches = 0
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        torch.cuda.reset_peak_memory_stats(device)
        toks, prefill_s, decode_s, n_pre, n_dec = prefill_decode(
            params, cfg, batch, FAMILY_NEW, dtype, device)
        peak = torch.cuda.max_memory_allocated(device)
        if (toks.shape != (b, FAMILY_NEW + 1) or toks.min() < 0
                or toks.max() >= cfg.vocab or n_pre != expect or n_dec):
            raise AssertionError(f"{arch} {name}: tokens {toks.shape}, "
                                 f"{n_pre} prefill and {n_dec} decode "
                                 f"flash_attention launches (expected "
                                 f"{expect} and 0)")
        launches += n_pre
        flash_attention.launches = 0
        logits, parts = family_breakdown(params, cfg, batch, device, dtype)
        if (flash_attention.launches != expect
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} profiled prefill {name}: wrong "
                                 f"launch count or non-finite logits")
        tokens = b * batch["tokens"].shape[1]
        out[name] = dict(prefill_s=prefill_s,
                         prefill_tok_per_s=tokens / prefill_s,
                         decode_ms_per_step=decode_s * 1e3,
                         decode_tok_per_s=b / decode_s, peak_bytes=peak,
                         flash_attention_launches=n_pre, **parts)
        log(f"{arch} B={b} prompt={s} new={FAMILY_NEW} {name}: prefill "
            f"{prefill_s!r} s ({tokens / prefill_s!r} tok/s), decode "
            f"{decode_s * 1e3!r} ms a step ({b / decode_s!r} tok/s), device "
            f"peak {peak} bytes, {n_pre} flash_attention launches a prefill "
            f"and {n_dec} in decode; profiled prefill: busy "
            f"{parts['device_busy_s']!r} s, scans {parts['scans_s']!r}, conv "
            f"{parts['conv_s']!r}, projections {parts['projections_s']!r}, "
            f"flash_attention {parts['flash_attention_s']!r}, rest "
            f"{parts['rest_s']!r}")
        if name == "fp32":
            fp32_tokens = toks
        del logits
    if cfg.family in ("ssm", "hybrid"):
        gen, stats = serve_batch(cfg, params, batch["tokens"], FAMILY_NEW + 1,
                                 s + FAMILY_NEW)
        if not np.array_equal(gen, fp32_tokens):
            raise AssertionError(f"{arch}: serve_batch's tokens differ from "
                                 f"prefill_decode's")
        out["serve_batch"] = stats
        log(f"{arch}: serve_batch (fp32) gives the same {FAMILY_NEW + 1} "
            f"tokens; prefill {stats['prefill_s']!r} s, "
            f"{stats['tok_per_s']!r} tok/s decode")
    del params, batch
    torch.cuda.empty_cache()
    return launches, out


def check_families_small(device):
    """Each family at reduced(), B, S = FAMILY_SMALL (llava: its 8 patches
    first; whisper: 24 frames), the same weights on the card and on the
    CPU, fp32, TF32 off: prefill logits and 4 decode steps' logits within
    SMALL_TOL of the largest |logit|; a training step's loss within
    LOSS_RTOL relative and every gradient within GRAD_RTOL of its leaf's
    largest entry on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cpu = torch.device("cpu")
    b, s = FAMILY_SMALL
    out = {}
    for arch in FAMILY_SERVE:
        cfg = get_arch(arch, reduced=True)
        on_cpu = lm.init_params(cfg, device=cpu, seed=3)
        on_card = copy.deepcopy(on_cpu).to(device)
        batch = family_batch(cfg, b, s + 1, cpu, seed=3, frames=24)
        prompt = {k: v[:, :s] if k == "tokens" else v
                  for k, v in batch.items()}
        runs = {}
        for name, model, dev in (("card", on_card, device),
                                 ("cpu", on_cpu, cpu)):
            pb = {k: v.to(dev) for k, v in prompt.items()}
            logits = lm.prefill_step(model, pb, cfg,
                                     dtype=torch.float32)[0].cpu()
            toks, *_ = prefill_decode(model, cfg, pb, 4, torch.float32, dev)
            lb = {k: v.to(dev) for k, v in batch.items()}
            lb["labels"] = lb["tokens"][:, 1:]
            lb["tokens"] = lb["tokens"][:, :-1]
            loss, _ = lm.loss_fn(model, lb, cfg, dtype=torch.float32)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            runs[name] = (logits, toks, loss.item(), [g.cpu() for g in grads])
        (lc, tc, l_card, gc), (lp, tp, l_cpu, gp) = runs["card"], runs["cpu"]
        err = ((lc - lp).abs().max() / lp.abs().max()).item()
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        grad_rel = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                       .item() for a, c in zip(gc, gp))
        same = bool(np.array_equal(tc, tp))
        out[arch] = {"logits_rel": err, "loss_rel": rel, "grad_rel": grad_rel,
                     "tokens_equal": same}
        log(f"{arch} reduced() B={b} S={s} on {device.type} vs plain on cpu: "
            f"prefill logits max abs diff {err!r} of the largest |logit|, "
            f"4 greedy decode tokens equal: {same}; training step loss "
            f"{l_card!r} vs {l_cpu!r} (relative {rel!r}), gradients worst "
            f"leaf {grad_rel!r} of its largest entry")
        if (err > SMALL_TOL or not same or rel > LOSS_RTOL
                or grad_rel > GRAD_RTOL):
            raise AssertionError(f"{arch}: the card and the plain path "
                                 f"disagree")
    return out


def time_family_shapes(device):
    """flash_attention at the families' prefill shapes (FA_FAMILIES), fp32
    and bf16: kernel, plain version, ``scaled_dot_product_attention`` and
    the bound."""
    out = {}
    for label, (shape, causal) in FA_FAMILIES.items():
        for dtype in FA_TOL:
            ft = time_flash(device, shape, dtype, causal)
            out.setdefault(label, {})[str(dtype)[6:]] = ft
            log(f"flash_attention at the {label} shape {shape} causal="
                f"{causal} {str(dtype)[6:]}: kernel {ft['ms']!r} ms, plain "
                f"{ft['plain_ms']!r} ms, scaled_dot_product_attention "
                f"{ft['library_ms']!r} ms (kernel / that "
                f"{ft['ms'] / ft['library_ms']!r}), bound {ft['bound_ms']!r} "
                f"ms ({ft['bound_by']}: {ft['ops']} operations, "
                f"{ft['bytes']} bytes)")
    return out


def drive_recurrent_encdec_serving(device):
    """The recurrent and encoder families' serving phase: each at published
    width (``serve_family``), flash_attention timed at their shapes
    (``time_family_shapes``), then card against CPU at reduced()
    (``check_families_small``). Returns (flash_attention launches of the
    timed prefills, numbers)."""
    t0 = time.perf_counter()
    launches, out = 0, {}
    for arch in FAMILY_SERVE:
        n, out[arch] = serve_family(arch, device)
        launches += n
    out["flash_attention_shapes"] = time_family_shapes(device)
    out["card_vs_cpu"] = check_families_small(device)
    out["phase_s"] = time.perf_counter() - t0
    log(f"recurrent / encoder serving phase: {out['phase_s']!r} s")
    return launches, out


def flash_cases():
    """(name, (B, Hq, Hkv, Sq, Skv, d), causal): where flash_attention is
    held to its plain version, fp32 and bf16."""
    cases = [("serving", FA_SERVE, True),
             ("ragged", (1, 9, 3, 1000, 1000, 64), True),
             ("Sq = Skv = 300", (2, 9, 3, 300, 300, 64), True),
             ("G = 1", (1, 4, 4, 257, 257, 64), True),
             ("non-causal Sq = 190, Skv = 333",
              (1, 4, 2, 190, 333, 128), False),
             ("one token", (2, 9, 3, 1, 1, 64), True),
             ("non-causal Skv > Sq", (1, 8, 1, 128, 256, 64), False)]
    cases += [(f"d={d}", (1, 4, 2, 200, 200, d), True)
              for d in (16, 32, 128, 160, 256)]
    cases.append(("d=256 non-causal", (1, 4, 1, 70, 130, 256), False))
    cases += [("dbrx-132b prefill (GQA 6:1)", FA_DBRX, True),
              ("deepseek-v2-236b MLA prefill", FA_DEEPSEEK, True),
              ("d=192 ragged", (2, 16, 16, 300, 300, 192), True)]
    cases += [(label, shape, causal)
              for label, (shape, causal) in FA_FAMILIES.items()]
    # one query over long keys: the fp32 plan's 8 key splits (whisper-tiny
    # cross, 4 splits, is among FA_FAMILIES above)
    cases.append(("one query, 1,500 keys, d=192", (2, 4, 4, 1, 1500, 192),
                  False))
    return cases


def flash_phase(device):
    """flash_attention against its plain version at every case, then timed
    at smollm-135m's serving shape and the two MoE prefills' shapes in fp32
    and bf16. Returns (worst abs difference per dtype, timings per dtype at
    the serving shape, timings at the MoE shapes by model and dtype)."""
    worst = check_flash(device, flash_cases())
    timing, moe_timing = {}, {}
    for label, shape in (("serving", FA_SERVE), ("dbrx-132b", FA_DBRX),
                         ("deepseek-v2-236b", FA_DEEPSEEK)):
        for dtype in FA_TOL:
            ft = time_flash(device, shape, dtype)
            if label == "serving":
                timing[dtype] = ft
            else:
                moe_timing.setdefault(label, {})[str(dtype)[6:]] = ft
            log(f"flash_attention at the {label} shape {shape} "
                f"{str(dtype)[6:]}: kernel {ft['ms']!r} ms, plain "
                f"{ft['plain_ms']!r} ms, scaled_dot_product_attention "
                f"{ft['library_ms']!r} ms (kernel / that "
                f"{ft['ms'] / ft['library_ms']!r}), bound {ft['bound_ms']!r} "
                f"ms ({ft['bound_by']}: {ft['ops']} operations, "
                f"{ft['bytes']} bytes)")
    return worst, timing, moe_timing


# ---------------------------------------------------------------------------
# the LM scale-out plane
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
                ("smollm-135m", "decode_32k"), ("caloforest", "photons"))
# the card's sharded prefills: 8 prompts of 2,048 tokens
SCALE_B, SCALE_S = 8, 2048
_CHILDREN = []


def start_dryrun(out_dir, fake_device="cuda", cells=DRYRUN_CELLS):
    """Phase 13 (a)'s dry-run cells, one process each, niced and on one
    thread: they trace on the CPU while the card's phases run."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    procs = []
    for arch, shape in cells:
        log_path = os.path.join(out_dir, f"{arch}_{shape}.log")
        with open(log_path, "w") as fh:
            procs.append((arch, shape, log_path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "single", "--fake-device",
                 fake_device, "--out", out_dir], env=env, stdout=fh,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))))
    _CHILDREN.extend(p for *_, p in procs)
    return procs, time.perf_counter()


def stop_children() -> None:
    """Ends every process this script started and left running."""
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_dryrun(procs, t_start, out_dir):
    """Waits for phase 13 (a)'s cells; each must be ``ok``. Returns their
    records' numbers."""
    out = {}
    for arch, shape, log_path, p in procs:
        rc = p.wait(timeout=600)
        with open(log_path) as fh:
            tail = fh.read()[-3000:]
        path = os.path.join(out_dir, f"{arch}_{shape}_single.json")
        if rc != 0 or not os.path.exists(path):
            raise AssertionError(f"dry run {arch} x {shape}: exit {rc}\n{tail}")
        with open(path) as fh:
            rec = json.load(fh)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} x {shape}: {rec['status']} "
                                 f"{rec.get('error')}")
        mem, roof = rec["memory_analysis"], rec["roofline"]
        out[f"{arch} {shape}"] = cell = {
            "trace_s": rec["compile_s"], "chips": rec["chips"],
            "peak_bytes_per_rank": mem["peak_bytes_per_device"],
            "analytic_bytes_per_rank": mem.get("analytic_per_chip_bytes"),
            "collectives": rec["collective_inventory"],
            "traced_flops": rec["cost_analysis_raw"]["flops"],
            "analytic_flops": rec["analytic"]["total_flops"],
            "roofline": roof}
        log(f"dry run {arch} x {shape} x {rec['mesh']} ({rec['chips']} fake "
            f"ranks): ok in {rec['compile_s']!r} s; per-rank peak "
            f"{mem['peak_bytes_per_device']} bytes (analytic "
            f"{cell['analytic_bytes_per_rank']}); collectives "
            f"{rec['collective_inventory']}; traced FLOPs "
            f"{cell['traced_flops']!r} (analytic {cell['analytic_flops']!r});"
            f" roofline dominant {roof['dominant']}, mfu_bound "
            f"{roof['mfu_bound']!r}")
    out["wall_s"] = time.perf_counter() - t_start
    return out


def drive_scaleout_plane(device, tmp, dry, bf16_step_s):
    """Phase 13 (b) and (c); (a)'s cells are collected first. Returns the
    numbers and the sharded prefills' flash_attention launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis import flops as fl
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import FastTokenStream
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import jax_leaves, params_to_jax
    from repro_torch.sharding import rules
    from repro_torch.sharding.dtensor import Layout, load_sharded
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import adamw_update, init_opt_state

    t_phase = time.perf_counter()
    out = {"dryrun": finish_dryrun(*dry)}
    cfg = get_arch("smollm-135m")
    base = lm.init_params(cfg, device=device, seed=0)
    ckpt_dir = os.path.join(tmp, "scale_ckpt")
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, 0, params_to_jax(base))
    out["save_s"] = time.perf_counter() - t0
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device)
        dp, tp = rules.axes_for_mesh(False)
        model = lm.init_params(cfg, device="meta")
        t0 = time.perf_counter()
        tree, _ = ckpt.restore(ckpt_dir, params_to_jax(base))
        host = dict(zip([n for n, _ in model.named_parameters()],
                        jax_leaves(model, tree)))
        specs = rules.param_specs(model, cfg, dp, tp, 1, 1)
        load_sharded(model, ckpt.reshard(host, mesh, specs), Layout(mesh, dp))
        sync(device)
        out["restore_reshard_s"] = time.perf_counter() - t0
        for (name, p), q in zip(model.named_parameters(), base.parameters()):
            if not torch.equal(p.to_local(), q):
                raise AssertionError(f"resharded {name} != the saved weights")
        gen = torch.Generator(device=device).manual_seed(3)
        prompts = torch.randint(0, cfg.vocab, (SCALE_B, SCALE_S),
                                generator=gen, device=device,
                                dtype=torch.int32)
        launches = 0
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            want, _ = lm.prefill_step(base, {"tokens": prompts}, cfg,
                                      dtype=dtype)
            lm.prefill_step(model, {"tokens": prompts}, cfg, dtype=dtype)
            sync(device)
            t0 = time.perf_counter()
            want, _ = lm.prefill_step(base, {"tokens": prompts}, cfg,
                                      dtype=dtype)
            sync(device)
            plain_s = time.perf_counter() - t0
            flash_attention.launches = 0
            t0 = time.perf_counter()
            got, _ = lm.prefill_step(model, {"tokens": prompts}, cfg,
                                     dtype=dtype)
            sync(device)
            shard_s = time.perf_counter() - t0
            n = flash_attention.launches
            launches += n
            if device.type == "cuda" and n != cfg.n_layers:
                raise AssertionError(f"sharded {name} prefill: {n} "
                                     f"flash_attention launches, expected "
                                     f"{cfg.n_layers}")
            got = got.full_tensor()
            err = ((got - want).abs().max() / want.abs().max()).item()
            if not err <= 1e-6:
                raise AssertionError(f"sharded {name} prefill: logits "
                                     f"{err!r} of the largest from the "
                                     "unsharded prefill's")
            out[name] = {"prefill_s": shard_s, "unsharded_prefill_s": plain_s,
                         "logits_err": err, "flash_launches": n}
            log(f"sharded smollm-135m prefill {name}, B={SCALE_B}, "
                f"S={SCALE_S} on the 1x1 mesh: {shard_s!r} s (unsharded "
                f"{plain_s!r} s), {n} flash_attention launches, logits "
                f"{err!r} of the largest from the unsharded prefill's")
            del want, got
            torch.cuda.empty_cache()

        # one training step, sharded and unsharded, from the same weights
        stream = FastTokenStream(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in stream.batch_at(0).items()}
        tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                           total_steps=2, remat_policy="full")

        def step(m):
            params = list(m.parameters())
            opt = init_opt_state(params)
            t0 = time.perf_counter()
            loss, _ = lm.loss_fn(m, batch, cfg, dtype=torch.bfloat16,
                                 remat_policy="full")
            with implicit_replication():
                grads = torch.autograd.grad(loss, params)
                new, _, _ = adamw_update(grads, opt, params, tcfg)
            sync(device)
            return loss.detach(), new, time.perf_counter() - t0

        want_loss, want_new, plain_s = step(base)
        got_loss, got_new, shard_s = step(model)
        got_loss = got_loss.full_tensor()
        if not torch.equal(got_loss, want_loss):
            raise AssertionError(f"sharded training step: loss "
                                 f"{got_loss.item()!r}, unsharded "
                                 f"{want_loss.item()!r}")
        step_err = max(((a.full_tensor() - b).abs().max()
                        / b.abs().max().clamp(min=1e-30)).item()
                       for a, b in zip(got_new, want_new))
        out["train_step"] = {"loss": want_loss.item(), "step_s": shard_s,
                             "unsharded_step_s": plain_s,
                             "params_err": step_err}
        log(f"sharded training step (bf16, remat full, AdamW): loss "
            f"{got_loss.item()!r} equal to the unsharded step's; {shard_s!r} "
            f"s (unsharded {plain_s!r} s, both the first of their run); "
            f"updated weights within {step_err!r} of each leaf's largest")
        del base, model, got_new, want_new
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (c) the model-FLOPs share of phase 10b's measured bf16 step
    cost = fl.cell_cost(cfg, ShapeConfig("train_8x2048", TRAIN_S, TRAIN_B,
                                         "train"), chips=1, dp_size=1,
                        tp_size=1)
    mfu = cost.model_flops / (bf16_step_s * fl.PEAK_FLOPS)
    out["mfu"] = {"model_flops": cost.model_flops, "step_s": bf16_step_s,
                  "share": mfu, "card": card_line()}
    log(f"smollm-135m training, bf16, B={TRAIN_B}, S={TRAIN_S}: model FLOPs "
        f"{cost.model_flops!r} a step in {bf16_step_s!r} s = {mfu!r} of "
        f"989e12 FLOP/s ({out['mfu']['card']})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"scale-out plane phase: {out['phase_s']!r} s (the dry-run cells "
        f"took {out['dryrun']['wall_s']!r} s from their start)")
    return launches, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        return _main()
    finally:
        stop_children()


def _main() -> int:
    from repro_torch.config import ForestConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.tree_predict.ops import forest_predict
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)
    dry_dir = tempfile.mkdtemp(prefix="dryrun_")
    dry = start_dryrun(dry_dir) + (dry_dir,)

    t0 = time.perf_counter()
    built = build.build(["tree_predict", "hist", "flash_attention"])
    for name in built:
        build.load(name)
    log(f"kernel build (all three in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    fp32_spills = []
    for name, (_, build_log) in built.items():
        for fn, lines in ptxas_lines(build_log).items():
            log(f"  {name} {fn}: {'; '.join(lines)}")
            if name == "flash_attention" and "fa_kernel" in fn \
                    and spills(lines):
                fp32_spills.append(fn)
    if fp32_spills:
        raise AssertionError(f"fp32 flash_attention instances spill: "
                             f"{fp32_spills}")
    log(f"fp32 flash_attention resident on a SM: {fp32_residency()}")
    sass = check_tensor_cores(built["flash_attention"][0])
    log(f"flash_attention bf16 instances on the tensor cores, loading by "
        f"TMA: (HGMMA, UTMALDG) instructions per d {sass}")

    # -- kernels against their plain versions -------------------------------
    m = N_ROWS // N_Y
    worst = check_kernel(device, tree_predict_cases())
    tp_timing = {}
    for label, shape in TREE_TIMED:
        tp_timing[label] = tt = time_kernel(device, shape)
        log(f"tree_predict at {label} {shape}: kernel {tt['ms']!r} ms, plain "
            f"{tt['plain_ms']!r} ms, bound {tt['bound_ms']!r} ms "
            f"({tt['bound_by']}: {tt['bytes']} bytes at 3.35 TB/s, "
            f"{tt['ops']} operations at 67 TFLOP/s)")
    timing = tp_timing["MO full width"]
    log("tree_predict has no library yardstick: no single PyTorch call "
        "traverses trees")

    exact, full = hist_cases()
    hist_worst = check_hist(device, exact, full)
    mo6 = full[1][1]
    hist_timing = {}
    for key, (label, shape) in zip(
            ("level0", "level6", "so_level6", "level6_int8", "level6_256"),
            full + [("MO level 6, int8 codes", mo6[:6] + (torch.int8,)),
                    ("MO level 6, 256 bins (two windows)",
                     mo6[:5] + (256, torch.int32))]):
        ht = time_hist(device, shape)
        hist_timing[key] = ht
        log(f"hist at {label} full width: kernel {ht['ms']!r} ms, "
            f"plain {ht['plain_ms']!r} ms, bound {ht['bound_ms']!r} ms "
            f"({ht['bound_by']}: {ht['bytes']} bytes at 3.35 TB/s, "
            f"{ht['ops']} adds at 67 TFLOP/s)")
    log("hist has no library yardstick: no single PyTorch call builds the "
        "histograms of all features without an [n*p, out] copy of g "
        "(87 GB at full width)")
    hist_worst = max(hist_worst, check_hist_batches(device,
                                                    hist_batch_cases()))
    for key, E, (label, shape) in (("mo_level6", 3, full[1]),
                                   ("so_level6", 2, full[2])):
        n, p, out, lanes, nn, nb, dt = shape
        hb = time_hist_batch(device, E, (n, p, out, lanes, nn, nb, dt))
        hist_timing[f"batch_{key}"] = hb
        log(f"hist {label} for a batch of {E} ensembles: one launch "
            f"{hb['ms']!r} ms against {E} launches of one {hb['singles_ms']!r}"
            f" ms ({hb['single_ms']!r} ms each); bound {hb['bound_ms']!r} ms "
            f"({hb['bound_by']}: {hb['bytes']} bytes, {hb['ops']} adds), "
            f"{hb['single_bound_ms']!r} ms each alone")

    fa_worst, fa_timing, fa_moe_timing = flash_phase(device)

    # -- the generation path -----------------------------------------------
    cfg = ForestConfig(method="flow", n_t=N_T, duplicate_k=K_DUP,
                       n_trees=N_TREES, max_depth=DEPTH, learning_rate=1.5,
                       n_bins=N_BINS, reg_lambda=1.0, multi_output=True)
    flow = random_artifacts(cfg, N_Y, P, m, seed=0, device=device)
    log(f"artifacts: leaf {tuple(flow.leaf.shape)}, "
        f"{flow.leaf.numel() * 4 / 1e9:.2f} GB on the device")
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    counts = drive_main_path(flow, N_ROWS, 1000, 1024)
    del flow
    torch.cuda.empty_cache()

    # -- the forest serving plane -------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        fs_tp, fs_hist, forest_serving = drive_forest_serving(device, tmp)
    release_pinned()
    torch.cuda.empty_cache()

    # -- sharded sampling and sharded serving --------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        sh_tp, sharded = drive_sharded(device, tmp)
    torch.cuda.empty_cache()

    # -- the training path -------------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as ckpt_root:
        hist_launches = drive_training(device, ckpt_root)
    torch.cuda.empty_cache()

    # -- the out-of-core sharded training path ------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        scale_launches, scaleout = drive_scaleout(device, tmp)
    hist_launches += scale_launches
    torch.cuda.empty_cache()

    # -- the LM serving path -----------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    fa_launches, serving = drive_serving(device)
    torch.cuda.empty_cache()

    # -- the MoE families' serving path ---------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    moe_launches, moe_serving = drive_moe_serving(device)
    fa_launches += moe_launches
    torch.cuda.empty_cache()

    # -- the recurrent and encoder families' serving path --------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    family_launches, family_serving = drive_recurrent_encdec_serving(device)
    fa_launches += family_launches
    torch.cuda.empty_cache()

    # -- the LM training path -------------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        lm_training = drive_lm_training(device, tmp)
    launched = (forest_predict.launches, histogram.launches,
                flash_attention.launches)
    if any(launched):
        raise AssertionError(f"LM training launched {launched} kernels: its "
                             "attention is mea_attention, not the kernel")
    log("LM training phase: no kernel of the three launched (tree_predict, "
        "hist, flash_attention: 0, 0, 0)")
    torch.cuda.empty_cache()

    # -- the comparison plane ------------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        comparison, sub_hist = drive_comparison(device, tmp)
    cmp_tp, cmp_hist = forest_predict.launches, histogram.launches
    if cmp_tp == 0 or cmp_hist == 0:
        raise AssertionError(f"comparison phase: {cmp_tp} tree_predict and "
                             f"{cmp_hist} hist launches in this process")
    comparison.update(tree_predict_launches=cmp_tp, hist_launches=cmp_hist,
                      subprocess_hist_launches=sub_hist)
    log(f"comparison phase: {cmp_tp} tree_predict and {cmp_hist} hist "
        f"launches here, {sub_hist} hist launches in the resource arms' "
        "subprocesses")
    torch.cuda.empty_cache()

    # -- the LM scale-out plane -----------------------------------------------
    forest_predict.launches = histogram.launches = flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        scale_launches_fa, scaleout_plane = drive_scaleout_plane(
            device, tmp, dry, 1.0 / lm_training["bf16"]["steps_per_s"])
    launched = (forest_predict.launches, histogram.launches)
    if any(launched):
        raise AssertionError(f"scale-out plane: tree_predict and hist "
                             f"launched {launched}")
    fa_launches += scale_launches_fa
    shutil.rmtree(dry[2], ignore_errors=True)
    torch.cuda.empty_cache()

    check_small(device)
    check_training_small(device)
    check_serving_small(device)
    lm_training["card_vs_cpu"] = check_training_lm_small(device)

    log(card)     # again here, where a run's tail shows it beside the numbers
    ht = hist_timing["level6"]
    kernels = [{
        "name": "tree_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
        "replaces": "src/repro/kernels/tree_predict/tree_kernel.py:54",
        "launches": sum(counts.values()) + fs_tp + sh_tp + cmp_tp,
        "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "hist", "route": "cuda",
        "source": "src/repro_torch/kernels/hist/csrc/hist.cu",
        "replaces": "src/repro/kernels/hist/hist_kernel.py:52",
        "launches": hist_launches + fs_hist + cmp_hist + sub_hist,
        "max_abs_err": hist_worst,
        "ms": ht["ms"], "plain_ms": ht["plain_ms"],
        "bound_ms": ht["bound_ms"], "bound_by": ht["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/fa_kernel.py:69",
        "launches": fa_launches,
        "max_abs_err": fa_worst[torch.float32],
        **{key: fa_timing[torch.float32][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")}}]
    print(json.dumps({"kernels": kernels, "launches_per_call": counts,
                      "tree_predict": tp_timing,
                      "hist_level0": hist_timing["level0"],
                      "hist_so_level6": hist_timing["so_level6"],
                      "hist_level6_int8": hist_timing["level6_int8"],
                      "hist_level6_256": hist_timing["level6_256"],
                      "hist_batch": {k: hist_timing[f"batch_{k}"]
                                     for k in ("mo_level6", "so_level6")},
                      "scaleout": dict(scaleout,
                                       hist_launches=scale_launches),
                      "flash_attention_bf16": dict(
                          fa_timing[torch.bfloat16],
                          max_abs_err=fa_worst[torch.bfloat16],
                          sdpa_ratio=(fa_timing[torch.bfloat16]["ms"]
                                      / fa_timing[torch.bfloat16][
                                          "library_ms"]),
                          source="src/repro_torch/kernels/flash_attention/"
                                 "csrc/flash_attention_bf16.cuh",
                          sass=sass),
                      "flash_attention_moe_shapes": fa_moe_timing,
                      "serving": serving,
                      "moe_serving": moe_serving,
                      "family_serving": family_serving,
                      "lm_training": lm_training,
                      "forest_serving": dict(
                          forest_serving, tree_predict_launches=fs_tp,
                          hist_launches=fs_hist),
                      "sharded": dict(sharded, tree_predict_launches=sh_tp),
                      "comparison": comparison,
                      "scaleout_plane": scaleout_plane}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
