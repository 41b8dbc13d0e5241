#!/usr/bin/env python3
"""Does smollm-135m's loss rise at lr 1e-3 on the CPU too, or only on a GPU?

    python3 scripts/check_torch_lm_lr.py [--out DIR] [--lr 1e-3] [--steps 4]

``chip_smoke.py`` trains smollm-135m at its published width and depth (30
layers, seeded weights, ``FastTokenStream``, B=8, S=2,048, remat "full",
fp32 masters, one warm-up step) at lr 1e-4: at 1e-3 its loss rose on the
GPU. This script trains that configuration at ``--lr`` from one set of
seeded weights, made on the CPU and copied to the GPU, on the same batches:

* on the CPU, fp32 (the plain PyTorch path, every core);
* on the GPU, fp32 and bf16 compute (TF32 off);
* on the GPU, ``chip_smoke.py``'s own run: weights seeded on the GPU, bf16.

It prints each run's loss and gradient norm by step and, for the GPU's fp32
run, the largest relative gap to the CPU's loss and gradient norm at any
step. If the CPU's loss rises as the GPU's does, the rise belongs to the
model and learning rate, not to the GPU's path. Needs one CUDA device;
exits non-zero without one. With ``--out DIR`` the summary is written there
too.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 2048          # chip_smoke.py's TRAIN_B, TRAIN_S


def run(cfg, tcfg, params, dtype, steps):
    """``train`` on FastTokenStream batches: ({step: (loss, grad_norm)},
    seconds)."""
    from repro_torch.data.tokens import FastTokenStream
    from repro_torch.train.loop import train
    stream = FastTokenStream(cfg.vocab, S, B, seed=0)
    t0 = time.perf_counter()
    _, _, history = train(cfg, tcfg, stream.batch_at, steps=steps,
                          log_every=1, dtype=dtype, params=params,
                          log_fn=lambda line: print(f"  {line}", flush=True))
    return ({h["step"]: (h["loss"], h["grad_norm"]) for h in history},
            time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = get_arch("smollm-135m")
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=1,
                       total_steps=args.steps, remat_policy="full")
    cpu_weights = lm.init_params(cfg, device="cpu", seed=0)
    runs = {}
    for name, make, dtype in (
            ("gpu fp32, CPU-made weights",
             lambda: copy.deepcopy(cpu_weights).to("cuda"), torch.float32),
            ("gpu bf16, CPU-made weights",
             lambda: copy.deepcopy(cpu_weights).to("cuda"), torch.bfloat16),
            ("gpu bf16, chip_smoke's weights (seeded on the GPU)",
             lambda: lm.init_params(cfg, device="cuda", seed=0),
             torch.bfloat16),
            ("cpu fp32, CPU-made weights",
             lambda: copy.deepcopy(cpu_weights), torch.float32)):
        print(f"{name}, lr {args.lr}:", flush=True)
        by_step, secs = run(cfg, tcfg, make(), dtype, args.steps)
        runs[name] = {"by_step": by_step, "seconds": secs}
        torch.cuda.empty_cache()
    gpu = runs["gpu fp32, CPU-made weights"]["by_step"]
    cpu = runs["cpu fp32, CPU-made weights"]["by_step"]
    gap = {k: max(abs(gpu[s][i] - cpu[s][i]) / abs(cpu[s][i]) for s in cpu)
           for i, k in enumerate(("loss", "grad_norm"))}
    summary = {
        "device": torch.cuda.get_device_name(0), "lr": args.lr,
        "batch": B, "seq": S, "steps": args.steps,
        "runs": {name: {"losses": {s: v[0] for s, v in r["by_step"].items()},
                        "grad_norms": {s: v[1]
                                       for s, v in r["by_step"].items()},
                        "rises": r["by_step"][args.steps][0]
                        > r["by_step"][1][0],
                        "seconds": r["seconds"]}
                 for name, r in runs.items()},
        "gpu_fp32_vs_cpu_rel": gap}
    for name, r in summary["runs"].items():
        print(f"{name}: losses {r['losses']}, grad norms {r['grad_norms']}, "
              f"{'rises' if r['rises'] else 'falls'} ({r['seconds']!r} s)")
    print(f"gpu fp32 vs cpu fp32, largest relative gap at any step: loss "
          f"{gap['loss']!r}, grad_norm {gap['grad_norm']!r}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "lm_lr.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
