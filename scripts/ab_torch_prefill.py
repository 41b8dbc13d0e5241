#!/usr/bin/env python3
"""Prefill time of smollm-135m on one GPU, for one or more source trees.

    python3 scripts/ab_torch_prefill.py SRC [SRC ...] [--rounds N]

Each SRC is a ``src/`` directory holding ``repro_torch`` (this checkout's
``src`` or that of another commit, unpacked with ``git archive``). Each
round runs every tree once, in its own process, in turns that alternate
direction (A B, B A, ...), so two commits are compared on one card. A run
builds the tree's kernels, makes smollm-135m at full width with seeded
random fp32 weights, and times ``prefill_step`` on 8 prompts of 2,048
tokens in bf16 (the entry point's default) and in fp32: one warm call,
then the fastest of five, each ended by a synchronise. Prints one JSON line
per run and a summary with every time. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

B, S = 8, 2048


def run_one(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("smollm-135m")
    params = lm.init_params(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    out = {"src": src}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        lm.prefill_step(params, {"tokens": prompts}, cfg, dtype=dtype)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            flash_attention.launches = 0
            t0 = time.perf_counter()
            lm.prefill_step(params, {"tokens": prompts}, cfg, dtype=dtype)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"s": times, "min_s": min(times),
                     "tok_per_s": B * S / min(times),
                     "flash_attention_launches": flash_attention.launches}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+", help="src/ directories to compare")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.srcs[0])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_torch_prefill: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for rnd in range(args.rounds):
        for src in (args.srcs if rnd % 2 == 0 else args.srcs[::-1]):
            proc = subprocess.run([sys.executable, __file__, "--one", src],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    summary = {src: {dt: [r[dt]["min_s"] for r in runs if r["src"] == src]
                     for dt in ("bf16", "fp32")} for src in args.srcs}
    print(json.dumps({"card": card, "min_s_per_run": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
