#!/usr/bin/env python3
"""Where the time of the PyTorch port's LM serving goes, on a GPU.

    python3 scripts/profile_torch_serving.py [--out DIR]

Builds smollm-135m at its full width (random seeded weights, fp32, as
``chip_smoke.py`` does) on the device and, for 8 prompts of 2,048 tokens:

* runs ``serve_batch`` (64 new tokens) three times and keeps the fastest
  prefill and decode;
* traces one prefill and 8 decode steps with ``torch.profiler``: wall time,
  the device's busy share (device time of all kernels / wall time), kernel
  launches per step and the kernels with the most device time.

Needs one CUDA device; exits non-zero without one. With ``--out DIR`` the
full profiler tables and the summary are written there too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_STEPS = 8


def trace(fn):
    """Profile ``fn()``: wall seconds, device-busy seconds, kernel count,
    the top kernels by device time and the profiler's table."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                busy_share=busy_us / 1e6 / wall, n_kernels=len(kernels),
                top_kernels_s={k[:80]: v / 1e6 for k, v in top}), table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import merge_caches, serve_batch
    from repro_torch.models import lm

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    device = torch.device("cuda")
    cfg = get_arch("smollm-135m")
    params = lm.init_params(cfg, device=device, seed=0)
    g = torch.Generator(device=device)
    g.manual_seed(1)
    b, s, new = cs.SERVE_B, cs.SERVE_S, cs.SERVE_NEW
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=g, device=device)
    size = s + new
    serve_batch(cfg, params, prompts[:1, :64], 2, cache_size=65)   # warm-up
    runs = [serve_batch(cfg, params, prompts, new, size)[1] for _ in range(3)]
    result = {"serve_batch": {
        "prefill_s": min(r["prefill_s"] for r in runs),
        "decode_s": min(r["decode_s"] for r in runs),
        "decode_tok_per_s": max(r["tok_per_s"] for r in runs)}}
    print("serve_batch", json.dumps(result["serve_batch"]), flush=True)

    state = {}

    def prefill():
        state["logits"], pc = lm.prefill_step(params, {"tokens": prompts},
                                              cfg, dtype=torch.float32)
        state["cache"] = merge_caches(
            lm.init_cache(cfg, b, size, torch.float32, device), pc)

    def decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        for i in range(DECODE_STEPS):
            state["logits"], state["cache"] = lm.decode_step(
                params, state["cache"], tok, s + i, cfg, dtype=torch.float32)
            tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]

    tables = {}
    result["prefill"], tables["prefill"] = trace(prefill)
    result["decode"], tables["decode"] = trace(decode)
    result["decode"]["steps"] = DECODE_STEPS
    result["decode"]["kernels_per_step"] = (result["decode"]["n_kernels"]
                                            / DECODE_STEPS)
    for key in ("prefill", "decode"):
        print(key, json.dumps(result[key]), flush=True)
    if args.out:
        for key, table in tables.items():
            with open(os.path.join(args.out, f"{key}.txt"), "w") as f:
                f.write(table)
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
