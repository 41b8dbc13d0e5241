#!/usr/bin/env python3
"""Where a training step of smollm-135m goes in the PyTorch port, on a GPU.

    python3 scripts/profile_torch_lm_training.py [--out DIR] [--steps N]

At ``chip_smoke.py``'s training shape (smollm-135m at its published width
and depth, B=8 sequences of 2,048 tokens, remat "full", fp32 masters,
seeded weights, ``FastTokenStream`` batches), for bf16 and fp32 compute:

* times ``--steps`` training steps after two warm-up steps (host clock):
  the step of ``repro_torch.train.loop.make_train_step``, split by a
  synchronise into its forward + backward (``loss_fn`` and
  ``torch.autograd.grad``) and its AdamW update;
* traces one step with ``torch.profiler``: the device's busy share of the
  step, its kernel launches, and the device time by kind (matrix
  products, the rest) and by kernel;
* times the training attention alone, ``mea_attention`` forward and
  backward at one layer's shape, and ``scaled_dot_product_attention`` on
  the same inputs as a yardstick.

Needs one CUDA device (TF32 off, as in ``chip_smoke.py``); exits non-zero
without one. With ``--out DIR`` the summary and the profiler tables are
written there too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATMUL = ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")


def attention_ms(cfg, b, s, dtype, reps=5):
    """(mea_attention forward + backward, SDPA forward + backward) ms at
    one layer's shape, causal."""
    from repro_torch.models.attention import mea_attention
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs():
        return [torch.randn((b, h, s, cfg.d_head), generator=g,
                            device="cuda", dtype=dtype).requires_grad_()
                for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]

    def mea(q, k, v):
        return mea_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        rep = cfg.n_heads // cfg.n_kv_heads
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            is_causal=True)

    out = []
    for fn in (mea, sdpa):
        q, k, v = inputs()
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(q, k, v)
            torch.autograd.grad(y.float().sum(), (q, k, v))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out.append(sorted(times[1:])[reps // 2])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_lm_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import FastTokenStream
    from repro_torch.models import lm
    from repro_torch.train.optim import adamw_update, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    cfg = get_arch("smollm-135m")
    b, s = cs.TRAIN_B, cs.TRAIN_S
    tcfg = TrainConfig(learning_rate=cs.TRAIN_LR, warmup_steps=1,
                       total_steps=100, remat_policy="full")
    stream = FastTokenStream(cfg.vocab, s, b, seed=0)
    summary = {"card": card, "batch": b, "seq": s, "remat": "full"}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        params = lm.init_params(cfg, device="cuda", seed=0)
        plist = list(params.parameters())
        opt = init_opt_state(plist)

        def step(i, timed=None):
            nonlocal opt
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in stream.batch_at(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = lm.loss_fn(params, batch, cfg, dtype=dtype,
                                 remat_policy="full")
            grads = torch.autograd.grad(loss, plist)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            new, opt, _ = adamw_update(grads, opt, plist, tcfg)
            with torch.no_grad():
                for p, q in zip(plist, new):
                    p.copy_(q)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if timed is not None:
                timed.append((t1 - t0, t2 - t1))
            return loss.item()

        for i in range(2):
            step(i)
        timed = []
        for i in range(2, 2 + args.steps):
            step(i, timed)
        fwd_bwd = sorted(x[0] for x in timed)[len(timed) // 2]
        update = sorted(x[1] for x in timed)[len(timed) // 2]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            step(2 + args.steps)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kernels) / 1e6
        mm = sum(e.device_time_total for e in kernels
                 if any(m in e.name.lower() for m in MATMUL)) / 1e6
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        mea_ms, sdpa_ms = attention_ms(cfg, b, s, dtype)
        summary[name] = {
            "fwd_bwd_s": fwd_bwd, "adamw_s": update,
            "step_s": fwd_bwd + update,
            "tokens_per_s": b * s / (fwd_bwd + update),
            "profiled_step_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall, "kernel_launches": len(kernels),
            "matmul_s": mm, "other_s": busy - mm,
            "attention_layer_fwd_bwd_ms": mea_ms,
            "sdpa_layer_fwd_bwd_ms": sdpa_ms,
            "top_kernels_s": [(k[:90], v / 1e6) for k, v in top]}
        print(f"{name}: forward + backward {fwd_bwd!r} s, AdamW "
              f"{update!r} s a step ({b * s / (fwd_bwd + update)!r} "
              f"tokens/s); profiled step {wall!r} s, device busy {busy!r} s "
              f"({busy / wall!r}), {len(kernels)} kernel launches, matrix "
              f"products {mm!r} s, the rest {busy - mm!r} s; mea_attention "
              f"forward + backward {mea_ms!r} ms a layer (x{cfg.n_layers} "
              f"layers, x2 with remat), SDPA {sdpa_ms!r} ms", flush=True)
        for k, v in top:
            print(f"  {v / 1e6!r} s  {k[:110]}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"lm_{name}_table.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="cuda_time_total", row_limit=60))
        del params, opt, plist
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    if args.out:
        with open(os.path.join(args.out, "lm_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
