#!/usr/bin/env python3
"""Where the time of one generate call of the PyTorch port goes, on a GPU.

    python3 scripts/profile_torch_generation.py [--out DIR]

Builds the CaloForest photons model of ``chip_smoke.py`` (random seeded
weights, full width) on the device and, for euler at n=1,000 (bucket 1024)
and at n=120,000:

* times each phase of ``sample`` (labels, x1 noise, the solve, unscale,
  copy to the host, unpad and shuffle) on the host clock with a
  ``torch.cuda.synchronize()`` after each;
* traces one whole call with ``torch.profiler`` and reports the device's
  busy share (device time of all kernels / wall time) and the kernels with
  the most device time.

Needs one CUDA device; exits non-zero without one. With ``--out DIR`` the
full profiler tables and the summary are written there too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phases(art, n, pad_to, seed=3):
    """Host-clock seconds of each phase of one euler sample call."""
    from repro_torch.core import interpolants as itp
    from repro_torch.forest.packed import PackedForest
    from repro_torch.tabgen import get_sampler
    from repro_torch.tabgen import sampling as S
    from repro_torch.tabgen.artifacts import unscale
    fcfg = art.config
    out = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    label_idx = S.sample_labels(art.counts, n, rng, fcfg.label_sampler)
    per_class = np.bincount(label_idx, minlength=art.n_y)
    m = pad_to or int(per_class.max())
    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff, device=art.device)
    t = mark("labels", t)
    x1 = S.row_noise(seed, art.n_y, m, art.p, art.device)
    t = mark("x1 noise", t)
    forests = PackedForest(art.feat, art.thr_val, art.leaf, fcfg.multi_output)
    x0 = get_sampler("euler").fn(x1, forests, depth=fcfg.max_depth,
                                 n_t=fcfg.n_t, ts=ts)
    t = mark("solve", t)
    x_all = unscale(x0, art.mins[:, None, :], art.maxs[:, None, :])
    t = mark("unscale", t)
    x_host = x_all.cpu()
    t = mark("copy to host", t)
    S.SampleHandle(x_host, per_class, np.asarray(art.classes), rng).result()
    mark("unpad and shuffle", t)
    return out


def trace(gen, n, pad_to):
    """Profile one generate call: busy share and top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(n, seed=3, pad_to=pad_to)
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
                top_kernels_s={k: v / 1e6 for k, v in top}), table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_generation: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke as cs
    from repro_torch.config import ForestConfig

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(cs.card_line(), flush=True)
    cfg = ForestConfig(method="flow", n_t=cs.N_T, duplicate_k=20,
                       n_trees=cs.N_TREES, max_depth=cs.DEPTH,
                       learning_rate=1.5, n_bins=64, reg_lambda=1.0,
                       multi_output=True)
    art = cs.random_artifacts(cfg, cs.N_Y, cs.P, cs.N_ROWS // cs.N_Y, seed=0,
                              device=torch.device("cuda"))
    gen = cs.generator_for(art)
    gen.generate(1000, seed=0, pad_to=1024)          # warm-up: build, lazy loads
    result = {}
    for n, pad_to in ((1000, 1024), (cs.N_ROWS, None)):
        key = f"euler n={n}" + (f" pad_to={pad_to}" if pad_to else "")
        ph = [phases(art, n, pad_to) for _ in range(3)]
        summary, table = trace(gen, n, pad_to)
        summary["phases_s"] = {k: min(p[k] for p in ph) for k in ph[0]}
        result[key] = summary
        print(key, json.dumps(summary), flush=True)
        if args.out:
            name = os.path.join(args.out, key.replace(" ", "_") + ".txt")
            with open(name, "w") as f:
                f.write(table)
    if args.out:
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
