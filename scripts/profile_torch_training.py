#!/usr/bin/env python3
"""Where the time of one group fit of the PyTorch port goes, on a GPU.

    python3 scripts/profile_torch_training.py [--out DIR] [--trees N]
        [--group E]

At the width of ``chip_smoke.py``'s training phase (CaloForest photons:
p=368, duplicate_k=20 over 8,000 rows of one class, so 160,000 rows;
max_depth=7, n_bins=64), for one MO group and one SO group (368 lanes an
ensemble), each of the ensembles that ``fit_artifacts`` trains as one loop
(``fitting.ensemble_groups``: 3 MO, 1 SO at this width; ``--group E``
sets E for both):

* times the group's set-up on the device (class block repeated, bridge,
  edges, codes, for each ensemble) and its boosting
  (``boosting.fit_ensembles``) on the host clock, with a
  ``torch.cuda.synchronize()`` after each, and splits the boosting
  rounds' time into ``build_histogram`` (the ``hist`` kernel and its row
  ordering), ``best_splits`` (plain PyTorch) and the rest (routing, leaf
  values, predictions, validation loss), by wrapping the two functions
  with synchronising timers; seconds an ensemble are the group's over E;
* traces one boosting round with ``torch.profiler`` and reports the
  device's busy share and the kernels with the most device time.

``--trees`` (default 20, the photons model's) sets the rounds of the timed
fit. Needs one CUDA device; exits non-zero without one. With ``--out DIR``
the profiler tables and the summary are written there too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Timers:
    """Synchronising wall-clock timers around named functions."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            return out
        return timed


def class_block():
    """One class of calorimeter showers as ``prepare_classes`` lays it out
    (host arrays; made once, outside every timed region)."""
    import chip_smoke as cs
    from repro_torch.tabgen.fitting import prepare_classes
    X, y = cs.calo_photons(np.full(cs.CLASS_ROWS, 6), seed=1)
    Xc, Wc = prepare_classes(X, y)[:2]
    return Xc[0], Wc[0]


def ensemble_inputs(cfg, block, seed=0):
    """One (timestep, class) ensemble's inputs, built on the device as
    ``fit_artifacts`` builds them: the class block repeated K times, the
    bridge, the edges and the codes."""
    from repro_torch.forest.binning import edges_with_sentinel, transform
    from repro_torch.core import interpolants as itp
    from repro_torch.tabgen.fitting import weighted_edges
    dev = torch.device("cuda")
    x0 = torch.from_numpy(block[0]).to(dev).repeat_interleave(
        cfg.duplicate_k, 0)
    w = torch.from_numpy(block[1]).to(dev).repeat_interleave(cfg.duplicate_k)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.tensor(0.5, device=dev)
    _, xt, tgt = itp.sample_bridge(x0, cfg.method, t, generator=gen)
    _, xtv, tgtv = itp.sample_bridge(x0, cfg.method, t, generator=gen)
    edges = weighted_edges(xt, w, cfg.n_bins)
    return (transform(xt, edges), tgt, w, edges_with_sentinel(edges),
            transform(xtv, edges), tgtv, w)


def group_inputs(cfg, block, E):
    """E ensembles' inputs (each from its own seed), stacked as
    ``boosting.fit_ensembles`` takes them."""
    parts = [ensemble_inputs(cfg, block, seed=e) for e in range(E)]
    return [torch.stack(a) for a in zip(*parts)]


def profile_ensemble(cfg, block, E):
    """Host-clock split of one group fit of E ensembles."""
    from repro_torch.forest import boosting, tree
    timers = Timers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = group_inputs(cfg, block, E)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    saved = tree.build_histogram, tree.best_splits
    tree.build_histogram = timers.wrap("build_histogram", tree.build_histogram)
    tree.best_splits = timers.wrap("best_splits", tree.best_splits)
    try:
        t0 = time.perf_counter()
        res = boosting.fit_ensembles(*args, cfg)
        torch.cuda.synchronize()
        boost = time.perf_counter() - t0
    finally:
        tree.build_histogram, tree.best_splits = saved
    rounds = int(res.rounds_run.max())
    split = dict(timers.seconds)
    split["rest"] = boost - sum(split.values())
    return dict(ensembles=E, setup_s=setup, boosting_s=boost,
                group_s=setup + boost, ensemble_s=(setup + boost) / E,
                rounds=rounds, per_tree_s=boost / rounds,
                peak_bytes=torch.cuda.max_memory_allocated(),
                boosting_split_s=split,
                boosting_share={k: v / boost for k, v in split.items()})


def trace_round(cfg, block, E):
    """Profile one boosting round of a group: busy share and top kernels."""
    from repro_torch.forest import boosting
    from torch.profiler import ProfilerActivity, profile
    args = group_inputs(cfg, block, E)
    one = dataclasses.replace(cfg, n_trees=1)
    boosting.fit_ensembles(*args, one)              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        boosting.fit_ensembles(*args, one)
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
                                      row_limit=30)
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                busy_share=busy_us / 1e6 / wall, n_kernels=len(kernels),
                top_kernels_s={k: v / 1e6 for k, v in top}), table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    ap.add_argument("--trees", type=int, default=20)
    ap.add_argument("--group", type=int, default=0,
                    help="ensembles a group (default: fit_artifacts's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke as cs
    from repro_torch.forest.boosting import lanes_per_ensemble
    from repro_torch.kernels import build
    from repro_torch.tabgen.fitting import ensemble_groups

    build.build(["hist"])                           # outside the timings
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(cs.card_line(), flush=True)
    result = {}
    block = class_block()
    for label, mo in (("MO", True), ("SO", False)):
        cfg = cs.photons_config(n_t=1, multi_output=mo)
        cfg = dataclasses.replace(cfg, n_trees=args.trees)
        E = args.group or ensemble_groups(
            8, lanes_per_ensemble(cfg, cs.P), cs.P, cfg.n_bins,
            cs.P if mo else 1, cfg.max_depth)[0][1]
        ensemble_inputs(cfg, block)                 # warm-up
        torch.cuda.reset_peak_memory_stats()
        summary = profile_ensemble(cfg, block, E)
        summary["one_round"], table = trace_round(cfg, block, E)
        result[label] = summary
        print(label, json.dumps(summary), flush=True)
        if args.out:
            with open(os.path.join(args.out, f"round_{label}.txt"), "w") as f:
                f.write(table)
        torch.cuda.empty_cache()
    if args.out:
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
