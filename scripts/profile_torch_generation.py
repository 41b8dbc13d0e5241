#!/usr/bin/env python3
"""Where the time of a generate call of the PyTorch port goes, on a GPU,
read from the program's own ``sample.*`` spans.

    python3 scripts/profile_torch_generation.py [--out DIR] \
        [--against OTHER/src/repro_torch/tabgen/sampling.py]

Builds the CaloForest photons model of ``chip_smoke.py`` (random seeded
weights, full width) on the device and, for euler at n=1,000 (bucket 1024)
and at n=120,000:

* the host ms of each of the eight spans a call records
  (``tabgen/sampling.py``: ``sample.issue`` over ``sample.x1``,
  ``sample.solve``, ``sample.compact``, ``sample.copy``; ``sample.result``
  over ``sample.result.wait``, ``.copy_out``), the median over warm calls,
  with nothing synchronised between them;
* one ``torch.profiler`` capture of a few calls with
  ``REPRO_OBS_TORCH_TRACE=1``: the device's busy share, its idle time
  split by the innermost program span the host was in at each instant of
  it, and the kernels with the most device time. The spans' device-side
  annotations are kept apart from the device's operations.

Then the spans' own cost: host µs of one span, the mirror off and on
(no capture running), and whole calls at the call shape of the
``photons-generate-4k`` cell (4,000 rows in 1,024-row buckets, closed
loop) in rotating rounds: the spans as they run (the mirror off), with
the mirror on, and, with ``--against``, another tree's ``sampling.py``
(say, a parent's exported with ``git archive``) loaded beside this
tree's package.

Needs one CUDA device; exits non-zero without one. With ``--out DIR`` the
profiler tables and the summary are written there too.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIRROR = "REPRO_OBS_TORCH_TRACE"
CALL_SPANS = ("sample.issue", "sample.x1", "sample.solve", "sample.compact",
              "sample.copy", "sample.result", "sample.result.wait",
              "sample.result.copy_out")


@contextlib.contextmanager
def mirror(on: bool):
    """The program's spans mirrored into ``torch.profiler`` (or not)."""
    saved = os.environ.get(MIRROR)
    os.environ[MIRROR] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ[MIRROR]
        else:
            os.environ[MIRROR] = saved


def span_ms(gen, n, pad_to, calls):
    """Median host ms of each ``sample.*`` span over ``calls`` warm calls,
    one after another, and the median whole call (issue to rows)."""
    from repro_torch.obs import default_tracer
    tracer = default_tracer()
    ids, whole = [], []
    for k in range(calls):
        t0 = time.perf_counter()
        h = gen.generate_async(n, seed=100 + k, pad_to=pad_to)
        h.result()
        whole.append(time.perf_counter() - t0)
        ids.append(h.trace_id)
    by = {name: [] for name in CALL_SPANS}
    for tid in ids:
        for sp in tracer.trace(tid):
            by[sp.name].append(sp.duration_s)
    out = {name: 1e3 * statistics.median(v) for name, v in by.items() if v}
    out["call"] = 1e3 * statistics.median(whole)
    return out


def idle_by_span(busy, lo, hi, ranges):
    """``{span: µs}``: the time of ``[lo, hi]`` outside ``busy`` (sorted,
    disjoint), split by the innermost of the nested ``ranges`` (``(start,
    end, name)``, one thread) that the host was in at each instant."""
    cuts = sorted({lo, hi} | {t for a, b, _ in ranges for t in (a, b)
                              if lo < t < hi})
    inner = []                            # (start, end, innermost span)
    for a, b in zip(cuts, cuts[1:]):
        live = [r for r in ranges if r[0] <= a and b <= r[1]]
        name = (max(live, key=lambda r: (r[0], -r[1]))[2] if live
                else "outside any sample span")
        inner.append((a, b, name))
    out, k = {}, 0
    for a, b, name in inner:
        idle = b - a
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        for s, e in busy[k:]:
            if s >= b:
                break
            idle -= min(e, b) - max(s, a)
        if idle > 0:
            out[name] = out.get(name, 0.0) + idle
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def capture(gen, n, pad_to, calls, top=8):
    """One profiler capture of ``calls`` calls with the mirror on: busy
    share, idle time by innermost program span, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.join(REPO, "portbench"))
    from harness.trace import merge
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with mirror(True), profile(activities=acts) as prof:
        for k in range(calls):
            gen.generate(n, seed=200 + k, pad_to=pad_to)
    ops, ranges = [], []
    for ev in prof.events():
        tr, program = ev.time_range, ev.name.startswith("sample.")
        if ev.device_type == DeviceType.CUDA:
            if not program:                  # annotations are not work
                ops.append((tr.start, tr.end, ev.name))
        elif program:
            ranges.append((tr.start, tr.end, ev.name))
    lo = min(a for a, _, _ in ranges)
    hi = max(b for _, b, _ in ranges)
    busy = merge([(a, b) for a, b, _ in ops], lo, hi)
    busy_us = sum(b - a for a, b in busy)
    by_op = {}
    for a, b, name in ops:
        by_op[name] = by_op.get(name, 0.0) + max(0, min(b, hi) - max(a, lo))
    gaps = {name: 1e-3 * us
            for name, us in idle_by_span(busy, lo, hi, ranges).items()}
    table = prof.key_averages().table(
        sort_by="cuda_time_total" if len(acts) > 1 else "cpu_time_total",
        row_limit=25)
    return dict(
        calls=calls, window_ms=1e-3 * (hi - lo), busy_ms=1e-3 * busy_us,
        busy_share=busy_us / (hi - lo),
        n_kernels=sum(1 for _, _, name in ops
                      if not name.startswith(("Memcpy", "Memset"))),
        idle_gaps_ms=gaps,
        top_ops_ms={k: 1e-3 * v for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]}), table


def load_sampling(path):
    """``path`` (a ``tabgen/sampling.py``) as a module of its own, bound
    to this tree's ``repro_torch``."""
    spec = importlib.util.spec_from_file_location("against_sampling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_us(spans=20000):
    """Host µs of one scoped span of the process tracer, the mirror off
    and on (no capture running), best of three runs of ``spans`` spans,
    eight a trace id as a generate call's."""
    from repro_torch.obs import default_tracer
    tracer, out = default_tracer(), {}
    for on in (False, True):
        best = float("inf")
        with mirror(on):
            for _ in range(3):
                t0 = time.perf_counter()
                for k in range(spans):
                    with tracer.span("cost.span", trace_id=f"cost-{k // 8}",
                                     bytes=0):
                        pass
                best = min(best, (time.perf_counter() - t0) / spans)
        out["mirror on" if on else "mirror off"] = 1e6 * best
    return out


def cost(art, against, n=4000, pad_to=1024, rounds=6, calls=60):
    """Per-call ms of closed-loop calls at one shape, arms in rotation:
    this tree's spans (mirror off, then on) and ``against``'s
    ``sample_async``. Returns each arm's per-round means and the median
    of its calls, and :func:`span_us`."""
    from repro_torch.tabgen import sampling
    arms = {"spans": (sampling, False), "spans+mirror": (sampling, True)}
    if against is not None:
        arms["against"] = (load_sampling(against), False)
    per_round = {a: [] for a in arms}
    every = {a: [] for a in arms}
    sync = torch.cuda.synchronize if art.device.type == "cuda" else \
        (lambda: None)
    for r in range(rounds):
        order = list(arms)[r % len(arms):] + list(arms)[:r % len(arms)]
        for arm in order:
            mod, on = arms[arm]
            with mirror(on):
                mod.sample_async(art, n, seed=r, pad_to=pad_to).result()
                sync()
                times = []
                for k in range(calls):
                    t0 = time.perf_counter()
                    mod.sample_async(art, n, seed=1000 * r + k,
                                     pad_to=pad_to).result()
                    times.append(1e3 * (time.perf_counter() - t0))
            per_round[arm].append(statistics.fmean(times))
            every[arm] += times
    out = {}
    for arm in arms:
        q = statistics.quantiles(every[arm], n=4)
        out[arm] = dict(median_ms=statistics.median(every[arm]),
                        q1_ms=q[0], q3_ms=q[2],
                        round_means_ms=per_round[arm])
    return dict(n=n, pad_to=pad_to, rounds=rounds, calls=calls, arms=out,
                span_us=span_us())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    ap.add_argument("--against", help="another tree's tabgen/sampling.py, "
                    "timed beside this one's")
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
    result = {}
    for n, pad_to, calls, traced in ((1000, 1024, 50, 5),
                                     (cs.N_ROWS, None, 6, 2)):
        key = f"euler n={n}" + (f" pad_to={pad_to}" if pad_to else "")
        for _ in range(2):                   # warm-up: builds, lazy loads
            gen.generate(n, seed=0, pad_to=pad_to)
        summary = {"spans_ms": span_ms(gen, n, pad_to, calls)}
        summary["trace"], table = capture(gen, n, pad_to, traced)
        result[key] = summary
        print(key, json.dumps(summary), flush=True)
        if args.out:
            name = os.path.join(args.out, key.replace(" ", "_") + ".txt")
            with open(name, "w") as f:
                f.write(table)
    result["cost"] = cost(art, args.against)
    print("cost", json.dumps(result["cost"]), flush=True)
    if args.out:
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
