#!/usr/bin/env python3
"""Where a served batch's time goes: the in-flight scheduler against its
drain arm, on one GPU, at CaloForest photons width.

    python3 scripts/probe_torch_serving.py --out DIR

Builds the kernels, registers one seeded photons model (``chip_smoke``'s
``random_artifacts``: flow, MO, n_t=100, 20 trees, depth 7, p=368, 15
classes) and warms it, then serves ``chip_smoke``'s 48 euler requests
(64-4,000 rows, 4 client threads) through ``InflightScheduler`` in
rounds that rotate three arms: in-flight, drain, and in-flight with the
copy to the host made at resolve time on the waiter's thread (the port's
behaviour before ``sample_async`` enqueued the copy itself: it lands behind
whatever the scheduler thread has enqueued of the next batch). Per batch it
records on the host the seconds the scheduler thread spent dispatching it
(acquire + enqueue of the solve and its copy), the seconds the waiter
waited on its copy event and the seconds of the rest of its resolve (copy
out, decode, delivery), and on the device, from CUDA events recorded
before the enqueue and after it, the batch's device span and the device's
idle gap before it. A last
in-flight run under ``torch.profiler`` gives the kernels' device time, by
name, against the run's wall time. Prints one line per arm and round, and
a JSON summary as the last line; writes every batch's numbers and the
profile's table to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed_scheduler():
    from repro_torch.serving import InflightScheduler

    class Timed(InflightScheduler):
        """Records per batch: dispatch seconds, event wait, host finish,
        and two CUDA timing events around the enqueue."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._probe_lock = threading.Lock()
            self.batches = []

        def _dispatch(self, batch):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            inflight = super()._dispatch(batch)
            dt = time.perf_counter() - t0
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if inflight is not None:
                with self._probe_lock:
                    self.batches.append(dict(
                        sample=inflight.sample, start=start, end=end,
                        rows=inflight.total_rows, dispatch_s=dt,
                        t_dispatched=time.perf_counter()))
            return inflight

        def _resolve(self, inflight):
            with self._probe_lock:
                rec = next(b for b in self.batches
                           if b["sample"] is inflight.sample)
            t0 = time.perf_counter()
            if inflight.sample.ready is not None:
                inflight.sample.ready.synchronize()
            t1 = time.perf_counter()
            super()._resolve(inflight)
            rec.update(wait_s=t1 - t0, finish_s=time.perf_counter() - t1,
                       t_resolved=time.perf_counter())

    return Timed


def run_arm(reg, sizes, prios, sync_resolve, chip_smoke):
    from repro_torch.serving import AdmissionController
    Timed = timed_scheduler()
    sched = Timed(reg, AdmissionController(), sync_resolve=sync_resolve,
                  max_coalesce_rows=chip_smoke.N_Y
                  * chip_smoke.FOREST_BUCKETS[-1],
                  coalesce_window_s=0.002)
    futs, lock = [], threading.Lock()

    def client(part):
        for n, pr in part:
            f = sched.submit(int(n), model="A", sampler="euler",
                             priority=str(pr))
            with lock:
                futs.append(f)

    jobs = list(zip(sizes, prios))
    k = chip_smoke.SERVE_CLIENTS
    threads = [threading.Thread(target=client, args=(jobs[i::k],))
               for i in range(k)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for f in futs:
        f.result(timeout=300)
    wall = time.perf_counter() - t0
    sched.stop()
    torch.cuda.synchronize()
    rows = []
    prev_end = None
    for b in sched.batches:
        span = b["start"].elapsed_time(b["end"]) / 1e3
        gap = (prev_end.elapsed_time(b["start"]) / 1e3
               if prev_end is not None else None)
        prev_end = b["end"]
        rows.append(dict(rows=b["rows"], dispatch_s=b["dispatch_s"],
                         wait_s=b["wait_s"], finish_s=b["finish_s"],
                         device_span_s=span, idle_before_s=gap))
    total_rows = int(sizes.sum())
    first_start, last_end = sched.batches[0]["start"], sched.batches[-1]["end"]
    device_window = first_start.elapsed_time(last_end) / 1e3
    spans = sum(r["device_span_s"] for r in rows)
    return dict(wall_s=wall, rows_per_s=total_rows / wall,
                batches=len(rows),
                dispatch_s=sum(r["dispatch_s"] for r in rows),
                wait_s=sum(r["wait_s"] for r in rows),
                finish_s=sum(r["finish_s"] for r in rows),
                device_span_s=spans, device_window_s=device_window,
                idle_between_s=sum(r["idle_before_s"] or 0 for r in rows),
                per_batch=rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for the per-run numbers and the profile")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of the three arms, each in its own turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.serving import ModelRegistry
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    for name in build.build(["tree_predict", "hist", "flash_attention"]):
        build.load(name)
    cfg = chip_smoke.photons_config(n_t=chip_smoke.N_T, multi_output=True)
    art = chip_smoke.random_artifacts(
        cfg, chip_smoke.N_Y, chip_smoke.P,
        chip_smoke.N_ROWS // chip_smoke.N_Y, seed=0, device=device)
    reg = ModelRegistry(device=device, buckets=chip_smoke.FOREST_BUCKETS)
    reg.register("A", art)
    del art
    print(f"warmup {reg.warmup('A')!r} s; host cores {os.cpu_count()}",
          flush=True)
    rng = np.random.default_rng(7)
    lo, hi = chip_smoke.SERVE_ROWS
    sizes = rng.integers(lo, hi + 1, size=chip_smoke.SERVE_REQUESTS)
    prios = np.where(rng.random(chip_smoke.SERVE_REQUESTS) < 2 / 3,
                     "interactive", "bulk")
    from repro_torch.tabgen import sampling
    copy_in_solve = sampling._copy_to_host
    arms = [("inflight", False), ("drain", True),
            ("inflight_copy_at_resolve", False)]
    order = []
    for r in range(args.rounds):
        order += arms[r % 3:] + arms[:r % 3]
    results = {arm: [] for arm, _ in arms}
    for i, (arm, sync_resolve) in enumerate(order):
        # the copy at resolve: SampleHandle keeps the device tensor and its
        # result() copies it on the waiter's thread, on the default stream
        sampling._copy_to_host = (
            (lambda x: (x, None)) if arm == "inflight_copy_at_resolve"
            else copy_in_solve)
        try:
            res = run_arm(reg, sizes, prios, sync_resolve, chip_smoke)
        finally:
            sampling._copy_to_host = copy_in_solve
        results[arm].append(res)
        with open(os.path.join(args.out, f"{i:02d}_{arm}.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(f"{i} {arm}: {res['wall_s']!r} s, {res['rows_per_s']!r} "
              f"rows/s, {res['batches']} batches; host: dispatch "
              f"{res['dispatch_s']!r} s, event wait {res['wait_s']!r} s, "
              f"finish {res['finish_s']!r} s; device: spans "
              f"{res['device_span_s']!r} s in a window of "
              f"{res['device_window_s']!r} s, idle between batches "
              f"{res['idle_between_s']!r} s", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_arm(reg, sizes, prios, False, chip_smoke)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_s = sum(e.device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    with open(os.path.join(args.out, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))
    print(f"profiled in-flight: {res['wall_s']!r} s wall, kernels "
          f"{kernel_s!r} s of device time ({kernel_s / res['wall_s']!r} of "
          "the wall); top: " + "; ".join(
              f"{e.key[:40]} {e.device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top), flush=True)
    summary = {arm: {k: [r[k] for r in rs] for k in
                     ("wall_s", "rows_per_s", "dispatch_s", "wait_s",
                      "finish_s", "device_span_s", "device_window_s",
                      "idle_between_s")}
               for arm, rs in results.items()}
    print(card, flush=True)
    summary["profiled_inflight"] = dict(wall_s=res["wall_s"],
                                        kernel_s=kernel_s)
    print(json.dumps({"card": card, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
