"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end metrics, measured
with nothing wrapped; with ``--trace 1`` the window (at most the mix's
``trace_seconds``) runs under ``torch.profiler`` with the benchmark's spans
around the program's layers, and the metrics are the cell's per-layer
metrics. ``--control`` runs the cell's control in the program's place: the
program's bfloat16 histogram path for a fit, the reference in bfloat16 for
generation; its check must fail.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers are the last lines on standard error. A run with
no CUDA device, fewer devices than the cell asks for, or with ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` loaded once the window has
closed exits with 2 and prints no result. So does a run in which a metric
that ``BENCHMARK.json`` lists for the cell reads nothing or a number that
is not finite: a reader that finds no span, counter or trace fails the run
rather than leaving its metric out while the work goes on unmeasured.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from harness import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    seed: int
    device: object
    control: bool = False


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    record: Dict
    shapes: Dict
    trace: Optional[object] = None


class MetricMissing(RuntimeError):
    """A metric the cell reports read ``None`` or a number not finite."""


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def load_cell(root: str, name: str, seed: int, device, control=False
              ) -> Cell:
    spec = registry.workload(registry.manifest(root), name)
    return Cell(root, name, registry.config(root, spec["config"]),
                registry.mix(root, spec["traffic"]),
                registry.limits(root, name), seed % 2 ** 63, device,
                control)


def driver(cell: Cell):
    return importlib.import_module(f"harness.drivers.{cell.mix['driver']}")


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(cell: Cell, seconds: float, trace: bool,
             started: float) -> Dict:
    """Set up, measure, check; returns the result object (or raises)."""
    import torch
    on_card = cell.device.type == "cuda"
    drv = driver(cell)
    state = drv.setup(cell)
    if on_card:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.perf_counter() - started
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    summary = None
    if trace:
        from harness.trace import WINDOW, Wrapper, summarise
        seconds = min(seconds, float(cell.mix["trace_seconds"]))
        wrapper = Wrapper()
        drv.instrument(state, wrapper)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW):
                    record = drv.window(state, seconds, True)
        finally:
            wrapper.restore()
        t_read = time.perf_counter()
        summary = summarise(prof)
        del prof
        record["trace_read_s"] = time.perf_counter() - t_read
    else:
        record = drv.window(state, seconds, False)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    record["peak_bytes"] = window_peak
    ctx = Context(record, drv.shapes(state), summary)
    man = registry.manifest(cell.root)
    metrics, missing = {}, []
    kind = "metrics" if trace else "end_to_end"
    entries = registry.metrics_of(man, "per_layer" if trace else
                                  "end_to_end", cell.name)
    for m in entries:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = registry.reader(cell.root, kind, m["name"]).read(ctx)
        if value is None or not math.isfinite(value):
            missing.append(f"{m['name']} read {value!r}")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if missing:
        raise MetricMissing(f"{cell.name}: " + "; ".join(missing))
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"attempted": len(record["calls"]), "failed": 0,
           "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["window"] = {"seconds": record["seconds"],
                     "elapsed_s": record["elapsed_s"],
                     "overrun_s": record["overrun_s"],
                     "calls": len(record["calls"])}
    if "result_s" in record["calls"][0]:
        out["window"]["result_ms_mean"] = 1e3 * sum(
            c["result_s"] for c in record["calls"]) / len(record["calls"])
    del ctx
    t_check = time.perf_counter()
    got = drv.check(state)
    out["window"]["check_s"] = time.perf_counter() - t_check
    out["window"]["setup_s"] = setup_s
    if "trace_read_s" in record:
        out["window"]["trace_read_s"] = record["trace_read_s"]
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in got.items()}
    out["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = checks
    return out


def main(argv, started: float) -> int:
    args = parse(argv)
    src = os.path.join(registry.repo_root(), "src")
    if os.path.isdir(src):
        sys.path.insert(0, src)
    import torch
    man = registry.manifest()
    spec = registry.workload(man, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    cell = load_cell(registry.BENCH, args.workload, args.seed,
                     torch.device("cuda"), args.control)
    try:
        out = run_cell(cell, args.seconds, bool(args.trace), started)
    except MetricMissing as e:
        print(f"a metric the cell reports read nothing: {e}",
              file=sys.stderr)
        return 2
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"forbidden modules loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 2
    w = out["window"]
    print(f"window: {w['calls']} calls, {w['elapsed_s']:.4f} s for "
          f"{w['seconds']} s asked, overrun {w['overrun_s']:.4f} s",
          file=sys.stderr)
    for k, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "window", "checks"]
    print(json.dumps({k: out[k] for k in order if k in out}))
    return 0
