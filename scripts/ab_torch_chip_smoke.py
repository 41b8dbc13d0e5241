#!/usr/bin/env python3
"""``chip_smoke.py`` of two checkouts, back to back on one GPU host.

    python3 scripts/ab_torch_chip_smoke.py --a DIR --b DIR
        [--order a,b,b,a] [--out DIR] [--timeout SECONDS]

Runs ``python3 chip_smoke.py`` from the root of checkout ``--a`` (e.g. a
parent, unpacked with ``git archive``) and of ``--b`` in the order given
(default a, b, b, a: each side once first and once second), one run after
the other. Before each run the checkout's kernel builds
(``src/repro_torch/kernels/*/_build``) are removed, so every run builds its
kernels as a fresh checkout does. Times each run's wall on the host clock,
writes its whole output to ``--out`` (``<i>-<side>.log``) and prints, per
run, its exit code, its wall and the lines that say where its time went
(the kernel build, the training fits, the comparison phase, its ``hist``
launches). The last line is a JSON summary. Exits non-zero when a run of
``--b`` failed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

KEYS = ("kernel build", "fit MO:", "fit SO:", "batch check",
        "hist MO level 6 for", "hist SO level 6 for", "comparison phase:",
        "resource ")


def run(side: str, root: str, log_path: str, timeout: float) -> dict:
    for build in glob.glob(os.path.join(root, "src", "repro_torch", "kernels",
                                        "*", "_build")):
        shutil.rmtree(build)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                                stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timed out"
    wall = time.perf_counter() - t0
    with open(log_path, errors="replace") as f:
        lines = f.read().splitlines()
    keys = [line for line in lines if line.startswith(KEYS)]
    return dict(side=side, rc=rc, wall_s=wall, last=lines[-1] if lines
                else "", lines=keys)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout run as side a")
    ap.add_argument("--b", required=True, help="checkout run as side b")
    ap.add_argument("--order", default="a,b,b,a")
    ap.add_argument("--out", default="chiprun_out/ab_smoke")
    ap.add_argument("--timeout", type=float, default=1250.0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    roots = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    runs = []
    for i, side in enumerate(args.order.split(","), 1):
        rec = run(side, roots[side], os.path.join(args.out,
                                                  f"{i}-{side}.log"),
                  args.timeout)
        runs.append(rec)
        print(f"run {i} side {side} ({roots[side]}): rc {rec['rc']}, wall "
              f"{rec['wall_s']!r} s", flush=True)
        for line in rec["lines"]:
            print(f"  {line}", flush=True)
        print(f"  last line: {rec['last']}", flush=True)
    print(json.dumps([{k: r[k] for k in ("side", "rc", "wall_s")}
                      for r in runs]))
    return int(any(r["rc"] != 0 for r in runs if r["side"] == "b"))


if __name__ == "__main__":
    sys.exit(main())
