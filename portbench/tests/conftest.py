"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
with tiny configurations, mixes and cells, run on the CPU through the same
harness as the card's runs (``harness.cli.run_cell``).

Run from the repository's root: ``python -m pytest portbench/tests``.
Tests that need the card carry the ``cuda`` marker and skip here.
"""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (BENCH, os.path.join(REPO, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_FOREST = {"method": "flow", "n_t": 5, "duplicate_k": 2, "n_trees": 3,
               "max_depth": 3, "learning_rate": 1.5, "reg_lambda": 1.0,
               "n_bins": 16, "multi_output": True, "early_stop_rounds": 0,
               "sigma": 0.0}
TINY_CONFIG = {"name": "tiny", "dataset": "photons_mini", "p": 64,
               "n_classes": 4, "rows_per_class": 40, "forest": TINY_FOREST}
TINY_MIXES = {
    "tiny-fit": {"driver": "fit", "n_t_per_call": 1, "classes_per_call": 2,
                 "check_split_rounds": 2, "trace_seconds": 1},
    "tiny-gen": {"driver": "generate", "rows": 200, "pad_to": None,
                 "in_flight": 2, "check_calls": 2, "trace_seconds": 1},
    "tiny-gen-bucket": {"driver": "generate", "rows": 30, "pad_to": 16,
                        "in_flight": 1, "check_calls": 3,
                        "trace_seconds": 1},
}
TINY_CELLS = {"tiny-fit": "tiny-fit", "tiny-gen": "tiny-gen",
              "tiny-gen-bucket": "tiny-gen-bucket"}
# the fit driver's end-to-end metrics, which no cell of BENCHMARK.json
# reports yet
FIT_END_TO_END = [
    {"name": "fit_s_per_ensemble", "unit": "s", "better": "lower",
     "bound": 0.02, "source": "host_clock", "workloads": ["tiny-fit"]},
    {"name": "fit_peak_gb", "unit": "GB", "better": "lower", "bound": 0.01,
     "source": "host_clock", "workloads": ["tiny-fit"]},
]


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's folder, with ``BENCHMARK.json`` beside it,
    that also holds the tiny cells; returns the folder's path."""
    root = tmp_path / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        man = json.load(f)
    write_json(str(root / "configs" / "tiny.json"), TINY_CONFIG)
    for name, mix in TINY_MIXES.items():
        write_json(str(root / "mixes" / f"{name}.json"), mix)
    for cell, mix in TINY_CELLS.items():
        man["workloads"].append({"name": cell, "config": "tiny",
                                 "traffic": mix, "chips": 1, "why": "test"})
        limits = ({"scaler_gap": 0.0, "edge_mismatch": 0.0,
                   "split_regret": 1e-6, "leaf_gap": 1e-5,
                   "val_loss_gap": 1e-5} if mix == "tiny-fit" else
                  {"row_gap": 1e-4, "label_mismatch": 0.0,
                   "rows_missing": 0.0})
        write_json(str(root / "limits" / f"{cell}.json"), limits)
    man["end_to_end"][:0] = [dict(m) for m in FIT_END_TO_END]
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("gen_rows_per_s", "gen_p95_ms",
                         "gen_p50_ms.latency"):
            m["workloads"] += ["tiny-gen", "tiny-gen-bucket"]
    write_json(str(tmp_path / "BENCHMARK.json"), man)
    return str(root)


def run_tiny(root, cell, seed=5, seconds=0.01, trace=False, control=False):
    """One CPU run of a tiny cell; returns the result object."""
    import time

    import torch

    from harness import cli
    c = cli.load_cell(root, cell, seed, torch.device("cpu"), control)
    return cli.run_cell(c, seconds, trace, time.perf_counter())
