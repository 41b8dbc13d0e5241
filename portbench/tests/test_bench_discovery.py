"""A configuration, a mix, a limits file and a metric reader dropped into
a copy of the benchmark's folder are found by name; nothing else names
them."""
import json
import os

from harness import registry

from conftest import run_tiny


def test_files_found_by_name(tiny_root):
    with open(os.path.join(tiny_root, "metrics", "rows_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    assert registry.reader(tiny_root, "metrics", "rows_seen").read(None) \
        == 42.0
    assert registry.config(tiny_root, "tiny")["p"] == 64
    assert registry.mix(tiny_root, "tiny-gen")["rows"] == 200
    man = registry.manifest(tiny_root)
    assert registry.workload(man, "tiny-fit")["traffic"] == "tiny-fit"


def test_a_cell_added_by_files_runs(tiny_root):
    """A new mix and cell, added by data files and manifest entries only,
    runs through the same harness."""
    with open(os.path.join(tiny_root, "mixes", "tiny-gen-3.json"), "w") as f:
        json.dump({"driver": "generate", "rows": 90, "pad_to": None,
                   "in_flight": 3, "check_calls": 1, "trace_seconds": 1}, f)
    with open(os.path.join(tiny_root, "limits", "tiny-gen-3.json"), "w") as f:
        json.dump({"row_gap": 1e-4, "label_mismatch": 0.0,
                   "rows_missing": 0.0}, f)
    path = os.path.join(os.path.dirname(tiny_root), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["workloads"].append({"name": "tiny-gen-3", "config": "tiny",
                             "traffic": "tiny-gen-3", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "gen_rows_per_s":
            m["workloads"].append("tiny-gen-3")
    with open(path, "w") as f:
        json.dump(man, f)
    out = run_tiny(tiny_root, "tiny-gen-3")
    assert out["correct"] and set(out["metrics"]) == {"gen_rows_per_s",
                                                      "setup_s"}
    assert registry.metrics_of(man, "per_layer", "tiny-gen-3") == []
