"""A metric that the manifest lists for a cell and that reads nothing, or
a number that is not finite, fails the run: the yardstick may not go
silent while the work it measures still runs."""
import json
import os

import pytest

from harness import cli, registry

from conftest import run_tiny


def _list_for(root, kind, entry):
    path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man[kind].append(entry)
    with open(path, "w") as f:
        json.dump(man, f)


def _reader(root, kind, name, body):
    with open(os.path.join(root, kind, f"{name}.py"), "w") as f:
        f.write(f"def read(ctx):\n    return {body}\n")


@pytest.mark.parametrize("body", ["None", "float('nan')", "float('inf')"])
def test_an_end_to_end_metric_that_reads_nothing_fails(tiny_root, body):
    _reader(tiny_root, "end_to_end", "rows_lost", body)
    _list_for(tiny_root, "end_to_end", {
        "name": "rows_lost", "unit": "rows", "better": "lower",
        "bound": 0.1, "source": "host_clock", "workloads": ["tiny-gen"]})
    with pytest.raises(cli.MetricMissing, match="rows_lost"):
        run_tiny(tiny_root, "tiny-gen")


def test_a_per_layer_metric_without_its_span_fails(tiny_root):
    """``tree_predict_roofline`` reads the device time of its spans; a run
    on the CPU has none, as a run would whose kernel a change moved out of
    the wrapped function."""
    _list_for(tiny_root, "per_layer", {
        "name": "tree_predict_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernel: kernels/tree_predict",
        "moves": "gen_rows_per_s", "workloads": ["tiny-gen"]})
    with pytest.raises(cli.MetricMissing, match="tree_predict_roofline"):
        run_tiny(tiny_root, "tiny-gen", trace=True)


def test_a_traced_run_with_every_metric_read_passes(tiny_root):
    _list_for(tiny_root, "per_layer", {
        "name": "gen_p50_ms.tiny", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "whole generate call",
        "moves": "gen_rows_per_s", "workloads": ["tiny-gen"]})
    _reader(tiny_root, "metrics", "gen_p50_ms",
            "1e3 * sorted(ctx.record['latencies_s'])[0]")
    out = run_tiny(tiny_root, "tiny-gen", trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"gen_p50_ms.latency", "gen_p50_ms.tiny"}


def test_one_reader_serves_the_names_of_a_split_quantity():
    for name in ("device_idle_pct.gen", "device_idle_pct.latency",
                 "device_idle_pct.fit"):
        assert registry.reader_path(registry.BENCH, "metrics", name) \
            .endswith(os.path.join("metrics", "device_idle_pct.py"))
    assert registry.reader_path(
        registry.BENCH, "metrics", "gen_p50_ms.latency").endswith(
        "gen_p50_ms.latency.py")
    with pytest.raises(FileNotFoundError):
        registry.reader_path(registry.BENCH, "metrics", "nothing.gen")
