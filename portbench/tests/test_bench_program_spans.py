"""The readers of the program's own ``sample.*`` spans (``harness/spans.py``
and ``metrics/{issue_ms,step_enqueue_us,result_wait_ms,result_finish_ms}.py``)
on the tiny CPU cells, on a ring of hand-made spans, and on a ring that holds
fewer spans than the window's calls, which fails the run."""
import json
import math
import os
import types

import pytest

import repro_torch.obs as obs
from harness import cli, registry
from repro_torch.obs import Tracer

from conftest import run_tiny

# the seven metrics as their cells would list them; here on the tiny cells
SPAN_METRICS = [
    ("issue_ms.gen", "ms", "facade: tabgen/sampling.py::sample_async",
     "gen_rows_per_s", "tiny-gen"),
    ("issue_ms.latency", "ms", "facade: tabgen/sampling.py::sample_async",
     "gen_p95_ms", "tiny-gen-bucket"),
    ("step_enqueue_us.latency", "us",
     "solve: tabgen/samplers.py, core/generate.py, forest/packed.py",
     "gen_p95_ms", "tiny-gen-bucket"),
    ("result_wait_ms.gen", "ms",
     "facade and host tail: tabgen/facade.py, tabgen/sampling.py",
     "gen_rows_per_s", "tiny-gen"),
    ("result_wait_ms.latency", "ms",
     "facade and host tail: tabgen/facade.py, tabgen/sampling.py",
     "gen_p95_ms", "tiny-gen-bucket"),
    ("result_finish_ms.gen", "ms",
     "facade and host tail: tabgen/facade.py, tabgen/sampling.py",
     "gen_rows_per_s", "tiny-gen"),
    ("result_finish_ms.latency", "ms",
     "facade and host tail: tabgen/facade.py, tabgen/sampling.py",
     "gen_p95_ms", "tiny-gen-bucket"),
]
CELL_OF = {name: cell for name, _, _, _, cell in SPAN_METRICS}


def list_span_metrics(root):
    path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    for name, unit, layer, moves, cell in SPAN_METRICS:
        man["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": layer, "moves": moves,
            "workloads": [cell]})
    with open(path, "w") as f:
        json.dump(man, f)


@pytest.fixture
def ring(monkeypatch):
    """A fresh process-wide tracer, so that no earlier test's spans count."""
    def use(capacity=16384):
        tracer = Tracer(capacity=capacity)
        monkeypatch.setitem(obs._defaults, "tracer", tracer)
        return tracer
    return use


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-gen-bucket"])
def test_each_reader_reads_a_finite_number(tiny_root, ring, cell):
    ring()
    list_span_metrics(tiny_root)
    out = run_tiny(tiny_root, cell, trace=True)
    assert out["correct"]
    mine = {n for n, c in CELL_OF.items() if c == cell}
    assert mine <= set(out["metrics"])
    for name in mine:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)


def test_a_ring_short_of_the_window_fails_the_run(tiny_root, ring):
    """Four spans cannot hold the eight of even one call: every reader reads
    ``None``, and the run fails (``MetricMissing``: exit 2, no result)."""
    ring(capacity=4)
    list_span_metrics(tiny_root)
    with pytest.raises(cli.MetricMissing, match="issue_ms.gen"):
        run_tiny(tiny_root, "tiny-gen", trace=True)


class Ctx:
    def __init__(self, calls, trace=True):
        self.record = {"calls": [{}] * calls}
        self.trace = object() if trace else None
        self.shapes = {}


class Ring:
    """A stand-in for the program's tracer that holds hand-made spans."""

    def __init__(self):
        self.made = []

    def add(self, name, seconds, parent=None, **attrs):
        sp = types.SimpleNamespace(name=name, duration_s=seconds,
                                   span_id=len(self.made) + 1,
                                   parent_id=parent, attrs=attrs)
        self.made.append(sp)
        return sp

    def call(self, issue_s, solve_s, steps, result_s, wait_s):
        iss = self.add("sample.issue", issue_s)
        self.add("sample.solve", solve_s, iss.span_id, steps=steps)
        res = self.add("sample.result", result_s)
        self.add("sample.result.wait", wait_s, res.span_id)

    def spans(self, name=None):
        return [s for s in self.made if name is None or s.name == name]


def per_layer(name):
    return registry.reader(registry.BENCH, "metrics", name)


def test_readers_on_hand_made_spans(monkeypatch):
    ring = Ring()
    monkeypatch.setitem(obs._defaults, "tracer", ring)
    for _ in range(2):                            # older calls, not read
        ring.call(9.0, 1.0, 10, 5.0, 2.0)
    for _ in range(3):
        ring.call(0.010, 0.008, 99, 0.005, 0.002)
    ctx = Ctx(3)
    assert per_layer("issue_ms.latency").read(ctx) == pytest.approx(10.0)
    assert per_layer("step_enqueue_us.latency").read(ctx) == \
        pytest.approx(8e3 / 99)
    assert per_layer("result_wait_ms.gen").read(ctx) == pytest.approx(2.0)
    assert per_layer("result_finish_ms.gen").read(ctx) == pytest.approx(3.0)
    assert per_layer("result_finish_ms.latency").read(Ctx(6)) is None
    for name in CELL_OF:
        assert per_layer(name).read(Ctx(3, trace=False)) is None


def test_one_reader_serves_both_cells_of_each_quantity():
    for name in CELL_OF:
        base = name.split(".")[0]
        assert registry.reader_path(registry.BENCH, "metrics", name) \
            .endswith(os.path.join("metrics", f"{base}.py"))
