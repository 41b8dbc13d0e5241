"""The single-output configuration's pieces on the CPU: a tiny SO cell run
through ``harness.cli.run_cell`` (correct; its control and planted faults
not), the reference's import rule and its walk against a tree walked by
hand, the SO work count at the cell's shape, and ``tree_walks_g_per_s`` on
hand-made spans. The control at the cell's own size runs on the card (the
``cuda`` test)."""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from harness import registry, work
from harness.drivers import generate_so
from harness.reference_so import forest_sum_so

from conftest import BENCH, REPO, TINY_CONFIG, run_tiny, write_json
from test_bench_imports import top_level_imports
from test_bench_program_spans import Ring

TINY_SO = dict(TINY_CONFIG, name="tiny-so", p=6, n_classes=3,
               forest=dict(TINY_CONFIG["forest"], multi_output=False))
SO_MIXES = {
    "tiny-so-gen": {"driver": "generate_so", "rows": 50, "pad_to": None,
                    "in_flight": 2, "check_calls": 2, "trace_seconds": 1},
    "tiny-so-gen-bucket": {"driver": "generate_so", "rows": 20,
                           "pad_to": 16, "in_flight": 1, "check_calls": 3,
                           "trace_seconds": 1},
}


@pytest.fixture
def so_root(tiny_root):
    """The tiny benchmark folder with a single-output configuration and
    two cells on it, each reporting ``gen_rows_per_s``."""
    write_json(os.path.join(tiny_root, "configs", "tiny-so.json"), TINY_SO)
    path = os.path.join(os.path.dirname(tiny_root), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    for name, mix in SO_MIXES.items():
        write_json(os.path.join(tiny_root, "mixes", f"{name}.json"), mix)
        write_json(os.path.join(tiny_root, "limits", f"{name}.json"),
                   {"row_gap": 1e-4, "label_mismatch": 0.0,
                    "rows_missing": 0.0})
        man["workloads"].append({"name": name, "config": "tiny-so",
                                 "traffic": name, "chips": 1,
                                 "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "gen_rows_per_s":
            m["workloads"] += list(SO_MIXES)
    write_json(path, man)
    return tiny_root


@pytest.mark.parametrize("cell", list(SO_MIXES))
def test_tiny_so_cell_is_correct_and_its_control_is_not(so_root, cell):
    out = run_tiny(so_root, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["row_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {"gen_rows_per_s", "setup_s"}
    ctl = run_tiny(so_root, cell, control=True)
    assert not ctl["correct"]
    assert ctl["checks"]["row_gap"]["value"] > ctl["checks"]["row_gap"][
        "limit"]


def _unchanged_state(monkeypatch):
    import repro_torch.core.generate as g
    monkeypatch.setattr(g, "predict_forest",
                        lambda x, forest, depth: torch.zeros_like(x))


def _one_lane_left_out(monkeypatch):
    import repro_torch.core.generate as g
    orig = g.predict_forest

    def drop(x, forest, depth):
        v = orig(x, forest, depth)
        v[..., -1] = 0.0
        return v
    monkeypatch.setattr(g, "predict_forest", drop)


def _altered_answer(monkeypatch):
    import repro_torch.tabgen.sampling as s
    orig = s.SampleHandle.result

    def result(self):
        X, y = orig(self)
        X = np.array(X)
        X[0, 0] += 0.01
        return X, y
    monkeypatch.setattr(s.SampleHandle, "result", result)


@pytest.mark.parametrize("fault", [_unchanged_state, _one_lane_left_out,
                                   _altered_answer])
def test_so_faults_fail(so_root, monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(so_root, "tiny-so-gen")
    assert not out["correct"], out["checks"]


def test_the_driver_refuses_a_multi_output_model():
    with pytest.raises(ValueError, match="single-output"):
        generate_so.random_model(TINY_CONFIG, 1, torch.device("cpu"))


def test_reference_so_imports_only_the_layout_free_helpers():
    path = os.path.join(BENCH, "harness", "reference_so.py")
    assert top_level_imports(path) <= {"__future__", "typing", "numpy",
                                       "torch", "harness"}
    with open(path) as f:
        text = f.read()
    assert ("from harness.reference import flow_grid, label_counts, span, "
            "x1_blocks") in text
    assert "repro_torch" not in text.replace("``repro_torch``", "")


def test_forest_sum_so_against_trees_walked_by_hand():
    """Two classes, three lanes, two depth-2 trees a lane, every row walked
    in plain Python; the lanes' sums add tree 0's leaf then tree 1's."""
    rng = np.random.default_rng(3)
    B, n, p, S, T, depth = 2, 5, 4, 3, 2, 2
    x = rng.normal(size=(B, n, p)).astype(np.float32)
    feat = rng.integers(0, p, (B, S, T, 3)).astype(np.int32)
    thr = rng.normal(size=(B, S, T, 3)).astype(np.float32)
    thr[0, 1, 0, 0] = np.inf
    leaf = rng.normal(size=(B, S, T, 4)).astype(np.float32)
    want = np.zeros((B, n, S), np.float32)
    for b in range(B):
        for i in range(n):
            for s in range(S):
                for t in range(T):
                    h = 0
                    for _ in range(depth):
                        right = x[b, i, feat[b, s, t, h]] > thr[b, s, t, h]
                        h = 2 * h + 1 + int(right)
                    want[b, i, s] += leaf[b, s, t, h - 3]
    got = forest_sum_so(*map(torch.from_numpy, (x, feat, thr, leaf)), depth)
    np.testing.assert_array_equal(got.numpy(), want)


def test_so_work_at_the_cells_shape():
    """An euler call of 120,000 rows from the photons SO model: each step
    reads and writes the rows (353.28 MB) and reads 15 classes x 368 lanes
    x 20 scalar trees of 127 splits and 128 leaves (168.69 MB), and adds
    one leaf a row, tree and lane (0.883 G adds): bound by bytes, 0.1558
    ms a step, as one SO kernel call at its shape."""
    cfg = registry.config(BENCH, "caloforest-photons-so")
    mix = registry.mix(BENCH, "generate-so-120k-inflight2")
    state = types.SimpleNamespace(cell=types.SimpleNamespace(config=cfg,
                                                             mix=mix),
                                  predict_shapes=[])
    s = generate_so.shapes(state)
    assert (s["T"], s["out"], s["steps"], s["rows"]) == (7360, 1, 99,
                                                         120_000)
    per_step = 8 * 120_000 * 368 + 4 * 15 * 368 * 20 * (2 * 127 + 128)
    assert per_step == 521_971_200
    adds = 120_000 * 368 * 20
    assert per_step / 3.35e12 > adds / 67e12
    assert work.generate_call_s(s["n_y"], s["rows"], s["p"], s["T"],
                                s["depth"], s["out"], s["steps"]) == \
        pytest.approx(99 * per_step / 3.35e12)
    assert work.predict_bytes_ops(15, 368, 20, 7, 368, 1, 8000) == \
        (per_step, 15 * 368 * 8000 * 20 * (7 + 1))
    assert 1e3 * per_step / 3.35e12 == pytest.approx(0.1558, rel=1e-3)
    f = cfg["forest"]
    assert cfg["model_bytes"]["total"] == 4 * 100 * 15 * 368 * 20 * (
        2 * 127 + 128) == f["n_t"] * 15 * 368 * 20 * 4 * (
        2 * (2 ** f["max_depth"] - 1) + 2 ** f["max_depth"])


def solve_call(ring, n_y, m, steps, **solve_attrs):
    """A call's ``sample.issue`` and the ``sample.solve`` under it."""
    iss = ring.add("sample.issue", 0.001, n_y=n_y, m=m)
    ring.add("sample.solve", 0.001, iss.span_id, steps=steps, **solve_attrs)


class Ctx:
    def __init__(self, calls, device_s, predict_shapes=()):
        self.record = {"calls": [{}] * calls}
        self.trace = types.SimpleNamespace(
            span_device_s=lambda name: device_s
            if name == "bench.tree_predict" else 0.0)
        self.shapes = {"predict_shapes": list(predict_shapes)}


def walks_reader():
    return registry.reader(registry.BENCH, "metrics",
                           "tree_walks_g_per_s.so")


def test_tree_walks_on_hand_made_spans(monkeypatch):
    """Two SO calls of 15 classes x 8,000 rows, 368 lanes of 20 trees, 99
    steps: 2 x 87.44 G = 174.87 G walks in 2.02 s of device time are
    86.57 G walks/s; an older call outside the window is not read; an MO
    call counts 1 lane."""
    ring = Ring()
    monkeypatch.setitem(obs._defaults, "tracer", ring)
    solve_call(ring, 4, 10, 3, lanes=1, trees=2)     # older, not read
    for _ in range(2):
        solve_call(ring, 15, 8000, 99, lanes=368, trees=20)
    walks = 2 * 15 * 8000 * 368 * 20 * 99
    assert walks == 174_873_600_000
    reader = walks_reader()
    assert reader.read(Ctx(2, 2.02)) == pytest.approx(86.571, rel=1e-4)
    assert reader.read(Ctx(3, 1.0)) == pytest.approx(
        1e-9 * (walks + 4 * 10 * 1 * 2 * 3))
    assert reader.read(Ctx(2, 0.0)) is None         # no kernel time
    assert reader.read(Ctx(4, 1.0)) is None         # ring short of calls
    ctx = Ctx(2, 1.0)
    ctx.trace = None
    assert reader.read(ctx) is None


def test_tree_walks_read_the_span_attributes(monkeypatch):
    """The attributes decide the count where the solves carry them, also
    against the kernel calls' shapes; a program whose solves carry none is
    read from those shapes; a solve without its issue reads nothing."""
    shapes = [(15, 368, 20, 7, 368, 1, 8000)] * 99
    ring = Ring()
    monkeypatch.setitem(obs._defaults, "tracer", ring)
    solve_call(ring, 15, 8000, 99, lanes=1, trees=20)
    one_lane = walks_reader().read(Ctx(1, 1.0, shapes))
    assert one_lane == pytest.approx(1e-9 * 15 * 8000 * 20 * 99)
    ring.made.clear()
    solve_call(ring, 15, 8000, 99)                  # an older program
    assert walks_reader().read(Ctx(1, 1.0, shapes)) == pytest.approx(
        368 * one_lane)
    ring.made.clear()
    ring.add("sample.solve", 0.001, 99, steps=99, lanes=368, trees=20)
    ring.add("sample.issue", 0.001, n_y=15, m=8000)
    assert walks_reader().read(Ctx(1, 1.0, shapes)) is None


@pytest.mark.cuda
def test_so_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "photons-so-generate", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0", "--control"],
                       cwd=REPO, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is False
