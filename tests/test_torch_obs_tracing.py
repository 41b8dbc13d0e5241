"""The port's spans inside the generate path, and their mirror into
``torch.profiler``, on the CPU.

* Every generate call records eight ``sample.*`` spans into
  ``repro_torch.obs.default_tracer()``, nested as ``tabgen/sampling.py``
  documents, under one trace id a call, also when ``result()`` runs on
  another thread. ``sample.solve`` counts the summing launches of its
  solve by kind, a replayed solve its capture's.
* ``Tracer(torch_annotations=...)`` / ``REPRO_OBS_TORCH_TRACE``: off, a
  profiler capture holds no ``sample.*`` range; on, it holds each scoped
  span as a range of the same name, nested as the spans are, and no
  cross-thread span.
"""
import collections
import contextlib
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import repro_torch.obs as obs
from repro_torch.config import ForestConfig
from repro_torch.kernels.tree_predict.ops import forest_predict
from repro_torch.launch.mesh import forest_mesh
from repro_torch.obs import Tracer, default_tracer
from repro_torch.tabgen import (TabularGenerator, artifacts_from_numpy,
                                sample_labels, solve_graph)

N_T = 4
PARENT = {"sample.x1": "sample.issue", "sample.solve": "sample.issue",
          "sample.compact": "sample.issue", "sample.copy": "sample.issue",
          "sample.issue": None, "sample.result.wait": "sample.result",
          "sample.result.copy_out": "sample.result", "sample.result": None}
SCOPED = ("outer", "inner", "leaf")


def make_gen(multi_output=False):
    """A tiny model of 3 classes, p = 4: single-output trees (4 lanes of
    T = 2 scalar-leaf trees a class) or multi-output ones (1 lane of T = 2
    trees with leaves of 4 outputs)."""
    rng = np.random.default_rng(0)
    n_y, T, p = 3, 2, 4
    lanes, out = (1, p) if multi_output else (p, 1)
    arrays = {
        "feat": rng.integers(0, p, (N_T, n_y, lanes, T, 3)).astype(np.int32),
        "thr_val": rng.normal(size=(N_T, n_y, lanes, T, 3)).astype(
            np.float32),
        "leaf": rng.normal(size=(N_T, n_y, lanes, T, 4, out)).astype(
            np.float32),
        "best_round": np.zeros((N_T, n_y, lanes), np.int32),
        "rounds_run": np.full((N_T, n_y, lanes), T, np.int32),
        "val_curve": np.zeros((N_T, n_y, lanes, T), np.float32),
        "mins": np.zeros((n_y, p), np.float32),
        "maxs": np.ones((n_y, p), np.float32),
        "classes": np.array([0, 1, 2]), "counts": np.array([5, 7, 4])}
    cfg = dataclasses.asdict(ForestConfig(n_t=N_T, n_trees=T, max_depth=2,
                                          multi_output=multi_output))
    g = TabularGenerator(ForestConfig(**cfg))
    g.artifacts = artifacts_from_numpy(arrays, cfg, "cpu")
    return g


@pytest.fixture(scope="module")
def gen():
    return make_gen()


def call(gen, how, n=11):
    """One generate call, returns ``(X, trace id)``."""
    if how == "generate":
        X, _ = gen.generate(n, seed=5)
        return X, default_tracer().spans(name="sample.issue")[-1].trace_id
    h = gen.generate_async(n, seed=5, pad_to=8)
    if how == "generate_async":
        return h.result()[0], h.trace_id
    out = {}
    t = threading.Thread(target=lambda: out.update(X=h.result()[0]),
                         name="resolver")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return out["X"], h.trace_id


@pytest.mark.parametrize("how", ["generate", "generate_async",
                                 "result_on_another_thread"])
def test_a_call_records_its_eight_spans(gen, how):
    X, tid = call(gen, how)
    spans = default_tracer().trace(tid)
    assert sorted(s.name for s in spans) == sorted(PARENT)
    by_name = {s.name: s for s in spans}
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.t_end is not None and s.trace_id == tid
        want = PARENT[s.name]
        assert (by_id[s.parent_id].name if s.parent_id else None) == want
    issue, res = by_name["sample.issue"], by_name["sample.result"]
    assert by_name["sample.solve"].attrs["steps"] == N_T - 1
    assert issue.attrs["rows"] == 11 and issue.attrs["n_y"] == 3
    assert issue.attrs["sampler"] == "euler"
    labels = sample_labels(np.array([5, 7, 4]), 11, None)
    m = 8 if how != "generate" else np.bincount(labels).max()
    assert issue.attrs["m"] == m
    compact = by_name["sample.compact"]
    assert compact.attrs["rows"] == len(X)
    assert compact.attrs["padding_rows"] == 3 * m - 11
    assert by_name["sample.copy"].attrs["bytes"] == 0   # no copy on the CPU
    assert res.attrs["rows"] == len(X) == 11
    assert by_name["sample.result.copy_out"].attrs["bytes"] >= X.nbytes
    assert res.t_start >= issue.t_end
    want_thread = "resolver" if how == "result_on_another_thread" else \
        issue.thread
    assert {by_name[n].thread for n in PARENT if "result" in n} == \
        {want_thread}


@pytest.mark.parametrize("multi_output, lanes", [(False, 4), (True, 1)])
def test_the_solve_span_counts_lanes_and_trees(multi_output, lanes):
    """``sample.solve`` carries the sub-forests of an ensemble (``lanes``:
    p for single-output trees, 1 for multi-output ones) and the trees of
    each (``trees``), beside ``steps``; ``graph`` reads ``eager``, since
    only a CUDA device replays a captured solve; ``sum_tma`` and
    ``sum_plain`` read 0, since the CPU launches no summing kernel."""
    g = make_gen(multi_output)
    X, tid = call(g, "generate_async")
    solve, = [s for s in default_tracer().trace(tid)
              if s.name == "sample.solve"]
    assert solve.attrs == {"steps": N_T - 1, "lanes": lanes, "trees": 2,
                           "graph": "eager", "sum_tma": 0, "sum_plain": 0}
    assert X.shape == (11, 4)


class _CountingGraph(solve_graph.SolveGraph):
    """A captured solve on the CPU, where no CUDA graph is: the capture
    solves eagerly into ``out`` and records the summing launches a card's
    capture of an unaligned width would (one plain launch a step, with
    one TMA launch besides, so the two counts differ); its replay is
    :meth:`SolveGraph.replay`, with a graph launch that runs nothing."""

    RECORDED = collections.Counter({
        (forest_predict, "launches"): 2 * (N_T - 1),
        (forest_predict, "sum_plain_launches"): N_T - 1,
        (forest_predict, "sum_tma_launches"): 1})

    def __init__(self, x1, out):
        self.graph = types.SimpleNamespace(replay=lambda: None)
        self.x1, self.out, self.launches = x1, out, self.RECORDED

    @classmethod
    def capture(cls, solve, x1, ts):
        return cls(x1.clone(), solve(x1.clone()))

    def use(self):
        return contextlib.nullcontext()


def test_a_replayed_solve_reports_its_captures_summing_launches(
        monkeypatch):
    """The first bucketed call captures (its eager solve launched nothing
    on the CPU: 0 and 0); the second replays and reports the launches the
    capture recorded, which the replay also adds to the counters."""
    key_of = solve_graph.graph_key
    monkeypatch.setattr(solve_graph, "graph_key",
                        lambda device, **kw: key_of("cuda", **kw))
    monkeypatch.setattr(solve_graph, "SolveGraph", _CountingGraph)
    monkeypatch.setattr(forest_predict, "sum_plain_launches", 0)
    monkeypatch.setattr(forest_predict, "sum_tma_launches", 0)
    monkeypatch.setattr(forest_predict, "launches", 0)
    g = make_gen(multi_output=True)
    seen = []
    for seed in (1, 2):
        h = g.generate_async(11, seed=seed, pad_to=8)
        h.result()
        solve, = [s for s in default_tracer().trace(h.trace_id)
                  if s.name == "sample.solve"]
        seen.append({k: solve.attrs[k]
                     for k in ("graph", "sum_tma", "sum_plain")})
    assert seen == [
        {"graph": "capture", "sum_tma": 0, "sum_plain": 0},
        {"graph": "replay", "sum_tma": 1, "sum_plain": N_T - 1}]
    assert (forest_predict.sum_tma_launches,
            forest_predict.sum_plain_launches) == (1, N_T - 1)


def test_a_mesh_call_draws_x1_inside_its_solve(gen, tmp_path):
    """On a mesh a rank draws its block of x1 as the sharded solve asks for
    it, so ``sample.x1`` sits under ``sample.solve``; the rest as above."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        h = gen.generate_async(11, seed=5, pad_to=8,
                               mesh=forest_mesh(1, 1, "cpu"))
        X, _ = h.result()
    finally:
        dist.destroy_process_group()
    spans = default_tracer().trace(h.trace_id)
    by_id = {s.span_id: s for s in spans}
    got = {s.name: by_id[s.parent_id].name if s.parent_id else None
           for s in spans}
    assert got == dict(PARENT, **{"sample.x1": "sample.solve"})
    assert len(spans) == 8 and len(X) == 11


def test_each_call_has_its_own_trace(gen):
    _, a = call(gen, "generate_async")
    _, b = call(gen, "generate_async")
    assert a != b
    assert len(default_tracer().trace(a)) == len(default_tracer().trace(b)) \
        == 8


def test_the_process_tracer_holds_two_thousand_calls():
    assert default_tracer().capacity == 16384 == 8 * 2048


def ranges(prof, names):
    """``name -> (start, end)`` of the capture's events named in ``names``
    (each must appear once)."""
    out = {}
    for ev in prof.events():
        if ev.name in names:
            assert ev.name not in out, ev.name
            out[ev.name] = (ev.time_range.start, ev.time_range.end)
    return out


def assert_nested(got, parent_of):
    for child, parent in parent_of.items():
        if parent is not None:
            (a, b), (pa, pb) = got[child], got[parent]
            assert pa <= a and b <= pb, (child, parent)


def capture(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_no_range_without_the_mirror(gen, monkeypatch):
    monkeypatch.delenv("REPRO_OBS_TORCH_TRACE", raising=False)
    prof = capture(lambda: call(gen, "generate_async"))
    assert not [e.name for e in prof.events()
                if e.name.startswith("sample.")]


@pytest.mark.parametrize("switch", ["env", "off_wins_over_env"])
def test_the_mirror_holds_the_eight_spans_nested(gen, monkeypatch, switch):
    monkeypatch.setenv("REPRO_OBS_TORCH_TRACE", "1")
    if switch == "off_wins_over_env":
        monkeypatch.setitem(obs._defaults, "tracer",
                            Tracer(capacity=64, torch_annotations=False))
    prof = capture(lambda: call(gen, "generate_async"))
    got = ranges(prof, set(PARENT))
    if switch == "off_wins_over_env":
        assert got == {}
        return
    assert set(got) == set(PARENT)
    assert_nested(got, PARENT)
    assert got["sample.issue"][1] <= got["sample.result"][0]


@pytest.mark.parametrize("switch", ["argument", "env"])
def test_scoped_spans_mirror_and_cross_thread_ones_do_not(monkeypatch,
                                                          switch):
    if switch == "argument":
        monkeypatch.delenv("REPRO_OBS_TORCH_TRACE", raising=False)
        tracer = Tracer(torch_annotations=True)
    else:
        monkeypatch.setenv("REPRO_OBS_TORCH_TRACE", "1")
        tracer = Tracer()

    def work():
        queued = tracer.start("queued")
        with tracer.span("outer"):
            with tracer.span("inner"):
                with tracer.span("leaf"):
                    torch.ones(4).sum()
        queued.end()

    got = ranges(capture(work), set(SCOPED) | {"queued"})
    assert set(got) == set(SCOPED)
    assert_nested(got, {"inner": "outer", "leaf": "inner"})
    assert [s.name for s in tracer.spans()] == ["leaf", "inner", "outer",
                                                "queued"]


def test_the_variable_is_read_per_span(monkeypatch):
    tracer = Tracer()

    def work():
        monkeypatch.setenv("REPRO_OBS_TORCH_TRACE", "0")
        with tracer.span("outer"):
            monkeypatch.setenv("REPRO_OBS_TORCH_TRACE", "1")
            with tracer.span("inner"):
                pass

    assert set(ranges(capture(work), {"outer", "inner"})) == {"inner"}
