"""A bucketed generate call's solve replayed as one CUDA graph
(``repro_torch.tabgen.solve_graph``).

On the CPU: the graphs' cache (least recently used evicted, gone with its
artifacts) and the launch counts a capture records. On the card (marked
``cuda``; this file imports neither JAX nor the JAX package, so ``pytest -m
cuda tests/test_torch_solve_graph.py`` runs there as it is): replayed rows
bit-equal to eager ones for every deterministic sampler, at two buckets,
for multi- and single-output forests; two handles in flight; a call on
another stream; the launch counters; the ``graph`` attribute of
``sample.solve``; the graphs' memory freed with the artifacts. On both: a
served request past the largest bucket solves eagerly and leaves the
bucket's graph in place.
"""
import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.config import ForestConfig
from repro_torch.kernels.build import (add_launches, count_launch,
                                       recorded_launches)
from repro_torch.kernels.tree_predict.ops import forest_predict
from repro_torch.obs import default_tracer
from repro_torch.serving.registry import ModelHandle
from repro_torch.tabgen import artifacts_from_numpy, sample, sample_async
from repro_torch.tabgen import solve_graph

N_T, N_Y, P, T, DEPTH = 6, 3, 16, 4, 3
COUNTS = np.array([3, 5, 2])
# rows of a call at each bucket: the largest class (half the rows) fits it
ROWS = {64: 100, 1024: 2000}


def make_artifacts(device, *, multi_output: bool, method: str = "flow"):
    """Seeded random trees of 3 classes, p = 16, 4 trees of depth 3 a
    sub-forest: one sub-forest of 16-output leaves (multi-output) or 16 of
    scalar leaves (single-output)."""
    rng = np.random.default_rng(7)
    lanes, out = (1, P) if multi_output else (P, 1)
    H, L = 2 ** DEPTH - 1, 2 ** DEPTH
    arrays = {
        "feat": rng.integers(0, P, (N_T, N_Y, lanes, T, H)).astype(np.int32),
        "thr_val": rng.normal(size=(N_T, N_Y, lanes, T, H)).astype(
            np.float32),
        "leaf": 0.3 * rng.normal(size=(N_T, N_Y, lanes, T, L, out)).astype(
            np.float32),
        "best_round": np.zeros((N_T, N_Y, lanes), np.int32),
        "rounds_run": np.full((N_T, N_Y, lanes), T, np.int32),
        "val_curve": np.zeros((N_T, N_Y, lanes, T), np.float32),
        "mins": rng.uniform(-1, 0, (N_Y, P)).astype(np.float32),
        "maxs": rng.uniform(1, 2, (N_Y, P)).astype(np.float32),
        "classes": np.arange(N_Y), "counts": COUNTS}
    cfg = ForestConfig(method=method, n_t=N_T, n_trees=T, max_depth=DEPTH,
                       multi_output=multi_output)
    return artifacts_from_numpy(arrays, dataclasses.asdict(cfg), device)


def eager(art, n, *, seed, pad_to, sampler=None):
    """The rows of an eager solve at the same shape: the first call of a
    key for an artifacts object (a copy that shares the tensors) is
    eager."""
    return sample(dataclasses.replace(art), n, sampler=sampler, seed=seed,
                  pad_to=pad_to)


def solve_graphs(handles):
    """The ``graph`` attribute of each call's ``sample.solve`` span."""
    out = []
    for h in handles:
        solve, = [s for s in default_tracer().trace(h.trace_id)
                  if s.name == "sample.solve"]
        out.append(solve.attrs["graph"])
    return out


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

class _Entry:
    """Stands in for a captured graph (weak-referenceable)."""


def test_graphs_go_with_their_artifacts():
    art = make_artifacts("cpu", multi_output=True)
    entry = _Entry()
    solve_graph.graphs_of(art).put(("k",), lambda: entry)
    ref, key = weakref.ref(entry), id(art)
    del entry
    assert key in solve_graph._GRAPHS and ref() is not None
    del art
    gc.collect()
    assert key not in solve_graph._GRAPHS and ref() is None


def test_graphs_evict_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(solve_graph, "GRAPHS_PER_MODEL", 2)
    art = make_artifacts("cpu", multi_output=True)
    graphs = solve_graph.graphs_of(art)
    made = []

    def make(name):
        def f():
            made.append(name)
            return _Entry()
        return f

    graphs.put("a", make("a"))
    graphs.put("b", make("b"))
    graphs.put("a", make("a again"))       # kept: not made twice
    assert graphs.get("a") is not None     # "b" is now the oldest
    graphs.put("c", make("c"))
    assert made == ["a", "b", "c"]
    assert list(graphs.entries) == ["a", "c"]


def test_a_capture_records_its_launches_and_a_replay_adds_them():
    before = (forest_predict.launches, forest_predict.so_ring_launches)
    with recorded_launches() as rec:
        count_launch(forest_predict)
        count_launch(forest_predict, "so_ring_launches")
    assert (forest_predict.launches,
            forest_predict.so_ring_launches) == before
    assert rec == {(forest_predict, "launches"): 2,
                   (forest_predict, "so_ring_launches"): 1}
    try:
        add_launches(rec)
        add_launches(rec)
        assert (forest_predict.launches - before[0],
                forest_predict.so_ring_launches - before[1]) == (4, 2)
    finally:
        forest_predict.launches, forest_predict.so_ring_launches = before


class _EagerGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    captured solve eagerly."""

    def __init__(self, solve):
        self.solve = solve

    @classmethod
    def capture(cls, solve, x1, ts):
        return cls(solve)

    def use(self):
        return contextlib.nullcontext()

    def replay(self, x1):
        return self.solve(x1)


def served(handle, calls):
    """``(n, seed)`` requests served by ``handle`` one after another, in
    its bucket or past its largest; returns their sample handles."""
    sampler = handle.samplers[0]
    return [handle.generate_async(n, sampler, seed=s) for n, s in calls]


# the largest class holds half the rows: about 50 of 100 (bucket 64), about
# 1,000 of 2,000 (past it)
SERVED = [(100, 1), (2000, 2), (2000, 4), (100, 3)]


def check_served_rows(handle, calls, art):
    for h, (n, s) in zip(calls, SERVED):
        X, y = h.result()
        Xe, ye = eager(art, n, seed=s, pad_to=handle.bucket(n, s))
        np.testing.assert_array_equal(X, Xe)
        np.testing.assert_array_equal(y, ye)


def test_an_oversize_served_request_solves_eagerly(monkeypatch):
    """The serving plane pads a request to its bucket, and one past the
    largest bucket to its exact size without ``pad_to``: the oversize
    calls read ``eager`` and leave the bucket's graph in place. On the CPU
    the graph is a stand-in that solves eagerly, keyed as on a card."""
    key_of = solve_graph.graph_key
    monkeypatch.setattr(solve_graph, "graph_key",
                        lambda device, **kw: key_of("cuda", **kw))
    monkeypatch.setattr(solve_graph, "SolveGraph", _EagerGraph)
    art = make_artifacts("cpu", multi_output=True)
    handle = ModelHandle("m", art, device="cpu", buckets=(64,))
    assert [handle.padding(n, s) for n, s in SERVED] == [64, None, None, 64]
    assert handle.bucket(2000, 2) > 64
    calls = served(handle, SERVED)
    assert solve_graphs(calls) == ["capture", "eager", "eager", "replay"]
    entries = solve_graph.graphs_of(art).entries
    assert [k[:2] for k in entries] == [("euler", (N_Y, 64, P))]
    check_served_rows(handle, calls, art)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and "
                    "replayed on the card (pytest -m cuda there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("multi_output", [True, False], ids=["mo", "so"])
@pytest.mark.parametrize("bucket", [64, 1024])
@pytest.mark.parametrize("sampler", ["euler", "heun", "ddim"])
def test_replayed_rows_equal_eager_rows(card, sampler, bucket, multi_output):
    art = make_artifacts(card, multi_output=multi_output,
                         method="diffusion" if sampler == "ddim" else "flow")
    n = ROWS[bucket]
    calls = [sample_async(art, n, sampler=sampler, seed=s, pad_to=bucket)
             for s in (11, 11, 12)]
    got = [h.result() for h in calls]
    assert solve_graphs(calls) == ["capture", "replay", "replay"]
    for (X, y), s in zip(got, (11, 11, 12)):
        Xe, ye = eager(art, n, seed=s, pad_to=bucket, sampler=sampler)
        np.testing.assert_array_equal(X, Xe)
        np.testing.assert_array_equal(y, ye)
        assert np.isfinite(X).all()
    assert not np.array_equal(got[1][0], got[2][0])


@pytest.mark.cuda
def test_two_handles_in_flight_equal_their_eager_rows(card):
    art = make_artifacts(card, multi_output=True)
    sample(art, 2000, seed=1, pad_to=1024)          # captures
    h1 = sample_async(art, 2000, seed=21, pad_to=1024)
    h2 = sample_async(art, 1500, seed=22, pad_to=1024)
    assert solve_graphs([h1, h2]) == ["replay", "replay"]
    for h, n, s in ((h2, 1500, 22), (h1, 2000, 21)):
        X, y = h.result()
        Xe, ye = eager(art, n, seed=s, pad_to=1024)
        np.testing.assert_array_equal(X, Xe)
        np.testing.assert_array_equal(y, ye)


@pytest.mark.cuda
def test_a_call_on_another_stream_equals_its_eager_rows(card):
    art = make_artifacts(card, multi_output=False)
    h0 = sample_async(art, 2000, seed=1, pad_to=1024)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        h1 = sample_async(art, 2000, seed=31, pad_to=1024)
    h2 = sample_async(art, 2000, seed=32, pad_to=1024)
    assert solve_graphs([h0, h1, h2]) == ["capture", "replay", "replay"]
    for h, s in ((h0, 1), (h1, 31), (h2, 32)):
        np.testing.assert_array_equal(
            h.result()[0], eager(art, 2000, seed=s, pad_to=1024)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("multi_output", [True, False], ids=["mo", "so"])
def test_replays_count_the_launches_they_run(card, multi_output):
    """The capture's call counts its eager solve once (the capture runs
    nothing); each replay counts what an eager call counts, the summing
    launches by kind among them (p = 16: one TMA-fed summing launch a MO
    step, none for SO)."""
    art = make_artifacts(card, multi_output=multi_output)

    def counts():
        return np.array([forest_predict.launches,
                         forest_predict.so_ring_launches,
                         forest_predict.sum_tma_launches,
                         forest_predict.sum_plain_launches])

    c0 = counts()
    sample(dataclasses.replace(art), 100, seed=3, pad_to=64)
    c1 = counts()
    per_call = c1 - c0
    assert per_call[0] == N_T - 1
    assert list(per_call[2:]) == [(N_T - 1) * multi_output, 0]
    sample(art, 100, seed=3, pad_to=64)                 # eager + capture
    c2 = counts()
    assert list(c2 - c1) == list(per_call)
    replays = 5
    for s in range(replays):
        sample(art, 100, seed=s, pad_to=64)
    c3 = counts()
    assert list(c3 - c2) == list(replays * per_call)


@pytest.mark.cuda
def test_the_span_reads_capture_once_then_replay(card, monkeypatch):
    """Per key: ``capture``, then ``replay``; an unbucketed call and a
    stochastic sampler ``eager``. With one graph a model, the other
    bucket's capture evicts a key, which then captures anew."""
    monkeypatch.setattr(solve_graph, "GRAPHS_PER_MODEL", 1)
    flow = make_artifacts(card, multi_output=True)
    calls = [sample_async(flow, 100, seed=s, pad_to=64) for s in range(3)]
    calls.append(sample_async(flow, 100, seed=0))           # unbucketed
    calls += [sample_async(flow, 100, seed=0, pad_to=b)
              for b in (1024, 64, 1024, 1024)]
    diff = make_artifacts(card, multi_output=True, method="diffusion")
    calls += [sample_async(diff, 100, sampler="em", seed=s, pad_to=64)
              for s in range(2)]
    for h in calls:
        h.result()
    assert solve_graphs(calls) == [
        "capture", "replay", "replay", "eager", "capture", "capture",
        "capture", "replay", "eager", "eager"]
    # every call, replayed or not, ran one TMA-fed summing launch a step
    # (p = 16), as the launcher reported it: a replay its capture's
    for h in calls:
        solve, = [s for s in default_tracer().trace(h.trace_id)
                  if s.name == "sample.solve"]
        assert (solve.attrs["sum_tma"], solve.attrs["sum_plain"]) == (
            N_T - 1, 0)


@pytest.mark.cuda
def test_dropping_the_artifacts_frees_its_graphs(card):
    gc.collect()
    base = torch.cuda.memory_allocated(card)
    art = make_artifacts(card, multi_output=True)
    sample(art, 2000, seed=1, pad_to=1024)
    key = solve_graph.graph_key(art.device, sampler="euler",
                                stochastic=False, pad_to=1024,
                                shape=(N_Y, 1024, P))
    entry = solve_graph.lookup(art, key)
    assert entry is not None
    ref, ident = weakref.ref(entry), id(art)
    held = torch.cuda.memory_allocated(card)
    assert held - base >= 2 * entry.out.numel() * 4   # x1 and out at least
    del entry, art
    gc.collect()
    assert ref() is None and ident not in solve_graph._GRAPHS
    assert torch.cuda.memory_allocated(card) <= base


@pytest.mark.cuda
def test_an_oversize_served_request_leaves_the_bucket_graph(card):
    art = make_artifacts(card, multi_output=False)
    handle = ModelHandle("m", art, device=card, buckets=(64,))
    calls = served(handle, SERVED)
    assert solve_graphs(calls) == ["capture", "eager", "eager", "replay"]
    assert len(solve_graph.graphs_of(art).entries) == 1
    check_served_rows(handle, calls, art)
