"""The ``pions-generate`` cell's pieces on the CPU: its entries and files,
found by name as the card's runs find them, and its new reader,
``tree_sum_plain_pct``: the plain summing kernel's share of the
multi-output summing launches of a traced window, read from the
``sum_tma`` / ``sum_plain`` attributes of the program's ``sample.solve``
spans, on hand-made spans, and from the device trace's kernel names for a
program whose spans lack the attributes."""
import json
import os
import types

import pytest

import repro_torch.obs as obs
from harness import registry

from conftest import BENCH, REPO
from test_bench_program_spans import Ring


def test_the_pions_cell_resolves():
    """``pions-generate``: its configuration (the pions width, 533, whose
    leaf rows are not 16-byte aligned, nothing reduced), the photons mix it
    reuses, limits as photons-generate's, and a reader for every metric it
    reports."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        man = json.load(f)
    cell = registry.workload(man, "pions-generate")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "caloforest-pions", "generate-120k-inflight2", 1)
    entry, = [c for c in man["configs"] if c["name"] == cell["config"]]
    assert entry["reduced"] == []
    assert entry["file"] == "portbench/configs/caloforest-pions.json"
    cfg = registry.config(BENCH, cell["config"])
    assert cfg["source"] == entry["source"]
    assert cfg["p"] == 533 and cfg["p"] % 4 and cfg["reduced"] == {}
    assert cfg["forest"]["multi_output"] and cfg["n_classes"] == 15
    assert registry.mix(BENCH, cell["traffic"])["driver"] == "generate"
    assert registry.limits(BENCH, "pions-generate") == registry.limits(
        BENCH, "photons-generate")
    reported = (registry.metrics_of(man, "end_to_end", "pions-generate")
                + registry.metrics_of(man, "per_layer", "pions-generate"))
    assert {m["name"] for m in reported} == {
        "gen_rows_per_s", "setup_s", "tree_predict_roofline.pions",
        "gen_mfu_pct.pions", "device_idle_pct.pions",
        "result_finish_ms.pions", "tree_sum_plain_pct.pions"}
    for m in reported:
        if m["name"] != "setup_s":
            kind = "end_to_end" if m in man["end_to_end"] else "metrics"
            assert callable(registry.reader(BENCH, kind, m["name"]).read)

# the summing kernels as the profiler names them
PLAIN_OP = ("void (anonymous namespace)::sum_kernel<5, true>(float const*, "
            "unsigned short const*, float*, int, int, int, int, int, int, "
            "int, int, int, int)")
TMA_OP = ("void (anonymous namespace)::sum_tma_kernel<5, 8, 1>(CUtensorMap, "
          "unsigned short const*, float*, int, int, int, int, int, int, int, "
          "int, int, int)")
OTHER_OPS = [("void at::native::cumsum_kernel<float>(float*)", 0.5),
             ("void (anonymous namespace)::route_kernel<true, true>()", 0.2)]


class Ctx:
    def __init__(self, calls, device_ops=(), trace=True):
        self.record = {"calls": [{}] * calls}
        self.trace = types.SimpleNamespace(
            device_ops=list(device_ops)) if trace else None
        self.shapes = {}


def reader():
    return registry.reader(registry.BENCH, "metrics",
                           "tree_sum_plain_pct.pions")


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setitem(obs._defaults, "tracer", r)
    return r


def solves(ring, *counts):
    """One ``sample.solve`` a call, ``(sum_tma, sum_plain)`` each, or
    ``None`` for a solve without the attributes."""
    for c in counts:
        attrs = {} if c is None else {"sum_tma": c[0], "sum_plain": c[1]}
        ring.add("sample.solve", 0.001, steps=99, **attrs)


def test_the_reader_is_found_by_its_base_name():
    assert registry.reader_path(registry.BENCH, "metrics",
                                "tree_sum_plain_pct.pions").endswith(
        "tree_sum_plain_pct.py")


@pytest.mark.parametrize("counts, want", [
    ([(0, 99), (0, 99)], 100.0),          # pions: 533 outputs, unaligned
    ([(99, 0), (99, 0), (99, 0)], 0.0),   # photons: 368 outputs, TMA
    ([(99, 0), (0, 99), (1, 98)], 100.0 * 197 / 297),
])
def test_the_share_of_plain_launches(ring, counts, want):
    solves(ring, (5, 5), (7, 0))          # older calls, outside the window
    solves(ring, *counts)
    got = reader().read(Ctx(len(counts), [(TMA_OP, 9.0)]))
    assert got == pytest.approx(want)


def test_nothing_to_read(ring):
    """No trace, a ring short of the window's calls, or solves that report
    no summing launch (an SO model, the CPU) read nothing."""
    solves(ring, (0, 99), (0, 99))
    assert reader().read(Ctx(2, trace=False)) is None
    assert reader().read(Ctx(3)) is None
    ring.made.clear()
    solves(ring, (0, 0), (0, 0))
    assert reader().read(Ctx(2, [(PLAIN_OP, 1.0)])) is None


def test_without_the_attributes_nothing_is_read_but_the_trace(ring):
    """A program older than the attributes reads nothing from its spans;
    its traced run is read from the summing kernels' device time by name
    (not ``cumsum_kernel``, not the routing kernel), and reads nothing
    where the trace holds neither summing kernel."""
    solves(ring, None, None)
    assert reader().read(Ctx(2, OTHER_OPS)) is None
    assert reader().read(Ctx(2, OTHER_OPS + [(PLAIN_OP, 3.0)])) == 100.0
    assert reader().read(Ctx(2, OTHER_OPS + [(TMA_OP, 3.0)])) == 0.0
    assert reader().read(Ctx(2, [(PLAIN_OP, 1.0), (TMA_OP, 3.0)])) == 25.0
    solves(ring, (0, 99))                # one solve of two with them
    assert reader().read(Ctx(2, [(TMA_OP, 3.0)])) == 0.0
