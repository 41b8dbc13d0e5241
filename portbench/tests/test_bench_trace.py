"""The reading of a trace: busy time as the union of device intervals in
the window, idle gaps labelled by the innermost span the host was in, and
the per-layer readers on a synthetic trace."""
import pytest

from harness import registry
from harness.trace import Trace, label_gaps, merge


def test_merge_clips_and_unites():
    assert merge([(5, 7), (0, 2), (1, 3), (9, 12)], 1, 10) == [
        (1, 3), (5, 7), (9, 10)]


def test_gaps_by_innermost_span():
    busy = [(2, 4), (6, 7)]
    ranges = [(0, 10, "bench.call"), (4, 5, "bench.best_splits")]
    got = dict(label_gaps(busy, 0, 10, ranges))
    # 0-2 and 7-10 in bench.call only; 4-6 starts inside best_splits
    assert got == {"bench.call": 5, "bench.best_splits": 2}


class Ctx:
    def __init__(self, trace, record, shapes):
        self.trace, self.record, self.shapes = trace, record, shapes


def per_layer(name):
    return registry.reader(registry.BENCH, "metrics", name)


def test_readers_on_a_synthetic_trace():
    tr = Trace(window_s=10.0, busy_s=9.0, n_kernels=990,
               spans={"bench.hist": [(0.1, 2.0)] * 3,
                      "bench.best_splits": [(0.1, 0.5)] * 2,
                      "bench.result": [(0.2, 0.0), (0.1, 0.0)]},
               device_ops=[], idle_gaps=[])
    shapes = {"hist_shapes": [(160_000, 368, 368, 1, 64, 64, 4, 1)] * 3}
    rec = {"ensembles": 3, "calls": [{}] * 10, "elapsed_s": 10.0,
           "hist_launches": 160, "latencies_s": [0.03] * 10}
    ctx = Ctx(tr, rec, shapes)
    assert per_layer("device_idle_pct.fit").read(ctx) == pytest.approx(10.0)
    assert per_layer("best_splits_ms_per_ensemble").read(ctx) == \
        pytest.approx(1e3 * 1.0 / 3)
    assert per_layer("hist_launches_per_ensemble").read(ctx) == \
        pytest.approx(160 / 3)
    roof = per_layer("hist_roofline").read(ctx)
    assert roof == pytest.approx(100 * 3 * 2.697e9 / 3.35e12 / 6.0,
                                 rel=1e-3)
    assert per_layer("kernels_per_call.latency").read(ctx) == 99.0
    assert per_layer("host_result_ms.gen").read(ctx) == pytest.approx(150.0)


def test_readers_find_nothing_without_a_trace():
    ctx = Ctx(None, {"ensembles": 1, "calls": [{}], "elapsed_s": 1.0,
                     "hist_launches": 0, "latencies_s": [0.1]}, {})
    for m in ("hist_roofline", "tree_predict_roofline",
              "fit_mfu_pct", "gen_mfu_pct", "device_idle_pct.gen",
              "best_splits_ms_per_ensemble", "hist_launches_per_ensemble"):
        assert per_layer(m).read(ctx) is None
