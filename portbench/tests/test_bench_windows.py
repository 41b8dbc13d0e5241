"""End-to-end metrics are taken over every call of a window: a rate over
all the work and all the time, a tail over all latencies, never medians
of chunks."""
import numpy as np
import pytest

from harness import registry


def e2e(name):
    return registry.reader(registry.BENCH, "end_to_end", name)


class Ctx:
    def __init__(self, record):
        self.record = record
        self.trace = None
        self.shapes = {}


def test_p95_is_over_all_calls():
    lat = [0.030] * 90 + [0.050] * 10          # a slow tail of 10%
    got = e2e("gen_p95_ms").read(Ctx({"latencies_s": lat}))
    assert got == pytest.approx(1e3 * np.percentile(lat, 95))
    # the median of ten chunks' p95s would read 30 ms: the tail is lost
    chunks = [np.percentile(lat[i::10], 95) for i in range(10)]
    assert np.median(chunks) * 1e3 != pytest.approx(got)
    assert got == pytest.approx(50.0)


def test_rates_over_the_whole_window():
    record = {"rows": 7 * 120_000, "elapsed_s": 2.0,
              "calls": [{}] * 7}
    assert e2e("gen_rows_per_s").read(Ctx(record)) == 420_000.0
    fit = {"elapsed_s": 41.5, "ensembles": 15}
    assert e2e("fit_s_per_ensemble").read(Ctx(fit)) == pytest.approx(
        41.5 / 15)


def test_fit_peak_in_gb():
    assert e2e("fit_peak_gb").read(Ctx({"peak_bytes": 49_720_000_000})) \
        == pytest.approx(49.72)
