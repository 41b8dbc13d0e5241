"""The port's out-of-core data layer against the JAX package, on the CPU.

``repro_torch.data.sketch`` and ``repro_torch.data.store`` are numpy-only
copies: fed the same batches, they must write the same files with the same
fingerprint, class stats, labels and sketch, and each package must open a
store the other ingested. Crash-resume and the refusals are held as
``tests/test_data_store.py`` holds the JAX package's.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro.data import sketch as jsketch
from repro.data import store as jstore
from repro.data.tabular import synthetic_resource_batches as j_batches
from repro.forest.binning import fit_bins_streaming as j_fit_bins_streaming
from repro_torch.data import sketch as tsketch
from repro_torch.data import store as tstore
from repro_torch.data.calorimeter import generate_batches as t_calo
from repro_torch.data.tabular import (synthetic_resource_batches as t_batches,
                                      synthetic_resource_dataset)
from repro_torch.forest.binning import fit_bins_streaming
from repro_torch.obs import MetricsRegistry, Tracer


def _batches(X, y, k=20):
    for s in range(0, len(X), k):
        yield X[s:s + k], None if y is None else y[s:s + k]


def _files(directory):
    """Every file of a store with its bytes' digest (the manifest apart)."""
    return {f: hashlib.sha256(open(os.path.join(directory, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(directory))
            if f != "manifest.json"}


def _same_store(a, b):
    assert a.fingerprint == b.fingerprint
    assert a.manifest == b.manifest
    assert a.shape == b.shape and a.n_shards == b.n_shards
    for got, ref in zip(a.class_stats(), b.class_stats()):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(a.labels(), b.labels())
    np.testing.assert_array_equal(a[np.arange(a.n_rows)],
                                  b[np.arange(b.n_rows)])
    for mode in ("floor", "linear"):
        np.testing.assert_array_equal(a.edges(16, mode=mode),
                                      b.edges(16, mode=mode))


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_entries", [2048, 64])
def test_sketch_equals_jax_on_the_same_batches(max_entries):
    """Exact below max_entries, compressed above: the same state and the
    same edges either way, and a merge of two halves too."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(700, 4)).astype(np.float32)
    w = (rng.random(700) > 0.1).astype(np.float32)
    sketches = []
    for mod in (jsketch, tsketch):
        a = mod.QuantileSketch(4, max_entries)
        b = mod.QuantileSketch(4, max_entries)
        a.update(X[:300], w[:300])
        b.update(X[300:], w[300:])
        a.merge(b)
        sketches.append(a)
    js, ts = sketches
    for k, v in js.state_dict().items():
        np.testing.assert_array_equal(ts.state_dict()[k], v, err_msg=k)
    for n_bins in (8, 64):
        for mode in ("floor", "linear"):
            np.testing.assert_array_equal(ts.edges(n_bins, mode=mode),
                                          js.edges(n_bins, mode=mode))
    whole = [mod.sketch_dataset(X, w, max_entries=max_entries, row_chunk=128)
             for mod in (jsketch, tsketch)]
    np.testing.assert_array_equal(whole[1].edges(16), whole[0].edges(16))


def test_fit_bins_streaming_equals_jax():
    X = np.random.default_rng(1).normal(size=(500, 3)).astype(np.float32)
    want = np.asarray(j_fit_bins_streaming(X, 16, row_chunk=128))
    got = fit_bins_streaming(X, 16, row_chunk=128, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ingest: the same store from either package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labelled", [True, False])
def test_ingest_writes_the_jax_packages_store(tmp_path, labelled):
    """The same batches give byte-equal shard and stats files, the same
    manifest (fingerprint, class histogram) and the same reader views."""
    X, y = synthetic_resource_dataset(333, 5, 3, seed=4)
    y = y if labelled else None
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    js = jstore.ingest(_batches(X, y), jd, shard_rows=64,
                       source={"kind": "test"})
    ts = tstore.ingest(_batches(X, y), td, shard_rows=64,
                       source={"kind": "test"}, metrics=MetricsRegistry(),
                       tracer=Tracer())
    assert _files(jd) == _files(td)
    _same_store(ts, js)
    assert ts.has_labels == labelled


def test_ingest_metrics_render_as_the_jax_packages(tmp_path):
    """The port's copy of ``repro.obs``: the same instruments, counted by
    the same ingest, render the same Prometheus text (the commit-time
    histograms aside, whose values are durations)."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro.obs import Tracer as JTracer
    from repro.obs import render_prometheus as j_render
    from repro_torch.obs import render_prometheus
    X, y = synthetic_resource_dataset(300, 3, 2, seed=7)
    jm, tm = JRegistry(), MetricsRegistry()
    jstore.ingest(_batches(X, y), str(tmp_path / "j"), shard_rows=64,
                  metrics=jm, tracer=JTracer())
    tracer = Tracer()
    tstore.ingest(_batches(X, y), str(tmp_path / "t"), shard_rows=64,
                  metrics=tm, tracer=tracer)

    def counters(text):
        return [line for line in text.splitlines()
                if "commit_seconds" not in line]
    assert counters(render_prometheus(tm)) == counters(j_render(jm))
    assert len(tracer.spans(name="ingest.shard")) == 5


def test_each_package_opens_the_others_store(tmp_path):
    X, y = synthetic_resource_dataset(260, 4, 2, seed=5)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.ingest(_batches(X, y), jd, shard_rows=100)
    tstore.ingest(_batches(X, y), td, shard_rows=100)
    _same_store(tstore.DatasetStore(jd), jstore.DatasetStore(jd))
    _same_store(jstore.DatasetStore(td), tstore.DatasetStore(td))
    for a, b in zip(tstore.DatasetStore(jd).iter_batches(70),
                    jstore.DatasetStore(td).iter_batches(70)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_synthetic_sources_are_the_jax_packages_rows():
    for a, b in zip(t_batches(300, 4, 3, batch_rows=128, seed=2),
                    j_batches(300, 4, 3, batch_rows=128, seed=2)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    from repro.data.calorimeter import generate_batches as j_calo
    for a, b in zip(t_calo("photons_mini", 50, batch_rows=32, seed=1),
                    j_calo("photons_mini", 50, batch_rows=32, seed=1)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_append_equals_the_jax_packages_append(tmp_path):
    """A sealed store grows by an append in either package to the same
    files, manifest (version 2) and sketch."""
    X, y = synthetic_resource_dataset(300, 3, 2, seed=6)
    out = []
    for name, mod in (("jax", jstore), ("port", tstore)):
        d = str(tmp_path / name)
        base = mod.ingest(_batches(X[:200], y[:200]), d, shard_rows=64)
        out.append((d, base.append(_batches(X[200:], y[200:]),
                                   source="day2")))
    (jd, js), (td, ts) = out
    assert ts.version == 2 and ts.n_rows == 300
    assert _files(jd) == _files(td)
    _same_store(ts, js)


# ---------------------------------------------------------------------------
# crash-resume and refusals (as tests/test_data_store.py)
# ---------------------------------------------------------------------------

def test_ingest_refuses_dirty_dir_and_mismatched_fingerprint(tmp_path):
    d = str(tmp_path / "s")
    X, y = synthetic_resource_dataset(200, 3, 2, seed=0)
    tstore.ingest(_batches(X, y), d, shard_rows=64)
    with pytest.raises(ValueError, match="resume=True"):
        tstore.ingest(_batches(X, y), d, shard_rows=64)
    with pytest.raises(ValueError, match="mismatched"):
        tstore.ingest(_batches(X, y), d, shard_rows=32, resume=True)
    again = tstore.ingest(_batches(X, y), d, shard_rows=64, resume=True)
    assert again.n_rows == 200


def test_crash_resume_finishes_without_touching_committed_shards(tmp_path):
    """A crash leaves a committed prefix that readers refuse; the resume
    skips it without rewriting a shard, and the finished store is the one
    an uninterrupted ingest writes, and the JAX package's."""
    X, y = synthetic_resource_dataset(1000, 4, 3, seed=11)

    def batches(crash_after=None):
        for sent, s in enumerate(range(0, 1000, 96)):
            if crash_after is not None and sent >= crash_after:
                raise RuntimeError("simulated ingest crash")
            yield X[s:s + 96], y[s:s + 96]

    clean = tstore.ingest(batches(), str(tmp_path / "clean"), shard_rows=256)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="simulated"):
        tstore.ingest(batches(crash_after=5), crash_dir, shard_rows=256)
    man = json.load(open(os.path.join(crash_dir, "manifest.json")))
    assert man["complete"] is False and man["n_rows"] == 256
    with pytest.raises(ValueError, match="unfinished ingest"):
        tstore.DatasetStore(crash_dir)
    before = {f: d for f, d in _files(crash_dir).items()
              if f.startswith("shard_")}
    mtimes = {f: os.stat(os.path.join(crash_dir, f)).st_mtime_ns
              for f in before}
    # the JAX package finishes the port's crashed ingest as well
    jres = jstore.ingest(batches(), str(tmp_path / "jclean"), shard_rows=256)
    resumed = tstore.ingest(batches(), crash_dir, shard_rows=256,
                            resume=True)
    assert {f: d for f, d in _files(crash_dir).items() if f in before} == \
        before
    assert all(os.stat(os.path.join(crash_dir, f)).st_mtime_ns == t
               for f, t in mtimes.items())
    _same_store(resumed, clean)
    _same_store(resumed, jres)


def test_resume_refuses_short_stream(tmp_path):
    X, y = synthetic_resource_dataset(500, 3, 2, seed=12)
    d = str(tmp_path / "s")

    def half():
        yield X[:256], y[:256]
        raise RuntimeError("crash")

    with pytest.raises(RuntimeError):
        tstore.ingest(half(), d, shard_rows=128)
    with pytest.raises(ValueError, match="not the one"):
        tstore.ingest(iter([(X[:100], y[:100])]), d, shard_rows=128,
                      resume=True)


def test_append_crash_resume_and_refusals(tmp_path):
    X, y = synthetic_resource_dataset(400, 3, 2, seed=13)
    d = str(tmp_path / "s")
    base = tstore.ingest(_batches(X[:200], y[:200]), d, shard_rows=64)

    def more(crash=False):
        yield X[200:300], y[200:300]
        if crash:
            raise RuntimeError("crash")
        yield X[300:], y[300:]

    with pytest.raises(RuntimeError):
        base.append(more(crash=True), source="day2")
    reader = tstore.DatasetStore(d)            # still a complete store
    assert reader.version == 1 and reader.n_rows >= 200
    with pytest.raises(ValueError, match="unfinished append"):
        reader.append(more(), source="day2")
    with pytest.raises(ValueError, match="mixing two streams|mix two"):
        reader.append(more(), source="other", resume=True)
    grown = reader.append(more(), source="day2", resume=True)
    assert grown.version == 2 and grown.n_rows == 400
    np.testing.assert_array_equal(grown[np.arange(400)], X)
