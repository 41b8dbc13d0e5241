"""Out-of-core dataset store: columnar, row-sharded, memmap-able on disk.

The JAX package's store (``repro.data.store``), numpy only, in the same
on-disk format: a store ingested by either package opens in the other with
the same fingerprint, class stats, labels and sketch.

Layout of a store directory::

    manifest.json       fingerprint + shard table + class histogram
                        (atomic fsync'd tmp-rename — the GridManifest
                        discipline from repro_torch.train.checkpoint)
    stats_<k>.npz       per-class min/max scalers + the mergeable quantile
                        sketch state after the first k shards (the manifest
                        names the one consistent with its shard table)
    shard_00000.x.npy   feature rows [rows, p] fp32 — np.load(mmap_mode=..)
    shard_00000.y.npy   labels [rows] int64 (only for labelled sources)

:func:`ingest` builds a store from any row-batch iterator in **one pass**:
each committed shard atomically advances the manifest together with the
running statistics (class histogram, per-class min/max scalers, and a
:class:`~repro_torch.data.sketch.QuantileSketch` per feature), so the scalers and
quantile edges every fit needs are precomputed at write time and no reader
ever has to stream (let alone sort) the full dataset again.

Crash-resume: the manifest is only rewritten after a shard's files are
durably on disk, so any crash leaves a prefix of committed shards plus, at
worst, orphaned files the next attempt overwrites. ``ingest(...,
resume=True)`` replays the (deterministic) iterator, skips exactly the
committed rows — finished shard files are never re-read or re-written —
and refuses a manifest whose fingerprint does not match the new call.

Freshness: a sealed store is appendable. :meth:`DatasetStore.append` adds
shards from a new batch iterator under the same commit discipline, merges
the new rows into the class stats and quantile sketch
(:meth:`QuantileSketch.merge`), and bumps a monotonic manifest ``version``
on completion — the data half of the incremental refresh loop (append →
``extend_artifacts`` warm-start fit → live swap).

Memory model: ingest holds O(batch + shard) rows; a :class:`DatasetStore`
reader holds O(1) metadata plus whatever rows a caller asks for —
``store[rows]`` gathers only from the shards those rows live in, which is
what lets ``repro_torch.forest.distributed.build_row_shards`` stage per-device
slices straight from disk.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.data.sketch import QuantileSketch
from repro_torch.obs import default_registry, default_tracer
from repro_torch.train.checkpoint import (_fsync_replace,
                                         describe_fingerprint_mismatch)

FORMAT_VERSION = 1
MANIFEST = "manifest.json"


def _shard_base(i: int) -> str:
    return f"shard_{i:05d}"


def _write_npy_atomic(directory: str, name: str, arr: np.ndarray) -> str:
    final = os.path.join(directory, name)
    tmp = os.path.join(directory, f".tmp_{name}")
    with open(tmp, "wb") as f:
        np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                  allow_pickle=False)
    _fsync_replace(tmp, final)
    return final


def _write_npz_atomic(directory: str, name: str, arrays: dict) -> str:
    final = os.path.join(directory, name)
    tmp = os.path.join(directory, f".tmp_{name}")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    _fsync_replace(tmp, final)
    return final


def _write_manifest(directory: str, payload: dict) -> None:
    tmp = os.path.join(directory, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    _fsync_replace(tmp, os.path.join(directory, MANIFEST))


def _read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class _ClassStats:
    """Streaming class histogram + per-class min/max scalers. Matches
    :func:`repro_torch.tabgen.fitting.class_stats_streaming` exactly (min/max and
    counts are associative, so chunking never changes the result)."""

    def __init__(self, p: int):
        self.p = p
        self.classes = np.empty((0,), np.int64)
        self.counts = np.empty((0,), np.int64)
        self.mins = np.empty((0, p), np.float32)
        self.maxs = np.empty((0, p), np.float32)

    def update(self, X: np.ndarray, y: np.ndarray) -> None:
        y = np.asarray(y, np.int64)
        new = np.setdiff1d(np.unique(y), self.classes)
        if len(new):
            merged = np.union1d(self.classes, new)
            remap = np.searchsorted(merged, self.classes)
            counts = np.zeros(len(merged), np.int64)
            mins = np.full((len(merged), self.p), np.inf, np.float32)
            maxs = np.full((len(merged), self.p), -np.inf, np.float32)
            counts[remap] = self.counts
            mins[remap] = self.mins
            maxs[remap] = self.maxs
            self.classes, self.counts, self.mins, self.maxs = (
                merged, counts, mins, maxs)
        cid = np.searchsorted(self.classes, y)
        xb = np.asarray(X, np.float32)
        for i in np.unique(cid):
            sel = xb[cid == i]
            self.counts[i] += len(sel)
            self.mins[i] = np.minimum(self.mins[i], sel.min(axis=0))
            self.maxs[i] = np.maximum(self.maxs[i], sel.max(axis=0))

    def state_dict(self) -> dict:
        return {"classes": self.classes, "counts": self.counts,
                "mins": self.mins, "maxs": self.maxs}

    @classmethod
    def from_state(cls, state, p: int) -> "_ClassStats":
        st = cls(p)
        st.classes = np.asarray(state["classes"], np.int64)
        st.counts = np.asarray(state["counts"], np.int64)
        st.mins = np.asarray(state["mins"], np.float32)
        st.maxs = np.asarray(state["maxs"], np.float32)
        return st


class DatasetStore:
    """Reader for an ingested store — array-like enough for the trainers.

    Exposes ``shape`` / ``dtype`` / ``len()`` / row indexing (slices and
    fancy integer arrays, always returning materialised fp32 row copies),
    so :func:`repro_torch.forest.distributed.build_row_shards` treats it exactly
    like the host ndarray it replaces while touching only the shards a row
    slice actually lives in (memmap reads, no full-dataset residency).
    """

    def __init__(self, directory: str):
        man = _read_manifest(directory)
        if man is None:
            raise FileNotFoundError(f"no {MANIFEST} in {directory} — not a "
                                    "dataset store (run repro_torch.launch.ingest)")
        if man.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(f"store at {directory} uses a newer format "
                             f"({man['format_version']} > {FORMAT_VERSION})")
        if not man.get("complete"):
            raise ValueError(
                f"store at {directory} is an unfinished ingest "
                f"({man.get('n_rows', 0)} rows committed); finish it with "
                "ingest(batches, directory, resume=True)")
        self.directory = directory
        self.manifest = man
        self.fingerprint = man["fingerprint"]
        self._shard_rows = np.asarray([s["rows"] for s in man["shards"]],
                                      np.int64)
        self._starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(self._shard_rows)])
        self.n_rows = int(self._starts[-1])
        self.p = int(self.fingerprint["p"])
        self.has_labels = self.fingerprint.get("label_dtype") is not None
        self._stats_cache: Optional[dict] = None
        self._labels_cache: Optional[np.ndarray] = None

    # -- array-like surface -------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.p)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    @property
    def ndim(self) -> int:
        return 2

    def __len__(self) -> int:
        return self.n_rows

    @property
    def n_shards(self) -> int:
        return len(self._shard_rows)

    @property
    def version(self) -> int:
        """Monotonic store version: 1 after the initial ingest, +1 per
        completed :meth:`append` — what model lineage records so a serving
        host can tell which data vintage a model was fit on."""
        return int(self.manifest.get("version", 1))

    @property
    def nbytes(self) -> int:
        """On-disk feature bytes (what in-memory residency would cost)."""
        return self.n_rows * self.p * 4

    # -- shard access -------------------------------------------------------

    def _path(self, i: int, kind: str) -> str:
        return os.path.join(self.directory, f"{_shard_base(i)}.{kind}.npy")

    def shard_x(self, i: int, mmap: bool = True) -> np.ndarray:
        """Feature rows of shard ``i`` (a read-only memmap by default)."""
        return np.load(self._path(i, "x"), mmap_mode="r" if mmap else None)

    def shard_y(self, i: int) -> Optional[np.ndarray]:
        if not self.has_labels:
            return None
        return np.load(self._path(i, "y"))

    def labels(self) -> np.ndarray:
        """All labels ``[n]`` int64 (zeros when unlabelled) — O(n) host
        metadata, 8 bytes/row; the fp32 features stay on disk."""
        if self._labels_cache is None:
            if not self.has_labels:
                self._labels_cache = np.zeros((self.n_rows,), np.int64)
            else:
                self._labels_cache = np.concatenate(
                    [self.shard_y(i) for i in range(self.n_shards)])
        return self._labels_cache

    def take(self, rows) -> np.ndarray:
        """Gather arbitrary global rows ``[k, p]`` fp32, reading only the
        shards those rows live in (grouped per shard, order preserved)."""
        rows = np.asarray(rows, np.int64)
        out = np.empty((len(rows), self.p), np.float32)
        shard_of = np.searchsorted(self._starts, rows, side="right") - 1
        for s in np.unique(shard_of):
            sel = shard_of == s
            # plain (non-mmap) shard read: one shard-sized buffer at a time
            # that is freed on return, so peak RSS stays O(gather + shard) —
            # memmap page faults would pin every touched page in ru_maxrss
            arr = self.shard_x(int(s), mmap=False)
            out[sel] = arr[rows[sel] - self._starts[s]]
            del arr
        return out

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, (int, np.integer)):
            return self.take([int(key)])[0]
        if isinstance(key, slice):
            start, stop, step = key.indices(self.n_rows)
            return self.take(np.arange(start, stop, step, dtype=np.int64))
        return self.take(key)

    def iter_batches(self, batch_rows: int = 65536
                     ) -> Iterable[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Stream ``(X, y)`` row batches shard by shard (y ``None`` when
        unlabelled) — the round-trip twin of the ingest input."""
        for i in range(self.n_shards):
            xs = self.shard_x(i)
            ys = self.shard_y(i)
            for s in range(0, xs.shape[0], batch_rows):
                xb = np.asarray(xs[s:s + batch_rows], np.float32)
                yield xb, None if ys is None else ys[s:s + batch_rows]

    # -- precomputed statistics --------------------------------------------

    def _stats(self) -> dict:
        if self._stats_cache is None:
            path = os.path.join(self.directory, self.manifest["stats"])
            with np.load(path) as data:
                self._stats_cache = {k: data[k] for k in data.files}
        return self._stats_cache

    def class_stats(self):
        """``(classes, counts, mins, maxs)`` — equal to what
        :func:`repro_torch.tabgen.fitting.class_stats_streaming` would compute
        over the materialised rows, but read from the manifest instead of
        re-streamed (the fit-time stats pass disappears)."""
        st = self._stats()
        return (np.asarray(st["classes"], np.int64),
                np.asarray(st["counts"], np.int64),
                np.asarray(st["mins"], np.float32),
                np.asarray(st["maxs"], np.float32))

    @property
    def sketch(self) -> QuantileSketch:
        """The dataset-level per-feature quantile sketch built at ingest."""
        return QuantileSketch.from_state(self._stats())

    def edges(self, n_bins: int, mode: str = "floor") -> np.ndarray:
        """Precomputed global bin edges ``[p, n_bins - 1]`` from the ingest
        sketch — the out-of-core replacement for sorting full columns (see
        :func:`repro_torch.forest.binning.fit_bins_streaming`)."""
        return self.sketch.edges(n_bins, mode=mode)

    # -- incremental append -------------------------------------------------

    def append(self, batches, *, source=None, resume: bool = False,
               metrics=None, tracer=None) -> "DatasetStore":
        """Add shards from a new batch iterator to this sealed store.

        The freshness-loop writer: new rows commit as additional shards
        under the same fsync/tmp-rename discipline as :func:`ingest`, each
        shard's rows folded into the running class stats and merged into
        the dataset-level quantile sketch (a per-shard
        :class:`~repro_torch.data.sketch.QuantileSketch` absorbed via
        :meth:`~repro_torch.data.sketch.QuantileSketch.merge` — the same path a
        parallel ingest combines writers with). The store stays a valid,
        readable, *complete* store throughout: concurrent readers opened
        before or during an append see a consistent committed prefix.

        Versioning: a durable ``append`` marker (recording the base row
        count and this call's ``source``) lands in the manifest before the
        first new row is consumed; the final commit drops the marker and
        bumps the manifest ``version`` (1 after ingest, +1 per completed
        append). A crash mid-append leaves the marker plus a prefix of
        committed shards — ``append(batches, resume=True)`` replays the
        deterministic iterator, skips exactly the committed new rows, and
        finishes the version bump. Resuming when no append is in flight is
        a no-op returning a fresh reader (the retry-after-success case).

        Returns a **new** :class:`DatasetStore` reader over the grown
        store; ``self`` keeps serving the pre-append row count.
        """
        _m = metrics or default_registry()
        _t = tracer or default_tracer()
        c_rows = _m.counter("ingest_rows", "Rows committed to dataset stores")
        c_shards = _m.counter("ingest_shards",
                              "Shards durably committed (manifest advanced)")
        c_batches = _m.counter("ingest_batches",
                               "Source batches consumed (after resume skip)")
        h_commit = _m.histogram(
            "ingest_shard_commit_seconds",
            "Per-shard commit time: shard files + stats + manifest "
            "(ingest.shard span durations)")

        directory = self.directory
        man = _read_manifest(directory)
        marker = man.get("append")
        if marker is not None and not resume:
            raise ValueError(
                f"store at {directory} has an unfinished append "
                f"({man['n_rows'] - marker['base_rows']} of its rows "
                "committed); finish it with append(batches, resume=True) "
                "or re-ingest into a fresh directory")
        if marker is None and resume:
            return DatasetStore(directory)   # append already completed
        if marker is not None and marker.get("source") != source:
            raise ValueError(
                f"append at {directory} was started with source="
                f"{marker.get('source')!r} but this resume passes "
                f"{source!r}; resuming would mix two streams")

        fingerprint = man["fingerprint"]
        p = int(fingerprint["p"])
        has_labels = fingerprint.get("label_dtype") is not None
        shard_rows = int(fingerprint["shard_rows"])
        sketch_entries = int(fingerprint["sketch_entries"])
        if marker is None:
            marker = {"source": source, "base_rows": int(man["n_rows"]),
                      "base_version": int(man.get("version", 1))}

        stats_path = os.path.join(directory, man["stats"])
        with np.load(stats_path) as data:
            state = {k: data[k] for k in data.files}
        sketch = QuantileSketch.from_state(state)
        cstats = _ClassStats.from_state(state, p)
        shards = list(man["shards"])
        skip = int(man["n_rows"]) - int(marker["base_rows"])

        def _commit_inner(xs, ys, final):
            i = len(shards)
            if len(xs):
                _write_npy_atomic(directory, f"{_shard_base(i)}.x.npy", xs)
                if ys is not None:
                    _write_npy_atomic(directory, f"{_shard_base(i)}.y.npy",
                                      ys)
                batch_sk = QuantileSketch(p, sketch_entries)
                batch_sk.update(xs)
                sketch.merge(batch_sk)
                cstats.update(xs, ys if ys is not None
                              else np.zeros(len(xs), np.int64))
                shards.append({"rows": int(len(xs))})
            stats_name = _stats_name(len(shards))
            _write_npz_atomic(directory, stats_name,
                              dict(sketch.state_dict(),
                                   **cstats.state_dict()))
            payload = {
                "format_version": FORMAT_VERSION,
                "fingerprint": fingerprint,
                "complete": True,
                "version": (marker["base_version"] + 1 if final
                            else marker["base_version"]),
                "n_rows": int(sum(s["rows"] for s in shards)),
                "n_classes": int(len(cstats.classes)),
                "class_histogram": {str(c): int(n) for c, n in
                                    zip(cstats.classes, cstats.counts)},
                "shards": shards,
                "stats": stats_name,
            }
            if not final:
                payload["append"] = marker
            _write_manifest(directory, payload)
            if len(xs):   # drop the superseded stats snapshot (best-effort)
                prev = os.path.join(directory, _stats_name(len(shards) - 1))
                if os.path.exists(prev) and prev != stats_path:
                    os.unlink(prev)

        def _commit(xs, ys, final):
            with _t.span("ingest.shard", shard=len(shards),
                         rows=int(len(xs)), complete=final) as sp:
                _commit_inner(xs, ys, final)
            h_commit.observe(sp.duration_s)
            if len(xs):
                c_rows.inc(int(len(xs)))
                c_shards.inc(1)

        with _t.span("store.append", base_rows=marker["base_rows"],
                     base_version=marker["base_version"], resume=resume):
            if not resume:
                # durable in-flight marker *before* any new row lands: every
                # crash state is either resumable or trivially retryable
                _write_manifest(directory, dict(man, append=marker))
            buf_x, buf_y, buffered = [], [], 0
            for b in batches:
                xb, yb = _norm_batch(b, p, has_labels)
                if skip:
                    take = min(skip, len(xb))
                    skip -= take
                    xb = xb[take:]
                    yb = None if yb is None else yb[take:]
                    if not len(xb):
                        continue
                c_batches.inc(1)
                buf_x.append(xb)
                if yb is not None:
                    buf_y.append(yb)
                buffered += len(xb)
                while buffered >= shard_rows:
                    xs = np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0]
                    ys = ((np.concatenate(buf_y) if len(buf_y) > 1
                           else buf_y[0]) if has_labels else None)
                    _commit(xs[:shard_rows],
                            None if ys is None else ys[:shard_rows],
                            final=False)
                    buf_x = [xs[shard_rows:]] if len(xs) > shard_rows else []
                    buf_y = (([ys[shard_rows:]] if len(ys) > shard_rows
                              else []) if has_labels else [])
                    buffered -= shard_rows
            if skip:
                raise ValueError(
                    f"append resume expected at least {skip} more rows from "
                    "the iterator than it produced — the stream is not the "
                    "one this append started with")
            xs = (np.concatenate(buf_x) if len(buf_x) > 1
                  else (buf_x[0] if buf_x else np.empty((0, p), np.float32)))
            ys = None
            if has_labels:
                ys = (np.concatenate(buf_y) if len(buf_y) > 1
                      else (buf_y[0] if buf_y else np.empty((0,), np.int64)))
            _commit(xs, ys, final=True)
        return DatasetStore(directory)


# ---------------------------------------------------------------------------
# ingest writer
# ---------------------------------------------------------------------------

def _norm_batch(b, p: Optional[int], has_labels: Optional[bool]):
    """Normalise one iterator item to ``(X fp32 [k, p], y int64 [k]|None)``
    and validate it against the stream's established shape/labelledness."""
    if isinstance(b, tuple):
        X, y = b
    else:
        X, y = b, None
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"batch must be [rows, p], got shape {X.shape}")
    if p is not None and X.shape[1] != p:
        raise ValueError(f"batch has p={X.shape[1]}, stream started with "
                         f"p={p}")
    if has_labels is not None and (y is not None) != has_labels:
        raise ValueError("stream mixes labelled and unlabelled batches")
    return (X.astype(np.float32, copy=False),
            None if y is None else np.asarray(y, np.int64))


def _stats_name(n_shards: int) -> str:
    return f"stats_{n_shards:05d}.npz"


def ingest(batches, directory: str, *, shard_rows: int = 65536,
           resume: bool = False, source=None,
           sketch_entries: int = 2048,
           metrics=None, tracer=None) -> DatasetStore:
    """Write a :class:`DatasetStore` from a row-batch iterator in one pass.

    ``batches`` yields ``X [k, p]`` arrays or ``(X, y)`` tuples (any ``k``;
    rows are re-chunked into ``shard_rows``-row shards). Per committed
    shard, the running class stats and quantile sketch advance and are
    durably written *before* the manifest that references them, so the
    manifest is always consistent with some prefix of the stream.

    ``resume=True`` continues a crashed ingest: the (deterministic)
    iterator is replayed, rows already committed are skipped without
    touching their shard files, and a fingerprint mismatch (different
    ``shard_rows`` / ``sketch_entries`` / ``source`` / schema) refuses
    loudly rather than mixing two streams. Resuming a complete store is a
    no-op returning the reader.

    ``source`` is an arbitrary JSON-serialisable description fingerprinted
    into the manifest (e.g. the CLI's generator spec) so a resume can only
    ever continue the stream it started with.

    Each shard commit runs under an ``ingest.shard`` span and advances
    ``ingest_rows`` / ``ingest_shards`` / ``ingest_batches`` counters plus
    an ``ingest_shard_commit_seconds`` histogram on ``metrics`` /
    ``tracer`` (default: the process-wide :func:`repro_torch.obs.default_registry`
    / :func:`repro_torch.obs.default_tracer`, which ``repro_torch.launch.ingest
    --metrics-dump`` renders at exit).
    """
    _m = metrics or default_registry()
    _t = tracer or default_tracer()
    c_rows = _m.counter("ingest_rows", "Rows committed to dataset stores")
    c_shards = _m.counter("ingest_shards",
                          "Shards durably committed (manifest advanced)")
    c_batches = _m.counter("ingest_batches",
                           "Source batches consumed (after resume skip)")
    h_commit = _m.histogram(
        "ingest_shard_commit_seconds",
        "Per-shard commit time: shard files + stats + manifest "
        "(ingest.shard span durations)")

    os.makedirs(directory, exist_ok=True)
    existing = _read_manifest(directory)
    if existing is not None and not resume:
        raise ValueError(
            f"{directory} already holds a "
            f"{'complete store' if existing.get('complete') else 'partial ingest'}"
            " — pass resume=True to continue it, or use a fresh directory")

    it = iter(batches)
    try:
        first = _norm_batch(next(it), None, None)
    except StopIteration:
        raise ValueError("ingest got an empty batch iterator") from None
    p = first[0].shape[1]
    has_labels = first[1] is not None
    fingerprint = {
        "p": int(p),
        "dtype": "float32",
        "label_dtype": "int64" if has_labels else None,
        "shard_rows": int(shard_rows),
        "sketch_entries": int(sketch_entries),
        "source": source,
    }

    if existing is not None:
        stale = existing.get("fingerprint")
        if stale != fingerprint:
            raise ValueError(
                f"ingest at {directory} was started under a mismatched "
                "configuration; resuming would mix two streams. Use a "
                "fresh directory to re-ingest.\n"
                + describe_fingerprint_mismatch(stale, fingerprint,
                                                stale_name="store",
                                                new_name="requested"))
        if existing.get("complete"):
            return DatasetStore(directory)
        shards = list(existing["shards"])
        stats_path = os.path.join(directory, existing["stats"])
        with np.load(stats_path) as data:
            state = {k: data[k] for k in data.files}
        sketch = QuantileSketch.from_state(state)
        cstats = _ClassStats.from_state(state, p)
    else:
        shards = []
        sketch = QuantileSketch(p, sketch_entries)
        cstats = _ClassStats(p)

    skip = int(sum(s["rows"] for s in shards))

    def _commit(xs: np.ndarray, ys: Optional[np.ndarray], complete: bool):
        """One atomic step: shard files -> stats -> manifest."""
        with _t.span("ingest.shard", shard=len(shards), rows=int(len(xs)),
                     complete=complete) as sp:
            _commit_inner(xs, ys, complete)
        h_commit.observe(sp.duration_s)
        if len(xs):
            c_rows.inc(int(len(xs)))
            c_shards.inc(1)

    def _commit_inner(xs, ys, complete):
        i = len(shards)
        if len(xs):
            _write_npy_atomic(directory, f"{_shard_base(i)}.x.npy", xs)
            if ys is not None:
                _write_npy_atomic(directory, f"{_shard_base(i)}.y.npy", ys)
            sketch.update(xs)
            cstats.update(xs, ys if ys is not None
                          else np.zeros(len(xs), np.int64))
            shards.append({"rows": int(len(xs))})
        stats_name = _stats_name(len(shards))
        state = dict(sketch.state_dict(), **cstats.state_dict())
        _write_npz_atomic(directory, stats_name, state)
        n_rows = int(sum(s["rows"] for s in shards))
        _write_manifest(directory, {
            "format_version": FORMAT_VERSION,
            "fingerprint": fingerprint,
            "complete": complete,
            "n_rows": n_rows,
            "n_classes": int(len(cstats.classes)),
            "class_histogram": {str(c): int(n) for c, n in
                                zip(cstats.classes, cstats.counts)},
            "shards": shards,
            "stats": stats_name,
        })
        if len(xs):   # drop the superseded stats snapshot (best-effort)
            prev = os.path.join(directory, _stats_name(len(shards) - 1))
            if os.path.exists(prev):
                os.unlink(prev)

    def stream():
        yield first
        for b in it:
            yield _norm_batch(b, p, has_labels)

    buf_x, buf_y, buffered = [], [], 0
    for xb, yb in stream():
        if skip:
            take = min(skip, len(xb))
            skip -= take
            xb = xb[take:]
            yb = None if yb is None else yb[take:]
            if not len(xb):
                continue
        c_batches.inc(1)
        buf_x.append(xb)
        if yb is not None:
            buf_y.append(yb)
        buffered += len(xb)
        while buffered >= shard_rows:
            xs = np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0]
            ys = (np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]) \
                if has_labels else None
            _commit(xs[:shard_rows],
                    None if ys is None else ys[:shard_rows], complete=False)
            buf_x = [xs[shard_rows:]] if len(xs) > shard_rows else []
            buf_y = ([ys[shard_rows:]] if len(ys) > shard_rows else []) \
                if has_labels else []
            buffered -= shard_rows
    if skip:
        raise ValueError(
            f"resume expected at least {skip} more rows from the iterator "
            "than it produced — the stream is not the one this ingest "
            "started with")
    # final (possibly partial) shard + the completing manifest write
    xs = (np.concatenate(buf_x) if len(buf_x) > 1
          else (buf_x[0] if buf_x else np.empty((0, p), np.float32)))
    ys = None
    if has_labels:
        ys = (np.concatenate(buf_y) if len(buf_y) > 1
              else (buf_y[0] if buf_y else np.empty((0,), np.int64)))
    _commit(xs, ys, complete=True)
    return DatasetStore(directory)
