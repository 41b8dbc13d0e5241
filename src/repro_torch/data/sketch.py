"""Mergeable weighted quantile sketches — the host-side QuantileDMatrix half.

A numpy-only copy of ``repro.data.sketch``: the same state, the same edges.

:class:`QuantileSketch` summarises per-feature value distributions from
streamed row batches: updates cost ``O(batch log batch)``, two sketches
merge (concat + compress), and the summary answers the two quantile queries
the forest code path uses —

* ``mode="floor"``  — :func:`repro_torch.tabgen.fitting.weighted_edges` semantics:
  the value at rank ``floor(q * (W - 1))`` over the positive-weight rows
  (zero-weight rows are excluded entirely, matching the padded-row masking);
* ``mode="linear"`` — ``np.quantile`` semantics (the JAX package's
  ``fit_bins``): linear interpolation between adjacent ranks.

Exactness contract: while a sketch holds at most ``max_entries`` distinct
points it is *exact* — both modes reproduce the reference functions
bit-for-bit (the rank arithmetic deliberately mirrors their float32
rounding). Past that it compresses to ``max_entries`` summary entries by
picking values at evenly spaced cumulative-weight positions (the XGBoost
approx-sketch merge-and-prune scheme), adding a rank error of at most
``total_weight / max_entries`` per compression.

Built for :mod:`repro_torch.data.store`: the ingest writer keeps one sketch per
dataset, updates it shard by shard, persists its state next to the store
manifest, and consumers read ``edges()`` instead of sorting full columns.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class QuantileSketch:
    """Per-feature weighted quantile summary over ``p`` features.

    State is a pair of ``[p, m]`` arrays (values sorted per row, and their
    weights); every operation keeps ``m`` identical across features, so the
    whole sketch vectorises and serialises as two dense arrays.
    """

    #: rows absorbed per internal sort, bounding the [p, m + chunk] transient
    _ABSORB_CHUNK = 65536

    def __init__(self, p: int, max_entries: int = 2048):
        if p < 1 or max_entries < 8:
            raise ValueError(f"p={p}, max_entries={max_entries}: need p >= 1 "
                             "and max_entries >= 8")
        self.p = int(p)
        self.max_entries = int(max_entries)
        self.vals = np.empty((self.p, 0), np.float32)
        self.wts = np.empty((self.p, 0), np.float32)
        self.total_weight = 0.0
        self.n_points = 0

    # -- building -----------------------------------------------------------

    def update(self, X, w=None) -> "QuantileSketch":
        """Absorb a row batch ``X [n, p]`` with optional row weights ``w
        [n]``. Rows with ``w <= 0`` are dropped (the ``weighted_edges``
        convention for padded rows)."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.p:
            raise ValueError(f"batch shape {X.shape} != [n, {self.p}]")
        wr = (np.ones(X.shape[0], np.float32) if w is None
              else np.asarray(w, np.float32))
        keep = wr > 0
        if not keep.all():
            X, wr = X[keep], wr[keep]
        for s in range(0, X.shape[0], self._ABSORB_CHUNK):
            xb = X[s:s + self._ABSORB_CHUNK]
            wb = wr[s:s + self._ABSORB_CHUNK]
            self._absorb(np.ascontiguousarray(xb.T, dtype=np.float32),
                         np.broadcast_to(wb, (self.p, len(wb))))
        self.total_weight += float(wr.sum(dtype=np.float64))
        self.n_points += int(X.shape[0])
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Absorb another sketch's summary (same ``p``); mergeability is
        what lets parallel ingests (or per-shard sketches) combine into one
        dataset-level summary."""
        if other.p != self.p:
            raise ValueError(f"cannot merge p={other.p} into p={self.p}")
        if other.n_points:
            self._absorb(other.vals, other.wts)
            self.total_weight += other.total_weight
            self.n_points += other.n_points
        return self

    def _absorb(self, v, wt):
        """Merge ``[p, k]`` (values, weights) into the sorted summary."""
        vals = np.concatenate([self.vals, v], axis=1)
        wts = np.concatenate([self.wts, np.asarray(wt, np.float32)], axis=1)
        order = np.argsort(vals, axis=1, kind="stable")
        self.vals = np.take_along_axis(vals, order, axis=1)
        self.wts = np.take_along_axis(wts, order, axis=1)
        if self.vals.shape[1] > 2 * self.max_entries:
            self._compress()

    def _compress(self):
        """Prune to ``max_entries`` summary points at evenly spaced
        cumulative-weight positions. Keeps the per-feature min and max and
        preserves every feature's total weight exactly (new weights are
        diffs of the original cumulative weights at the picked entries)."""
        m = self.vals.shape[1]
        cap = self.max_entries
        cw = np.cumsum(self.wts, axis=1, dtype=np.float64)
        frac = np.linspace(0.0, 1.0, cap)
        new_vals = np.empty((self.p, cap), np.float32)
        new_cw = np.empty((self.p, cap), np.float64)
        for r in range(self.p):
            idx = np.minimum(np.searchsorted(cw[r], frac * cw[r, -1],
                                             side="left"), m - 1)
            idx[0] = 0
            new_vals[r] = self.vals[r, idx]
            new_cw[r] = cw[r, idx]
        self.vals = new_vals
        self.wts = np.diff(new_cw, prepend=0.0, axis=1).astype(np.float32)

    # -- queries ------------------------------------------------------------

    def quantiles(self, qs, mode: str = "floor") -> np.ndarray:
        """Quantile values at ``qs`` per feature: ``[p, len(qs)]`` fp32."""
        m = self.vals.shape[1]
        if m == 0:
            raise ValueError("empty sketch (no positive-weight rows seen)")
        if mode not in ("floor", "linear"):
            raise ValueError(f"mode={mode!r}: expected 'floor' or 'linear'")
        qs = np.asarray(qs, np.float32)
        cw = np.cumsum(self.wts, axis=1, dtype=np.float64)
        out = np.empty((self.p, len(qs)), np.float32)
        for r in range(self.p):
            w_tot = cw[r, -1]
            if mode == "floor":
                # rank arithmetic in float32, truncation toward zero —
                # mirrors weighted_edges' `(qs * (n_real - 1)).astype(int)`
                ranks = np.clip((qs * np.float32(w_tot - 1.0))
                                .astype(np.int64), 0, None)
                idx = np.minimum(np.searchsorted(cw[r], ranks + 1,
                                                 side="left"), m - 1)
                out[r] = self.vals[r, idx]
            else:
                # np.quantile/jnp.quantile 'linear': interpolate between the
                # order statistics straddling position q * (W - 1), in fp32
                pos = qs * np.float32(w_tot - 1.0)
                lo_rank = np.floor(pos)
                fr = (pos - lo_rank).astype(np.float32)
                lo = np.minimum(np.searchsorted(cw[r], lo_rank + 1.0,
                                                side="left"), m - 1)
                hi = np.minimum(np.searchsorted(cw[r], lo_rank + 2.0,
                                                side="left"), m - 1)
                out[r] = (self.vals[r, lo] * (1.0 - fr)
                          + self.vals[r, hi] * fr)
        return out

    def edges(self, n_bins: int, mode: str = "floor") -> np.ndarray:
        """Per-feature bin edges ``[p, n_bins - 1]`` — drop-in for
        :func:`~repro_torch.tabgen.fitting.weighted_edges` (``mode="floor"``) or
        :func:`~repro_torch.forest.binning.fit_bins` (``mode="linear"``)."""
        if mode == "floor":
            qs = np.arange(1, n_bins, dtype=np.float32) / np.float32(n_bins)
        else:
            qs = np.linspace(0.0, 1.0, n_bins + 1,
                             dtype=np.float32)[1:-1]
        return self.quantiles(qs, mode=mode)

    # -- persistence --------------------------------------------------------

    def state_dict(self) -> dict:
        """Dense-array state for ``np.savez`` (see repro_torch.data.store)."""
        return {
            "sketch_vals": self.vals,
            "sketch_wts": self.wts,
            "sketch_meta": np.asarray([self.p, self.max_entries,
                                       self.n_points], np.int64),
            "sketch_total_weight": np.float64(self.total_weight),
        }

    @classmethod
    def from_state(cls, state) -> "QuantileSketch":
        p, max_entries, n_points = (int(v) for v in state["sketch_meta"])
        sk = cls(p, max_entries)
        sk.vals = np.asarray(state["sketch_vals"], np.float32)
        sk.wts = np.asarray(state["sketch_wts"], np.float32)
        sk.total_weight = float(state["sketch_total_weight"])
        sk.n_points = n_points
        return sk


def sketch_dataset(X, w=None, *, max_entries: int = 2048,
                   row_chunk: int = 65536,
                   sketch: Optional[QuantileSketch] = None) -> QuantileSketch:
    """One-call sketch of an array-like ``X [n, p]`` fed in row chunks —
    never materialises a converted or sorted full copy of a column."""
    n, p = X.shape
    sk = sketch or QuantileSketch(p, max_entries)
    for s in range(0, n, row_chunk):
        wb = None if w is None else np.asarray(w[s:s + row_chunk])
        sk.update(np.asarray(X[s:s + row_chunk]), wb)
    return sk
