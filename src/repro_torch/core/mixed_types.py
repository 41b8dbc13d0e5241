"""Mixed-type tabular handling (paper App. D.1: "Categorical variables are
one-hot encoded", integer targets rounded).

A copy of ``repro.core.mixed_types`` (numpy only): the port may not import
the JAX package, whose ``core/__init__.py`` loads jax.

``TabularSchema`` dummy-encodes categorical columns before fitting and
post-processes generated rows: one-hot groups re-argmaxed, integer columns
rounded and clipped to the observed range — the original ForestDiffusion's
``cat_indexes``/``int_indexes`` behaviour.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class TabularSchema:
    """Column-type schema: which raw columns are categorical / integer.

    ``encode``/``decode`` map between the raw column layout and the
    continuous representation the forest models are trained on.
    ``to_dict``/``from_dict`` make the fitted schema JSON-portable so a
    saved generator can decode on a serving host that never saw the
    training data.
    """
    def __init__(self, cat_cols: Sequence[int] = (),
                 int_cols: Sequence[int] = ()):
        self.cat_cols = sorted(cat_cols)
        self.int_cols = sorted(set(int_cols) - set(cat_cols))

    def fit(self, X: np.ndarray):
        X = np.asarray(X)
        self.n_raw = X.shape[1]
        self._cats: Dict[int, np.ndarray] = {}
        for c in self.cat_cols:
            self._cats[c] = np.unique(X[:, c])
        self._int_lo = {c: np.floor(X[:, c].min()) for c in self.int_cols}
        self._int_hi = {c: np.ceil(X[:, c].max()) for c in self.int_cols}
        # encoded layout: numeric/int columns first (original order), then
        # one-hot blocks per categorical column
        self._num_cols = [j for j in range(self.n_raw)
                          if j not in self.cat_cols]
        return self

    @property
    def encoded_width(self) -> int:
        return len(self._num_cols) + sum(len(v) for v in self._cats.values())

    def encode(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        parts = [X[:, self._num_cols].astype(np.float32)]
        for c in self.cat_cols:
            cats = self._cats[c]
            onehot = (X[:, c][:, None] == cats[None, :]).astype(np.float32)
            parts.append(onehot)
        return np.concatenate(parts, axis=1)

    def decode(self, Z: np.ndarray) -> np.ndarray:
        Z = np.asarray(Z)
        numeric = all(np.issubdtype(np.asarray(v).dtype, np.number)
                      for v in self._cats.values())
        out = np.empty((Z.shape[0], self.n_raw),
                       np.float64 if numeric else object)
        k = len(self._num_cols)
        for i, j in enumerate(self._num_cols):
            col = Z[:, i].astype(np.float64)
            if j in self.int_cols:
                col = np.clip(np.round(col), self._int_lo[j], self._int_hi[j])
            out[:, j] = col
        for c in self.cat_cols:
            cats = self._cats[c]
            block = Z[:, k:k + len(cats)]
            out[:, c] = cats[np.argmax(block, axis=1)]
            k += len(cats)
        return out

    def encode_with_missing(self, X: np.ndarray) -> np.ndarray:
        """Like ``encode`` but NaNs survive the trip: a missing numeric cell
        stays NaN, and a missing categorical cell NaNs its whole one-hot
        block — exactly the mask shape imputation needs."""
        X = np.asarray(X)
        Z = self.encode(np.where(_isnan(X), 0, X) if X.dtype == object
                        else np.nan_to_num(X.astype(np.float64)))
        nan = _isnan(X)
        for i, j in enumerate(self._num_cols):
            Z[nan[:, j], i] = np.nan
        k = len(self._num_cols)
        for c in self.cat_cols:
            w = len(self._cats[c])
            Z[nan[:, c], k:k + w] = np.nan
            k += w
        return Z

    # -- JSON portability ---------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "cat_cols": list(self.cat_cols),
            "int_cols": list(self.int_cols),
            "n_raw": int(self.n_raw),
            "cats": {str(c): np.asarray(v).tolist()
                     for c, v in self._cats.items()},
            "int_lo": {str(c): float(v) for c, v in self._int_lo.items()},
            "int_hi": {str(c): float(v) for c, v in self._int_hi.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TabularSchema":
        schema = cls(cat_cols=d["cat_cols"], int_cols=d["int_cols"])
        schema.n_raw = int(d["n_raw"])
        schema._cats = {int(c): np.asarray(v) for c, v in d["cats"].items()}
        schema._int_lo = {int(c): v for c, v in d["int_lo"].items()}
        schema._int_hi = {int(c): v for c, v in d["int_hi"].items()}
        schema._num_cols = [j for j in range(schema.n_raw)
                            if j not in schema.cat_cols]
        return schema


def _isnan(X: np.ndarray) -> np.ndarray:
    """Elementwise NaN test that also works on object arrays (mixed string /
    float columns)."""
    if X.dtype != object:
        return np.isnan(X.astype(np.float64, copy=False)) \
            if np.issubdtype(X.dtype, np.floating) else np.zeros(X.shape, bool)
    # x != x catches every NaN flavour (float, np.float32/64) elementwise;
    # strings and other types compare equal to themselves
    return np.asarray(X != X, dtype=bool)
