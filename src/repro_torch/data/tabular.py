"""Synthetic tabular datasets for resource-scaling runs (paper §4.1,
App. D.1): a numpy-only copy of the part of ``repro.data.tabular`` that the
port's ingest and training CLIs draw from, row for row the same.

The ``*_batches`` variant streams the same family as bounded row batches
for :func:`repro_torch.data.store.ingest` and the out-of-core benchmarks: batch
``b`` is drawn from its own PRNG stream seeded ``[seed, b]``, so any run
over the same ``(n, batch_rows, seed)`` yields bit-identical batches, a
larger-than-RAM dataset never exists in memory at once, and a crash-resumed
ingest can replay the stream from scratch at generator (not storage) cost.
It is deliberately *not* row-equal to its one-shot twin (that one
interleaves X and y draws on a single stream)."""
from __future__ import annotations

import numpy as np


def synthetic_resource_dataset(n: int, p: int, n_y: int, seed: int = 0):
    """Paper D.1: X ~ N(0, I); labels uniform over [0, n_y). Random feature
    correlations make unregularised trees use their full capacity."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    y = rng.integers(0, n_y, size=n).astype(np.int64)
    return X, y


def synthetic_resource_batches(n: int, p: int, n_y: int, *,
                               batch_rows: int = 65536, seed: int = 0):
    """Chunked twin of :func:`synthetic_resource_dataset`: yields
    ``(X [k, p] fp32, y [k] int64)`` batches totalling exactly ``n`` rows,
    deterministic in ``(n, p, n_y, batch_rows, seed)``."""
    for b, s in enumerate(range(0, n, batch_rows)):
        rows = min(batch_rows, n - s)
        rng = np.random.default_rng([seed, b])
        X = rng.normal(size=(rows, p)).astype(np.float32)
        y = rng.integers(0, n_y, size=rows).astype(np.int64)
        yield X, y
