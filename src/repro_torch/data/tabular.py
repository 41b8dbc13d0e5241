"""Synthetic tabular datasets for resource-scaling runs (paper §4.1,
App. D.1), the serving demos' two-moons and the quality comparison's
correlated Gaussian: a numpy-only copy of ``repro.data.tabular``, row for
row the same.

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


def two_moons(n: int, noise: float = 0.08, seed: int = 0):
    """Two interleaved half circles with noise: the JAX package's toy
    dataset, row for row."""
    rng = np.random.default_rng(seed)
    n2 = n // 2
    t = np.pi * rng.random(n2)
    a = np.stack([np.cos(t), np.sin(t)], 1)
    b = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    X = np.concatenate([a, b]) + noise * rng.normal(size=(2 * n2, 2))
    y = np.concatenate([np.zeros(n2), np.ones(n2)]).astype(np.int64)
    perm = rng.permutation(len(X))
    return X[perm].astype(np.float32), y[perm]


def two_moons_batches(n: int, noise: float = 0.08, *,
                      batch_rows: int = 65536, seed: int = 0):
    """Chunked twin of :func:`two_moons` (each batch is an independently
    shuffled small two-moons draw; the union has the same distribution)."""
    for b, s in enumerate(range(0, n, batch_rows)):
        rows = min(batch_rows, n - s)
        batch_seed = np.random.SeedSequence([seed, b]).generate_state(1)[0]
        # two_moons returns 2*(n//2) rows: over-ask by one and slice so
        # odd batches (e.g. the tail) still total exactly n
        X, y = two_moons(rows + rows % 2, noise=noise, seed=int(batch_seed))
        yield X[:rows], y[:rows]


def correlated_gaussian(n: int, p: int, seed: int = 0):
    """Full-rank correlated Gaussian — tests joint-structure learning (the
    paper's MO-trees motivation)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(p, p)) / np.sqrt(p)
    cov = A @ A.T + 0.1 * np.eye(p)
    X = rng.multivariate_normal(np.zeros(p), cov, size=n)
    return X.astype(np.float32), cov


def correlated_gaussian_batches(n: int, p: int, *, batch_rows: int = 65536,
                                seed: int = 0):
    """Chunked, label-free correlated Gaussian (one shared covariance drawn
    from ``seed``; rows per batch from stream ``[seed, b]``) — exercises
    the unlabelled ingest path with a non-trivial joint structure."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(p, p)) / np.sqrt(p)
    cov = A @ A.T + 0.1 * np.eye(p)
    for b, s in enumerate(range(0, n, batch_rows)):
        rows = min(batch_rows, n - s)
        brng = np.random.default_rng([seed, b])
        yield brng.multivariate_normal(np.zeros(p), cov,
                                       size=rows).astype(np.float32)
