"""Single-output generation through the port's normal path against the
benchmark's plain reference of single-output forests
(``portbench/harness/reference_so.py``), on the CPU.

``TabularGenerator.generate_async`` on a model with one scalar-leaf
sub-forest an output column (``multi_output=False``, ``n_sub = p``) must
give the rows, labels and order of ``reference_so.generate_call_so`` bit
for bit: both sum each lane's trees in order 0 ... T-1 in float32, step
``x - h·v`` on the same time grid, unscale with the same float32 formula
and shuffle by the same permutation, so no tolerance is needed. The model
is either seeded random trees of the benchmark cell's layout or one the
port fitted; the call unpadded or in a bucket above the largest class.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

from repro_torch.config import ForestConfig
from repro_torch.tabgen import TabularGenerator, artifacts_from_numpy

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.reference_so import generate_call_so  # noqa: E402

N_T, DEPTH, T, P = 4, 3, 3, 5


def seeded():
    """Seeded random SO trees: ``[n_t, n_y, p, T, ...]``, leaves of one
    output, ~10% of thresholds +inf."""
    rng = np.random.default_rng(7)
    n_y, H, L = 3, 2 ** DEPTH - 1, 2 ** DEPTH
    thr = rng.uniform(-1, 1, (N_T, n_y, P, T, H)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.1] = np.inf
    mins = rng.random((n_y, P)).astype(np.float32)
    arrays = {
        "feat": rng.integers(0, P, (N_T, n_y, P, T, H)).astype(np.int32),
        "thr_val": thr,
        "leaf": rng.normal(0, 0.3, (N_T, n_y, P, T, L, 1)).astype(
            np.float32),
        "best_round": np.full((N_T, n_y, P), T - 1, np.int32),
        "rounds_run": np.full((N_T, n_y, P), T, np.int32),
        "val_curve": np.zeros((N_T, n_y, P, T), np.float32),
        "mins": mins, "maxs": mins + 1.0 + rng.random((n_y, P)).astype(
            np.float32),
        "classes": np.array([2, 5, 9]), "counts": np.array([30, 45, 25])}
    cfg = dataclasses.asdict(ForestConfig(n_t=N_T, n_trees=T,
                                          max_depth=DEPTH,
                                          multi_output=False))
    gen = TabularGenerator(ForestConfig(**cfg))
    gen.artifacts = artifacts_from_numpy(arrays, cfg, "cpu")
    return gen


def fitted():
    """A model the port fitted on the CPU: three classes of unequal size."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(90, P)).astype(np.float32)
    y = np.repeat([0, 1, 2], [40, 30, 20])
    X[y == 1] += 2.0
    cfg = ForestConfig(n_t=N_T, duplicate_k=3, n_trees=T, max_depth=DEPTH,
                       n_bins=16, learning_rate=0.5, reg_lambda=1.0,
                       multi_output=False)
    return TabularGenerator(cfg).fit(X, y, device="cpu")


@pytest.fixture(scope="module", params=["seeded", "fitted"])
def gen(request):
    return {"seeded": seeded, "fitted": fitted}[request.param]()


def reference_model(art):
    return {"feat": art.feat, "thr": art.thr_val, "leaf": art.leaf,
            "mins": art.mins, "maxs": art.maxs, "depth": DEPTH,
            "classes": art.classes, "counts": art.counts}


@pytest.mark.parametrize("n, pad_to", [(37, None), (37, 32), (1, 16)])
def test_so_generate_async_equals_the_reference(gen, n, pad_to):
    art = gen.artifacts
    assert art.feat.shape[2] == art.p and art.leaf.shape[-1] == 1
    X, y = gen.generate_async(n, seed=11, pad_to=pad_to).result()
    Xr, yr = generate_call_so(reference_model(art), n, 11, pad_to)
    np.testing.assert_array_equal(y, yr)
    np.testing.assert_array_equal(X, Xr)
    assert np.isfinite(X).all() and X.shape == (n, art.p)


def test_a_planted_fault_shows(gen):
    """The comparison is not blind: with lane 0's first tree left out of
    the reference's model, its rows differ from the program's."""
    art = gen.artifacts
    model = reference_model(art)
    model["leaf"] = art.leaf.clone()
    model["leaf"][:, :, 0, 0] = 0.0
    X, _ = gen.generate_async(37, seed=11).result()
    Xr, _ = generate_call_so(model, 37, 11, None)
    assert np.abs(X - Xr).max() > 0
