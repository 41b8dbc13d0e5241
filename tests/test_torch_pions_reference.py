"""Multi-output generation at an unaligned width through the port's normal
path against the benchmark's plain reference
(``portbench/harness/reference.py``), on the CPU.

The ``pions-generate`` cell serves CaloForest pions, p = out = 533: a leaf
row of 2,132 bytes is not 16-byte aligned, so on the card every summing
launch takes ``sum_kernel`` in place of ``sum_tma_kernel``. Here the same
path at a tiny unaligned width, p = out = 13 (52-byte rows), n_t = 4, 3
classes, 3 trees of depth 3: the benchmark's generate driver makes the
model from a seed and serves it through ``TabularGenerator.generate_async``
as the cell does. The port's CPU path and the reference add the same fp32
leaves in the same tree order, step ``x - h·v`` on the same grid, unscale,
unpad and shuffle alike, so rows, labels and order are equal to the bit and
no tolerance is needed; the cell's ``row_gap`` limit (1e-3) is for the
card, whose kernels also add in tree order.
"""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import reference as ref  # noqa: E402
from harness.drivers import generate as gen_drv  # noqa: E402

CONFIG = {"name": "tiny-unaligned", "p": 13, "n_classes": 3,
          "rows_per_class": 40,
          "forest": {"method": "flow", "n_t": 4, "duplicate_k": 2,
                     "n_trees": 3, "max_depth": 3, "learning_rate": 1.5,
                     "reg_lambda": 1.0, "n_bins": 16, "multi_output": True,
                     "early_stop_rounds": 0, "sigma": 0.0}}
SEED = 2 ** 40 + 7     # a seed past 32 bits, as the benchmark draws


@pytest.fixture(scope="module")
def model():
    return gen_drv.random_model(CONFIG, 2024, torch.device("cpu"))


def test_the_model_has_unaligned_leaf_rows(model):
    assert tuple(model["leaf"].shape) == (4, 3, 3, 8, 13)
    assert model["leaf"].shape[-1] * 4 % 16


@pytest.mark.parametrize("n, pad_to", [(90, None), (20, 16), (1, None)])
def test_generate_async_equals_the_reference(model, n, pad_to):
    gen = gen_drv.generator(CONFIG, model)
    X, y = gen.generate_async(n, seed=SEED, pad_to=pad_to).result()
    Xr, yr = ref.generate_call(model, n, SEED, pad_to)
    np.testing.assert_array_equal(y, yr)
    np.testing.assert_array_equal(X, Xr)


def test_a_planted_fault_shows(model):
    """One tree's leaves halved at one step of the port's model: the rows
    move by far more than the cell's ``row_gap`` limit, relative to each
    class's span as the cell's check measures it."""
    planted = dict(model, leaf=model["leaf"].clone())
    planted["leaf"][2, :, 1] *= 0.5
    X, _ = gen_drv.generator(CONFIG, planted).generate(90, seed=SEED)
    Xr, yr = ref.generate_call(model, 90, SEED, None)
    sp = ref.span(model["mins"], model["maxs"]).numpy()
    assert np.max(np.abs(X - Xr) / sp[yr]) > 1e-3
