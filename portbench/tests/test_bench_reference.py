"""The frozen plain reference against the port's CPU path on the same
inputs, at a tiny size, so that a wrong reference shows here and not on the
card."""
import dataclasses

import numpy as np
import torch

from harness import reference as ref
from harness.drivers import fit as fit_drv
from harness.drivers import generate as gen_drv
from harness.showers import showers

from conftest import TINY_CONFIG, run_tiny


def test_fit_follows_the_port():
    """On the CPU the reference's sums add each cell's rows in row order,
    as the port's: the port's trees give nothing away, and the leaves and
    the validation curve agree."""
    from repro_torch.tabgen.fitting import fit_artifacts
    fcfg = fit_drv.forest_config(TINY_CONFIG, n_t=1)
    classes = (1, 3)
    rows = {c: showers("photons_mini", np.full(40, c), seed=[9, c])
            for c in classes}
    X = np.concatenate([rows[c] for c in classes])
    y = np.repeat(classes, 40)
    noise = fit_drv.noise_fn(123, torch.device("cpu"))
    arts = fit_artifacts(X, y, fcfg, seed=123, device="cpu", noise=noise)
    for yi, c in enumerate(classes):
        shape = (40 * fcfg.duplicate_k, 64)
        prog = {f: getattr(arts, f)[0, yi, 0].numpy()
                for f in ("feat", "thr_val", "leaf", "val_curve")}
        prog["mins"], prog["maxs"] = arts.mins[yi].numpy(), \
            arts.maxs[yi].numpy()
        got = ref.follow_fit(rows[c], noise(yi, 0, shape)[0],
                             noise(yi, 1, shape)[0], 0.0,
                             dataclasses.asdict(fcfg), prog, "cpu")
        assert got["scaler_gap"] == got["edge_mismatch"] == 0.0
        assert got["split_regret"] == 0.0 and got["leaf_gap"] == 0.0
        assert got["val_loss_gap"] < 1e-6


def test_every_round_is_judged_when_splits_are_sampled():
    """With the splits judged in the first round only, a fault limited to
    the last round's leaves or validation loss still shows."""
    from repro_torch.tabgen.fitting import fit_artifacts
    fcfg = fit_drv.forest_config(TINY_CONFIG, n_t=1)
    rows = showers("photons_mini", np.full(40, 2), seed=[9, 2])
    noise = fit_drv.noise_fn(321, torch.device("cpu"))
    arts = fit_artifacts(rows, np.full(40, 2), fcfg, seed=321, device="cpu",
                         noise=noise)
    shape = (40 * fcfg.duplicate_k, 64)
    prog = {f: getattr(arts, f)[0, 0, 0].numpy().copy()
            for f in ("feat", "thr_val", "leaf", "val_curve")}
    prog["mins"], prog["maxs"] = arts.mins[0].numpy(), arts.maxs[0].numpy()

    def follow(p):
        return ref.follow_fit(rows, noise(0, 0, shape)[0],
                              noise(0, 1, shape)[0], 0.0,
                              dataclasses.asdict(fcfg), p, "cpu",
                              split_rounds=[0])
    sound = follow(prog)
    assert sound["leaf_gap"] == 0.0 and sound["val_loss_gap"] < 1e-6
    late_leaf = dict(prog, leaf=prog["leaf"].copy())
    late_leaf["leaf"][-1] *= 0.0
    assert follow(late_leaf)["leaf_gap"] > 0.5
    late_curve = dict(prog, val_curve=prog["val_curve"].copy())
    late_curve["val_curve"][-1] *= 1.01
    assert follow(late_curve)["val_loss_gap"] > 5e-3


def test_generate_matches_the_port():
    cfg = TINY_CONFIG
    model = gen_drv.random_model(cfg, 77, torch.device("cpu"))
    gen = gen_drv.generator(cfg, model)
    for n, pad in ((200, None), (30, 16), (1, None)):
        X, y = gen.generate(n, seed=4242, pad_to=pad)
        Xr, yr = ref.generate_call(model, n, 4242, pad)
        np.testing.assert_array_equal(y, yr)
        np.testing.assert_array_equal(X, Xr)


def test_tiny_cells_are_correct(tiny_root):
    for cell in ("tiny-fit", "tiny-gen", "tiny-gen-bucket"):
        out = run_tiny(tiny_root, cell)
        assert out["correct"], (cell, out["checks"])
        assert out["attempted"] >= 1 and out["failed"] == 0
