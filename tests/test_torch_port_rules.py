"""Rules of the PyTorch port: it stands alone, and it runs on the GPU unless
asked for the CPU.

* No module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax``
  or anything of the JAX package ``repro``.
* Importing the port's entry points loads neither.
* Entry points (loading, sampling and training) given ``device=None`` take
  the GPU and raise where there is none; ``device="cpu"`` runs the plain
  PyTorch path.
"""
import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.kernels.dispatch as dispatch
from repro_torch.config import ForestConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.tabgen import (TabularGenerator, artifacts_from_numpy,
                                fit_artifacts)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.tabgen, repro_torch.tabgen.fitting, "
            "repro_torch.kernels.tree_predict.ops, "
            "repro_torch.kernels.hist.ops;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _tiny_model_files(tmp_path):
    rng = np.random.default_rng(0)
    n_t, n_y, T, depth, p = 3, 2, 2, 2, 3
    arrays = {
        "feat": rng.integers(0, p, (n_t, n_y, p, T, 3)).astype(np.int32),
        "thr_val": rng.normal(size=(n_t, n_y, p, T, 3)).astype(np.float32),
        "leaf": rng.normal(size=(n_t, n_y, p, T, 4, 1)).astype(np.float32),
        "best_round": np.zeros((n_t, n_y, p), np.int32),
        "rounds_run": np.full((n_t, n_y, p), T, np.int32),
        "val_curve": np.zeros((n_t, n_y, p, T), np.float32),
        "mins": np.zeros((n_y, p), np.float32),
        "maxs": np.ones((n_y, p), np.float32),
        "classes": np.array([0, 1]), "counts": np.array([5, 7])}
    cfg = dataclasses.asdict(ForestConfig(n_t=n_t, n_trees=T, max_depth=depth))
    art = artifacts_from_numpy(arrays, cfg, "cpu")
    gen = TabularGenerator(art.config)
    gen.artifacts = art
    return gen.save(str(tmp_path / "tiny"))


def test_entry_points_default_to_gpu_and_raise_without_one(tmp_path,
                                                           monkeypatch):
    base = _tiny_model_files(tmp_path)
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TabularGenerator.load(base)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    gen = TabularGenerator.load(base, device="cpu")
    X, y = gen.generate(12, seed=0)
    assert X.shape == (12, 3) and np.isfinite(X).all()
    assert gen.artifacts.device == torch.device("cpu")


def test_training_defaults_to_gpu_and_raises_without_one(monkeypatch):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    cfg = ForestConfig(n_t=2, duplicate_k=2, n_trees=2, max_depth=2,
                       n_bins=8)
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_artifacts(X, None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TabularGenerator(cfg).fit(X)
    gen = TabularGenerator(cfg).fit(X, device="cpu")
    assert gen.artifacts.device == torch.device("cpu")
    X2, _ = gen.generate(10, seed=0)
    assert X2.shape == (10, 3) and np.isfinite(X2).all()


def test_gpu_is_the_default_device_where_present(monkeypatch):
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_artifacts_reject_feature_indices_out_of_range(tmp_path):
    base = _tiny_model_files(tmp_path)
    with np.load(base + ".npz") as data:
        arrays = dict(data)
    arrays["feat"][0, 0, 0, 0, 0] = 3          # p = 3
    with pytest.raises(ValueError, match="feature indices"):
        artifacts_from_numpy(arrays, dataclasses.asdict(
            ForestConfig(n_t=3, n_trees=2, max_depth=2)), "cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path, alone):
    """Without CUDA (or, alone in a directory, without the port) the smoke
    test exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, cwd=script.parent, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
