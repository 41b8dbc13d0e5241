"""A run with the timed path broken underneath reads ``correct`` false:
a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced. The card's look is skipped: the tiny
cells run on the CPU through the same harness. (One chip a cell: no
exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

from conftest import run_tiny


def _unchanged_state(monkeypatch):
    import repro_torch.forest.boosting as b
    monkeypatch.setattr(b, "gather_leaves",
                        lambda leaf, node: torch.zeros(
                            leaf.shape[0], node.shape[1], leaf.shape[-1]))


def _half_batch(monkeypatch):
    import repro_torch.forest.tree as t
    orig = t.build_histogram

    def half(codes, node_id, g, w, *a, **k):
        w = w.clone()
        w[..., w.shape[-1] // 2:] = 0.0      # rows left out ...
        return orig(codes, node_id, g, w * 2.0, *a, **k)   # ... mean kept
    monkeypatch.setattr(t, "build_histogram", half)


def _altered_leaf(monkeypatch):
    import repro_torch.forest.boosting as t
    orig = t.grow_tree

    def grow(*a, **k):
        tree, node = orig(*a, **k)
        leaf = tree.leaf.clone()
        leaf[..., 0, 0] += 0.5
        return tree._replace(leaf=leaf), node
    monkeypatch.setattr(t, "grow_tree", grow)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_leaf])
def test_fit_faults_fail(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root, "tiny-fit")
    assert not out["correct"], out["checks"]


def _gen_unchanged_state(monkeypatch):
    import repro_torch.core.generate as g
    monkeypatch.setattr(g, "predict_forest",
                        lambda x, forest, depth: torch.zeros_like(x))


def _gen_half_batch(monkeypatch):
    import repro_torch.core.generate as g
    orig = g.predict_forest

    def half(x, forest, depth):
        v = orig(x, forest, depth)
        v[:, 1::2] = v[:, 0::2].mean(dim=1, keepdim=True)
        return v
    monkeypatch.setattr(g, "predict_forest", half)


def _gen_altered_answer(monkeypatch):
    import repro_torch.tabgen.sampling as s
    orig = s.SampleHandle.result

    def result(self):
        X, y = orig(self)
        X = np.array(X)
        X[0, 0] += 0.01
        return X, y
    monkeypatch.setattr(s.SampleHandle, "result", result)


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-gen-bucket"])
@pytest.mark.parametrize("fault", [_gen_unchanged_state, _gen_half_batch,
                                   _gen_altered_answer])
def test_generate_faults_fail(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root, cell)
    assert not out["correct"], out["checks"]
