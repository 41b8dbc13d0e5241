"""Packed forests: stacked tree arrays and batched inference.

One packed forest holds the sub-forests of one (timestep, class) ensemble,
``[n_sub, T, ...]``; the generator stacks them further to ``[n_t, n_y, ...]``.
:func:`predict_forest` evaluates a whole class batch ``[B, n_sub, T, ...]``
in one :func:`~repro_torch.kernels.tree_predict.ops.forest_predict` call,
where the JAX package vmaps over classes and then over sub-forests.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.tree_predict.ops import forest_predict


@dataclasses.dataclass(frozen=True)
class PackedForest:
    feat: torch.Tensor     # [..., n_sub, T, H] int32
    thr_val: torch.Tensor  # [..., n_sub, T, H] fp32
    leaf: torch.Tensor     # [..., n_sub, T, L, out_sub] fp32
    multi_output: bool

    def at(self, i) -> "PackedForest":
        """Index the leading axis (a timestep of a stacked forest)."""
        return PackedForest(self.feat[i], self.thr_val[i], self.leaf[i],
                            self.multi_output)


def predict_forest(x, forest: PackedForest, depth: int):
    """x ``[B, n, p]`` raw feature values; forest ``[B, n_sub, T, ...]``.

    Returns ``[B, n, p_out]``. MO forests have ``n_sub = 1`` and vector
    leaves (``out = p_out``); SO forests have ``n_sub = p_out`` scalar-leaf
    sub-forests, whose ``[B, p_out, n, 1]`` output is transposed here (into
    a contiguous tensor, so the solver's next state stays contiguous too).
    """
    out = forest_predict(x, forest.feat, forest.thr_val, forest.leaf, depth)
    if forest.multi_output:
        return out[:, 0]                                  # [B, n, p_out]
    return out[..., 0].transpose(1, 2).contiguous()      # SO: [B, p_out, n] -> [B, n, p_out]
