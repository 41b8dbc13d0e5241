"""Best-split search from histograms (second-order boosting gain).

For squared-error boosting the hessian is 1, so H is the accumulated sample
weight. Multi-output trees sum the gain over outputs (in a fixed order:
:func:`ordered_sum`) and share one split structure. Plain PyTorch on both devices, as the JAX package leaves it to
XLA outside any Pallas kernel; every leading dimension (lanes, nodes) is a
batch dimension.
"""
from __future__ import annotations

from typing import Tuple

import torch

_BLOCK = 16   # XLA's block length for a long cumulative sum


def prefix_sum(x, dim: int):
    """Inclusive cumulative sum along ``dim`` in the order XLA's CPU backend
    sums ``jnp.cumsum``: sequentially within blocks of 16, then each block
    plus the (recursively summed) total of the blocks before it.

    Only elementwise adds, so the result is the same on every device and in
    every run (``torch.cumsum`` on CUDA may not be), and it equals the JAX
    package's ``jnp.cumsum`` on the CPU to the bit.
    """
    dim = dim % x.dim()
    length = x.shape[dim]
    if length <= _BLOCK:
        y = x.clone()
        for k in range(1, length):
            y.select(dim, k).add_(y.select(dim, k - 1))
        return y
    blocks = -(-length // _BLOCK)
    pad = blocks * _BLOCK - length
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    y = prefix_sum(x.unflatten(dim, (blocks, _BLOCK)), dim + 1)
    totals = prefix_sum(y.select(dim + 1, _BLOCK - 1), dim)
    y.narrow(dim, 1, blocks - 1).add_(
        totals.narrow(dim, 0, blocks - 1).unsqueeze(dim + 1))
    return y.flatten(dim, dim + 1).narrow(dim, 0, length)


_ROW = 32     # XLA's CPU backend sums a row of up to 32 in order


def ordered_sum(x):
    """Sum over the last dimension in a fixed order of elementwise adds, so
    the result is the same on every device (``Tensor.sum`` on CUDA adds a
    row in another order than on the CPU).

    A row of up to 32 is summed left to right, the order of ``jnp.sum`` on
    XLA's CPU backend, so the JAX package's gains are matched to the bit
    there. A longer row of n is cut into contiguous chunks of w = ceil(n /
    32) (the last one may be shorter); the chunks are added elementwise in
    order, and the w partial sums are summed the same way. Every add reads
    contiguous runs, so the card streams the histograms' width.
    """
    n = x.shape[-1]
    if n <= _ROW:
        acc = x[..., 0].clone()
        for k in range(1, n):
            acc.add_(x[..., k])
        return acc
    w = -(-n // _ROW)
    acc = x[..., :w].clone()
    for start in range(w, n, w):
        part = x[..., start:start + w]
        acc[..., :part.shape[-1]].add_(part)
    return ordered_sum(acc)


def best_splits(sum_g, count, reg_lambda: float, min_child_weight: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the best (feature, bin) per node.

    sum_g ``[..., p, bins, out]``; count ``[..., p, bins]``. Returns (feat
    ``[...]`` int32, thr_bin ``[...]`` int32, gain ``[...]`` f32). Nodes whose
    best gain is not positive get ``thr_bin = bins - 1`` (the +inf sentinel:
    every row routes left). Ties go to the first (feature, bin), as
    ``jnp.argmax`` breaks them.
    """
    *lead, p, bins, out = sum_g.shape
    gl = prefix_sum(sum_g, -2)                 # left sums for a split at bin b
    hl = prefix_sum(count, -1)
    gt = gl[..., -1:, :]
    ht = hl[..., -1:]
    gr = gt - gl
    hr = ht - hl

    def score(g2, h):
        return ordered_sum(torch.square(g2)) / (h + reg_lambda + 1e-12)

    gain = score(gl, hl) + score(gr, hr) - score(gt, ht)   # [..., p, bins]
    valid = (hl >= min_child_weight) & (hr >= min_child_weight)
    gain = torch.where(valid, gain, -torch.inf)
    flat = gain.reshape(*lead, p * bins)
    best = torch.argmax(flat, dim=-1)
    best_gain = torch.gather(flat, -1, best.unsqueeze(-1)).squeeze(-1)
    dead = ~(best_gain > 0.0)
    feat = torch.where(dead, 0, best // bins).to(torch.int32)
    thr = torch.where(dead, bins - 1, best % bins).to(torch.int32)
    return feat, thr, torch.where(dead, 0.0, best_gain)
