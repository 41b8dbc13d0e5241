"""Plain PyTorch version of packed-forest inference, batched over forests.

The CPU path of :func:`repro_torch.kernels.tree_predict.ops.forest_predict`
and the version the CUDA kernel is held against on the card. Trees are summed
in scan order (0 … T-1) in float32, as ``repro.kernels.tree_predict.ref`` and
the kernel do, so all three agree to the bit.
"""
from __future__ import annotations

import torch


def forest_predict_ref(x, feat, thr_val, leaf, depth: int):
    """x ``[B, n, p]``; feat/thr_val ``[B, S, T, H]``; leaf ``[B, S, T, L, out]``.

    Returns ``[B, S, n, out]``: forest ``(b, s)`` applied to the rows of
    ``x[b]``. A row goes right at heap node ``h`` iff
    ``x[row, feat[h]] > thr_val[h]`` (strict, so ``+inf`` never goes right).
    """
    B, n, p = x.shape
    S, T = feat.shape[1], feat.shape[2]
    out = leaf.shape[-1]
    xs = x.unsqueeze(1).expand(B, S, n, p)
    acc = torch.zeros((B, S, n, out), dtype=torch.float32, device=x.device)
    for t in range(T):
        f_t = feat[:, :, t].long()                      # [B, S, H]
        thr_t = thr_val[:, :, t]
        node = torch.zeros((B, S, n), dtype=torch.long, device=x.device)
        for level in range(depth):
            heap = node + (2 ** level - 1)
            f = torch.gather(f_t, 2, heap)
            c = torch.gather(xs, 3, f.unsqueeze(-1)).squeeze(-1)
            node = node * 2 + (c > torch.gather(thr_t, 2, heap))
        idx = node.unsqueeze(-1).expand(B, S, n, out)
        acc = acc + torch.gather(leaf[:, :, t], 2, idx)
    return acc
