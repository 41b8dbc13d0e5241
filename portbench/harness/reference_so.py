"""The plain reference of single-output forests that decides ``correct`` for
a configuration with ``multi_output`` false: plain PyTorch, in float32.

A single-output (SO) model holds, for each (timestep, class), one
scalar-leaf sub-forest a column of the output: ``feat`` / ``thr`` ``[n_t,
n_y, S, T, H]`` and ``leaf`` ``[n_t, n_y, S, T, L, 1]``, with S = p lanes.
Lane s of a class routes every row of the class through its own T trees
and adds their leaves in the order 0 ... T-1; that sum is the row's column
s of the vector field.

It imports nothing of the program (``repro_torch``) and nothing of the JAX
package. Of :mod:`harness.reference` it takes only the helpers that do not
depend on the trees' layout: the label counts, the x1 blocks, the time
grid and the scalers' span. The rest of an euler call (the solve over the
stacked SO forests, unscaling, unpadding and the shuffle) is written out
here again.

The forests are walked a class block at a time (:data:`BLOCK_ELEMENTS`),
every lane of the block at once, level by level: at the cell's size, 15
classes of 8,000 rows and 368 lanes, one block of ~1 GB of working set.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harness.reference import flow_grid, label_counts, span, x1_blocks

BLOCK_ELEMENTS = 1 << 26    # rows x lanes of the classes walked at once


def forest_sum_so(x, feat, thr, leaf, depth: int) -> torch.Tensor:
    """Single-output forests, S lanes a class: x ``[B, n, p]``, feat / thr
    ``[B, S, T, H]``, leaf ``[B, S, T, L]`` -> ``[B, n, S]``. Lane s of
    class b routes each row of ``x[b]`` through its trees 0 ... T-1 and
    adds their leaves in that order. A row goes right at node h iff
    ``x[feat[h]] > thr[h]``. Classes are walked in blocks of at most
    :data:`BLOCK_ELEMENTS` rows x lanes (one class at least)."""
    B, n, _ = x.shape
    S = feat.shape[1]
    out = torch.empty((B, n, S), dtype=x.dtype, device=x.device)
    per = max(1, BLOCK_ELEMENTS // max(1, n * S))
    for b0 in range(0, B, per):
        b1 = min(B, b0 + per)
        out[b0:b1] = _walk(x[b0:b1], feat[b0:b1], thr[b0:b1], leaf[b0:b1],
                           depth)
    return out


def _walk(x, feat, thr, leaf, depth: int) -> torch.Tensor:
    """:func:`forest_sum_so` of one block of classes. A row's place in a
    tree is its 1-based heap index g (the root 1, the children of g 2g and
    2g + 1), and a tree's splits are read from its tables with one entry
    put in front, so that every row of every lane moves one level by two
    gathers from the tables, one from x, a compare and ``g ← 2g + (x >
    thr)``. After the last level g - L is the leaf, read at g from the
    tree's leaves with L entries put in front. Indices are int32."""
    nb, n, _ = x.shape
    S, T, H = feat.shape[1:]
    L = leaf.shape[-1]
    acc = torch.zeros((nb, n, S), dtype=x.dtype, device=x.device)
    for t in range(T):
        f_t = F.pad(feat[:, :, t], (1, 0))[:, None].expand(nb, n, S, H + 1)
        thr_t = F.pad(thr[:, :, t], (1, 0))[:, None].expand(nb, n, S, H + 1)
        g = torch.ones((nb, n, S, 1), dtype=torch.int32, device=x.device)
        for _ in range(depth):
            v = torch.gather(x, 2, torch.gather(f_t, 3, g)[..., 0])[..., None]
            g = torch.add(v > torch.gather(thr_t, 3, g), g, alpha=2)
        leaf_t = F.pad(leaf[:, :, t], (L, 0))[:, None].expand(nb, n, S, 2 * L)
        acc = acc + torch.gather(leaf_t, 3, g)[..., 0]
    return acc


def generate_call_so(model: Dict, n: int, seed: int, pad_to: Optional[int],
                     *, dtype=torch.float32
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows and labels of one euler call of ``n`` rows with ``seed`` from a
    single-output model.

    ``model``: ``feat`` / ``thr`` ``[n_t, n_y, S, T, H]``, ``leaf`` ``[n_t,
    n_y, S, T, L, 1]``, ``mins`` / ``maxs`` ``[n_y, p]`` (S = p),
    ``counts``, ``classes``, ``depth``. The solve runs in ``dtype``
    (float32: the configuration's precision; a lower one is the
    control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feat, thr, leaf = model["feat"], model["thr"], model["leaf"]
    n_t, n_y = feat.shape[:2]
    p = model["mins"].shape[1]
    device = feat.device
    per_class = label_counts(model["counts"], n)
    m = int(per_class.max()) if pad_to is None else int(pad_to)
    x = x1_blocks(seed, n_y, m, p, device).to(dtype)
    ts = flow_grid(n_t).to(device)
    hs = (ts[1:] - ts[:-1]).flip(0)
    for h, i in zip(hs, range(n_t - 1, 0, -1)):
        v = forest_sum_so(x, feat[i], thr[i].to(dtype),
                          leaf[i, ..., 0].to(dtype), model["depth"])
        x = x - h.to(dtype) * v
    x = x.float()
    mins, maxs = model["mins"][:, None, :], model["maxs"][:, None, :]
    x = (x + 1.0) / 2.0 * span(mins, maxs) + mins
    x_all = x.cpu().numpy()
    X = np.concatenate([x_all[c, :k] for c, k in enumerate(per_class)])
    y = np.repeat(np.asarray(model["classes"]), per_class)
    perm = np.random.default_rng(seed).permutation(len(X))
    return X[perm], y[perm]
