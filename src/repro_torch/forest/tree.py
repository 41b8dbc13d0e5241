"""Level-wise tree growth with static shapes (XGBoost ``hist`` on a GPU).

Trees are grown breadth-first to a fixed depth; per-row state is one int32
node id, the histograms come from :func:`repro_torch.forest.hist.build_histogram`
(one kernel launch per level), and the split search is plain PyTorch. Heap
layout: internal node h has children 2h+1 / 2h+2; leaves are node ids in
``[0, 2^depth)``.

Every function takes a leading lane dimension ``S``: the SO outputs (one
scalar-leaf tree each, all on the same codes) or the one MO tree
(``S = 1``). The JAX package vmaps over the SO outputs instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.forest.hist import build_histogram
from repro_torch.forest.split import best_splits


class Tree(NamedTuple):
    feat: torch.Tensor     # [S, 2^depth - 1] int32 (heap order)
    thr_bin: torch.Tensor  # [S, 2^depth - 1] int32
    thr_val: torch.Tensor  # [S, 2^depth - 1] f32 (raw-value thresholds, +inf sentinel)
    leaf: torch.Tensor     # [S, 2^depth, out] f32 (learning-rate scaled)


def _column(x, f):
    """``x[i, f[s, i]]`` for x ``[n, p]``, f ``[S, n]`` -> ``[S, n]``."""
    n, p = x.shape
    rows = torch.arange(n, device=x.device) * p
    return x.reshape(-1)[rows + f.long()]


def gather_leaves(leaf, node):
    """``leaf[s, node[s, i]]`` for leaf ``[S, L, out]`` -> ``[S, n, out]``."""
    return torch.gather(leaf, 1, node.long().unsqueeze(-1).expand(
        -1, -1, leaf.shape[-1]))


def grow_tree(codes, g, w, edges_sentinel, *, depth: int, n_bins: int,
              reg_lambda: float, min_child_weight: float,
              learning_rate: float, hist_bf16: bool = False):
    """Fit one regression tree per lane on gradients g.

    codes ``[n, p]`` int; g ``[S, n, out]`` f32; w ``[n]`` f32 sample
    weights; edges_sentinel ``[p, n_bins]`` f32 raw-value bin edges (+inf
    last). Returns ``(Tree, node_id [S, n] int32)``, the leaf of every row.

    ``hist_bf16`` rounds the histograms to bf16 before the split search, as
    the JAX package does on one device too. The leaf sums are one more
    histogram launch (one feature, one bin, a node per leaf): a sum in row
    order with no atomics, so a tree grown on the card is the same in every
    run, which the warm-start contract needs.
    """
    S, n, out = g.shape
    dev = g.device
    n_heap = 2 ** depth - 1
    feat_heap = torch.zeros((S, n_heap), dtype=torch.int32, device=dev)
    thr_heap = torch.full((S, n_heap), n_bins - 1, dtype=torch.int32,
                          device=dev)
    node_id = torch.zeros((S, n), dtype=torch.int32, device=dev)

    for level in range(depth):
        n_nodes = 2 ** level
        sum_g, count = build_histogram(codes, node_id, g, w, n_nodes, n_bins)
        if hist_bf16:
            sum_g = sum_g.to(torch.bfloat16).float()
            count = count.to(torch.bfloat16).float()
        feat_l, thr_l, _ = best_splits(sum_g, count, reg_lambda,
                                       min_child_weight)      # [S, n_nodes]
        del sum_g, count
        lo = n_nodes - 1
        feat_heap[:, lo:lo + n_nodes] = feat_l
        thr_heap[:, lo:lo + n_nodes] = thr_l
        node = node_id.long()
        c_i = _column(codes, torch.gather(feat_l, 1, node))
        go_right = c_i > torch.gather(thr_l, 1, node)
        node_id = node_id * 2 + go_right.to(torch.int32)

    # leaf values: Newton step -G/(H + lambda), lr-scaled
    n_leaves = 2 ** depth
    zeros = torch.zeros((n, 1), dtype=torch.int8, device=dev)
    leaf_g, leaf_h = build_histogram(zeros, node_id, g, w, n_leaves, 1)
    leaf_g = leaf_g.reshape(S, n_leaves, out)
    leaf_h = leaf_h.reshape(S, n_leaves)
    leaf = -learning_rate * leaf_g / (leaf_h[..., None] + reg_lambda + 1e-12)
    thr_val = edges_sentinel[feat_heap.long(), thr_heap.long()]
    return Tree(feat_heap, thr_heap, thr_val, leaf), node_id


def predict_tree_codes(codes, tree: Tree, depth: int):
    """Traverse by bin codes (training time). codes ``[n, p]``; returns
    ``[S, n, out]``."""
    S = tree.feat.shape[0]
    node = torch.zeros((S, codes.shape[0]), dtype=torch.long,
                       device=codes.device)
    for level in range(depth):
        heap = node + (2 ** level - 1)
        c = _column(codes, torch.gather(tree.feat, 1, heap))
        node = node * 2 + (c > torch.gather(tree.thr_bin, 1, heap))
    return gather_leaves(tree.leaf, node)


def predict_tree_values(x, feat, thr_val, leaf, depth: int):
    """Traverse by raw values. x ``[n, p]``; feat/thr_val ``[S, H]``; leaf
    ``[S, L, out]``. Returns ``[S, n, out]``; a row goes right iff
    ``x > thr_val`` (strict, so +inf never goes right)."""
    S = feat.shape[0]
    node = torch.zeros((S, x.shape[0]), dtype=torch.long, device=x.device)
    for level in range(depth):
        heap = node + (2 ** level - 1)
        c = _column(x, torch.gather(feat, 1, heap))
        node = node * 2 + (c > torch.gather(thr_val, 1, heap))
    return gather_leaves(leaf, node)
