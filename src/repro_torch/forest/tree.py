"""Level-wise tree growth with static shapes (XGBoost ``hist`` on a GPU).

Trees are grown breadth-first to a fixed depth; per-row state is one int32
node id, the histograms come from :func:`repro_torch.forest.hist.build_histogram`
(one kernel launch per level), and the split search is plain PyTorch. Heap
layout: internal node h has children 2h+1 / 2h+2; leaves are node ids in
``[0, 2^depth)``.

Every function takes a leading lane dimension ``S``: the SO outputs (one
scalar-leaf tree each, all on the same codes) or the one MO tree
(``S = 1``). The JAX package vmaps over the SO outputs instead.

Sharded training: ``grow_tree(group=...)`` takes the process group of the
data ranks, each of which holds its own rows. The histograms are reduced
over it before the split search (:func:`_reduced_best_splits`: an
all-reduce, or a reduce-scatter over the features), and so are the leaf
sums: distributed XGBoost's all-reduce, through ``torch.distributed``. With
no group, or a world of one, nothing is reduced and the route is the
single-device one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

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


def group_size(group) -> int:
    """The ranks of ``group``; 1 for no group (the single-device route)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t, group):
    """``t`` summed over ``group``, in place; ``t`` itself when there is
    nothing to reduce."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def _reduced_best_splits(sum_g, count, reg_lambda: float,
                         min_child_weight: float, group, split_reduce: str,
                         hist_bf16: bool):
    """Histogram reduction over the data ranks of ``group``, then the split
    search: the JAX package's ``_reduced_best_splits``.

    ``split_reduce="allreduce"``: all-reduce the full histograms, and every
    rank searches all features (distributed XGBoost). ``"reduce_scatter"``:
    pad the features to a multiple of the ranks, reduce-scatter them, find
    each rank's best split over its own features, and all-gather the
    ``(gain, feature, bin)`` triples; the best gain wins, the first rank on
    a tie. ``hist_bf16`` sends the histograms as bf16. sum_g ``[S, nodes,
    p, bins, out]``, count ``[S, nodes, p, bins]``; returns ``(feat, thr,
    gain)``, each ``[S, nodes]``.
    """
    if hist_bf16:
        sum_g = sum_g.to(torch.bfloat16)
        count = count.to(torch.bfloat16)
    shards = group_size(group)
    if shards == 1 or split_reduce == "allreduce":
        sum_g = all_reduce_sum(sum_g, group)
        count = all_reduce_sum(count, group)
        return best_splits(sum_g.float(), count.float(), reg_lambda,
                           min_child_weight)
    if split_reduce != "reduce_scatter":
        raise ValueError(f"split_reduce={split_reduce!r}: 'allreduce' or "
                         "'reduce_scatter'")
    S, nodes, p, bins = count.shape
    p_pad = -(-p // shards) * shards
    p_loc = p_pad // shards
    # the feature dimension first: the collectives split dimension 0
    g_in = torch.zeros((p_pad, S, nodes, bins, sum_g.shape[-1]),
                       dtype=sum_g.dtype, device=sum_g.device)
    g_in[:p] = sum_g.permute(2, 0, 1, 3, 4)
    c_in = torch.zeros((p_pad, S, nodes, bins), dtype=count.dtype,
                       device=count.device)
    c_in[:p] = count.permute(2, 0, 1, 3)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    g_loc = g_in.new_empty((p_loc,) + g_in.shape[1:])
    c_loc = c_in.new_empty((p_loc,) + c_in.shape[1:])
    scatter(g_loc, g_in, group=group)
    scatter(c_loc, c_in, group=group)
    feat_l, thr_l, gain_l = best_splits(
        g_loc.float().permute(1, 2, 0, 3, 4),
        c_loc.float().permute(1, 2, 0, 3), reg_lambda, min_child_weight)
    feat_g = feat_l + dist.get_rank(group) * p_loc
    packed = torch.stack([gain_l, feat_g.float(), thr_l.float()], dim=-1)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    allp = packed.new_empty((shards * S,) + packed.shape[1:])
    gather(allp, packed.contiguous(), group=group)
    allp = allp.view((shards,) + packed.shape)       # [shards, S, nodes, 3]
    best = torch.argmax(allp[..., 0], dim=0)              # [S, nodes]
    sel = torch.gather(allp, 0, best[None, ..., None].expand(
        1, -1, -1, 3))[0]
    feat = torch.clamp(sel[..., 1].to(torch.int32), 0, p - 1)
    thr = sel[..., 2].to(torch.int32)
    gain = sel[..., 0]
    dead = ~(gain > 0.0)
    return (torch.where(dead, 0, feat).to(torch.int32),
            torch.where(dead, bins - 1, thr).to(torch.int32),
            torch.where(dead, 0.0, gain))


def grow_tree(codes, g, w, edges_sentinel, *, depth: int, n_bins: int,
              reg_lambda: float, min_child_weight: float,
              learning_rate: float, hist_bf16: bool = False,
              group: Optional[dist.ProcessGroup] = None,
              split_reduce: str = "allreduce"):
    """Fit one regression tree per lane on gradients g.

    codes ``[n, p]`` int; g ``[S, n, out]`` f32; w ``[n]`` f32 sample
    weights; edges_sentinel ``[p, n_bins]`` f32 raw-value bin edges (+inf
    last). Returns ``(Tree, node_id [S, n] int32)``, the leaf of every row.

    ``hist_bf16`` rounds the histograms to bf16 before the split search, as
    the JAX package does on one device too. The leaf sums are one more
    histogram launch (one feature, one bin, a node per leaf): a sum in row
    order with no atomics, so a tree grown on the card is the same in every
    run, which the warm-start contract needs.

    ``group`` holds the data ranks of a sharded fit (this rank's rows are
    ``codes``): histograms and leaf sums are reduced over it, by
    ``split_reduce`` (see :func:`_reduced_best_splits`).
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
        feat_l, thr_l, _ = _reduced_best_splits(
            sum_g, count, reg_lambda, min_child_weight, group, split_reduce,
            hist_bf16)                                         # [S, n_nodes]
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
    leaf_g = all_reduce_sum(leaf_g.reshape(S, n_leaves, out), group)
    leaf_h = all_reduce_sum(leaf_h.reshape(S, n_leaves), group)
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
