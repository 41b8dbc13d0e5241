"""Boosting loop with early stopping and warm start.

``fit_boosted`` fits the boosted trees of every lane of one ensemble at once:
one lane for an MO ensemble, one lane per output for SO. Each round grows
one tree per active lane, with one histogram launch per level for all of
them. A lane stops on its own: at ``n_trees`` rounds, or when its
fresh-noise validation loss has not improved for ``early_stop_rounds``
rounds. That is what the JAX package's ``vmap`` of a ``while_loop`` does,
and each lane's result (``rounds_run``, ``best_round``, ``val_curve`` with
inf for rounds never run, leaves masked past the best round) is what that
lane would get if it were trained alone: every per-lane quantity is computed
lane by lane, and the loop only ever narrows the batch to the active lanes.

Warm start: boosting is additive, so a model trained to round R extends to
R + K without recomputing the first R rounds. ``warm=`` seeds the round
buffers from a previous result and replays the saved trees on the raw
(pre-binning) inputs to rebuild the running predictions. That is exact,
because :func:`repro_torch.forest.binning.transform` guarantees ``code > b
<=> x > edges[:, b]``. Rounds past ``best_round`` were masked to zero
leaves, so each lane restarts at its ``best_round + 1`` and grows them
again, deterministically. A warm-started run to R + K equals a cold run to
R + K bit for bit.

Sharded training: ``group`` (the data ranks, each with its own rows) is
passed on to every tree, and the validation loss sums its numerator and
denominator over it, so every rank sees the same loss and stops the same
lanes at the same round.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.config import ForestConfig
from repro_torch.forest.split import ordered_sum
from repro_torch.forest.tree import (all_reduce_sum, gather_leaves,
                                     grow_tree, predict_tree_codes,
                                     predict_tree_values)


class BoostResult(NamedTuple):
    feat: torch.Tensor        # [S, T, H] int32
    thr_val: torch.Tensor     # [S, T, H] f32
    leaf: torch.Tensor        # [S, T, L, out] f32 (rounds past best are zeroed)
    best_round: torch.Tensor  # [S] int32 (index of the best validation round)
    rounds_run: torch.Tensor  # [S] int32
    val_curve: torch.Tensor   # [S, T] f32 (inf for rounds not run)


def _wmse(pred, tgt, w, group=None):
    """Weighted MSE per lane: pred/tgt ``[S, n, out]``, w ``[n]`` -> ``[S]``.

    Both sums add in :func:`~repro_torch.forest.split.ordered_sum`'s fixed
    order, so a lane's loss (and with it ``best_round``) is the same on
    every device. They accumulate in float64 and are rounded once to
    float32, so a lane's loss does not depend on which other lanes share
    the batch. Over the data ranks of ``group`` both sums are then added
    in float32, as the JAX package's ``psum`` adds them.
    """
    sq = (w[None, :, None] * torch.square(pred - tgt)).double()
    num = ordered_sum(sq.flatten(1)).to(torch.float32)
    den = (ordered_sum(w.double()).to(torch.float32)
           * tgt.shape[2]).reshape(1)
    num = all_reduce_sum(num, group)
    den = all_reduce_sum(den, group)
    return num / torch.clamp(den, min=1e-12)


def fit_boosted(codes, tgt, w, edges_sentinel, val_codes, val_tgt, val_w,
                fcfg: ForestConfig, *, warm=None, x_raw=None,
                val_raw=None, group: Optional[dist.ProcessGroup] = None
                ) -> BoostResult:
    """codes/val_codes ``[n, p]`` int, shared by the lanes; tgt/val_tgt
    ``[S, n, out]``; w/val_w ``[n]`` weights. ``group``: the data ranks of
    a sharded fit (``None``: one device).

    ``warm = (feat [S, R, H], thr_val [S, R, H], leaf [S, R, L, out],
    val_curve [S, R], best_round [S])`` continues a previous run (same data,
    edges and config up to ``n_trees``); ``x_raw``/``val_raw`` are the raw
    inputs the codes were quantised from.
    """
    S, n, out = tgt.shape
    dev = tgt.device
    T, depth = fcfg.n_trees, fcfg.max_depth
    H, L = 2 ** depth - 1, 2 ** depth
    es = fcfg.early_stop_rounds

    feat_buf = torch.zeros((S, T, H), dtype=torch.int32, device=dev)
    thr_buf = torch.full((S, T, H), torch.inf, dtype=torch.float32, device=dev)
    leaf_buf = torch.zeros((S, T, L, out), dtype=torch.float32, device=dev)
    vcurve = torch.full((S, T), torch.inf, dtype=torch.float32, device=dev)
    pred = torch.zeros((S, n, out), dtype=torch.float32, device=dev)
    vpred = torch.zeros((S, val_codes.shape[0], out), dtype=torch.float32,
                        device=dev)
    if warm is None:
        r = torch.zeros((S,), dtype=torch.long, device=dev)
        best_loss = torch.full((S,), torch.inf, dtype=torch.float32,
                               device=dev)
        best_r = torch.zeros((S,), dtype=torch.long, device=dev)
    else:
        if x_raw is None or val_raw is None:
            raise ValueError("warm start needs x_raw/val_raw (the raw rows "
                             "the codes were quantised from) to replay the "
                             "saved trees")
        wf, wt, wl, wvc, wbr = warm
        R0 = wf.shape[1]
        if R0 > T:
            raise ValueError(f"warm state has {R0} rounds but n_trees={T}; "
                             "extension needs n_trees > the base model's "
                             "round count")
        feat_buf[:, :R0] = wf.to(torch.int32)
        thr_buf[:, :R0] = wt.to(torch.float32)
        leaf_buf[:, :R0] = wl.to(torch.float32)
        vcurve[:, :R0] = wvc.to(torch.float32)
        best_r = wbr.to(dev, torch.long)
        # replay rounds 0 … best_round of every lane, in round order, so the
        # running sums are added up exactly as the original loop added them
        for k in range(int(best_r.max()) + 1 if S else 0):
            live = (k <= best_r)[:, None, None]
            pred = torch.where(live, pred + predict_tree_values(
                x_raw, feat_buf[:, k], thr_buf[:, k], leaf_buf[:, k], depth),
                pred)
            vpred = torch.where(live, vpred + predict_tree_values(
                val_raw, feat_buf[:, k], thr_buf[:, k], leaf_buf[:, k],
                depth), vpred)
        # the loop state at r = best_round + 1: the improving round set the
        # best loss to its own validation loss and zeroed the patience
        r = best_r + 1
        best_loss = torch.gather(vcurve, 1, best_r[:, None])[:, 0]
    patience = torch.zeros((S,), dtype=torch.long, device=dev)
    # without early stopping or a warm start every lane runs rounds 0 … T-1
    # together: no per-round look at which lanes are still active
    static = es == 0 and warm is None
    rounds = 0

    while True:
        if static:
            if rounds == T:
                break
            rounds += 1
            lanes = torch.arange(S, device=dev)
        else:
            active = r < T
            if es > 0:
                active &= patience < es
            lanes = active.nonzero()[:, 0]
            if lanes.numel() == 0:
                break
        rl = r[lanes]
        tree, node_id = grow_tree(
            codes, pred[lanes] - tgt[lanes], w, edges_sentinel, depth=depth,
            n_bins=fcfg.n_bins, reg_lambda=fcfg.reg_lambda,
            min_child_weight=fcfg.min_child_weight,
            learning_rate=fcfg.learning_rate, hist_bf16=fcfg.hist_bf16,
            group=group, split_reduce=fcfg.split_reduce)
        pred[lanes] = pred[lanes] + gather_leaves(tree.leaf, node_id)
        vp = vpred[lanes] + predict_tree_codes(val_codes, tree, depth)
        vpred[lanes] = vp
        vloss = _wmse(vp, val_tgt[lanes], val_w, group)
        improved = vloss < best_loss[lanes]
        best_loss[lanes] = torch.minimum(vloss, best_loss[lanes])
        best_r[lanes] = torch.where(improved, rl, best_r[lanes])
        patience[lanes] = torch.where(improved, 0, patience[lanes] + 1)
        feat_buf[lanes, rl] = tree.feat
        thr_buf[lanes, rl] = tree.thr_val
        leaf_buf[lanes, rl] = tree.leaf
        vcurve[lanes, rl] = vloss
        r[lanes] = rl + 1

    if es > 0:
        keep = torch.arange(T, device=dev)[None, :] <= best_r[:, None]
        leaf_buf = torch.where(keep[:, :, None, None], leaf_buf, 0.0)
    else:
        best_r = r - 1
    return BoostResult(feat_buf, thr_buf, leaf_buf, best_r.to(torch.int32),
                       r.to(torch.int32), vcurve)


def fit_ensemble(codes, tgt, w, edges_sentinel, val_codes, val_tgt, val_w,
                 fcfg: ForestConfig, *, warm=None, x_raw=None,
                 val_raw=None, group: Optional[dist.ProcessGroup] = None
                 ) -> BoostResult:
    """One (timestep, class) ensemble. tgt/val_tgt ``[n, p]``.

    MO: one vector-leaf boosting run, one lane. SO: one scalar-leaf run per
    output, as p lanes of one :func:`fit_boosted` call on the shared codes.
    Returns a :class:`BoostResult` whose lane dimension is the sub-ensemble
    dimension: MO feat ``[1, T, H]``, leaf ``[1, T, L, p]``; SO feat
    ``[p, T, H]``, leaf ``[p, T, L, 1]``. ``warm`` carries the previous
    result's arrays with that leading dimension. ``group``: the data ranks
    of a sharded fit.
    """
    if fcfg.multi_output:
        lanes, val_lanes = tgt[None], val_tgt[None]
    else:
        lanes = tgt.T.unsqueeze(-1).contiguous()
        val_lanes = val_tgt.T.unsqueeze(-1).contiguous()
    return fit_boosted(codes, lanes, w, edges_sentinel, val_codes, val_lanes,
                       val_w, fcfg, warm=warm, x_raw=x_raw, val_raw=val_raw,
                       group=group)
