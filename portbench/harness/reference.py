"""The plain reference that decides ``correct``: plain PyTorch and NumPy.

It imports nothing of the program (``repro_torch``) and nothing of the JAX
package: every function here is written out again, a frozen copy of the
semantics the port documents, so a later change to the port cannot move
the yardstick. It works out again whatever the port derives from a seed
(the class split and scalers, the bridge, the quantile edges, the x1 noise
blocks, the label counts and the shuffle) from the same inputs that the
benchmark hands the program: the showers, the bridge noise, the model's
weights.

Two computations:

* :func:`follow_fit` - one (timestep, class) ensemble of a fit call:
  per-class min-max scaling, K-fold duplication, the flow bridge, quantile
  edges and bin codes, then, following the program's trees round by
  round, gradient histograms, every split's second-order gain, Newton
  leaves and the validation curve.
* :func:`generate_call` - one euler generate call: labels, x1 in seeded
  blocks of 1,024 rows, the euler solve over the stacked forests (trees
  summed in order 0 ... T-1), unscaling, unpadding and the shuffle.
  ``dtype`` computes the solve in a lower precision (the control).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

NOISE_BLOCK = 1024          # rows of one x1 block of a generate call
X1_STREAM = 0               # a generate call's x1 stream


def stream_seed(*words: int) -> int:
    """A 63-bit generator seed from integer words (seed, stream, ...)."""
    ss = np.random.SeedSequence([w % 2 ** 64 for w in words])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def linspace32(start: float, stop: float, num: int) -> torch.Tensor:
    """``start·(1-s) + stop·s`` with ``s = iota·(1/(num-1))`` in float32,
    the last point exactly ``stop``."""
    lo = torch.tensor(start, dtype=torch.float32)
    hi = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return lo[None]
    div = num - 1
    s = torch.arange(div, dtype=torch.float32) * torch.tensor(
        1.0 / div, dtype=torch.float32)
    return torch.cat([lo * (1 - s) + hi * s, hi[None]])


def flow_grid(n_t: int) -> torch.Tensor:
    """The uniform flow-matching time grid ``[n_t]`` from 0 to 1."""
    return linspace32(0.0, 1.0, n_t)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def label_counts(counts: Sequence[int], n: int) -> np.ndarray:
    """Rows of each class in a call of ``n`` rows: the empirical
    proportions, floored, the remainder to the largest fractions."""
    counts = np.asarray(counts)
    reps = np.floor(n * counts / counts.sum()).astype(int)
    rem = n - reps.sum()
    frac = n * counts / counts.sum() - reps
    reps[np.argsort(-frac)[:rem]] += 1
    return reps


def x1_blocks(seed: int, n_y: int, m: int, p: int, device) -> torch.Tensor:
    """Standard-normal x1 ``[n_y, m, p]``: class c's rows come in blocks of
    :data:`NOISE_BLOCK`, block b from a generator seeded by
    ``(seed, X1_STREAM, c, b)``."""
    blocks = -(-m // NOISE_BLOCK)
    x1 = torch.empty((n_y, blocks * NOISE_BLOCK, p), dtype=torch.float32,
                     device=device)
    gen = torch.Generator(device=device)
    for c in range(n_y):
        for b in range(blocks):
            gen.manual_seed(stream_seed(seed, X1_STREAM, c, b))
            x1[c, b * NOISE_BLOCK:(b + 1) * NOISE_BLOCK].normal_(
                generator=gen)
    return x1[:, :m].contiguous()


def forest_sum(x, feat, thr, leaf, depth: int) -> torch.Tensor:
    """Multi-output forests, one a class: x ``[B, n, p]``, feat / thr
    ``[B, T, H]``, leaf ``[B, T, L, out]`` -> ``[B, n, out]``, the leaves of
    trees 0 ... T-1 added in that order. A row goes right at node h iff
    ``x[feat[h]] > thr[h]``."""
    B, n, _ = x.shape
    T, out = feat.shape[1], leaf.shape[-1]
    acc = torch.zeros((B, n, out), dtype=x.dtype, device=x.device)
    for t in range(T):
        node = torch.zeros((B, n), dtype=torch.long, device=x.device)
        for level in range(depth):
            heap = node + (2 ** level - 1)
            f = torch.gather(feat[:, t].long(), 1, heap)
            v = torch.gather(x, 2, f.unsqueeze(-1)).squeeze(-1)
            node = node * 2 + (v > torch.gather(thr[:, t], 1, heap))
        acc = acc + torch.gather(
            leaf[:, t], 1, node.unsqueeze(-1).expand(B, n, out))
    return acc


def span(mins, maxs):
    """``max - min``, with degenerate columns pinned to 1."""
    return torch.where(maxs > mins, maxs - mins, torch.ones_like(mins))


def generate_call(model: Dict, n: int, seed: int, pad_to: Optional[int],
                  *, dtype=torch.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Rows and labels of one euler call of ``n`` rows with ``seed``.

    ``model``: ``feat`` / ``thr`` ``[n_t, n_y, T, H]``, ``leaf`` ``[n_t,
    n_y, T, L, out]``, ``mins`` / ``maxs`` ``[n_y, p]``, ``counts``,
    ``classes``, ``depth``. The solve runs in ``dtype`` (float32: the
    configuration's precision)."""
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
        v = forest_sum(x, feat[i], thr[i].to(dtype), leaf[i].to(dtype),
                       model["depth"])
        x = x - h.to(dtype) * v
    x = x.float()
    mins, maxs = model["mins"][:, None, :], model["maxs"][:, None, :]
    x = (x + 1.0) / 2.0 * span(mins, maxs) + mins
    x_all = x.cpu().numpy()
    X = np.concatenate([x_all[c, :k] for c, k in enumerate(per_class)])
    y = np.repeat(np.asarray(model["classes"]), per_class)
    perm = np.random.default_rng(seed).permutation(len(X))
    return X[perm], y[perm]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def class_scaler(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature float32 min and max of one class's rows."""
    return rows.min(axis=0), rows.max(axis=0)


def scale_rows(rows: np.ndarray, mins: np.ndarray, maxs: np.ndarray
               ) -> np.ndarray:
    """Rows to [-1, 1] in float64 (the span of a degenerate column is 1),
    stored as float32."""
    gt = maxs > mins
    sp = (maxs - mins) * gt + (1 - gt)
    return ((rows - mins) / sp * 2.0 - 1.0).astype(np.float32)


def quantile_edges(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Edges ``[p, n_bins - 1]``: of each column sorted, the entries at
    ``int(b/n_bins · (n - 1))`` for b = 1 ... n_bins - 1 (all rows weigh
    1)."""
    s = torch.sort(x, dim=0).values
    inv = torch.tensor(1.0, dtype=torch.float32) / n_bins
    qs = torch.arange(1, n_bins, dtype=torch.float32) * inv
    n_real = torch.tensor(float(x.shape[0]), dtype=torch.float32)
    idx = torch.clamp((qs * (n_real - 1.0)).to(torch.int32), 0,
                      x.shape[0] - 1)
    return s[idx.long().to(x.device)].T.contiguous()


def bin_codes(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``code[i, j]``: the number of edges of feature j strictly below
    ``x[i, j]``."""
    return torch.searchsorted(edges.contiguous(), x.T.contiguous(),
                              right=False).T.contiguous()


def histograms(codes, node, g, n_nodes: int, n_bins: int):
    """``sum_g [n_nodes, p, n_bins, out]`` and ``count [n_nodes, p,
    n_bins]``: the rows of each (node, feature, bin) summed, one
    ``index_add_`` a feature (every row weighs 1)."""
    n, p = codes.shape
    out = g.shape[1]
    vals = torch.cat([g, torch.ones((n, 1), dtype=g.dtype, device=g.device)],
                     dim=1)
    base = node.long() * (p * n_bins)
    cells = torch.zeros((n_nodes * p * n_bins, out + 1), dtype=g.dtype,
                        device=g.device)
    for j in range(p):
        cells.index_add_(0, base + j * n_bins + codes[:, j].long(), vals)
    cells = cells.view(n_nodes, p, n_bins, out + 1)
    return cells[..., :out], cells[..., out]


def _prefix_sum(x, dim: int):
    """Inclusive cumulative sum along ``dim``: in order within blocks of
    16, then each block plus the total of the blocks before it."""
    dim = dim % x.dim()
    length = x.shape[dim]
    if length <= 16:
        y = x.clone()
        for k in range(1, length):
            y.select(dim, k).add_(y.select(dim, k - 1))
        return y
    blocks = -(-length // 16)
    pad = blocks * 16 - length
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    y = _prefix_sum(x.unflatten(dim, (blocks, 16)), dim + 1)
    totals = _prefix_sum(y.select(dim + 1, 15), dim)
    y.narrow(dim, 1, blocks - 1).add_(
        totals.narrow(dim, 0, blocks - 1).unsqueeze(dim + 1))
    return y.flatten(dim, dim + 1).narrow(dim, 0, length)


def _row_sum(x):
    """Sum over the last dimension in a fixed order: up to 32 left to
    right, longer rows in contiguous chunks of ceil(n/32) added in order,
    then their partial sums the same way."""
    n = x.shape[-1]
    if n <= 32:
        acc = x[..., 0].clone()
        for k in range(1, n):
            acc.add_(x[..., k])
        return acc
    w = -(-n // 32)
    acc = x[..., :w].clone()
    for start in range(w, n, w):
        part = x[..., start:start + w]
        acc[..., :part.shape[-1]].add_(part)
    return _row_sum(acc)


def split_gains(sum_g, count, reg_lambda: float, min_child_weight: float):
    """The second-order gain ``[nodes, p, bins]`` of every (feature, bin)
    split of every node, summed over the outputs (``-inf`` where a child
    would weigh less than ``min_child_weight``), and each node's own score
    ``[nodes]``, the sum the gain of a split is taken from."""
    gl = _prefix_sum(sum_g, -2)
    hl = _prefix_sum(count, -1)
    gt, ht = gl[..., -1:, :], hl[..., -1:]
    gr, hr = gt - gl, ht - hl

    def score(g2, h):
        return _row_sum(torch.square(g2)) / (h + reg_lambda + 1e-12)

    whole = score(gt, ht)
    gain = score(gl, hl) + score(gr, hr) - whole
    valid = (hl >= min_child_weight) & (hr >= min_child_weight)
    return torch.where(valid, gain, -torch.inf), whole[:, 0, 0]


def route_codes(codes, feat, thr, depth: int) -> torch.Tensor:
    """The leaf of every row of ``codes`` in a tree grown on codes."""
    n = codes.shape[0]
    rows = torch.arange(n, device=codes.device)
    node = torch.zeros((n,), dtype=torch.long, device=codes.device)
    for level in range(depth):
        h = node + (2 ** level - 1)
        node = node * 2 + (codes[rows, feat[h]] > thr[h]).long()
    return node


def val_loss(pred, tgt) -> float:
    """Mean squared error over rows and outputs, summed in float64."""
    return float(torch.square(pred.double() - tgt.double()).sum()
                 / tgt.numel())


def _regret(codes, node, g, k: int, bins: int, lam: float, mcw: float,
            f, b) -> float:
    """The widest gain that a level's splits ``(f, b)`` give away against
    each node's best, as a share of the node's own score (a share of the
    best gain would blow up where the gain is a small difference of large
    scores)."""
    sum_g, count = histograms(codes, node, g, k, bins)
    gain, whole = split_gains(sum_g, count, lam, mcw)
    gain = gain.reshape(k, -1)
    del sum_g, count
    best = gain.max(1).values.clamp(min=0.0)
    chosen = torch.where(b < bins - 1,
                         gain[torch.arange(k, device=gain.device),
                              f * bins + b], 0.0)
    regret = torch.where(whole > 0, (best - chosen) / whole,
                         torch.where(best > chosen, torch.inf, 0.0))
    return float(regret.max())


def follow_fit(rows: np.ndarray, noise_train: torch.Tensor,
               noise_val: torch.Tensor, t: float, fcfg: Dict, prog: Dict,
               device, split_rounds=None) -> Dict[str, float]:
    """Follow one ensemble that the program fitted, round by round, and
    judge it. ``rows``: one class's raw rows ``[m, p]``; the bridge noise
    ``[m·K, p]`` of the training and the validation split; ``t``; ``prog``:
    the program's ``feat`` / ``thr_val`` ``[R, H]``, ``leaf`` ``[R, L,
    out]``, ``val_curve`` ``[R]``, ``mins`` / ``maxs`` ``[p]`` of its R
    rounds; ``split_rounds``: the rounds whose splits are judged (``None``:
    every round).

    The reference works out the inputs itself (scalers, duplication, the
    bridge, the quantile edges, the codes). Then, each round, it takes the
    program's tree structure, routes the rows by it level by level, builds
    its own histograms of its own gradients and finds every split's gain;
    it grows its own Newton leaves on that structure and advances its own
    predictions with them. In a round outside ``split_rounds`` it only
    routes the rows by the program's splits: every round's leaves and
    validation loss are judged, the histograms and gains, the costly part,
    only in the rounds sampled. Summation order differs from the
    program's, so a near tie may go either way: the reference judges the
    program's splits by their gains rather than growing its own trees.

    Returns ``scaler_gap`` (largest difference of the min-max scalers),
    ``edge_mismatch`` (splits whose threshold is no edge of the
    reference's), ``split_regret`` (the widest gap between a node's best
    gain and the gain of the program's split, as a share of the node's own
    score), ``leaf_gap`` (the widest norm of
    a round's leaf difference, relative to the larger of that round's
    reference norm and the median round's) and ``val_loss_gap`` (the
    widest relative gap of a round's validation loss)."""
    if not fcfg["multi_output"] or fcfg["method"] != "flow":
        raise ValueError("the reference fits multi-output flow ensembles")
    depth, bins = fcfg["max_depth"], fcfg["n_bins"]
    lam, mcw = fcfg["reg_lambda"], fcfg["min_child_weight"]
    mins, maxs = class_scaler(rows)
    x0 = torch.from_numpy(scale_rows(rows, mins, maxs)).to(device)
    x0 = x0.repeat_interleave(fcfg["duplicate_k"], dim=0)
    tt = torch.tensor(t, dtype=torch.float32, device=device)

    def bridge(x1):
        return torch.addcmul((1.0 - tt) * x0, x1, tt), x1 - x0

    xt, tgt = bridge(noise_train.to(device))
    edges = quantile_edges(xt, bins)
    codes = bin_codes(xt, edges)
    xtv, tgtv = bridge(noise_val.to(device))
    codes_v = bin_codes(xtv, edges)
    del xt, xtv, x0
    edges_inf = torch.cat([edges, torch.full((edges.shape[0], 1), torch.inf,
                                             device=device)], dim=1)
    n = codes.shape[0]
    rows_i = torch.arange(n, device=device)
    pred = torch.zeros_like(tgt)
    vpred = torch.zeros_like(tgtv)
    res = {"scaler_gap": float(max(np.abs(prog["mins"] - mins).max(),
                                   np.abs(prog["maxs"] - maxs).max())),
           "edge_mismatch": 0.0, "split_regret": 0.0}
    leaf_diff, leaf_norm, vloss = [], [], []
    rounds = len(prog["val_curve"])
    judged = set(range(rounds) if split_rounds is None else split_rounds)
    for r in range(rounds):
        feat = torch.as_tensor(prog["feat"][r], device=device).long()
        thr_val = torch.as_tensor(prog["thr_val"][r], device=device)
        # each split's bin: the first edge of its feature at its threshold
        hit = edges_inf[feat] == thr_val[:, None]
        res["edge_mismatch"] += float((~hit.any(1)).sum())
        thr = torch.where(hit.any(1), hit.int().argmax(1), bins - 1)
        g = pred - tgt
        node = torch.zeros((n,), dtype=torch.long, device=device)
        for level in range(depth):
            k = 2 ** level
            f, b = feat[k - 1:2 * k - 1], thr[k - 1:2 * k - 1]
            if r in judged:
                res["split_regret"] = max(res["split_regret"], _regret(
                    codes, node, g, k, bins, lam, mcw, f, b))
            node = node * 2 + (codes[rows_i, f[node]] > b[node]).long()
        L = 2 ** depth
        leaf_g = torch.zeros((L, g.shape[1]), device=device).index_add_(
            0, node, g)
        leaf_h = torch.zeros((L,), device=device).index_add_(
            0, node, torch.ones((n,), device=device))
        leaf = -fcfg["learning_rate"] * leaf_g / (leaf_h[:, None] + lam
                                                  + 1e-12)
        got = torch.as_tensor(prog["leaf"][r], device=device)
        leaf_diff.append(float(torch.linalg.norm(got - leaf)))
        leaf_norm.append(float(torch.linalg.norm(leaf)))
        pred = pred + leaf[node]
        vpred = vpred + leaf[route_codes(codes_v, feat, thr, depth)]
        vloss.append(val_loss(vpred, tgtv))
    scale = np.maximum(leaf_norm, np.median(leaf_norm))
    res["leaf_gap"] = float(np.max(np.asarray(leaf_diff) / scale))
    want = np.asarray(vloss)
    res["val_loss_gap"] = float(np.max(
        np.abs(np.asarray(prog["val_curve"], np.float64) - want) / want))
    return res
