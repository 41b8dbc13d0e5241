"""Plain PyTorch version of the gradient-histogram build, batched over lanes.

The CPU path of :func:`repro_torch.kernels.hist.ops.histogram` and the
version the CUDA kernel is held against on the card. Per feature it does one
``index_add_`` of ``g·w`` into the ``S·n_nodes·p·n_bins`` cells. On the CPU
``index_add_`` adds the rows in order, as ``jax.ops.segment_sum`` does on the
CPU, so this version equals ``repro.kernels.hist.ref.histogram_ref`` to the
bit, lane by lane, and the kernel, which also adds each cell's rows in
order, equals it too. On a CUDA tensor ``index_add_`` uses float atomics,
whose order (and so the last bits of a sum) changes from run to run.

A code outside ``[0, n_bins)`` adds its row to no cell, as in the kernel: it
goes to a spare cell that is never returned.
"""
from __future__ import annotations

import torch


def batched(codes, w, ens, S: int):
    """The one-ensemble form (codes ``[n, p]``, w ``[n]``, ``ens=None``) as
    the batched one: ``codes [1, n, p]``, ``w [1, n]``, every one of the S
    lanes on ensemble 0 (int32). Batched inputs pass through."""
    if codes.dim() == 2:
        codes = codes[None]
    if w.dim() == 1:
        w = w[None]
    if ens is None:
        ens = torch.zeros((S,), dtype=torch.int32, device=codes.device)
    return codes, w, ens


def histogram_ref(codes, node_id, g, w, n_nodes: int, n_bins: int,
                  ens=None):
    """codes ``[E, n, p]`` int; node_id ``[S, n]`` int; g ``[S, n, out]``
    f32; w ``[E, n]`` f32; ens ``[S]`` int in ``[0, E)``: the ensemble of
    each lane. ``codes [n, p]`` and ``w [n]`` with ``ens=None`` are the
    case E = 1, every lane on ensemble 0.

    Returns ``sum_g [S, n_nodes, p, n_bins, out]`` with
    ``sum_g[s, k, j, b] = Σ w[e, i]·g[s, i]`` over the rows i with
    ``node_id[s, i] = k`` and ``codes[e, i, j] = b``, e = ``ens[s]``, and
    ``count [S, n_nodes, p, n_bins]``, the same sum of ``w[e, i]``. Lane s
    is one SO output (or one MO tree) of ensemble ``ens[s]``: the lanes of
    an ensemble share its codes and weights.
    """
    S, n = node_id.shape
    dev = g.device
    codes, w, ens = batched(codes, w, ens, S)
    ens = ens.long()
    E, _, p = codes.shape
    out = g.shape[2]

    def lanes(x):
        """x [E, n] per lane: [S, n], or [1, n] for one ensemble (it
        broadcasts against the lanes, with no copy)."""
        return x if E == 1 else x[ens]

    w_lane = lanes(w)
    gw = (g * w_lane[:, :, None]).reshape(S * n, out)
    ws = w_lane.expand(S, n).reshape(-1)
    lane = torch.arange(S, device=dev)[:, None]
    base = (lane * n_nodes + node_id.long()) * (p * n_bins)     # [S, n]
    cells = S * n_nodes * p * n_bins
    sums = torch.zeros((cells + 1, out), dtype=torch.float32, device=dev)
    cnt = torch.zeros((cells + 1,), dtype=torch.float32, device=dev)
    for j in range(p):
        code = lanes(codes[:, :, j].long())
        seg = torch.where((code >= 0) & (code < n_bins),
                          base + j * n_bins + code, cells).reshape(-1)
        sums.index_add_(0, seg, gw)
        cnt.index_add_(0, seg, ws)
    return (sums[:cells].view(S, n_nodes, p, n_bins, out),
            cnt[:cells].view(S, n_nodes, p, n_bins))
