"""Plain PyTorch version of the gradient-histogram build, batched over lanes.

The CPU path of :func:`repro_torch.kernels.hist.ops.histogram` and the
version the CUDA kernel is held against on the card. Per feature it does one
``index_add_`` of ``g·w`` into the ``S·n_nodes·p·n_bins`` cells. On the CPU
``index_add_`` adds the rows in order, as ``jax.ops.segment_sum`` does on the
CPU, so this version equals ``repro.kernels.hist.ref.histogram_ref`` to the
bit, and the kernel, which also adds each cell's rows in order, equals it
too. On a CUDA tensor ``index_add_`` uses float atomics, whose order (and so
the last bits of a sum) changes from run to run.

A code outside ``[0, n_bins)`` adds its row to no cell, as in the kernel: it
goes to a spare cell that is never returned.
"""
from __future__ import annotations

import torch


def histogram_ref(codes, node_id, g, w, n_nodes: int, n_bins: int):
    """codes ``[n, p]`` int; node_id ``[S, n]`` int; g ``[S, n, out]`` f32;
    w ``[n]`` f32.

    Returns ``sum_g [S, n_nodes, p, n_bins, out]`` with
    ``sum_g[s, k, j, b] = Σ w_i·g[s, i]`` over the rows i with
    ``node_id[s, i] = k`` and ``codes[i, j] = b``, and ``count [S, n_nodes,
    p, n_bins]``, the same sum of ``w_i``. Lane s is one SO output (or the
    one MO tree): all lanes share the codes and the weights.
    """
    S, n = node_id.shape
    p = codes.shape[1]
    out = g.shape[2]
    dev = g.device
    gw = (g * w[None, :, None]).reshape(S * n, out)
    ws = w.repeat(S)
    lane = torch.arange(S, device=dev)[:, None]
    base = (lane * n_nodes + node_id.long()) * (p * n_bins)     # [S, n]
    cells = S * n_nodes * p * n_bins
    sums = torch.zeros((cells + 1, out), dtype=torch.float32, device=dev)
    cnt = torch.zeros((cells + 1,), dtype=torch.float32, device=dev)
    for j in range(p):
        code = codes[:, j].long()
        seg = (base + (j * n_bins + code)[None, :])
        seg = torch.where(((code >= 0) & (code < n_bins))[None, :], seg,
                          cells).reshape(-1)
        sums.index_add_(0, seg, gw)
        cnt.index_add_(0, seg, ws)
    return (sums[:cells].view(S, n_nodes, p, n_bins, out),
            cnt[:cells].view(S, n_nodes, p, n_bins))
