"""Gradient/count histogram accumulation: the XGBoost ``hist`` hot spot.

``build_histogram`` is the trainer's one call into the histogram kernel. It
brings its inputs to the types the kernel takes and hands them to
:func:`repro_torch.kernels.hist.ops.histogram`, where the tensors' device
picks the path: the plain PyTorch version on the CPU, the hand-written CUDA
kernel on the GPU. The lane dimension ``S`` batches the SO outputs, which
share their ensemble's codes, and the ensembles of a batch, each with its
own codes and weights, into one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hist.ops import CODE_DTYPES, histogram


def build_histogram(codes, node_id, g, w, n_nodes: int, n_bins: int,
                    ens=None):
    """Per-(lane, node, feature, bin) gradient sums and weights.

    codes ``[E, n, p]`` int; node_id ``[S, n]`` int; g ``[S, n, out]``; w
    ``[E, n]``; ens ``[S]`` int, each lane's ensemble (codes ``[n, p]``, w
    ``[n]`` and ``ens=None``: one ensemble). Returns ``(sum_g [S, n_nodes,
    p, n_bins, out], count [S, n_nodes, p, n_bins])`` f32.
    """
    if codes.dtype not in CODE_DTYPES:
        codes = codes.to(torch.int32)
    if ens is not None:
        ens = ens.to(torch.int32).contiguous()
    return histogram(codes.contiguous(), node_id.to(torch.int32).contiguous(),
                     g.to(torch.float32).contiguous(),
                     w.to(torch.float32).contiguous(), n_nodes, n_bins, ens)
