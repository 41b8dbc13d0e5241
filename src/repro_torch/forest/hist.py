"""Gradient/count histogram accumulation: the XGBoost ``hist`` hot spot.

``build_histogram`` is the trainer's one call into the histogram kernel. It
brings its inputs to the types the kernel takes and hands them to
:func:`repro_torch.kernels.hist.ops.histogram`, where the tensors' device
picks the path: the plain PyTorch version on the CPU, the hand-written CUDA
kernel on the GPU. The lane dimension ``S`` batches the SO outputs, which
share the codes, into one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hist.ops import CODE_DTYPES, histogram


def build_histogram(codes, node_id, g, w, n_nodes: int, n_bins: int):
    """Per-(lane, node, feature, bin) gradient sums and weights.

    codes ``[n, p]`` int; node_id ``[S, n]`` int; g ``[S, n, out]``; w
    ``[n]``. Returns ``(sum_g [S, n_nodes, p, n_bins, out], count [S,
    n_nodes, p, n_bins])`` f32.
    """
    if codes.dtype not in CODE_DTYPES:
        codes = codes.to(torch.int32)
    return histogram(codes.contiguous(), node_id.to(torch.int32).contiguous(),
                     g.to(torch.float32).contiguous(),
                     w.to(torch.float32).contiguous(), n_nodes, n_bins)
