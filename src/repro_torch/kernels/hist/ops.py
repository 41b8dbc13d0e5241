"""``histogram``: the gradient histograms of one tree level, for all lanes.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`); on a CUDA device it launches the hand-written kernel
(``csrc/hist.cu``, built at first use by :mod:`repro_torch.kernels.build`)
on the current stream, without a sync, or raises. ``histogram.launches``
counts kernel launches, so a run can show that its main path went through
the kernel.

Before the launch the wrapper sorts each lane's rows by node, stably (so
rows keep their order inside a node), and finds where each node's rows
start; a block of the kernel then walks the rows of one node only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.hist.ref import histogram_ref

CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
_GRID_YZ = 65535       # CUDA's limit on gridDim.y (nodes) and gridDim.z (S)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("hist")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hist_launch.argtypes = ([ptr, i32] + [ptr] * 6 + [i32] * 6 + [ptr])
    lib.hist_launch.restype = i32
    return lib


def _check(codes, node_id, g, w, n_nodes: int, n_bins: int) -> None:
    if codes.dtype not in CODE_DTYPES:
        raise TypeError(f"codes must be int8, int16 or int32, got {codes.dtype}")
    for name, t, dtype in (("node_id", node_id, torch.int32),
                           ("g", g, torch.float32), ("w", w, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in (("codes", codes), ("node_id", node_id), ("g", g),
                    ("w", w)):
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dim() != 2 or node_id.dim() != 2 or g.dim() != 3 or w.dim() != 1:
        raise ValueError(
            f"expected codes [n,p], node_id [S,n], g [S,n,out], w [n]; got "
            f"{tuple(codes.shape)}, {tuple(node_id.shape)}, {tuple(g.shape)}, "
            f"{tuple(w.shape)}")
    n = codes.shape[0]
    S = node_id.shape[0]
    if node_id.shape[1] != n or tuple(g.shape[:2]) != (S, n) or w.shape[0] != n:
        raise ValueError(
            f"row counts disagree: codes {tuple(codes.shape)}, node_id "
            f"{tuple(node_id.shape)}, g {tuple(g.shape)}, w {tuple(w.shape)}")
    if n_nodes < 1 or n_bins < 1 or g.shape[2] < 1:
        raise ValueError(f"n_nodes={n_nodes}, n_bins={n_bins}, out="
                         f"{g.shape[2]}: each must be >= 1")


def node_order(node_id, n_nodes: int):
    """Each lane's rows grouped by node, in row order within a node.

    node_id ``[S, n]`` i32 -> ``(order [S, n] i32, offsets [S, n_nodes + 1]
    i32)``: the rows of node k of lane s are ``order[s, offsets[s, k] :
    offsets[s, k + 1]]``, ascending. Rows whose node lies outside ``[0,
    n_nodes)`` fall outside every range.
    """
    S = node_id.shape[0]
    order = torch.argsort(node_id, dim=1, stable=True)
    bounds = torch.arange(n_nodes + 1, dtype=torch.int32,
                          device=node_id.device)
    offsets = torch.searchsorted(torch.gather(node_id, 1, order),
                                 bounds.expand(S, -1).contiguous(),
                                 out_int32=True)
    return order.to(torch.int32), offsets


def histogram(codes, node_id, g, w, n_nodes: int, n_bins: int):
    """codes ``[n, p]`` int8/int16/int32 in ``[0, n_bins)``, shared by all
    lanes; node_id ``[S, n]`` i32 in ``[0, n_nodes)``; g ``[S, n, out]`` f32;
    w ``[n]`` f32 -> ``(sum_g [S, n_nodes, p, n_bins, out], count [S,
    n_nodes, p, n_bins])`` f32, as :func:`.ref.histogram_ref`.

    MO trees call it with ``S = 1, out = p``; SO trees with one lane per
    output, ``S = p, out = 1``.
    """
    _check(codes, node_id, g, w, n_nodes, n_bins)
    if g.device.type == "cpu":
        return histogram_ref(codes, node_id, g, w, n_nodes, n_bins)
    if g.device.type != "cuda":
        raise ValueError(f"no hist path for device {g.device}")
    from repro_torch.kernels.build import check_launch
    lib = _lib()
    n, p = codes.shape
    S, out = node_id.shape[0], g.shape[2]
    if S > _GRID_YZ or n_nodes > _GRID_YZ:
        raise ValueError(f"S={S}, n_nodes={n_nodes}: each must be <= "
                         f"{_GRID_YZ}")
    dev = g.device
    sum_g = torch.empty((S, n_nodes, p, n_bins, out), dtype=torch.float32,
                        device=dev)
    count = torch.empty((S, n_nodes, p, n_bins), dtype=torch.float32,
                        device=dev)
    if n == 0 or p == 0:
        return sum_g.zero_(), count.zero_()
    order, offsets = node_order(node_id, n_nodes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hist_launch(
            codes.data_ptr(), codes.element_size(), order.data_ptr(),
            offsets.data_ptr(), g.data_ptr(), w.data_ptr(), sum_g.data_ptr(),
            count.data_ptr(), S, n, p, out, n_nodes, n_bins, stream)
    check_launch("hist", rc)
    histogram.launches += 1
    return sum_g, count


histogram.launches = 0
