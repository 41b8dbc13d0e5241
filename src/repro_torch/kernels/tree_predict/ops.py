"""``forest_predict``: the one entry point every forest traversal goes through.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`), which takes any depth and any number of trees; on a
CUDA device it launches the hand-written kernels (``csrc/tree_predict.cu``,
built at first use by :mod:`repro_torch.kernels.build`) on the current
stream, without a sync, or raises. ``forest_predict.launches`` counts the
calls that launched them (one call: a routing and a summing kernel per
chunk of trees, or the fused SO kernel), so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.tree_predict.ref import forest_predict_ref

MAX_DEPTH = 16            # the kernels keep leaf indices as uint16
SCRATCH_BYTES = 64 << 20  # leaf-index scratch of one chunk of trees, at most


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    return declare(load("tree_predict"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch functions' C signatures on a built library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.tree_predict_launch.restype = i32
    return lib


def _check(x, feat, thr_val, leaf, depth: int) -> None:
    if depth < 1:
        raise ValueError(f"depth={depth}: must be >= 1")
    for name, t, dtype in (("x", x, torch.float32), ("feat", feat, torch.int32),
                           ("thr_val", thr_val, torch.float32),
                           ("leaf", leaf, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3 or feat.dim() != 4 or leaf.dim() != 5:
        raise ValueError(
            f"expected x [B,n,p], feat [B,S,T,H], leaf [B,S,T,L,out]; got "
            f"{tuple(x.shape)}, {tuple(feat.shape)}, {tuple(leaf.shape)}")
    B, S, T = feat.shape[:3]
    H, L = 2 ** depth - 1, 2 ** depth
    if (x.shape[0] != B or tuple(feat.shape) != (B, S, T, H)
            or tuple(thr_val.shape) != (B, S, T, H)
            or tuple(leaf.shape[:4]) != (B, S, T, L)):
        raise ValueError(
            f"shapes disagree for depth {depth}: x {tuple(x.shape)}, feat "
            f"{tuple(feat.shape)}, thr_val {tuple(thr_val.shape)}, leaf "
            f"{tuple(leaf.shape)}")


def tiling(B: int, S: int, T: int, n: int):
    """``(tc, npad)``: trees a chunk, so that the ``[B, S, tc, npad]`` uint16
    leaf-index scratch of an out > 1 launch stays within ``SCRATCH_BYTES``;
    npad is n rounded up to 8, for the kernel's 16-byte copies."""
    npad = -(-n // 8) * 8
    return max(1, min(T, SCRATCH_BYTES // max(1, 2 * B * S * npad))), npad


def launch(lib, x, feat, thr_val, leaf, depth: int):
    """Launch the kernels of ``lib`` on checked CUDA tensors; returns y."""
    from repro_torch.kernels.build import check_launch
    B, n, p = x.shape
    S, T = feat.shape[1], feat.shape[2]
    n_out = leaf.shape[-1]
    if depth > MAX_DEPTH:
        raise ValueError(f"depth={depth}: the CUDA tree_predict kernel takes "
                         f"depth <= {MAX_DEPTH} (uint16 leaf indices); the "
                         "CPU path takes any depth")
    y = torch.empty((B, S, n, n_out), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    tc, npad = tiling(B, S, T, n)
    scratch = torch.empty((B * S * tc * npad if n_out > 1 else 0,),
                          dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr_val.data_ptr(),
            leaf.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, S, n, p,
            T, depth, n_out, tc, npad, stream)
    check_launch("tree_predict", rc)
    return y


def forest_predict(x, feat, thr_val, leaf, depth: int):
    """x ``[B, n, p]`` f32; feat ``[B, S, T, H]`` i32; thr_val ``[B, S, T, H]``
    f32; leaf ``[B, S, T, L, out]`` f32 -> ``[B, S, n, out]`` f32.

    Every feature index must lie in ``[0, p)``; artifacts are checked for
    that once, on the host, when they are loaded. The CUDA kernels take
    depth <= ``MAX_DEPTH`` and any number of trees.
    """
    _check(x, feat, thr_val, leaf, depth)
    if x.device.type == "cpu":
        return forest_predict_ref(x, feat, thr_val, leaf, depth)
    if x.device.type != "cuda":
        raise ValueError(f"no tree_predict path for device {x.device}")
    y = launch(_lib(), x, feat, thr_val, leaf, depth)
    if y.numel():
        from repro_torch.kernels.build import count_launch
        count_launch(forest_predict)
    return y


forest_predict.launches = 0
