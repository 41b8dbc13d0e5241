"""``forest_predict``: the one entry point every forest traversal goes through.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`); on a CUDA device it launches the hand-written kernel
(``csrc/tree_predict.cu``, built at first use by
:mod:`repro_torch.kernels.build`) on the current stream, without a sync, or
raises. ``forest_predict.launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.tree_predict.ref import forest_predict_ref

MAX_DEPTH = 8          # leaf indices are kept as uint8 in shared memory
_SMEM_BYTES = 48 * 1024  # default dynamic shared memory a block may use
_GRID_YZ = 65535       # CUDA's limit on gridDim.y (S) and gridDim.z (B)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("tree_predict")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.tree_predict_launch.restype = i32
    lib.tree_predict_rows_per_block.argtypes = []
    lib.tree_predict_rows_per_block.restype = i32
    return lib


def _check(x, feat, thr_val, leaf, depth: int) -> None:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth={depth}: the kernel takes 1..{MAX_DEPTH}")
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


def forest_predict(x, feat, thr_val, leaf, depth: int):
    """x ``[B, n, p]`` f32; feat ``[B, S, T, H]`` i32; thr_val ``[B, S, T, H]``
    f32; leaf ``[B, S, T, L, out]`` f32 -> ``[B, S, n, out]`` f32.

    Every feature index must lie in ``[0, p)``; artifacts are checked for
    that once, on the host, when they are loaded.
    """
    _check(x, feat, thr_val, leaf, depth)
    if x.device.type == "cpu":
        return forest_predict_ref(x, feat, thr_val, leaf, depth)
    if x.device.type != "cuda":
        raise ValueError(f"no tree_predict path for device {x.device}")
    from repro_torch.kernels.build import check_launch
    lib = _lib()
    B, n, p = x.shape
    S, T = feat.shape[1], feat.shape[2]
    n_out = leaf.shape[-1]
    if T * lib.tree_predict_rows_per_block() > _SMEM_BYTES:
        raise ValueError(f"T={T} trees exceed the kernel's shared memory")
    if S > _GRID_YZ or B > _GRID_YZ:
        raise ValueError(f"B={B}, S={S}: each must be <= {_GRID_YZ}")
    y = torch.empty((B, S, n, n_out), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr_val.data_ptr(),
            leaf.data_ptr(), y.data_ptr(), B, S, n, p, T, depth, n_out,
            stream)
    check_launch("tree_predict", rc)
    forest_predict.launches += 1
    return y


forest_predict.launches = 0
