"""``forest_predict``: the one entry point every forest traversal goes through.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`), which takes any depth and any number of trees; on a
CUDA device it launches the hand-written kernels (``csrc/tree_predict.cu``,
built at first use by :mod:`repro_torch.kernels.build`) on the current
stream, without a sync, or raises. ``forest_predict.launches`` counts the
calls that launched them (one call: a routing and a summing kernel per
chunk of trees, or the fused SO kernel), so a run can show that its main
path went through the kernel; ``forest_predict.so_ring_launches`` counts
the SO calls whose plan (:func:`so_plan`) staged the trees in shared memory.
``forest_predict.sum_tma_launches`` and ``.sum_plain_launches`` count the
out > 1 summing kernels by kind, as the launcher reports them: the leaves
fed by TMA (``sum_tma_kernel``, where a leaf row is 16-byte aligned) or by
``cp.async`` from all threads (``sum_kernel``, e.g. at 533 outputs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.tree_predict.ref import forest_predict_ref

MAX_DEPTH = 16            # the kernels keep leaf indices as uint16
SCRATCH_BYTES = 64 << 20  # leaf-index scratch of one chunk of trees, at most
SMEM_PER_BLOCK = 232_448  # shared memory a block may use on an H100
SO_STAGES = 2             # csrc: kSoStages, slices a ring
SO_WARPS = 15             # walking warps a block at most (csrc: kSoWarps - 1)
SO_CHAINS = 4             # csrc: kSoChains, walks a thread keeps going
# the launcher's report: summing launches fed by TMA, and by cp.async
_SumLaunches = ctypes.c_int * 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    return declare(load("tree_predict"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch functions' C signatures on a built library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = ([ptr] * 6 + [i32] * 12
                                        + [ptr, ctypes.POINTER(i32)])
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


def so_slice_bytes(trees: int, depth: int) -> int:
    """One stage of an SO ring (csrc: ``so_slice_bytes``): feat, thr and
    leaf of ``trees`` trees, each copied as the 16-byte-aligned span that
    covers it, so each part holds its values and 3 more, in 16-byte units."""
    H, L = 2 ** depth - 1, 2 ** depth
    return 4 * (2 * ((trees * H + 6) // 4 * 4) + (trees * L + 6) // 4 * 4)


def so_smem_bytes(p: int, depth: int, rows: int, rings: int,
                  trees: int) -> int:
    """``so_kernel``'s shared memory (csrc: ``so_bytes``): a full and an
    empty mbarrier a stage (rounded up to 128 bytes), x for ``rows`` rows,
    ``rings`` rings of ``SO_STAGES`` slices of ``trees`` trees."""
    bars = -(-16 * rings * SO_STAGES // 128) * 128
    return (bars + 4 * p * rows
            + rings * SO_STAGES * so_slice_bytes(trees, depth))


def so_plan(B: int, S: int, T: int, depth: int, p: int, n: int):
    """``(rows, rings, trees)`` for an SO launch (out = 1) at these shapes:
    ``so_kernel`` stages x for ``rows`` rows (a multiple of 32) and feeds
    ``rings`` sub-forests at once, ``trees`` trees a slice; None where not
    even 32 rows and one ring of one-tree slices fit a block's shared
    memory (``so_l1_kernel`` reads x and the trees through L1).

    A pure function of the shapes. Of the plans that fit, it takes the one
    with the most walks in flight (walking warps × trees a slice, at most
    SO_CHAINS), then the most rows (each staged tree serves more rows),
    then the largest slices. Rows stop at n rounded up to 32, rings at S
    and at SO_WARPS walking warps."""
    if so_smem_bytes(p, depth, 32, 1, 1) > SMEM_PER_BLOCK:
        return None
    best, best_key = None, None
    for trees in {min(T, SO_CHAINS), min(T, 2), 1}:
        for rows in range(32, min(128, -(-n // 32) * 32) + 1, 32):
            rings = 0
            while (rings < min(S, SO_WARPS // (rows // 32))
                   and so_smem_bytes(p, depth, rows, rings + 1, trees)
                   <= SMEM_PER_BLOCK):
                rings += 1
            key = (rings * rows // 32 * trees, rows, trees)
            if rings and (best_key is None or key > best_key):
                best, best_key = (rows, rings, trees), key
    return best


# the wrapper's plan of each SO shape it has launched
_so_plan = functools.lru_cache(maxsize=1024)(so_plan)


def launch(lib, x, feat, thr_val, leaf, depth: int, so=None):
    """Launch the kernels of ``lib`` on checked CUDA tensors; returns
    ``(y, (TMA summing launches, plain summing launches))``, the second as
    the launcher reports them. ``so``: the plan of an SO launch
    (:func:`so_plan`), None for the L1 kernel."""
    from repro_torch.kernels.build import check_launch
    B, n, p = x.shape
    S, T = feat.shape[1], feat.shape[2]
    n_out = leaf.shape[-1]
    if depth > MAX_DEPTH:
        raise ValueError(f"depth={depth}: the CUDA tree_predict kernel takes "
                         f"depth <= {MAX_DEPTH} (uint16 leaf indices); the "
                         "CPU path takes any depth")
    y = torch.empty((B, S, n, n_out), dtype=torch.float32, device=x.device)
    sums = _SumLaunches()
    if y.numel() == 0:
        return y, tuple(sums)
    tc, npad = tiling(B, S, T, n)
    scratch = torch.empty((B * S * tc * npad if n_out > 1 else 0,),
                          dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr_val.data_ptr(),
            leaf.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, S, n, p,
            T, depth, n_out, tc, npad, *(so or (0, 0, 0)), stream, sums)
    check_launch("tree_predict", rc)
    return y, tuple(sums)


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
    so = None
    if leaf.shape[-1] == 1:
        B, n, p = x.shape
        so = _so_plan(B, feat.shape[1], feat.shape[2], depth, p, n)
    y, (tma, plain) = launch(_lib(), x, feat, thr_val, leaf, depth, so)
    if y.numel():
        from repro_torch.kernels.build import count_launch
        kinds = ["so_ring_launches"] if so else []
        kinds += ["sum_tma_launches"] * tma + ["sum_plain_launches"] * plain
        count_launch(forest_predict, *kinds)
    return y


forest_predict.launches = 0
forest_predict.so_ring_launches = 0
forest_predict.sum_tma_launches = 0
forest_predict.sum_plain_launches = 0


def sum_launches(counts) -> dict:
    """``{"sum_tma": k, "sum_plain": k}``: the summing launches of each kind
    in a count of launches by ``(wrapper, counter)``, as
    :func:`~repro_torch.kernels.build.recorded_launches` and
    :func:`~repro_torch.kernels.build.tallied_launches` give it (0 and 0
    for CPU work, which launches no kernel)."""
    return {"sum_tma": counts[forest_predict, "sum_tma_launches"],
            "sum_plain": counts[forest_predict, "sum_plain_launches"]}
