"""``histogram``: the gradient histograms of one tree level, for all lanes.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`); on a CUDA device it launches the hand-written kernel
(``csrc/hist.cu``, built at first use by :mod:`repro_torch.kernels.build`)
on the current stream, without a sync, or raises. ``histogram.launches``
counts kernel launches, so a run can show that its main path went through
the kernel. The work is the operator ``repro_torch::histogram``
(``torch.library.custom_op``): a fake or ``meta`` tensor (the dry run's
traced forest slice) is answered from the shapes alone, with no library
built and no launch.

Before the launch the wrapper lays each lane's rows out by node
(:func:`node_layout`: stably, so rows keep their order inside a node, each
node from a multiple of 32 positions) and picks the kernel's tile
(:func:`plan`); a block of the kernel then walks the positions of one node
only. The kernel's layout passes write the rows' values and one-byte codes
in that order (SO narrows the codes as :func:`narrow_codes` does). A code
is one byte in the kernel, so more than ``BYTE_BINS`` bins are split into
contiguous windows (:func:`bin_windows`): one pass of the kernel each, over
the same node layout, each writing its bins straight into the full output.
The plain functions are held by the CPU tests.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.hist.ref import histogram_ref

CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
_GRID_YZ = 65535       # CUDA's limit on gridDim.y (nodes) and gridDim.z (S)
# csrc/hist.cu's tiles and shared-memory limit
MAX_SMEM = 227 * 1024
WARP = 32
BARS = 128                 # bytes of mbarriers a block
# MO ("columns"): warps of PER features each (a thread: one column of
# them) over 32 columns, at most 12 features a block (6 warps; two blocks
# share an SM), and one feature a warp at a level of one node, where more
# blocks shorten the last wave; SO ("features"): adding warps of 128
# features (4 a lane) and both columns, at most 3, and a copying warp
COLS_FEATS, PER, PER_ONE_NODE = 12, 2, 1
FEATS_WARPS = 3
COLS_ROWS = 32
SM_SMEM = 228 * 1024       # an SM's shared memory, 1 KB of it kept a block
FEATS_ROWS, FEATS_STAGES, FEATS_PER_WARP = 16, 4, 128
# one pass's bins: its codes are one byte, with one code left for the
# window's spare bin (csrc/hist.cu's kByteBins)
BYTE_BINS = 255


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's tile. ``kind`` "columns": a block's ``width`` = 32
    columns of the out + 1 (g·w, then the count), ``per`` features a warp
    (a thread owns one column of them);
    "features" (out = 1): ``width`` = 2 columns, 128 features an adding
    warp. A block is ``warps`` warps (SO: and one that copies) of one
    (lane, node) over ``feats`` features: ``feature_tiles`` × ``col_tiles``
    blocks per (lane, node). The one-byte codes come in tiles of ``feats``
    padded to ``tile``, ``code_stride`` = feature_tiles × tile a row (MO:
    the codes' rows once transposed). ``stages``: chunks in a block's
    ring."""
    kind: str
    warps: int
    per: int
    stages: int
    feats: int
    tile: int
    width: int
    feature_tiles: int
    col_tiles: int
    code_stride: int
    smem: int


def _round(x: int, to: int) -> int:
    return -(-x // to) * to


def smem_bytes(kind: str, warps: int, n_bins: int,
               stages: int = FEATS_STAGES, per: int = 1) -> int:
    """Shared memory of one block (``ColsLayout`` / ``FeatsLayout`` in
    csrc/hist.cu): mbarriers, cells and the ring of staged chunks."""
    nb1 = n_bins + 1
    if kind == "columns":
        feats = warps * per
        stage = _round(COLS_ROWS * WARP * 4 + feats * COLS_ROWS, 128)
        return BARS + nb1 * feats * WARP * 4 + stages * stage
    stage = _round(256 + FEATS_ROWS * FEATS_PER_WARP * warps, 128)
    return BARS + warps * nb1 * 1024 + FEATS_STAGES * stage


def plan(p: int, out: int, n_bins: int, n_nodes: int = 2,
         kind: str | None = None, warps: int | None = None,
         per: int | None = None) -> Plan:
    """The kernel's tile for p features, out + 1 columns, n_bins bins and
    n_nodes nodes: lanes over features for SO (out = 1), over columns
    otherwise (``PER`` features a thread, ``PER_ONE_NODE`` at a level of
    one node), with as many warps as shared memory holds, up to 12
    features a block (MO) or ``FEATS_WARPS`` (SO) and to what the p
    features fill. ``kind``, ``warps`` and ``per`` override the choice (the
    probe compares them). ``n_bins`` is the bins of one pass, at most
    ``BYTE_BINS`` (:func:`bin_windows` splits more)."""
    if not 1 <= n_bins <= BYTE_BINS:
        raise ValueError(f"n_bins={n_bins}: one pass of the kernel takes 1 "
                         f"to {BYTE_BINS} bins (one-byte codes); "
                         "bin_windows splits more")
    kinds = (kind,) if kind else (
        ("features", "columns") if out == 1 else ("columns",))
    for k in kinds:
        kper = 1
        if k == "columns":
            kper = per or (PER_ONE_NODE if n_nodes == 1 else PER)
        if kper not in (1, 2):
            raise ValueError(f"per={kper}: 1 or 2")
        per_warp = kper if k == "columns" else FEATS_PER_WARP
        top = COLS_FEATS // kper if k == "columns" else FEATS_WARPS
        most = min(top, -(-p // per_warp))
        for w in ((warps,) if warps else range(most, 0, -1)):
            stages = FEATS_STAGES
            if k == "columns":
                # the deepest ring that fits, but 3 chunks where that lets
                # two blocks share an SM
                stages = 4
                two = SM_SMEM // 2 - 1024
                if (smem_bytes(k, w, n_bins, 4, kper) > two
                        and smem_bytes(k, w, n_bins, 3, kper) <= two):
                    stages = 3
            smem = smem_bytes(k, w, n_bins, stages, kper)
            if smem > MAX_SMEM:
                continue
            feats = w * per_warp
            width = WARP if k == "columns" else 2
            tile = feats if k == "columns" else _round(feats, 16)
            tiles = -(-p // feats)
            return Plan(k, w, kper, stages, feats, tile, width, tiles,
                        -(-(out + 1) // width), tiles * tile, smem)
    raise ValueError(f"n_bins={n_bins}: one warp's cells do not fit the "
                     f"{MAX_SMEM} bytes of shared memory of a block")


def bin_windows(p: int, out: int, n_bins: int, n_nodes: int):
    """The kernel's passes for ``n_bins`` bins: contiguous, near-equal
    windows ``[(b0, b1), ...]`` that cover ``[0, n_bins)`` in order, as few
    as :func:`plan` takes for p features, out columns and n_nodes nodes
    (one window up to ``BYTE_BINS`` bins; 256 bins are two of 128)."""
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins}: must be >= 1")
    for k in range(-(-n_bins // BYTE_BINS), n_bins + 1):
        try:
            plan(p, out, -(-n_bins // k), n_nodes)
        except ValueError:
            continue
        cuts = [i * n_bins // k for i in range(k + 1)]
        return list(zip(cuts[:-1], cuts[1:]))
    raise ValueError(f"p={p}, out={out}: no window of the kernel fits the "
                     f"{MAX_SMEM} bytes of shared memory of a block")


def blocks(pl: Plan, S: int, p: int, out: int, n_nodes: int):
    """Each block of a launch as the kernel maps its index: ``(lane, node,
    features [j0, j1), columns [c0, c1))``, clipped to the p features and
    the out + 1 columns (the last one the count). Every block walks the
    rows of its (lane, node) only."""
    for s in range(S):
        for node in range(n_nodes):
            for x in range(pl.feature_tiles * pl.col_tiles):
                j0 = (x // pl.col_tiles) * pl.feats
                c0 = (x % pl.col_tiles) * pl.width
                yield (s, node, j0, min(j0 + pl.feats, p), c0,
                       min(c0 + pl.width, out + 1))


def narrow_codes(codes, n_bins: int, pl: Plan, lo: int = 0):
    """Plain version of the kernel's narrowing pass (``hist_narrow``, SO)
    for the window ``[lo, lo + n_bins)``: codes ``[n, p]`` -> ``[n + 1,
    pl.code_stride]`` uint8, feature ``t · feats + q`` at column ``t · tile
    + q``: each code less lo, or n_bins where that lies outside [0, n_bins),
    in the padding and in all of row n (the row that padding positions of
    the node layout read)."""
    n, p = codes.shape
    shifted = codes.to(torch.int32) - lo
    inside = (shifted >= 0) & (shifted < n_bins)
    body = torch.where(inside, shifted, n_bins)
    full = torch.full((n + 1, pl.feature_tiles, pl.tile), n_bins,
                      dtype=torch.int32, device=codes.device)
    padded = torch.full((n, pl.feature_tiles * pl.feats), n_bins,
                        dtype=torch.int32, device=codes.device)
    padded[:, :p] = body
    full[:n, :, :pl.feats] = padded.view(n, pl.feature_tiles, pl.feats)
    return full.view(n + 1, pl.code_stride).to(torch.uint8)


CHUNK = 32                 # the kernels' rows a chunk: a node's positions


def node_layout(node_id, n_nodes: int):
    """The kernels' node-ordered layout of each lane's rows: every node's
    rows in row order from a position that is a multiple of ``CHUNK``, its
    range padded to whole chunks.

    node_id ``[S, n]`` i32 -> ``(src [S, L] i32, offsets [S, n_nodes + 1]
    i32)``: node k of lane s owns positions ``offsets[s, k] : offsets[s,
    k + 1]``, where ``src`` holds its rows, ascending, then -1 for padding
    (as every position outside the nodes). ``L = ceil((n + (CHUNK - 1) ·
    n_nodes) / CHUNK) · CHUNK`` bounds every lane's layout. Rows whose node
    lies outside [0, n_nodes) are in no node."""
    S, n = node_id.shape
    dev = node_id.device
    order, ends = node_order(node_id, n_nodes)
    counts = (ends[:, 1:] - ends[:, :-1]).long()
    padded = -(-counts // CHUNK) * CHUNK
    offsets = torch.zeros((S, n_nodes + 1), dtype=torch.long, device=dev)
    offsets[:, 1:] = torch.cumsum(padded, 1)
    L = -(-(n + (CHUNK - 1) * n_nodes) // CHUNK) * CHUNK
    sorted_id = torch.gather(node_id, 1, order.long())
    inside = (sorted_id >= 0) & (sorted_id < n_nodes)
    k = sorted_id.clamp(0, n_nodes - 1).long()
    t = torch.arange(n, device=dev)[None, :]
    pos = torch.gather(offsets, 1, k) + t - torch.gather(ends.long(), 1, k)
    src = torch.full((S, L + 1), -1, dtype=torch.int32, device=dev)
    src.scatter_(1, torch.where(inside, pos, L), order)
    return src[:, :L].contiguous(), offsets.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    return declare(load("hist"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch functions' C signatures on a built library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, args in (("hist_narrow", [ptr, i32, ptr] + [i32] * 7 + [ptr]),
                     ("hist_launch_cols",
                      [ptr, i32] + [ptr] * 8 + [i32] * 15 + [ptr]),
                     ("hist_launch_feats",
                      [ptr, i32] + [ptr] * 8 + [i32] * 10 + [ptr])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i32
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
    return _histogram_op(codes, node_id, g, w, n_nodes, n_bins)


@torch.library.custom_op("repro_torch::histogram", mutates_args=())
def _histogram_op(codes: torch.Tensor, node_id: torch.Tensor,
                  g: torch.Tensor, w: torch.Tensor, n_nodes: int,
                  n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`histogram` on checked inputs: the plain version for a CPU
    tensor, the kernel for a CUDA tensor."""
    if g.device.type == "cpu":
        return histogram_ref(codes, node_id, g, w, n_nodes, n_bins)
    if g.device.type != "cuda":
        raise ValueError(f"no hist path for device {g.device}")
    out = launch(_lib(), codes, node_id, g, w, n_nodes, n_bins)
    from repro_torch.kernels.build import count_launch
    count_launch(histogram)
    return out


@_histogram_op.register_fake
def _histogram_fake(codes, node_id, g, w, n_nodes, n_bins):
    S, p, out = node_id.shape[0], codes.shape[1], g.shape[2]
    return (g.new_empty((S, n_nodes, p, n_bins, out)),
            g.new_empty((S, n_nodes, p, n_bins)))


histogram.launches = 0


def launch(lib, codes, node_id, g, w, n_nodes: int, n_bins: int,
           pl: Plan | None = None):
    """The CUDA path of :func:`histogram` through the built library ``lib``
    (checked CUDA inputs): lays the rows out by node (:func:`node_layout`,
    once), allocates the outputs and the kernel's node-ordered copies of
    its inputs, and launches the kernel on the current stream once per bin
    window (:func:`bin_windows`) with the window's tile (:func:`plan`'s, or
    ``pl``). Counts nothing: :func:`histogram` does;
    ``scripts/probe_torch_hist.py`` launches other builds and tiles of the
    kernel through it."""
    from repro_torch.kernels.build import check_launch
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
    windows = bin_windows(p, out, n_bins, n_nodes)
    src, offsets = node_layout(node_id, n_nodes)
    L = src.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    values = None      # the rows' values in node order, shared by windows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in windows:
            wpl = pl or plan(p, out, hi - lo, n_nodes)
            first = values is None
            if wpl.kind == "columns":
                # the rows in node order: g·w with w as the count column,
                # and the window's codes transposed
                out_pad = _round(out + 1, 4)
                if first:
                    values = torch.empty((S, L, out_pad), **f32)
                codes_t = torch.empty((S, wpl.code_stride, L),
                                      dtype=torch.uint8, device=dev)
                rc = lib.hist_launch_cols(
                    codes.data_ptr(), codes.element_size(), src.data_ptr(),
                    offsets.data_ptr(), g.data_ptr(), w.data_ptr(),
                    values.data_ptr(), codes_t.data_ptr(), sum_g.data_ptr(),
                    count.data_ptr(), S, n, L, p, wpl.code_stride, out,
                    out_pad, n_nodes, hi - lo, lo, n_bins, int(first),
                    wpl.warps, wpl.per, wpl.stages, stream)
            else:
                narrow = torch.empty((n + 1, wpl.code_stride),
                                     dtype=torch.uint8, device=dev)
                rc = lib.hist_narrow(codes.data_ptr(), codes.element_size(),
                                     narrow.data_ptr(), n, p, wpl.feats,
                                     wpl.tile, wpl.code_stride, hi - lo, lo,
                                     stream)
                check_launch("hist", rc)
                if first:
                    values = (torch.empty((S, L), **f32),
                              torch.empty((S, L), **f32))
                gs, ws = values
                rc = lib.hist_launch_feats(
                    narrow.data_ptr(), wpl.code_stride, src.data_ptr(),
                    offsets.data_ptr(), g.data_ptr(), w.data_ptr(),
                    gs.data_ptr(), ws.data_ptr(), sum_g.data_ptr(),
                    count.data_ptr(), S, n, L, p, n_nodes, hi - lo, lo,
                    n_bins, int(first), wpl.warps, stream)
            check_launch("hist", rc)
    return sum_g, count
