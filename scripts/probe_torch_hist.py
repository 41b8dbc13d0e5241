#!/usr/bin/env python3
"""Where the hist kernel's time goes, on one GPU.

    python3 scripts/probe_torch_hist.py [--against REV_OR_DIR] [--out DIR]
                                        [--rounds N] [--parent-variants]

Builds the kernel of this checkout (``src/repro_torch/kernels/hist/csrc``)
and the parent's (``--against``: a git revision, default ``HEAD``, whose
``csrc/`` is taken with ``git show``, or a directory holding a copy of that
``csrc/``, for a machine without git), and variants: copies of ``csrc/``
with a few lines replaced, one ``nvcc`` each, all at once. A source gets
the variants of the design it holds (``DESIGNS``: a set applies where every
one of its edits is found), so the same script probes PR 12's kernel (with
``--parent-variants`` when it is the parent) and the one that replaced it.
PR 12's set:

* ``phases``: ``clock64()`` cycles per warp for each phase of a block
  (zeroing, waiting on staged loads, barriers, issuing loads, the add
  loop, write-out);
* ``no_add``: staging only, the adds left out;
* ``one_block_per_sm``: the same grid, with shared memory padded so that
  one block fits an SM: if a block's time falls, the SM's shared
  resources were the limit; if not, the block's own chain is;
* ``loads_only``, ``stores_only``, ``pipelined``: the cells only read,
  only written, or a group's reads before its writes (timed only).

PR 15's set: ``phases`` (the adding warps' and the copying warp's),
``no_add``, ``no_copy`` (chunks past the first ring not copied), and the
same build launched with other tiles (``PR15["plans"]``).

Variants that compute the function (``exact``) are held, each in a
subprocess with a time limit, to the plain version: bit-equal to it on the
CPU at small cases, within ``HIST_TOL`` of it on the card at the three
full-width shapes, two launches bit-equal. All are timed at the three
shapes of the training path at CaloForest photons width (n = 160,000,
p = 368, 64 bins, int32 codes): MO level 0 (one node, out = 368), MO level
6 (64 nodes) and SO level 6 (368 lanes, out = 1), in alternating rounds
beside the parent. For each build it prints the kernels' registers and
local memory (``cudaFuncGetAttributes``) and blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at each shape, and the
SASS of the loop that adds (``cuobjdump -sass``): its instructions per
cell added, by opcode. The last line is a JSON summary. Needs one CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]
CSRC_REL = "src/repro_torch/kernels/hist/csrc"
N, P, BINS = 160_000, 368, 64
# (label, (n, p, out, S, n_nodes, n_bins)); codes int32, as the trainer's
SHAPES = [("MO level 0", (N, P, P, 1, 1, BINS)),
          ("MO level 6", (N, P, P, 1, 64, BINS)),
          ("SO level 6", (N, P, 1, P, 64, BINS))]
REPS = {"MO level 0": 4, "MO level 6": 4, "SO level 6": 2}
PHASE_SUMS = "g_probe_phase"
PHASE_READER = f"""
extern "C" int hist_probe_phases(unsigned long long* host, int reset) {{
  unsigned long long zero[16] = {{0}};
  if (reset) return (int)cudaMemcpyToSymbol({PHASE_SUMS}, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, {PHASE_SUMS}, sizeof(zero));
}}
"""
PHASE_DECL = (f"__device__ unsigned long long {PHASE_SUMS}[16];\n"
              "#define PHASE(k) { const long long tn = clock64(); "
              "ph[k] += tn - tp; tp = tn; }\n")


def phase_flush(warp_expr: str, block_expr: str,
                copier_expr: str = "false") -> str:
    """Device code that adds a warp's phase sums ``ph[0..7]`` to the
    counters: slots 0-7 the cycles, 8 the warps, 9 the blocks, 10 the
    chunks (``chunks``, counted by the block's thread 0), 11 the copying
    warps."""
    return (f"  if ({warp_expr}) {{\n"
            "    for (int k = 0; k < 8; ++k)\n"
            f"      atomicAdd(&{PHASE_SUMS}[k], (unsigned long long)ph[k]);\n"
            f"    atomicAdd(&{PHASE_SUMS}[8], 1ull);\n"
            f"    if ({copier_expr}) atomicAdd(&{PHASE_SUMS}[11], 1ull);\n"
            "  }\n"
            f"  if ({block_expr}) {{\n"
            f"    atomicAdd(&{PHASE_SUMS}[9], 1ull);\n"
            f"    atomicAdd(&{PHASE_SUMS}[10], (unsigned long long)chunks);\n"
            "  }\n")


# ---------------------------------------------------------------------------
# PR 12's design: a block owns FT features x CT columns of one (lane, node),
# one cell per thread, 32 rows staged per chunk between two barriers
# ---------------------------------------------------------------------------

_PR12_ADD = """        float* cell = h + b * CT;
        *cell = __fadd_rn(*cell, vals[r]);
"""
_PR12_ATTRS = """
namespace {
template <int CT>
int probe_attrs(int n_bins, int* info) {
  constexpr int FT = tile_feats(CT);
  const size_t smem = tile_smem(FT, CT, n_bins);
  const void* fn = (const void*)hist_kernel<int32_t, CT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, FT * CT,
                                                      smem);
  info[0] = a.numRegs; info[1] = (int)a.localSizeBytes;
  info[2] = FT * CT; info[3] = (int)smem; info[4] = blocks;
  return (int)err;
}
}  // namespace
extern "C" int hist_probe_attrs(int n, int p, int out, int S, int n_nodes,
                                int n_bins, int kind, int warps, int per,
                                int* info) {
  return out + 1 >= 32 ? probe_attrs<32>(n_bins, info)
                       : probe_attrs<2>(n_bins, info);
}
"""
PR12 = {
    "name": "PR 12 (one cell per thread, 32-row chunks)",
    "attrs": _PR12_ATTRS,
    "sass_kernel": r"hist_kernelIiLi32E",     # the MO instance, int32 codes
    "phases": ["zero, first loads", "waiting on staged loads",
               "barrier after staging", "issue next loads", "add loop",
               "barrier after adds", "write-out"],
    "variants": [
        ("phases", True, [
            ("  for (int e = tid; e < FT * nb1 * CT; e += kThreads) "
             "hist[e] = 0.0f;\n",
             "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  long long tp = clock64();\n  int chunks = 0;\n"
             "  for (int e = tid; e < FT * nb1 * CT; e += kThreads) "
             "hist[e] = 0.0f;\n"),
            ("  int buf = 0;\n", "  PHASE(0)\n  int buf = 0;\n"),
            ("    if (tid < kRows) srow[(buf ^ 1) * kRows + tid] = next;\n"
             "    __syncthreads();\n",
             "    if (tid < kRows) srow[(buf ^ 1) * kRows + tid] = next;\n"
             "    PHASE(1)\n    __syncthreads();\n    PHASE(2)\n"),
            ("    // add, rows in order.", "    PHASE(3)\n    // add, rows in order."),
            ("    __syncthreads();   // this chunk's staging area and rows are "
             "free again\n",
             "    PHASE(4)\n"
             "    __syncthreads();   // this chunk's staging area and rows are "
             "free again\n    PHASE(5)\n    ++chunks;\n"),
            ("      count[cell] = v;\n  }\n}\n",
             "      count[cell] = v;\n  }\n  PHASE(6)\n"
             + phase_flush("tid % 32 == 0", "tid == 0") + "}\n"),
            ("template <typename CodeT, int CT>\n__global__",
             PHASE_DECL + "template <typename CodeT, int CT>\n__global__"),
        ]),
        ("no_add", False, [(_PR12_ADD, "")]),
        ("one_block_per_sm", True, [(
            "size_t tile_smem(int ft, int ct, int n_bins) {\n  return ",
            "size_t tile_smem_used(int ft, int ct, int n_bins);\n"
            "size_t tile_smem(int ft, int ct, int n_bins) {\n"
            "  const size_t used = tile_smem_used(ft, ct, n_bins);\n"
            "  return used > kMaxSmem / 2 + 1024 ? used : kMaxSmem / 2 + 1024;"
            "\n}\nsize_t tile_smem_used(int ft, int ct, int n_bins) {\n"
            "  return ")]),
        # the cells are loaded and summed, never stored: the loads alone,
        # free to overlap (no store between them)
        ("loads_only", False, [
            (_PR12_ADD, "        sink = __fadd_rn(sink, __fadd_rn(h[b * CT], "
                        "vals[r]));\n"),
            ("  int buf = 0;\n", "  float sink = 0.0f;\n  int buf = 0;\n"),
            ("  // write the tile out,",
             "  if (sink == 1.2345f) hist[tid] = sink;\n"
             "  // write the tile out,")]),
        # each row's value stored into its cell, nothing loaded
        ("stores_only", False, [(_PR12_ADD, "        h[b * CT] = vals[r];\n")]),
        # the loads of a group of 16 rows' cells before any of their stores:
        # rows of the group that share a bin lose adds (timed only); shows
        # what the read-modify-write chain of one thread costs
        ("pipelined", False, [(
            """#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int b = (pairs[r / 2] >> (16 * (r % 2))) & 0xFFFF;
        float* cell = h + b * CT;
        *cell = __fadd_rn(*cell, vals[r]);
      }
""",
            """      float cur[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        cur[r] = h[((pairs[r / 2] >> (16 * (r % 2))) & 0xFFFF) * CT];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        h[((pairs[r / 2] >> (16 * (r % 2))) & 0xFFFF) * CT] =
            __fadd_rn(cur[r], vals[r]);
""")]),
    ],
}



def pr12_launch(lib, name):
    """PR 12's C signature: int codes of any width, no plan."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.hist.ops import node_order
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hist_launch.argtypes = [ptr, i32] + [ptr] * 6 + [i32] * 6 + [ptr]
    lib.hist_launch.restype = i32

    def run(codes, node_id, g, w, n_nodes, n_bins):
        n, p = codes.shape
        S, out = node_id.shape[0], g.shape[2]
        sum_g = torch.empty((S, n_nodes, p, n_bins, out), device=g.device)
        count = torch.empty((S, n_nodes, p, n_bins), device=g.device)
        order, offsets = node_order(node_id, n_nodes)
        rc = lib.hist_launch(
            codes.data_ptr(), codes.element_size(), order.data_ptr(),
            offsets.data_ptr(), g.data_ptr(), w.data_ptr(), sum_g.data_ptr(),
            count.data_ptr(), S, n, p, out, n_nodes, n_bins,
            torch.cuda.current_stream().cuda_stream)
        check_launch("hist", rc)
        return sum_g, count
    return run


class PreWindowLib:
    """A library built from a ``csrc/`` older than the bin windows (one
    pass, at most 255 bins), called with the current arguments: ``lo``,
    ``bin_stride`` and the layout flag are dropped."""

    def __init__(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn, args in (("hist_narrow", [ptr, i32, ptr] + [i32] * 6 + [ptr]),
                         ("hist_launch_cols",
                          [ptr, i32] + [ptr] * 8 + [i32] * 12 + [ptr]),
                         ("hist_launch_feats",
                          [ptr, i32] + [ptr] * 8 + [i32] * 7 + [ptr])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i32
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def hist_narrow(self, *a):
        return self.lib.hist_narrow(*a[:9], *a[10:])

    def hist_launch_cols(self, *a):
        return self.lib.hist_launch_cols(*a[:19], *a[22:])

    def hist_launch_feats(self, *a):
        return self.lib.hist_launch_feats(*a[:16], *a[19:])


def pr15_launch(lib, name):
    """PR 15's design, with the tile of ``name``'s plan variant."""
    from repro_torch.kernels.hist.ops import declare, launch, plan
    if not isinstance(lib, PreWindowLib):
        declare(lib)

    def run(codes, node_id, g, w, n_nodes, n_bins):
        kw = plan_kw(name, g.shape[2])
        pl = plan(codes.shape[1], g.shape[2], n_bins, n_nodes, **kw)
        return launch(lib, codes, node_id, g, w, n_nodes, n_bins, pl=pl)
    return run


PR12["launch"] = pr12_launch

# ---------------------------------------------------------------------------
# PR 15's design: a warp owns 8 features x 1 column (MO) or 4 features x 2
# columns (SO) per thread, loads staged by a cp.async ring of 4 chunks
# ---------------------------------------------------------------------------

_PR15_ATTRS = """
extern "C" int hist_probe_attrs(int n, int p, int out, int S, int n_nodes,
                                int n_bins, int kind, int warps, int per,
                                int* info) {
  // the ring ops.plan picks: 4 chunks, 3 where that lets two blocks share
  // an SM
  const size_t two = 228 * 1024 / 2 - 1024;
  const int feats = warps * per;
  const int stages = ColsLayout(n_bins, feats, 4).bytes() > two &&
                             ColsLayout(n_bins, feats, 3).bytes() <= two
                         ? 3
                         : 4;
  const size_t smem = kind == 0 ? ColsLayout(n_bins, feats, stages).bytes()
                                : FeatsLayout(n_bins, warps).bytes();
  const void* fn = kind == 1   ? (const void*)hist_feats_kernel
                   : per == 2 ? (const void*)hist_cols_kernel<2>
                              : (const void*)hist_cols_kernel<1>;
  const int threads = 32 * (kind == 0 ? warps : warps + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  info[0] = a.numRegs; info[1] = (int)a.localSizeBytes;
  info[2] = threads; info[3] = (int)smem; info[4] = blocks;
  return (int)err;
}
"""
_PR15_MO_TMA = ("      mbar_expect_tx(bar, R * kWarp * 4 + FT * R);\n"
                "      tma_3d(vals(st), &tm_vals, bar, c0, begin + k * R, s);\n"
                "      tma_3d(codes(st), &tm_codes, bar, begin + k * R, j0, s);"
                "\n")
_PR15_SO_TMA = ("        mbar_expect_tx(full(st), R * FT + 2 * R * 4);\n"
                "        tma_2d(stage_g(st), &tm_g, full(st), begin + k * R, s);"
                "\n        tma_2d(stage_g(st) + 32, &tm_w, full(st), begin + k * "
                "R, s);\n")
_PR15_FLUSH = phase_flush("lane == 0", "tid == 0")              # MO
_PR15_SO_FLUSH = phase_flush("lane == 0", "tid == 0", "warp == W")
PR15 = {
    "name": "PR 15 (rows in node order by TMA; MO 2 features a thread, SO "
            "a copying warp)",
    "attrs": _PR15_ATTRS,
    "launch": pr15_launch,
    "sass_kernel": r"hist_cols_kernelILi2EE",   # the MO kernel, K = 2
    # phases 0-3 per adding warp, 4-5 per copying warp (SO only)
    "phases": ["adders: waiting for a chunk", "adders: adds",
               "adders: barriers", "write-out",
               "copier: waiting for a free stage", "copier: issuing copies"],
    "variants": [
        ("phases", True, [
            ("struct ColsLayout {", PHASE_DECL + "struct ColsLayout {"),
            ("  const int chunks = ",
             "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  long long tp = clock64();\n  const int chunks = "),
            ("    mbar_wait(bars + 8 * st, (k / S) & 1);\n",
             "    mbar_wait(bars + 8 * st, (k / S) & 1);\n    PHASE(0)\n"),
            ("    __syncthreads();   // every warp is done with stage st\n",
             "    PHASE(1)\n    __syncthreads();   // every warp is done with "
             "stage st\n    PHASE(2)\n"),
            ("        count[cell + b] = v;\n    }\n  }\n}\n",
             "        count[cell + b] = v;\n    }\n  }\n  PHASE(3)\n"
             + _PR15_FLUSH + "}\n"),
            ("  if (col > out) return;\n",
             "  if (col > out) {\n    PHASE(3)\n" + _PR15_FLUSH
             + "    return;\n  }\n"),
            ("      mbar_wait(full(st), (k / S) & 1);\n",
             "      mbar_wait(full(st), (k / S) & 1);\n      PHASE(0)\n"),
            ("      if (lane == 0) mbar_arrive(empty(st));\n",
             "      if (lane == 0) mbar_arrive(empty(st));\n      PHASE(1)\n"),
            ("      if (k >= S) mbar_wait(empty(st), (k / S - 1) & 1);\n",
             "      if (k >= S) mbar_wait(empty(st), (k / S - 1) & 1);\n"
             "      PHASE(4)\n"),
            ("                  FT, full(st));\n",
             "                  FT, full(st));\n      PHASE(5)\n"),
            ("  __syncthreads();   // every cell is final\n",
             "  __syncthreads();   // every cell is final\n"
             "  if (warp != W) PHASE(2) else tp = clock64();\n"),
            ("  if (warp == W) return;\n",
             "  if (warp == W) {\n" + _PR15_SO_FLUSH + "    return;\n  }\n"),
            ("        count[cell0 + b] = a.y;\n      }\n    }\n  }\n}\n",
             "        count[cell0 + b] = a.y;\n      }\n    }\n  }\n"
             "  PHASE(3)\n" + _PR15_SO_FLUSH + "}\n"),
        ]),
        # the copies and the waits only: no cell read or written
        ("no_add", False, [
            ("          cur[q] = lds(a[q]);\n", "          cur[q] = 0.0f;\n"),
            ("        for (int q = 0; q < K; ++q) sts(a[q], __fadd_rn(cur[q], "
             "v[r]));\n", ""),
            ("          for (int q = 0; q < kFeatsPerLane; ++q) cur[q] = "
             "lds2(a[q]);\n", ""),
            ("            sts2(a[q], make_float2(__fadd_rn(cur[q].x, "
             "val[r].x),\n                                   "
             "__fadd_rn(cur[q].y, val[r].y)));\n",
             "            (void)cur[q];\n")]),
        # chunks past the first ring copy nothing (their mbarriers complete
        # on 0 bytes): the adds read stale stages (timed only)
        ("no_copy", False, [
            (_PR15_MO_TMA,
             "      mbar_expect_tx(bar, k < S ? R * kWarp * 4 + FT * R : 0);\n"
             "      if (k < S) {\n" + _PR15_MO_TMA.split("\n", 1)[1] + "      }\n"),
            (_PR15_SO_TMA,
             "        mbar_expect_tx(full(st), k < S ? R * FT + 2 * R * 4"
             " : 0);\n        if (k < S) {\n"
             + _PR15_SO_TMA.split("\n", 1)[1] + "        }\n"),
            ("      if (lane < R)\n        bulk_copy(",
             "      if (lane < R && k < S)\n        bulk_copy(")]),
    ],
    # the same build launched with another tile: ops.plan's arguments, for
    # MO (out > 1) or SO (out = 1) launches; the other kind takes the plan
    "plans": {"k1_w24": ("MO", {"per": 1, "warps": 24}),
              "k1_w12": ("MO", {"per": 1, "warps": 12}),
              "k2_w6": ("MO", {"per": 2, "warps": 6}),
              "k2_w12": ("MO", {"per": 2, "warps": 12})},
}

DESIGNS = [PR12, PR15]


def log(msg: str) -> None:
    print(msg, flush=True)


def design_for(text: str):
    """The design whose every edit matches ``text`` (each edit replaces
    every place it matches)."""
    for design in DESIGNS:
        if all(old in text for _, _, edits in design["variants"]
               for old, _ in edits):
            return design
    return None


def parent_csrc(against: str, work: str) -> str:
    """A copy of the parent's csrc/ in ``work``; returns its path."""
    dest = os.path.join(work, "parent_csrc")
    if os.path.isdir(against):
        shutil.copytree(against, dest)
        return dest
    os.makedirs(dest)
    names = subprocess.run(
        ["git", "-C", REPO, "ls-tree", "--name-only", f"{against}:{CSRC_REL}"],
        capture_output=True, text=True, check=True).stdout.split()
    for name in names:
        blob = subprocess.run(
            ["git", "-C", REPO, "show", f"{against}:{CSRC_REL}/{name}"],
            capture_output=True, check=True).stdout
        with open(os.path.join(dest, name), "wb") as f:
            f.write(blob)
    return dest


def sources(work: str, against: str, parent_variants: bool):
    """{build name: (.cu path, design, exact)} for the kernel, the parent
    and each one's variants (the parent's only with ``parent_variants``);
    a parent identical to the kernel is built once, as ``kernel``."""
    from repro_torch.kernels import build
    here = os.path.dirname(build.source("hist"))
    roots = {"kernel": here}
    parent = parent_csrc(against, work)
    with open(os.path.join(here, "hist.cu")) as f:
        mine = f.read()
    with open(os.path.join(parent, "hist.cu")) as f:
        theirs = f.read()
    if theirs != mine:
        roots["parent"] = parent
    out = {}
    for base, root in roots.items():
        with open(os.path.join(root, "hist.cu")) as f:
            text = f.read()
        design = design_for(text)
        todo = [(base, True, [])]
        if base == "parent" and not parent_variants:
            design_name = design["name"] if design else "unknown design"
            log(f"parent: {design_name}, without its variants")
        elif design is None:
            log(f"{base}: no variant set matches its source; built as is")
        else:
            log(f"{base}: {design['name']}")
            todo += [(f"{base}.{v}", exact, edits)
                     for v, exact, edits in design["variants"]]
        for name, exact, edits in todo:
            d = os.path.join(work, name)
            shutil.copytree(root, d)
            path = os.path.join(d, "hist.cu")
            edited = text
            for old, new in edits:
                edited = edited.replace(old, new)
            if design is not None:
                edited += design["attrs"]
                if name.endswith(".phases"):
                    edited += PHASE_READER
            with open(path, "w") as f:
                f.write(edited)
            out[name] = (path, design, exact)
        if design is not None and base == "kernel":
            for v in design.get("plans", {}):
                out[f"{base}.{v}"] = (out[base][0], design, True)
    return out


def plan_kw(name: str, out: int) -> dict:
    """ops.plan's overrides for build ``name`` at a launch with ``out``
    columns (``PR15["plans"]``; none for other builds)."""
    target, kw = PR15["plans"].get(name.rsplit(".", 1)[-1], ("", {}))
    return kw if "." in name and target == ("SO" if out == 1 else "MO") \
        else {}


def plan_of(name: str, shape):
    """The tile build ``name`` runs at ``shape``."""
    from repro_torch.kernels.hist.ops import plan
    n, p, out, S, n_nodes, n_bins = shape
    return plan(p, out, n_bins, n_nodes, **plan_kw(name, out))


def build_all(srcs: dict, work: str, out_dir: str) -> dict:
    from repro_torch.kernels import build
    procs, libs = {}, {}
    for name, (cu, _, _) in srcs.items():
        lib = os.path.join(os.path.dirname(cu), "libhist.so")
        if any(lib == other for other, _ in procs.values()):
            libs[name] = lib                  # a plan variant: same build
            continue
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if out_dir:
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(text)
        if proc.returncode != 0:
            if "." not in name:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{text[-4000:]}")
            log(f"nvcc failed for {name}, left out:\n{text[-2000:]}")
            continue
        libs[name] = lib
    return libs


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    if hasattr(lib, "hist_probe_attrs"):
        lib.hist_probe_attrs.argtypes = ([ctypes.c_int] * 9
                                         + [ctypes.c_void_p])
    return lib


def hist_fn(path: str, name: str):
    """Build ``name`` (its library at ``path``) as ``histogram(codes,
    node_id, g, w, n_nodes, n_bins)``, through its design's C signature."""
    with open(os.path.join(os.path.dirname(path), "hist.cu")) as f:
        text = f.read()
    design = design_for(text)
    launcher = design["launch"] if design else pr15_launch
    lib = load(path)
    if launcher is pr15_launch and "bin_stride" not in text:
        lib = PreWindowLib(lib)
    return launcher(lib, name)


def check(lib_path: str, name: str) -> int:
    """The build against the plain version (chip_smoke's cases); 0 if it
    agrees everywhere."""
    import torch
    import chip_smoke as cs
    exact, _ = cs.hist_cases()
    full = [(label, shape + (torch.int32,)) for label, shape in SHAPES]
    try:
        worst = cs.check_hist(torch.device("cuda"), exact, full,
                              histogram=hist_fn(lib_path, name))
    except AssertionError as e:
        log(f"  FAILED: {e}")
        return 1
    log(f"  every case agrees; largest abs difference {worst!r}")
    return 0


def attributes(libs: dict) -> dict:
    out = {}
    for name, path in libs.items():
        lib = load(path)
        if not hasattr(lib, "hist_probe_attrs"):
            continue
        for label, shape in SHAPES:
            info = (ctypes.c_int * 5)()
            pl = plan_of(name, shape)
            rc = lib.hist_probe_attrs(*shape, int(pl.kind == "features"),
                                      pl.warps, pl.per, info)
            if rc:
                raise RuntimeError(f"{name} attributes: cudaError {rc}")
            row = dict(zip(("registers", "local_bytes", "threads",
                            "dynamic_smem", "blocks_per_sm"), info))
            out.setdefault(name, {})[label] = row
            log(f"{name} at {label}: {row}")
    return out


def sass_loop(lib_path: str, kernel_re: str) -> dict:
    """Opcode counts of the innermost loop with FADDs in the kernel whose
    mangled name matches ``kernel_re``, per FADD (one cell added)."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for part in sass.split("Function : ")[1:]:
        if not re.match(r"\S*" + kernel_re, part):
            continue
        instrs, labels = [], {}
        for line in part.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(instrs)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                instrs.append((int(m.group(1), 16), m.group(2).strip()))
        index = {addr: i for i, (addr, _) in enumerate(instrs)}
        loops = []
        for i, (_, text) in enumerate(instrs):
            if "BRA" not in text:
                continue
            t = re.search(r"BRA\S*\s+(?:\S+\s+)?`?\(?(\.L_x_\d+|0x[0-9a-f]+)",
                          text)
            if not t:
                continue
            tgt = t.group(1)
            j = labels.get(tgt) if tgt.startswith(".L") \
                else index.get(int(tgt, 16))
            if j is not None and j <= i:
                body = [x for _, x in instrs[j:i + 1]]
                if any(x.split()[0].startswith("FADD")
                       or (x.startswith("@") and x.split()[1]
                           .startswith("FADD")) for x in body):
                    loops.append(body)
        if not loops:
            return {"error": "no loop with FADD found"}
        body = min(loops, key=len)
        ops = {}
        for x in body:
            words = x.split()
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        fadds = max(ops.get("FADD", 0), 1)
        return {"instructions": len(body), "fadd": ops.get("FADD", 0),
                "per_cell_added": len(body) / fadds,
                "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return {"error": f"no kernel matching {kernel_re}"}


def inputs():
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda")
    out = {}
    for label, shape in SHAPES:
        out[label] = cs.hist_inputs(*shape, torch.int32, seed=7, device=dev)
    return out


def timings(libs: dict, rounds: int) -> dict:
    """Min ms per launch of each build at each shape, over alternating
    rounds (the order reversed every other round)."""
    import chip_smoke as cs
    data = inputs()
    fns = {name: hist_fn(path, name) for name, path in libs.items()}
    times = {name: {label: [] for label, _ in SHAPES} for name in fns}
    order = list(fns)
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for label, shape in SHAPES:
                args, nn, nb = data[label], shape[4], shape[5]
                times[name][label].append(cs.cuda_ms(
                    lambda f=fns[name]: f(*args, nn, nb), REPS[label]))
    for name, by_shape in times.items():
        log(f"{name}: " + "; ".join(f"{label} {min(t)!r} ms ({t!r})"
                                    for label, t in by_shape.items()))
    return {name: {label: min(t) for label, t in by_shape.items()}
            for name, by_shape in times.items()}


def phases(lib_path: str, design: dict) -> dict:
    """Cycles per warp and phase, per block and per chunk, at each shape."""
    import torch
    lib = load(lib_path)
    lib.hist_probe_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    data = inputs()
    fn = hist_fn(lib_path, "phases")
    out = {}
    for label, shape in SHAPES:
        args, nn, nb = data[label], shape[4], shape[5]
        fn(*args, nn, nb)
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 16)()
        lib.hist_probe_phases(sums, 1)
        fn(*args, nn, nb)
        torch.cuda.synchronize()
        lib.hist_probe_phases(sums, 0)
        warps, blocks, chunks = sums[8], sums[9], sums[10]
        row = {"blocks": blocks, "chunks_per_block": chunks / max(blocks, 1)}
        for i, phase in enumerate(design["phases"]):
            # a copier's phases per copying warp, an adder's per adding
            # warp (slot 11 counts the copying warps), the others per warp
            if phase.startswith("copier"):
                row[phase] = sums[i] / max(sums[11], 1)
            elif phase.startswith("adders"):
                row[phase] = sums[i] / max(warps - sums[11], 1)
            else:
                row[phase] = sums[i] / max(warps, 1)
        out[label] = row
        log(f"{label}: {blocks} blocks, {row['chunks_per_block']!r} chunks "
            "a block; cycles per warp: " + "; ".join(
                f"{p} {row[p]!r}" for p in design["phases"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default="HEAD",
                    help="the parent: a git revision, or a directory "
                         "holding its csrc/ (default HEAD)")
    ap.add_argument("--out", help="directory for the build logs and summary")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--parent-variants", action="store_true",
                    help="build and time the parent's variants too")
    ap.add_argument("--check", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_torch_hist: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        return check(*args.check)
    import chip_smoke as cs
    card = cs.card_line()
    log(card)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed, sass, counted = [], {}, {}
    with tempfile.TemporaryDirectory() as work:
        srcs = sources(work, args.against, args.parent_variants)
        libs = build_all(srcs, work, args.out)
        srcs = {name: v for name, v in srcs.items() if name in libs}
        attrs = attributes(libs)
        for name, (_, design, exact) in srcs.items():
            if design is not None and "." not in name:
                sass[name] = sass_loop(libs[name], design["sass_kernel"])
                log(f"{name} SASS, innermost loop with FADD (MO instance): "
                    f"{sass[name]}")
        for name, (_, _, exact) in srcs.items():
            if not exact:
                continue
            # each case's line goes to a file; the summary line is shown
            out_log = os.path.join(args.out or work, f"check_{name}.log")
            try:
                with open(out_log, "w") as f:
                    rc = subprocess.run([sys.executable, __file__, "--check",
                                         libs[name], name], stdout=f,
                                        stderr=subprocess.STDOUT,
                                        timeout=300).returncode
            except subprocess.TimeoutExpired:
                rc = "timed out"
            with open(out_log) as f:
                last = (f.read().strip().splitlines() or [""])[-1]
            log(f"{name} vs the plain version: {last} (rc {rc})")
            if rc != 0:
                failed.append(name)
        # a build that failed or hung in its check is not timed
        timed = {name: lib for name, lib in libs.items()
                 if not any(f == name or name.startswith(f"{f}.")
                            for f in failed)}
        best = timings(timed, args.rounds)
        for name, (_, design, _) in srcs.items():
            if name.endswith(".phases") and name in timed:
                log(f"{name}: clock64 cycles per warp")
                counted[name] = phases(libs[name], design)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"after the timings: clocks.sm, clocks.max.sm, power.draw = "
        f"{clocks.strip()}")
    summary = {"card": card, "shapes": dict(SHAPES), "min_ms": best,
               "attributes": attrs, "sass": sass, "phases": counted,
               "failed": failed}
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
