#!/usr/bin/env python3
"""Where the tree_predict kernel's time goes, on one GPU.

    python3 scripts/probe_torch_tree_predict.py [--against REV_OR_DIR]
                                                [--out DIR] [--rounds N]
                                                [--parent-variants]

Builds the kernel of this checkout
(``src/repro_torch/kernels/tree_predict/csrc``) and the parent's
(``--against``: a git revision, default ``HEAD``, whose ``csrc/`` is taken
with ``git show``, or a directory holding a copy of that ``csrc/``, for a
machine without git), and variants: copies of ``csrc/`` with a few lines
replaced, one ``nvcc`` each, all at once. A source gets the variants of the
design it holds (``DESIGNS``: a set applies where every one of its edits is
found); the parent's only with ``--parent-variants``. The one-kernel
design's set (route every (row, tree) into shared memory, then sum leaf
rows read from global memory):

* ``phases``: ``clock64()`` cycles per warp of routing, the barrier, and
  summing with its leaf loads;
* ``route_only``: routing, with the sum left out (a warp writes one value
  a row);
* ``sum_fixed``: summing with fixed leaf indices (no routing loads);
* ``one_tree_leaves``: every tree's leaf row read from tree 0's table, so
  the leaves stay in L2 (wrong by construction);
* ``one_block_per_sm``: shared memory padded so that one block fits an SM.

The two-kernel design's set (a routing kernel into a uint16 index
scratch and a summing kernel over column tiles, fed by TMA where it can
be; SO fused): ``phases`` of the routing and summing kernels, ``no_sum``
(the routing kernel alone), ``no_route`` (the summing kernel alone),
``tma_w16`` (the TMA-fed summing kernel with 16 adding warps, not 8),
``tma_2blk`` (with a 3-stage ring, two blocks an SM), ``sum_cp_async``
(the summing kernel fed by cp.async from all its threads, one block
barrier a tree),
``route_x_global`` (the routing kernel gathering x through L1),
``route_forest_l1`` (its trees read through L1) and ``route_no_store``
(without its index stores, so its walks are dropped: its staging alone).

The SO redesign's set (a thread walks one row of one sub-forest, 4 trees
at once, adding in tree order; rings of tree slices, each lane of a
copying warp feeding one ring; the MO kernels as in the two-kernel
design): ``phases`` (``clock64()`` cycles per walking warp waiting for its
ring, walking, adding and staging x), ``w24`` (up to 23 walking warps,
not 15), ``feed_only`` (leaf indices fixed: the rings and the adds without
the walks) and ``walk_only`` (each ring filled once, its first slices
walked again and again: the walks without the feed). Its build and its
``w24`` variant are also timed at the SO shapes under other plans (rows,
rings, trees a slice: ``PLANS``), each checked first.
``--out`` also gets the kernel build's SASS (``cuobjdump -sass``).

Variants that compute the function are held to the plain version
(bit-equal) at every timed shape and at odd row counts, each in a
subprocess with a time limit.
Every build is timed at the generation path's shapes at CaloForest photons
width (MO: B = 15 classes, T = 20, depth 7, p = out = 368, n = 8,000 a
class; SO: 368 sub-forests of one output; MO at n = 1,024 and 4,096 a
class, the latency shapes; pions width, p = out = 533), in alternating
rounds beside the parent, with the plain version's time and the bound of
each shape. Prints ptxas's registers and shared memory per build. The last
line is a JSON summary. Needs one CUDA device and ``nvcc``.
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
CSRC_REL = "src/repro_torch/kernels/tree_predict/csrc"
SOURCE = "tree_predict.cu"
# (label, (B, S, T, depth, p, out, n)), n rows a class
SHAPES = [("MO full width", (15, 1, 20, 7, 368, 368, 8000)),
          ("SO full width", (15, 368, 20, 7, 368, 1, 8000)),
          ("MO n=1024", (15, 1, 20, 7, 368, 368, 1024)),
          ("MO n=4096", (15, 1, 20, 7, 368, 368, 4096)),
          ("pions width", (15, 1, 20, 7, 533, 533, 8000)),
          ("SO n=1024", (15, 368, 20, 7, 368, 1, 1024)),
          ("SO pions width", (15, 533, 20, 7, 533, 1, 8000))]
REPS = 10
PHASE_SUMS = "g_probe_phase"
PHASE_READER = f"""
extern "C" int tree_predict_probe_phases(unsigned long long* host,
                                         int reset) {{
  unsigned long long zero[16] = {{0}};
  if (reset) return (int)cudaMemcpyToSymbol({PHASE_SUMS}, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, {PHASE_SUMS}, sizeof(zero));
}}
"""
PHASE_DECL = (f"__device__ unsigned long long {PHASE_SUMS}[16];\n"
              "#define PHASE(k) { const long long tn = clock64(); "
              "ph[k] += tn - tp; tp = tn; }\n")
PHASE_START = "  long long ph[4] = {0, 0, 0, 0};\n  long long tp = clock64();\n"


def phase_flush(base: int, count: int) -> str:
    """Device code that adds a warp's ``ph[0..count)`` to slots ``base..``
    of the counters and counts the warp in slot ``base + count``."""
    return ("  if (threadIdx.x % 32 == 0) {\n"
            f"    for (int k = 0; k < {count}; ++k)\n"
            f"      atomicAdd(&{PHASE_SUMS}[{base} + k], "
            "(unsigned long long)ph[k]);\n"
            f"    atomicAdd(&{PHASE_SUMS}[{base + count}], 1ull);\n"
            "  }\n")


# ---------------------------------------------------------------------------
# the first port's design: one kernel
# ---------------------------------------------------------------------------

_ONE_STORE = "    leaf_idx[t * kRows + r] = (uint8_t)node;\n"
_ONE_SUM = """  const int total = rows * n_out;
  for (int i = threadIdx.x; i < total; i += kThreads) {"""
_ONE_END = """    y_blk[(long long)r * n_out + c] = acc;
  }
}
"""
ONE_KERNEL = {
    "name": "one kernel (route into shared memory, sum leaf rows from global)",
    "phases": [(0, ["routing", "barrier", "summing"])],
    "variants": [
        ("phases", True, [
            ("  extern __shared__ uint8_t leaf_idx[];  // [T][kRows]\n",
             "  extern __shared__ uint8_t leaf_idx[];  // [T][kRows]\n"
             + PHASE_START),
            ("  __syncthreads();\n\n  // phase 2",
             "  PHASE(0)\n  __syncthreads();\n  PHASE(1)\n\n  // phase 2"),
            (_ONE_END, _ONE_END[:-2] + "  PHASE(2)\n" + phase_flush(0, 3)
             + "}\n"),
            ("namespace {\n", PHASE_DECL + "namespace {\n")]),
        ("route_only", False, [
            (_ONE_SUM, "  if (threadIdx.x < rows)\n"
                        "    y_blk[(long long)threadIdx.x * n_out] = "
                        "leaf_idx[threadIdx.x] + leaf_idx[(T - 1) * kRows + "
                        "threadIdx.x];\n  const int total = 0;\n"
                        "  for (int i = threadIdx.x; i < total; i += "
                        "kThreads) {")]),
        ("sum_fixed", False, [
            (_ONE_STORE, "    leaf_idx[t * kRows + r] = (uint8_t)((r * 37 "
                          "+ t * 11) & (L - 1));\n")]),
        ("one_tree_leaves", False, [
            ("acc += __ldg(leaf_bs + ((long long)t * L + node)",
             "acc += __ldg(leaf_bs + ((long long)0 * L + node)")]),
        ("one_block_per_sm", True, [
            ("  const size_t smem = (size_t)T * kRows;\n",
             "  const size_t smem = 120 * 1024;\n"
             "  cudaFuncSetAttribute(tree_predict_kernel, "
             "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n")]),
    ],
}


def one_kernel_launch(lib):
    """The one-kernel C signature: no scratch."""
    import torch
    from repro_torch.kernels.build import check_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.tree_predict_launch.restype = i32

    def run(x, feat, thr, leaf, depth):
        B, n, p = x.shape
        S, T = feat.shape[1], feat.shape[2]
        out = leaf.shape[-1]
        y = torch.empty((B, S, n, out), device=x.device)
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            y.data_ptr(), B, S, n, p, T, depth, out,
            torch.cuda.current_stream().cuda_stream)
        check_launch("tree_predict", rc)
        return y
    return run


ONE_KERNEL["launch"] = one_kernel_launch


# ---------------------------------------------------------------------------
# the redesign: a routing and a summing kernel (SO fused)
# ---------------------------------------------------------------------------

def two_kernel_launch(lib):
    """The two-kernel C signature (no SO plan), as its wrapper launched it."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.tree_predict.ops import tiling
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.tree_predict_launch.restype = i32

    def run(x, feat, thr, leaf, depth):
        B, n, p = x.shape
        S, T = feat.shape[1], feat.shape[2]
        out = leaf.shape[-1]
        y = torch.empty((B, S, n, out), device=x.device)
        tc, npad = tiling(B, S, T, n)
        scratch = torch.empty((B * S * tc * npad if out > 1 else 0,),
                              dtype=torch.int16, device=x.device)
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), B, S, n, p, T, depth, out, tc,
            npad, torch.cuda.current_stream().cuda_stream)
        check_launch("tree_predict", rc)
        return y
    return run


_TWO_ROUTE_END = "    }\n  }\n}  // route_kernel\n"
_TWO_SUM_END = "col_a);\n}  // sum_kernel\n"
TWO_KERNELS = {
    "name": "two kernels (route into uint16 indices, sum over column tiles "
            "with staged leaves; SO fused)",
    "launch": two_kernel_launch,
    # slots 0-2: the routing kernel (staging, walking); 4-6: summing
    # (waiting for a stage and the barrier, adding)
    "phases": [(0, ["route: staging", "route: routing"]),
               (4, ["sum: waiting for a stage", "sum: adds"])],
    "variants": [
        ("phases", True, [
            ("namespace {\n", PHASE_DECL + "namespace {\n"),
            ("  // route: stage\n", PHASE_START + "  // route: stage\n"),
            ("  // route: walk\n", "  PHASE(0)\n  // route: walk\n"),
            (_TWO_ROUTE_END, "    }\n  }\n  PHASE(1)\n" + phase_flush(0, 2)
             + "}  // route_kernel\n"),
            ("  // sum: start\n", PHASE_START + "  // sum: start\n"),
            ("    // sum: staged\n", "    PHASE(0)\n    // sum: staged\n"),
            ("    // sum: added\n", "    PHASE(1)\n    // sum: added\n"),
            (_TWO_SUM_END, "col_a);\n" + phase_flush(4, 2)
             + "}  // sum_kernel\n"),
        ]),
        # the TMA-fed summing kernel with 16 adding warps (512 rows, design
        # 7); with a 3-stage ring and two blocks an SM (registers spill)
        ("tma_w16", True, [("launch_sum_tma<5, kSumWarps, 1>",
                            "launch_sum_tma<5, 16, 1>")]),
        ("tma_2blk", True, [("launch_sum_tma<5, kSumWarps, 1>",
                             "launch_sum_tma<3, kSumWarps, 2>")]),
        # the routing kernel reading its trees through L1, not staged
        ("route_forest_l1", True, [
            ("  const bool forest_shared = 8 * ((1 << depth) - 1) <= "
             "kForestBytes;", "  const bool forest_shared = false;")]),
        # the routing kernel without its index stores
        ("route_no_store", False, [("      if (row < npad) {\n",
                                    "      if (row < 0) {\n")]),
        # the routing kernel gathering x through L1, not staged
        ("route_x_global", True, [
            ("  const bool x_shared =\n      route_x_bytes(p) + kForestBytes <= "
             "kMaxSmem;\n", "  const bool x_shared = false;\n")]),
        # the summing kernel fed by cp.async from all its threads, one block
        # barrier a tree (design 6), where the TMA-fed one would run
        ("sum_cp_async", True, [
            ("  const bool tma = n_out % 4 == 0",
             "  const bool tma = false && n_out % 4 == 0")]),
        ("no_sum", False, [("    if (run_sum) {\n", "    if (false) {\n")]),
        ("no_route", False, [("    if (run_route) {\n",
                               "    if (false) {\n")]),
    ],
}


# ---------------------------------------------------------------------------
# the SO redesign: a thread a row of a sub-forest, rings fed by a copying warp
# ---------------------------------------------------------------------------

def row_owned_launch(lib, plan=None):
    """The wrapper's C signature; ``plan`` (rows, rings, trees) in place of
    ``ops.so_plan``'s for SO shapes. A build whose launcher does not yet
    report its summing kernels (no ``sums`` out-parameter) is called with
    the signature it has."""
    from repro_torch.kernels.tree_predict import ops
    with open(os.path.join(os.path.dirname(lib._name), SOURCE)) as f:
        reports = "int* sums" in f.read()
    if reports:
        ops.declare(lib)
    else:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tree_predict_launch.argtypes = [ptr] * 6 + [i32] * 12 + [ptr]
        lib.tree_predict_launch.restype = i32

    def unreported(x, feat, thr, leaf, depth, so):
        import torch
        from repro_torch.kernels.build import check_launch
        (B, n, p), (S, T) = x.shape, feat.shape[1:3]
        out = leaf.shape[-1]
        y = torch.empty((B, S, n, out), device=x.device)
        tc, npad = ops.tiling(B, S, T, n)
        scratch = torch.empty((B * S * tc * npad if out > 1 else 0,),
                              dtype=torch.int16, device=x.device)
        rc = lib.tree_predict_launch(
            x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), B, S, n, p, T, depth, out, tc,
            npad, *(so or (0, 0, 0)),
            torch.cuda.current_stream().cuda_stream)
        check_launch("tree_predict", rc)
        return y

    def run(x, feat, thr, leaf, depth):
        (B, n, p), (S, T) = x.shape, feat.shape[1:3]
        so = None
        if leaf.shape[-1] == 1:
            so = plan or ops.so_plan(B, S, T, depth, p, n)
        if reports:
            return ops.launch(lib, x, feat, thr, leaf, depth, so)[0]
        return unreported(x, feat, thr, leaf, depth, so)
    return run


# plans timed beside so_plan's at the SO shapes, for each build: (walking
# warps at most, [(rows, rings, trees a slice)])
_MAIN = [(96, 5, 4), (64, 7, 4), (128, 3, 4), (64, 5, 8)]
PLANS = {"": (15, _MAIN), ".w24": (23, [(96, 7, 4), (64, 11, 4)]),
         ".feed_only": (15, _MAIN[:2]), ".walk_only": (15, _MAIN[:2])}
_W24_EDIT = ("constexpr int kSoWarps = 16;", "constexpr int kSoWarps = 24;")
# each ring filled once: the walks of its first slices again and again
_WALK_ONLY = [
    ("    while (__any_sync(0xffffffffu, k < K && s < N)) {",
     "    while (__any_sync(0xffffffffu, k < K && s < N && use == 0)) {"),
    ("      const bool go = k < K && s < N &&",
     "      const bool go = use == 0 && k < K && s < N &&"),
    ("      mbar_wait(full0 + 8 * slot, (j / kSoStages) & 1);\n",
     "      if (j < kSoStages) mbar_wait(full0 + 8 * slot, 0);\n")]
ROW_OWNED = {
    "name": "two kernels for MO; SO: a thread a row of a sub-forest, rings of "
            "tree slices fed by a copying warp",
    "launch": row_owned_launch,
    # slots 8-11: so_kernel's walking warps
    "phases": [(8, ["so: ring wait", "so: walking", "so: adding",
                    "so: staging x"])],
    "variants": [
        ("phases", True, [
            ("namespace {\n", PHASE_DECL + "namespace {\n"),
            ("  // so: stage\n", PHASE_START + "  // so: stage\n"),
            ("  // so: start\n", "  PHASE(3)\n  // so: start\n"),
            ("      // so: staged\n", "      PHASE(0)\n      // so: staged\n"),
            ("        // so: walked\n",
             "        PHASE(1)\n        // so: walked\n"),
            ("        // so: added\n",
             "        PHASE(2)\n        // so: added\n"),
            ("  // so: done\n", phase_flush(8, 4) + "  // so: done\n")]),
        ("w24", True, [_W24_EDIT]),
        # the walks left out: every row lands on leaf r % L of each tree
        ("feed_only", False, [
            ("        so_walk<true>(hb, f_u + u0 * H, t_u + u0 * H, m, H, "
             "depth, x_r, R);\n",
             "        for (int c = 0; c < kSoChains; ++c) hb[c] = 4 * (H + 1 + "
             "((r + c) & (L - 1)));\n")]),
        ("walk_only", False, _WALK_ONLY),
    ],
}

DESIGNS = [ONE_KERNEL, ROW_OWNED, TWO_KERNELS]


def log(msg: str) -> None:
    print(msg, flush=True)


def design_for(text: str):
    """The design whose every edit matches ``text``."""
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
    and their variants; a parent identical to the kernel is built once."""
    from repro_torch.kernels import build
    here = os.path.dirname(build.source("tree_predict"))
    roots = {"kernel": here}
    parent = parent_csrc(against, work)
    with open(os.path.join(here, SOURCE)) as f:
        mine = f.read()
    with open(os.path.join(parent, SOURCE)) as f:
        if f.read() != mine:
            roots["parent"] = parent
    out = {}
    for base, root in roots.items():
        with open(os.path.join(root, SOURCE)) as f:
            text = f.read()
        design = design_for(text)
        todo = [(base, True, [])]
        if design is None:
            log(f"{base}: no variant set matches its source; not built")
            continue
        log(f"{base}: {design['name']}")
        if base == "kernel" or parent_variants:
            todo += [(f"{base}.{v}", exact, edits)
                     for v, exact, edits in design["variants"]]
        for name, exact, edits in todo:
            d = os.path.join(work, name)
            shutil.copytree(root, d)
            edited = text
            for old, new in edits:
                edited = edited.replace(old, new)
            if name.endswith(".phases"):
                edited += PHASE_READER
            path = os.path.join(d, SOURCE)
            with open(path, "w") as f:
                f.write(edited)
            with open(os.path.join(d, "design"), "w") as f:
                f.write(design["name"])
            suffix = name[len(base):]
            if design is ROW_OWNED and suffix in PLANS:
                with open(os.path.join(d, "plans"), "w") as f:
                    f.write(suffix)
            out[name] = (path, design, exact)
    return out


def ptxas(text: str):
    """ptxas's lines on registers and shared memory, per kernel."""
    return [ln.strip() for ln in text.splitlines()
            if re.search(r"Used \d+ registers|Compiling entry", ln)]


def build_all(srcs: dict, out_dir: str) -> dict:
    from repro_torch.kernels import build
    procs, libs = {}, {}
    for name, (cu, _, _) in srcs.items():
        lib = os.path.join(os.path.dirname(cu), "libtree_predict.so")
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
                raise RuntimeError(f"nvcc failed for {name}:\n{text[-4000:]}")
            log(f"nvcc failed for {name}, left out:\n{text[-2000:]}")
            continue
        for line in ptxas(text):
            log(f"  {name}: {line}")
        libs[name] = lib
    return libs


def predict_fn(lib_path: str, plan=None):
    """The build at ``lib_path`` as ``forest_predict(x, feat, thr, leaf,
    depth)``, through its design's C signature (``plan``: the SO plan in
    place of the wrapper's, for the SO redesign)."""
    with open(os.path.join(os.path.dirname(lib_path), "design")) as f:
        name = f.read()
    design = next(d for d in DESIGNS if d["name"] == name)
    lib = ctypes.CDLL(lib_path)
    fn = getattr(lib, "tree_predict_error_string")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return design["launch"](lib, plan) if plan else design["launch"](lib)


def build_plans(lib_path: str):
    """The build's ``PLANS`` (none for a build without them), each with
    ``fits(p, depth)``: whether it fits a block at that shape."""
    from repro_torch.kernels.tree_predict import ops
    path = os.path.join(os.path.dirname(lib_path), "plans")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        warps, plans = PLANS[f.read()]

    def fitting(plan):
        rows, rings, _ = plan
        return lambda p, depth: (
            ops.so_smem_bytes(p, depth, *plan) <= ops.SMEM_PER_BLOCK
            and rings * rows // 32 <= warps)
    return [(plan, fitting(plan)) for plan in plans]


def plan_name(build: str, plan) -> str:
    return f"{build}@{'x'.join(map(str, plan))}"


def inputs(shape):
    import torch
    import chip_smoke as cs
    return cs.kernel_inputs(*shape, seed=7, device=torch.device("cuda"))


def check(lib_path: str) -> int:
    """The build against the plain version at every shape and at
    chip_smoke's check cases; 0 if it is bit-equal everywhere."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.tree_predict.ref import forest_predict_ref
    fn = predict_fn(lib_path)
    with open(os.path.join(os.path.dirname(lib_path), "design")) as f:
        design = f.read()
    # the two-kernel design also takes chip_smoke's edge cases (depth
    # 9–16, 400 and 512 trees), which the one-kernel design refuses or
    # gets wrong by design
    cases = (cs.tree_predict_cases() if design != ONE_KERNEL["name"] else
             SHAPES + [(f"{kind} n={n}", (B, S, 20, 7, 368, out, n))
                       for n in (1, 97, 130)
                       for kind, B, S, out in (("MO", 15, 1, 368),
                                               ("SO", 2, 368, 1))])
    plans = build_plans(lib_path)
    fns = [(None, fn)] + [(plan, predict_fn(lib_path, plan))
                          for plan, _ in plans]
    fits = dict(plans)
    for i, (label, shape) in enumerate(cases):
        args = cs.kernel_inputs(*shape, seed=100 + i,
                                device=torch.device("cuda"))
        ref = forest_predict_ref(*args, shape[3])
        for plan, f in fns:
            if plan and (shape[5] != 1 or not fits[plan](shape[4], shape[3])):
                continue
            got = f(*args, shape[3])
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() if ref.numel() else 0.0
            tag = f" plan {plan}" if plan else ""
            log(f"  {label} {shape}{tag}: max abs diff {err!r}")
            if err != 0.0:
                log(f"  FAILED at {label}{tag}")
                return 1
    log("  every case bit-equal")
    return 0


def timings(libs: dict, rounds: int) -> dict:
    """Min ms a launch of each build at each shape over alternating rounds
    (the order reversed every other round), and the plain version's; the
    SO redesign's builds also under each of ``PLANS`` at the SO shapes."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.tree_predict.ref import forest_predict_ref
    fns = {name: (predict_fn(path), None) for name, path in libs.items()}
    for name, path in libs.items():
        for plan, fits in build_plans(path):
            fns[plan_name(name, plan)] = (predict_fn(path, plan), fits)
    times = {name: {} for name in fns}
    extra = {}
    for label, shape in SHAPES:
        args = inputs(shape)
        plain = cs.cuda_ms(lambda: forest_predict_ref(*args, shape[3]), 3)
        nbytes, ops = cs.predict_bytes_ops(*shape)
        bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        ops_ms = ops / cs.FP32_OPS_PER_S * 1e3
        extra[label] = {"plain_ms": plain, "bytes": nbytes, "ops": ops,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations"}
        log(f"{label} {shape}: plain {plain!r} ms; bound "
            f"{extra[label]['bound_ms']!r} ms ({nbytes} bytes, {ops} "
            "operations)")
        order = [name for name, (_, fits) in fns.items()
                 if fits is None or (shape[5] == 1
                                     and fits(shape[4], shape[3]))]
        for rnd in range(rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                times[name].setdefault(label, []).append(cs.cuda_ms(
                    lambda f=fns[name][0]: f(*args, shape[3]), REPS))
        del args
        torch.cuda.empty_cache()
    for name, by_shape in times.items():
        log(f"{name}: " + "; ".join(f"{label} {min(t)!r} ms ({t!r})"
                                    for label, t in by_shape.items()))
    best = {name: {label: min(t) for label, t in by_shape.items()}
            for name, by_shape in times.items()}
    return best, extra


def phases(lib_path: str, design: dict) -> dict:
    """Cycles per warp and phase at each shape."""
    import torch
    lib = ctypes.CDLL(lib_path)
    lib.tree_predict_probe_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn = predict_fn(lib_path)
    out = {}
    so = design is ROW_OWNED      # its phases count so_kernel alone
    for label, shape in SHAPES:
        if so and shape[5] != 1:
            continue
        args = inputs(shape)
        sums = (ctypes.c_ulonglong * 16)()
        fn(*args, shape[3])
        torch.cuda.synchronize()
        lib.tree_predict_probe_phases(sums, 1)
        fn(*args, shape[3])
        torch.cuda.synchronize()
        lib.tree_predict_probe_phases(sums, 0)
        row = {}
        for base, names in design["phases"]:
            warps = sums[base + len(names)]
            row[f"warps@{base}"] = warps
            for i, phase in enumerate(names):
                row[phase] = sums[base + i] / max(warps, 1)
        out[label] = row
        log(f"{label}: cycles per warp: " + "; ".join(
            f"{k} {v!r}" for k, v in row.items()))
        del args
        torch.cuda.empty_cache()
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
    ap.add_argument("--check", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_torch_tree_predict: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        return check(args.check)
    import chip_smoke as cs
    card = cs.card_line()
    log(card)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed, counted = [], {}
    with tempfile.TemporaryDirectory() as work:
        srcs = sources(work, args.against, args.parent_variants)
        libs = build_all(srcs, args.out)
        srcs = {name: v for name, v in srcs.items() if name in libs}
        if args.out:
            from repro_torch.kernels import build
            tool = os.path.join(os.path.dirname(build.find_nvcc()),
                                "cuobjdump")
            with open(os.path.join(args.out, "sass_kernel.txt"), "w") as f:
                subprocess.run([tool, "-sass", libs["kernel"]], stdout=f,
                               stderr=subprocess.STDOUT, timeout=300)
        for name, (_, _, exact) in srcs.items():
            if not exact:
                continue
            out_log = os.path.join(args.out or work, f"check_{name}.log")
            try:
                with open(out_log, "w") as f:
                    rc = subprocess.run([sys.executable, __file__, "--check",
                                         libs[name]], stdout=f,
                                        stderr=subprocess.STDOUT,
                                        timeout=900).returncode
            except subprocess.TimeoutExpired:
                rc = "timed out"
            with open(out_log) as f:
                last = (f.read().strip().splitlines() or [""])[-1]
            log(f"{name} vs the plain version: {last} (rc {rc})")
            if rc != 0:
                failed.append(name)
        timed = {name: lib for name, lib in libs.items()
                 if not any(f == name or name.startswith(f"{f}.")
                            for f in failed)}
        best, extra = timings(timed, args.rounds)
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
               "shape_info": extra, "phases": counted, "failed": failed}
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
