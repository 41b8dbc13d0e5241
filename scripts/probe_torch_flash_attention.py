#!/usr/bin/env python3
"""Where the flash-attention kernel's time goes, on one GPU.

    python3 scripts/probe_torch_flash_attention.py [--out DIR]
    python3 scripts/probe_torch_flash_attention.py --fp32-against CSRC \
        [--sweep] [--out DIR]

With ``--fp32-against``, the fp32 instance's same-call A/B: builds the
committed ``csrc/flash_attention.cu``, the one in ``CSRC`` (a parent
commit's ``csrc/``, exported first: the card's machine has no git) and a
copy with clock64() counters per phase of a tile, one nvcc each, all at
once; logs ptxas's registers and spills of every fp32 instance and the
card's resident warps (``flash_attention_fp32_config``); holds every build
but the parent's to the plain version (2e-5 + 2e-5·|plain|, two launches
bit-equal) at chip_smoke.py's cases in a subprocess with a time limit; then
times parent and kernel at the seven prefill shapes of chip_smoke.py in
four alternating rounds beside ``scaled_dot_product_attention`` (its
backend named from the kernels of a profiler trace) and the bound, with
the SM clock sampled by nvidia-smi, and prints the phase counters' cycles
a warp and tile. ``--sweep`` also builds and times a copy per
``FP32_VARIANTS`` entry (other ``Shape<d>`` tiles, or other lines such as
the ring depth ``kStages``), and the committed kernel at other key
splits.

Without it, the bf16 instance's probe:

Builds the committed kernel (``csrc/flash_attention_bf16.cuh``) and
variants of it, each a copy of ``csrc/`` with a few lines replaced, one
``nvcc`` each, all at once:

* ``serial``: S(t) waits for P·V(t-1), and the softmax for S(t): nothing
  of a warpgroup overlaps (the first design's schedule);
* ``turns``: the two consumer warpgroups take turns at issuing their
  products, by a pair of mbarriers (ping-pong);
* ``three_warpgroups``: three consumer warpgroups of 64 rows, BK = 64 and
  160 registers a consumer thread (d <= 64 only: the m64n128 and wider
  products of larger d do not fit 160 registers);
* ``no_p_lo``, ``no_pv``: without the P_lo product, without P·V at all;
* ``no_reload``: K and V are loaded for the first ring of tiles only;
* ``phases``: the kernel with ``clock64()`` counters per phase of the
  consumer loop and of the producer's waits.

The first four and ``phases`` compute the function and are held to the
plain version (atol 1e-3 + rtol 1e-2·|plain|, two launches bit-equal) at
ragged, causal, GQA and every-d cases, each in a subprocess with a time
limit; the other three are wrong by construction and only timed. All are
timed at smollm-135m's serving shape (B=8, Hq=9, Hkv=3, S=2,048, d=64,
causal) in four alternating rounds beside
``scaled_dot_product_attention``, and ``phases`` prints cycles per phase.
The last line is a JSON summary. Needs one CUDA device and ``nvcc``.
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
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)        # chip_smoke: the fp32 cases, shapes, bound
SHAPE = (8, 9, 3, 2048, 2048, 64)       # (B, Hq, Hkv, Sq, Skv, d)
CASES = [("one tile", (1, 1, 1, 64, 64, 64), False),
         ("serving", SHAPE, True),
         ("ragged", (1, 9, 3, 1000, 1000, 64), True),
         ("Sq = Skv = 300", (2, 9, 3, 300, 300, 64), True),
         ("G = 1", (1, 4, 4, 257, 257, 64), True),
         ("non-causal Sq = 190, Skv = 333", (1, 4, 2, 190, 333, 128), False),
         ("one token", (2, 9, 3, 1, 1, 64), True)]
CASES += [(f"d={d}", (1, 4, 2, 200, 200, d), True) for d in (16, 32, 128,
                                                              160, 256)]

_ISSUE = """      wgmma_fence();
      w.issue_s(q_wg, k_tile(s));
      wgmma_commit();
      w.issue_pv(v_tile(prev));
      wgmma_commit();
"""
_PV_HI = """#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(acc, p_hi[kk],
                   make_desc(v + kk * 16 * W, BK * W, 8 * W, C::kLayout), 1);
"""
_PV_LO = _PV_HI.replace("p_hi", "p_lo")
_PHASE_SUMS = "g_phase"
ALL_D = (16, 32, 64, 128, 160, 256)
# (name, exact: computes the function, head sizes built, [(old, new), ...])
VARIANTS = [
    ("kernel", True, ALL_D, []),
    ("serial", True, ALL_D, [(
        _ISSUE + "      wgmma_wait<1>();",
        """      wgmma_fence();
      w.issue_pv(v_tile(prev));
      wgmma_commit();
      wgmma_wait<0>();
      w.issue_s(q_wg, k_tile(s));
      wgmma_commit();
      wgmma_wait<0>();""")]),
    ("turns", True, ALL_D, [
        ("  auto full = [&](int s) { return bars + 8 * (1 + s); };\n"
         "  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };",
         "  auto turn = [&](int g) { return bars + 8 * (1 + g); };\n"
         "  auto full = [&](int s) { return bars + 8 * (3 + s); };\n"
         "  auto empty = [&](int s) { return bars + 8 * (3 + S + s); };"),
        ("    mbar_init(q_full, 1);\n",
         "    mbar_init(q_full, 1);\n    mbar_init(turn(0), 128);\n"
         "    mbar_init(turn(1), 128);\n"),
        ("    const uint32_t q_wg = q_s + 64 * g * W;\n",
         "    const uint32_t q_wg = q_s + 64 * g * W;\n    int turns = 0;\n"
         "    auto take_turn = [&]() { mbar_wait(turn(g), turns++ & 1); };\n"
         "    auto pass_turn = [&]() { mbar_arrive(turn(1 - g)); };\n"
         "    if (g == 1) pass_turn();\n"),
        ("    wgmma_fence();\n    w.issue_s(q_wg, k_tile(0));\n"
         "    wgmma_commit();\n",
         "    take_turn();\n    wgmma_fence();\n    w.issue_s(q_wg, k_tile(0));\n"
         "    wgmma_commit();\n    pass_turn();\n"),
        (_ISSUE, "      take_turn();\n" + _ISSUE + "      pass_turn();\n"),
        ("    wgmma_fence();\n    w.issue_pv(v_tile((n_kt - 1) % S));\n"
         "    wgmma_commit();\n",
         "    take_turn();\n    wgmma_fence();\n"
         "    w.issue_pv(v_tile((n_kt - 1) % S));\n    wgmma_commit();\n"
         "    pass_turn();\n")]),
    ("three_warpgroups", True, (16, 32, 64), [
        ("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 3;"),
        ("kBK = D <= 128 ? 128 : 64;", "kBK = 64;"),
        ("    case 128: FA_BF16_LAUNCH(128);\n"
         "    case 160: FA_BF16_LAUNCH(160);\n"
         "    case 256: FA_BF16_LAUNCH(256);\n", "")]),
    ("no_p_lo", False, ALL_D, [(_PV_LO, "")]),
    ("no_pv", False, ALL_D, [(_PV_HI + _PV_LO, "")]),
    ("no_reload", False, ALL_D, [(
        "        mbar_expect_tx(full(s), 2 * C::kTileBytes);\n",
        "        if (t >= S) {\n          mbar_arrive(full(s));\n"
        "          continue;\n        }\n"
        "        mbar_expect_tx(full(s), 2 * C::kTileBytes);\n")]),
    ("phases", True, ALL_D, [
        ("// -- the kernel ---",
         f"__device__ unsigned long long {_PHASE_SUMS}[16];\n"
         "// -- the kernel ---"),
        ("    mbar_wait(q_full, 0);\n",
         "    long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "    long long tp = clock64();\n"
         "#define PHASE(k) { const long long tn = clock64(); "
         "ph[k] += tn - tp; tp = tn; }\n"
         "    mbar_wait(q_full, 0);\n"),
        ("    softmax(0);\n    w.rescale_and_split();\n",
         "    softmax(0);\n    w.rescale_and_split();\n    PHASE(0)\n"),
        ("      mbar_wait(full(s), (kt / S) & 1);\n",
         "      mbar_wait(full(s), (kt / S) & 1);\n      PHASE(1)\n"),
        ("      fence_regs(w.sc);\n      softmax(kt * BK);\n",
         "      fence_regs(w.sc);\n      PHASE(2)\n      softmax(kt * BK);\n"
         "      PHASE(3)\n"),
        ("      mbar_arrive(empty(prev));\n      w.rescale_and_split();\n",
         "      mbar_arrive(empty(prev));\n      PHASE(4)\n"
         "      w.rescale_and_split();\n      PHASE(5)\n"),
        ("    w.store(o, bh, sq);\n",
         "    w.store(o, bh, sq);\n    PHASE(6)\n    ph[7] = n_kt - 1;\n"
         "    if (threadIdx.x % 128 == 0)\n"
         "      for (int k = 0; k < 8; ++k)\n"
         f"        atomicAdd(&{_PHASE_SUMS}[k], "
         "(unsigned long long)ph[k]);\n"
         f"    if (threadIdx.x == 0) atomicAdd(&{_PHASE_SUMS}[9], 1ull);\n"),
        ("        if (t >= S) mbar_wait(empty(s), (t / S - 1) & 1);\n",
         "        if (t >= S) {\n          const long long t0 = clock64();\n"
         "          mbar_wait(empty(s), (t / S - 1) & 1);\n"
         f"          atomicAdd(&{_PHASE_SUMS}[8], "
         "(unsigned long long)(clock64() - t0));\n        }\n")]),
]
PHASES = ["prologue and tile 0", "waiting for K, V", "issue to S landed",
          "softmax", "P·V landed, slot freed", "rescale and split",
          "epilogue"]
PHASE_READER = f"""
extern "C" int flash_attention_phases(unsigned long long* host, int reset) {{
  unsigned long long zero[16] = {{0}};
  if (reset)
    return (int)cudaMemcpyToSymbol(fa_bf16::{_PHASE_SUMS}, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, fa_bf16::{_PHASE_SUMS},
                                   sizeof(zero));
}}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def sources(work: str) -> dict:
    """A copy of csrc/ per variant, edited; returns {name: .cu path}."""
    from repro_torch.kernels import build
    csrc = os.path.dirname(build.source("flash_attention"))
    out = {}
    for name, _, _, edits in VARIANTS:
        d = os.path.join(work, name)
        shutil.copytree(csrc, d)
        path = os.path.join(d, "flash_attention_bf16.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit does not match once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        cu = os.path.join(d, "flash_attention.cu")
        if name == "phases":
            with open(cu, "a") as f:
                f.write(PHASE_READER)
        out[name] = cu
    return out


def build_all(work: str, out_dir: str) -> dict:
    from repro_torch.kernels import build
    procs = {}
    for name, cu in sources(work).items():
        lib = os.path.join(work, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if out_dir:
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(text)
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and "ILi64E" in line \
                    and "fa_wgmma" in line:
                log(f"{name} d=64: "
                    + " | ".join(x.strip() for x in lines[i + 1:i + 3]))
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-4000:]}")
        libs[name] = lib
    return libs


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.flash_attention_launch.restype = i32
    return lib


def inputs(shape, seed):
    import torch
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").bfloat16()
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def launch(lib, q, k, v, causal):
    import torch
    o = torch.empty_like(q)
    b, hq, sq, d = q.shape
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, b, hq,
        k.shape[1], sq, k.shape[2], d, int(causal), 0,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return o


def check(lib_path: str, dims) -> int:
    """Each case of a head size in ``dims`` against the plain version;
    returns the failures."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lib = load(lib_path)
    failures = 0
    for name, shape, causal in CASES:
        if shape[5] not in dims:
            continue
        q, k, v = inputs(shape, seed=shape[3] + shape[5])
        got, again = launch(lib, q, k, v, causal), launch(lib, q, k, v, causal)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal).float()
        worst = ((got.float() - ref).abs()
                 / (1e-3 + 1e-2 * ref.abs())).max().item()
        equal = torch.equal(got, again)
        failures += not (worst <= 1.0 and equal)
        log(f"  {name} {shape} causal={causal}: worst |diff| / limit "
            f"{worst!r}, repeat bit-equal {equal}")
    return failures


def timings(libs: dict) -> dict:
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = inputs(SHAPE, seed=7)
    loaded = {name: load(path) for name, path in libs.items()
              if name != "phases"}

    def ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    calls = {name: (lambda lib=lib: launch(lib, q, k, v, True))
             for name, lib in loaded.items()}
    calls["sdpa"] = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    times = {name: [] for name in calls}
    order = list(calls)
    for rnd in range(4):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            times[name].append(ms(calls[name]))
    for name, t in times.items():
        log(f"{name}: {t!r} ms, min {min(t)!r}")
    return {name: min(t) for name, t in times.items()}


def phases(lib_path: str) -> dict:
    """Cycles per phase of the consumer loop, per warpgroup and tile."""
    import torch
    lib = load(lib_path)
    lib.flash_attention_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    q, k, v = inputs(SHAPE, seed=7)
    launch(lib, q, k, v, True)
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * 16)()
    lib.flash_attention_phases(sums, 1)
    reps = 5
    for _ in range(reps):
        launch(lib, q, k, v, True)
    torch.cuda.synchronize()
    lib.flash_attention_phases(sums, 0)
    blocks = sums[9]
    loops = sums[7]
    out = {"blocks_per_launch": blocks // reps,
           "loop_tiles_per_warpgroup": loops / (2 * blocks)}
    for i, name in enumerate(PHASES):
        out[name] = {"cycles_per_warpgroup": sums[i] / (2 * blocks),
                     "cycles_per_loop_tile": sums[i] / max(loops, 1)}
        log(f"  {name}: {sums[i] / (2 * blocks)!r} cycles per warpgroup, "
            f"{sums[i] / max(loops, 1)!r} per loop tile")
    out["producer_empty_wait_cycles_per_block"] = sums[8] / blocks
    log(f"  producer waiting for a free slot: {sums[8] / blocks!r} cycles "
        f"per block")
    return out


# ---------------------------------------------------------------------------
# the fp32 instance: same-call A/B against a parent's csrc/
# ---------------------------------------------------------------------------

def fp32_shapes():
    """(label, (B, Hq, Hkv, Sq, Skv, d), causal): the seven prefill shapes
    chip_smoke.py times the fp32 kernel at."""
    import chip_smoke as cs
    out = [("smollm-135m", cs.FA_SERVE, True), ("dbrx-132b", cs.FA_DBRX, True),
           ("deepseek-v2-236b MLA", cs.FA_DEEPSEEK, True)]
    return out + [(label, shape, causal)
                  for label, (shape, causal) in cs.FA_FAMILIES.items()]


# builds to time beside the committed one with --sweep: {name: (tiles {d:
# (TR, CX, BK, BQ)} in place of ops.FP32_TILES and csrc/flash_attention.cu's
# Shape<d>, [(old, new)] other lines of the source replaced)}
FP32_VARIANTS = {
    "bk64": ({64: (4, 8, 64, 64)}, []),
    "tr8": ({64: (8, 8, 32, 128), 192: (8, 16, 32, 64),
             256: (8, 16, 32, 64)}, []),
    # a third ring slot (d = 256 at BK = 16 to fit a block)
    "s3": ({256: (4, 16, 16, 64)},
           [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
}


# a build with clock64() counters per phase of a tile, summed over warps
# (lane 0): the block barrier, thread 0's TMA issue + the wait for the
# tile, S, mask + softmax, P·V; [5] counts tiles
FP32_PHASE_EDITS = [
    ("template <int D>\n__global__ void __launch_bounds__(Tile<D>::NT, 1)",
     "__device__ unsigned long long g_fa32_phase[8];\n"
     "template <int D>\n__global__ void __launch_bounds__(Tile<D>::NT, 1)"),
    ("  for (int t = 0; t < n_kt; ++t) {\n",
     "  long long ph[5] = {0, 0, 0, 0, 0};\n  long long tp = clock64();\n"
     "#define PHASE(n) { const long long tn = clock64(); ph[n] += tn - tp; "
     "tp = tn; }\n"
     "  for (int t = 0; t < n_kt; ++t) {\n"),
    ("    if (tid == 0) issue(t + kStages - 1);\n",
     "    PHASE(0)\n    if (tid == 0) issue(t + kStages - 1);\n"),
    ("    const float* ks = ring + (t % kStages) * 2 * TILE / 4 + cx * W;\n",
     "    PHASE(1)\n"
     "    const float* ks = ring + (t % kStages) * 2 * TILE / 4 + cx * W;\n"),
    ("    // the mask, on tiles that cross Skv or the diagonal\n",
     "    PHASE(2)\n    // the mask, on tiles that cross Skv or the "
     "diagonal\n"),
    ("    // P's rows are written and read by the CX lanes of one warp\n"
     "    __syncwarp();\n",
     "    // P's rows are written and read by the CX lanes of one warp\n"
     "    __syncwarp();\n    PHASE(3)\n"),
    ("  }\n\n  // each row's l over the CX lanes that hold it\n",
     "    PHASE(4)\n  }\n  if (threadIdx.x % 32 == 0) {\n"
     "    for (int n = 0; n < 5; ++n)\n"
     "      atomicAdd(&g_fa32_phase[n], (unsigned long long)ph[n]);\n"
     "    atomicAdd(&g_fa32_phase[5], (unsigned long long)n_kt);\n  }\n\n"
     "  // each row's l over the CX lanes that hold it\n"),
]
FP32_PHASE_READER = """
extern "C" int flash_attention_fp32_phases(unsigned long long* host,
                                           int reset) {
  unsigned long long zero[8] = {0};
  if (reset)
    return (int)cudaMemcpyToSymbol(g_fa32_phase, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_fa32_phase, sizeof(zero));
}
"""
FP32_PHASES = ["block barrier", "TMA issue + wait for the tile", "S = Q·Kᵀ",
               "mask + softmax", "P·V"]


def variant_tiles(name: str) -> dict:
    from repro_torch.kernels.flash_attention.ops import FP32_TILES
    return {**FP32_TILES, **FP32_VARIANTS.get(name, ({}, []))[0]}


def shape_line(d: int, tile) -> str:
    tr, cx, bk, bq = tile
    return (f"template <> struct Shape<{d}> {{ static constexpr int TR = "
            f"{tr}, CX = {cx}, BK = {bk}, BQ = {bq}; }};")


def edited_source(csrc: str, d_dir: str, edits) -> str:
    """A copy of ``csrc`` in ``d_dir`` with ``edits`` [(old, new)] made
    in its flash_attention.cu, each matching once; returns the .cu."""
    shutil.copytree(csrc, d_dir)
    path = os.path.join(d_dir, "flash_attention.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{d_dir}: the edit does not match once: "
                               f"{old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def fp32_sources(csrc_parent: str, work: str, sweep: bool) -> dict:
    """{name: .cu}: the committed kernel, the parent's, a copy with the
    phase counters (``phases``) and, with ``sweep``, a copy of csrc/ per
    FP32_VARIANTS entry."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import FP32_TILES
    csrc = os.path.dirname(build.source("flash_attention"))
    out = {"kernel": build.source("flash_attention"),
           "parent": os.path.join(csrc_parent, "flash_attention.cu")}
    for name, (table, edits) in (FP32_VARIANTS.items() if sweep else ()):
        out[name] = edited_source(
            csrc, os.path.join(work, name),
            [(shape_line(d, FP32_TILES[d]), shape_line(d, tile))
             for d, tile in table.items()] + edits)
    out["phases"] = edited_source(csrc, os.path.join(work, "phases"),
                                  FP32_PHASE_EDITS)
    with open(out["phases"], "a") as f:
        f.write(FP32_PHASE_READER)
    return out


def build_fp32(csrc_parent: str, work: str, out_dir: str, sweep: bool):
    """nvcc of every fp32_sources() entry at once; returns ({name: library
    path}, the committed or variant fp32 instances that spill) and logs each
    fp32 instance's ptxas lines."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    procs = {}
    for name, cu in fp32_sources(csrc_parent, work, sweep).items():
        lib = os.path.join(work, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, spills = {}, []
    for name, (lib, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if out_dir:
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(text)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-4000:]}")
        for fn, lines in cs.ptxas_lines(text).items():
            if "fa_kernel" in fn:
                log(f"{name} {fn}: {'; '.join(lines)}")
                if name != "parent" and cs.spills(lines):
                    spills.append(f"{name} {fn}")
        libs[name] = lib
    return libs, spills


def load_fp32(path: str, takes_splits: bool = True) -> ctypes.CDLL:
    """A library's flash_attention_launch; the earlier SIMT kernel takes no
    key splits."""
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    n = 9 if takes_splits else 8
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * n + [ptr]
    lib.flash_attention_launch.restype = i32
    return lib


def launch_fp32(lib, q, k, v, causal, splits=None):
    """One launch of a library's fp32 kernel; ``splits`` for the committed
    kernel, None for the parent's signature."""
    import torch
    o = torch.empty_like(q)
    b, hq, sq, d = q.shape
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 4, b, hq,
            k.shape[1], sq, k.shape[2], d, int(causal)]
    if splits is not None:
        args.append(splits)
    rc = lib.flash_attention_launch(*args,
                                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc} (splits "
                           f"{splits})")
    return o


def fp32_inputs(shape, seed):
    import torch
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda")
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def plan_splits(shape, causal, tiles=None):
    """fp32_plan's key splits at a shape, for the table ``tiles``."""
    from repro_torch.kernels.flash_attention.ops import FP32_TILES, fp32_plan
    b, hq, _, sq, skv, d = shape
    return fp32_plan(b, hq, sq, skv, d, causal, tiles or FP32_TILES).splits


def check_fp32(lib_path: str, name: str) -> int:
    """A build (the committed kernel or a variant) at chip_smoke.py's fp32
    cases, and the committed one at every swept key split too, against the
    plain version; returns the failures."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lib = load_fp32(lib_path)
    tiles = variant_tiles(name)
    atol, rtol = cs.FA_TOL[torch.float32]
    failures = 0
    cases = [(label, shape, causal, plan_splits(shape, causal, tiles))
             for label, shape, causal in cs.flash_cases()]
    if name == "kernel":
        cases += [(f"{label} splits {sp}", shape, causal, sp)
                  for label, shape, causal in fp32_shapes()
                  for sp in sweep_splits(shape, causal)]
    for i, (label, shape, causal, splits) in enumerate(cases):
        q, k, v = fp32_inputs(shape, seed=300 + i)
        got = launch_fp32(lib, q, k, v, causal, splits)
        again = launch_fp32(lib, q, k, v, causal, splits)
        ref = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        ok = bool((diff <= atol + rtol * ref.abs()).all())
        equal = torch.equal(got, again)
        failures += not (ok and equal)
        log(f"  {name}: {label} {shape} causal={causal} splits {splits}: max "
            f"abs "
            f"diff {diff.max().item()!r}, within limit {ok}, repeat "
            f"bit-equal {equal}")
        del q, k, v, got, again, ref, diff
        torch.cuda.empty_cache()
    return failures


def sweep_splits(shape, causal):
    """Key splits other than fp32_plan's to time at a shape where the keys
    are split."""
    chosen = plan_splits(shape, causal)
    return [sp for sp in (1, 2, 4, 8) if chosen > 1 and sp != chosen]


def sdpa_backend(q, k, v, causal) -> list:
    """The CUDA kernels one scaled_dot_product_attention call ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def backend_name(kernels) -> str:
    text = " ".join(kernels).lower()
    for key, name in (("flash", "flash"), ("fmha", "efficient"),
                      ("efficient", "efficient"), ("cudnn", "cudnn")):
        if key in text:
            return name
    return "math"


def fp32_ab(libs: dict, sweep: bool, parent_takes_splits: bool) -> dict:
    """Parent, committed kernel, each variant (at its own plan) and SDPA at
    the seven shapes, in four alternating rounds."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ops import fp32_plan
    sdpa = torch.nn.functional.scaled_dot_product_attention
    loaded = {name: load_fp32(path, name != "parent" or parent_takes_splits)
              for name, path in libs.items()}
    out = {}
    # the SM clock and power while the kernels run, every 100 ms
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for label, shape, causal in fp32_shapes():
        q, k, v = fp32_inputs(shape, seed=7)
        splits = plan_splits(shape, causal)
        calls = {"parent": lambda: launch_fp32(
            loaded["parent"], q, k, v, causal,
            splits if parent_takes_splits else None)}
        for name in loaded:
            if name != "parent":
                sp = plan_splits(shape, causal, variant_tiles(name))
                calls[name] = (lambda lib=loaded[name], sp=sp: launch_fp32(
                    lib, q, k, v, causal, sp))
        calls["sdpa"] = lambda: sdpa(q, k, v, is_causal=causal,
                                     enable_gqa=True)
        if sweep:
            for sp in sweep_splits(shape, causal):
                calls[f"splits {sp}"] = (lambda sp=sp: launch_fp32(
                    loaded["kernel"], q, k, v, causal, sp))
        times = {name: [] for name in calls}
        order = list(calls)
        for rnd in range(4):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                times[name].append(cs.cuda_ms(calls[name], 10))
        nbytes, ops = cs.flash_bytes_ops(*shape, causal, 4)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.FP32_OPS_PER_S) * 1e3
        kernels = sdpa_backend(q, k, v, causal)
        best = {name: min(t) for name, t in times.items()}
        b, hq, _, sq, skv, d = shape
        p = fp32_plan(b, hq, sq, skv, d, causal)
        out[label] = dict(
            shape=shape, causal=causal, splits=splits, bound_ms=bound,
            blocks=p.blocks, min_ms=best, all_ms=times,
            share_of_bound=bound / best["kernel"],
            parent_over_kernel=best["parent"] / best["kernel"],
            kernel_over_sdpa=best["kernel"] / best["sdpa"],
            sdpa_backend=backend_name(kernels), sdpa_kernels=kernels)
        log(f"{label} {shape} causal={causal} splits {splits}: kernel "
            f"{best['kernel']!r} ms, parent {best['parent']!r} ms "
            f"(parent / kernel {best['parent'] / best['kernel']!r}), sdpa "
            f"{best['sdpa']!r} ms ({backend_name(kernels)}), bound "
            f"{bound!r} ms (share {bound / best['kernel']!r})")
        for name, t in times.items():
            log(f"    {name}: {t!r}")
        del q, k, v
        torch.cuda.empty_cache()
    smi.terminate()
    samples = [tuple(float(x) for x in line.split(","))
               for line in smi.communicate()[0].splitlines()
               if line.count(",") == 1]
    if samples:
        clocks = sorted(c for c, _ in samples)
        watts = sorted(w for _, w in samples)
        out["clocks_during_ab"] = {
            "samples": len(samples), "sm_mhz_median": clocks[len(clocks) // 2],
            "sm_mhz_min": clocks[0], "sm_mhz_max": clocks[-1],
            "power_w_median": watts[len(watts) // 2]}
        log(f"during the A/B: {out['clocks_during_ab']}")
    return out


def fp32_phases(lib_path: str, tiles: dict) -> dict:
    """clock64 cycles per phase, per warp and tile, of a phases build (of
    the table ``tiles``) at each of the seven shapes."""
    import torch
    lib = load_fp32(lib_path)
    lib.flash_attention_fp32_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for label, shape, causal in fp32_shapes():
        q, k, v = fp32_inputs(shape, seed=7)
        splits = plan_splits(shape, causal, tiles)
        launch_fp32(lib, q, k, v, causal, splits)
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 8)()
        lib.flash_attention_fp32_phases(sums, 1)
        launch_fp32(lib, q, k, v, causal, splits)
        torch.cuda.synchronize()
        lib.flash_attention_fp32_phases(sums, 0)
        n = max(sums[5], 1)       # warp-tiles
        out[label] = {name: sums[i] / n for i, name in enumerate(FP32_PHASES)}
        log(f"phases at {label}: " + ", ".join(
            f"{name} {sums[i] / n:.1f}" for i, name in
            enumerate(FP32_PHASES)) + " cycles a warp and tile")
        del q, k, v
    return out


def fp32_main(args, card: str) -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import (
        FP32_TILES, fp32_config)
    with open(os.path.join(args.fp32_against, "flash_attention.cu")) as f:
        parent_takes_splits = bool(re.search(r"int splits,\s*void\* stream",
                                             f.read()))
    with tempfile.TemporaryDirectory() as work:
        libs, spilled = build_fp32(args.fp32_against, work, args.out,
                                   args.sweep)
        # the committed library under build/'s name, so ops.fp32_config
        # loads this build
        os.makedirs(build.build_dir("flash_attention"), exist_ok=True)
        shutil.copy(libs["kernel"], build.library_path("flash_attention"))
        occupancy = {}
        for d in FP32_TILES:
            occupancy[f"d={d}"] = cfg = fp32_config(d)
            log(f"fp32 d={d}: {cfg}")
        failed = [f"spills: {fn}" for fn in spilled]
        for name, lib in libs.items():
            if name == "parent":
                continue
            log(f"fp32 {name} vs the plain version:")
            try:
                rc = subprocess.run([sys.executable, __file__, "--check-fp32",
                                     lib, name], timeout=300).returncode
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc != 0:
                failed.append(f"check {name}: {rc}")
        ok = {name: lib for name, lib in libs.items()
              if not name.startswith("phases")
              and not any(f.startswith(f"check {name}:") for f in failed)}
        ab = (fp32_ab(ok, args.sweep, parent_takes_splits) if "kernel" in ok
              else {})
        phases = (fp32_phases(libs["phases"], variant_tiles("kernel"))
                  if "check phases: 1" not in failed else {})
    summary = {"card": card, "fp32_ab": ab, "occupancy": occupancy,
               "phases": phases,
               "variants": FP32_VARIANTS, "tiles": FP32_TILES,
               "failed": failed}
    if args.out:
        with open(os.path.join(args.out, "fp32_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the build logs and summary")
    ap.add_argument("--fp32-against", metavar="CSRC",
                    help="a parent's csrc/: run the fp32 A/B against it")
    ap.add_argument("--sweep", action="store_true",
                    help="with --fp32-against: time other tiles, ring "
                    "depths and key splits too")
    ap.add_argument("--check", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--check-fp32", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_torch_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        lib_path, dims = args.check
        return 1 if check(lib_path, [int(d) for d in dims.split(",")]) else 0
    if args.check_fp32:
        return 1 if check_fp32(*args.check_fp32) else 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(card)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.fp32_against:
        return fp32_main(args, card)
    failed = []
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(work, args.out)
        for name, exact, dims, _ in VARIANTS:
            if not exact:
                continue
            log(f"{name} vs the plain version:")
            try:
                rc = subprocess.run(
                    [sys.executable, __file__, "--check", libs[name],
                     ",".join(map(str, dims))], timeout=300).returncode
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc != 0:
                failed.append(name)
        best = timings(libs)
        log("phases (clock64 cycles) at the serving shape:")
        counted = phases(libs["phases"])
    summary = {"card": card, "shape": SHAPE, "min_ms": best,
               "phases": counted, "failed": failed}
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
