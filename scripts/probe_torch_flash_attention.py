#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel's time goes, on one GPU.

    python3 scripts/probe_torch_flash_attention.py [--out DIR]

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
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
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
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
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
        k.shape[1], sq, k.shape[2], d, int(causal),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the build logs and summary")
    ap.add_argument("--check", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_torch_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        lib_path, dims = args.check
        return 1 if check(lib_path, [int(d) for d in dims.split(",")]) else 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(card)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
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
