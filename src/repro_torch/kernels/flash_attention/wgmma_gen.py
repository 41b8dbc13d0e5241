"""Writes ``csrc/wgmma.cuh``: the ``wgmma`` instructions the bf16 kernel
issues, one inline-PTX function per shape.

A ``wgmma.mma_async`` of width N names each of its N/2 fp32 accumulator
registers in the instruction text, so each shape is its own ``asm``
statement; this script writes them out instead of a hand. Run it after
changing a shape, and commit the header:

    python -m repro_torch.kernels.flash_attention.wgmma_gen

``tests/test_torch_flash_attention.py`` checks that the committed header is
what :func:`render` gives.
"""
from __future__ import annotations

import os

RS_WIDTHS = (16, 32, 64, 128, 160, 192, 256)   # N of P·V: every d
SS_WIDTHS = (64, 128)                      # N of S's m64nNk16: BK
HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "wgmma.cuh")

_PREAMBLE = """\
// Generated by repro_torch/kernels/flash_attention/wgmma_gen.py; do not
// edit by hand. Hopper's warpgroup products for bf16 inputs and an fp32
// accumulator, m64nNk16, as inline PTX (sm_90a only):
//
//   Wgmma<N>::ss(d, desc_a, desc_b, acc)  d[64 x N] (+)= A · B, A [64 x 16]
//       and B [N x 16] both K-major in shared memory (descriptors), for
//       the N that are a KV tile's keys;
//   Wgmma<N>::rs(d, a, desc_b, acc)       d (+)= A · B, A [64 x 16] from
//       registers (4 x bf16x2 a thread), B [16 x N] MN-major in shared
//       memory (the transpose bit set), for every head size N;
//
// acc = 0 overwrites d. d is the thread's N/2 accumulator registers: with
// t its index in the warpgroup, d[i] holds row 16·(t/32) + (t%32)/4 +
// 8·((i/2)%2) and column 8·(i/4) + 2·(t%4) + i%2.
#pragma once
#include <cstdint>

template <int N>
struct Wgmma;
"""


def _regs(n: int, first: int) -> str:
    names = [f"%{first + i}" for i in range(n)]
    lines = [", ".join(names[i:i + 8]) for i in range(0, n, 8)]
    return "{" + (",\\n\"\n        \"".join(lines)) + "}"


def _outputs(n: int) -> str:
    items = [f'"+f"(d[{i}])' for i in range(n)]
    return ",\n          ".join(", ".join(items[i:i + 6])
                                for i in range(0, n, 6))


def _shape(n: int) -> str:
    r = n // 2
    ss = (f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{_regs(r, 0)}, "\n'
          f'        "%{r}, %{r + 1}, p, 1, 1, 0, 0;\\n"')
    rs = (f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{_regs(r, 0)}, "\n'
          f'        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, '
          f'1, 1, 1;\\n"')
    ss_fn = f"""
  __device__ __forceinline__ static void ss(float (&d)[{r}], uint64_t desc_a,
                                            uint64_t desc_b, int acc) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{r + 2}, 0;\\n"
{ss}
        "}}\\n"
        : {_outputs(r)}
        : "l"(desc_a), "l"(desc_b), "r"(acc));
  }}""" if n in SS_WIDTHS else ""
    return f"""
template <>
struct Wgmma<{n}> {{{ss_fn}
  __device__ __forceinline__ static void rs(float (&d)[{r}],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int acc) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{r + 5}, 0;\\n"
{rs}
        "}}\\n"
        : {_outputs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(acc));
  }}
}};
"""


def render() -> str:
    return _PREAMBLE + "".join(_shape(n) for n in RS_WIDTHS)


if __name__ == "__main__":
    with open(HEADER, "w") as f:
        f.write(render())
    print(HEADER)
