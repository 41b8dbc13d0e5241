// The bf16 instance of flash attention, on Hopper's tensor cores.
//
// Replaces, for bfloat16 inputs, src/repro/kernels/flash_attention/
// fa_kernel.py::flash_attention_pallas, with the semantics of
// flash_attention.cu's header: causal aligned top-left, query head h reads
// KV head h / (Hq/Hkv), any Sq and Skv, masked scores -1e30, the output
// acc / max(l, 1e-30) rounded once to bf16.
//
// Bound. At the serving shape of smollm-135m (B = 8, Hq = 9, Hkv = 3, S =
// 2,048, d = 64, causal) the function needs 38.67 G operations, 0.039 ms at
// 989 TFLOP/s, against 50 MB of inputs and output, 0.015 ms at 3.35 TB/s:
// the tensor cores bound it. This kernel does 1.5× those products on them
// (P·V twice, below), plus one exp2 a score on the SFU.
//
// Design. A block owns 128 query rows of one (batch, query head): two
// consumer warpgroups of 64 rows and a producer warpgroup (384 threads),
// which hands its registers to the consumers (setmaxnreg 24 / 240). The
// heaviest causal tiles (the last rows) launch first.
//  - Loads. The producer's lane 0 loads the block's Q once and then the K and
//    V tiles of BK keys into a ring of kStages stages, by TMA
//    (cp.async.bulk.tensor.3d) over tensor maps of q [B·Hq, Sq, d] and k, v
//    [B·Hkv, Skv, d], encoded by the host at each launch. Rows past Sq or
//    Skv fall out of the map and arrive as zeros; a 2-D map over flattened
//    rows would read the next head's keys instead. A full mbarrier per stage
//    counts the bytes in; an empty one counts the 256 consumer threads out.
//    Tiles are swizzled in shared memory at the widest of 128/64/32 bytes
//    that divides a row of 2·d bytes, as kChunks boxes of that width.
//  - S = Q·Kᵀ: wgmma m64n{BK}k16, both operands K-major in shared memory.
//    BK = 128 for d <= 128 and 64 above, where the 64 × d fp32 output
//    accumulator takes d/2 registers a thread.
//  - Softmax on the accumulator fragment (each thread holds 2 rows × BK/8
//    pairs): scale by log2(e)/√d in fp32 after the product (1/√d is not a
//    power of two for every d, so bf16 q is not pre-scaled), -1e30 on tiles
//    that cross the diagonal or Skv (a zero row from the map scores 0, not
//    -1e30), row max and sum over the quad by shuffles, acc and l rescaled
//    by exp2(m_prev - m_new), l summed from the fp32 p.
//  - O += P·V: wgmma m64n{d}k16 with P from registers (the score fragment of
//    a k16 slice is the A fragment's layout) and V as stored, MN-major, with
//    the transpose bit. P is not rounded once to bf16: that alone puts the
//    output up to 1.9× past the kernel's limit of 1e-3 + 1e-2·|plain|
//    (tests/test_torch_flash_attention.py emulates it). It goes in as two
//    products, P_hi = bf16(p) and P_lo = bf16(p - P_hi), against the same V
//    tile: 1.5× the tensor-core work of the function.
//  - Overlap. A warpgroup issues tile t's S and tile t-1's P·V together
//    and runs tile t's softmax while they compute (it needs only S).
//  - Sums run in a fixed order with no atomics, so two launches give the
//    same bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace fa_bf16 {

// consumer warpgroups of 64 query rows (three, with BK = 64 and 160
// registers, measured slower at d = 64: PERF.md)
constexpr int kWarpgroups = 2;
constexpr int kRows = 64 * kWarpgroups;        // query rows per block
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 128;     // + the producer warpgroup
// registers a thread after setmaxnreg: the producer keeps 24 and the
// consumers share the rest of the SM's 65,536 (240 each for two)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    (65536 - 128 * kProducerRegs) / kConsumers / 8 * 8;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kBarrierBytes = 256;

template <int D>
struct Cfg {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kSwizzle = kRowBytes % 128 == 0 ? 128
                                  : kRowBytes % 64 == 0 ? 64 : 32;
  static constexpr int kChunks = kRowBytes / kSwizzle;  // boxes across d
  static constexpr int kBK = D <= 128 ? 128 : 64;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kBK * kRowBytes;    // one K or V tile
  static constexpr int kStages =
      1024 + kQBytes + 3 * 2 * kTileBytes + kBarrierBytes <= kSmemLimit ? 3
                                                                       : 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + (size_t)kStages * 2 * kTileBytes + kBarrierBytes;
  // the wgmma descriptors' layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1
                                      : kSwizzle == 64 ? 2 : 3;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
  static_assert(D % 16 == 0 && kRowBytes % kSwizzle == 0, "bad d");
};

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts ~2^32 cycles (seconds) is a broken pipeline: trap rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed groups still run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the wait (it sees them as used when the instruction is issued).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle's layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- the kernel ---------------------------------------------------------------

// The consumer warpgroup's state and steps; one tile of BK keys at a time.
template <int D>
struct Consumer {
  using C = Cfg<D>;
  static constexpr int W = C::kSwizzle;
  static constexpr int BK = C::kBK;

  float acc[D / 2];            // O, 64 rows × D in the wgmma fragment
  float sc[BK / 2];            // this tile's scores, then its p
  uint32_t p_hi[BK / 16][4];   // the last tile's P as bf16 pairs, hi ..
  uint32_t p_lo[BK / 16][4];   // .. and lo, the A operands of P·V
  float m[2], l[2], alpha[2], ls[2];
  int row_base, col_base, wg_first;

  // S = Q·Kᵀ over d in slices of 16 (32 bytes; W / 32 slices a box)
  __device__ __forceinline__ void issue_s(uint32_t q_wg, uint32_t k) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = kk * 32 / W * BK * W + kk * 32 % W;
      const uint64_t da = make_desc(q_wg + kk * 32 / W * kRows * W +
                                        kk * 32 % W,
                                    16, 8 * W, C::kLayout);
      const uint64_t db = make_desc(k + off, 16, 8 * W, C::kLayout);
      Wgmma<BK>::ss(sc, da, db, kk > 0);
    }
  }

  // O += P_hi·V + P_lo·V. V [key][d] is MN-major: keys 16kk.., 8-key
  // groups 8W bytes apart, boxes of W/2 columns BK·W bytes apart.
  __device__ __forceinline__ void issue_pv(uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(acc, p_hi[kk],
                   make_desc(v + kk * 16 * W, BK * W, 8 * W, C::kLayout), 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(acc, p_lo[kk],
                   make_desc(v + kk * 16 * W, BK * W, 8 * W, C::kLayout), 1);
  }

  // Takes the row maxima and turns sc into p = exp2(s·c - m), in the log2
  // domain (scale_log2 = log2(e)/√d); sets alpha and ls. kMask first sets
  // the scores of keys past Skv or (causal) past the row to -1e30: a
  // second instance, run only on tiles that cross the diagonal or Skv.
  template <bool kMask>
  __device__ __forceinline__ void softmax(int k0, int skv, int causal,
                                          float scale_log2) {
    if (kMask) {
      // register i holds key k0 + col_base + 8·(i / 4) + i % 2 of row
      // row_base + 8·((i / 2) % 2): masked where 8·(i / 4) + i % 2 > last[h]
      int last[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        last[h] = skv - 1 - k0 - col_base;
        if (causal) last[h] = min(last[h], row_base + 8 * h - k0 - col_base);
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (8 * (i / 4) + i % 2 > last[(i / 2) % 2]) sc[i] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // the scale is positive, so the max of the scaled scores
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      neg_m[h] = -m_new;
      ls[h] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[h]));
      ls[h] += sc[i];
    }
  }

  // After the last P·V has landed: rescale acc and l, and split p into the
  // bf16 pair for the next P·V (registers 8kk + 2r, +1 are A register r of
  // slice kk: row 8·(r % 2), keys 16kk + 8·(r / 2) + 2·(lane % 4) + {0, 1}).
  __device__ __forceinline__ void rescale_and_split() {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][r] = pack_bf16(sc[i] - __low2float(hi),
                                sc[i + 1] - __high2float(hi));
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ o,
                                        int bh, int sq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row_base + 8 * h;
      if (row < sq) {
        const float denom = fmaxf(lt, 1e-30f);
        __nv_bfloat16* out = o + ((long long)bh * sq + row) * D + col_base;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] / denom,
                                    acc[4 * j + 2 * h + 1] / denom);
        }
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                int skv, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int W = C::kSwizzle;
  constexpr int BK = C::kBK;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle repeats every 8 rows of W bytes: align to the widest
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + C::kQBytes;   // stage s: K then V
  const uint32_t bars = kv_s + S * 2 * C::kTileBytes;
  // barriers: Q full, then full and empty per stage
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto k_tile = [&](int s) { return kv_s + s * 2 * C::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + C::kTileBytes; };

  const int bh = blockIdx.x;                        // b·Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = bh / hq;
  const int bh_kv = b * hkv + (bh - b * hq) / (hq / hkv);
  const int last_row = min(q0 + kRows, sq) - 1;
  const int kend = causal ? min(skv, last_row + 1) : skv;
  const int n_kt = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: gives its registers to the consumers; one lane
    // keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_3d(q_s + c * kRows * W, &tm_q, q_full, c * W / 2, q0, bh);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), (t / S - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(k_tile(s) + c * BK * W, &tm_k, full(s), c * W / 2,
                      t * BK, bh_kv);
          tma_load_3d(v_tile(s) + c * BK * W, &tm_v, full(s), c * W / 2,
                      t * BK, bh_kv);
        }
      }
    }
  } else {
    // consumers: warpgroup g owns rows q0 + 64g .. q0 + 64g + 63. Each
    // tile's S and the last tile's P·V are issued together, then the
    // softmax runs while they compute.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    Consumer<D> w;
    w.row_base = q0 + 64 * g + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    w.col_base = 2 * (lane % 4);
    w.wg_first = q0 + 64 * g;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w.m[h] = kNegInf;
      w.l[h] = 0.0f;
    }
    const uint32_t q_wg = q_s + 64 * g * W;
    auto softmax = [&](int k0) {
      if (k0 + BK > skv || (causal && k0 + BK - 1 > w.wg_first))
        w.template softmax<true>(k0, skv, causal, scale_log2);
      else
        w.template softmax<false>(k0, skv, causal, scale_log2);
    };

    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    wgmma_fence();
    w.issue_s(q_wg, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(w.sc);
    softmax(0);
    w.rescale_and_split();

    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % S;
      const int prev = (kt - 1) % S;
      mbar_wait(full(s), (kt / S) & 1);
      wgmma_fence();
      w.issue_s(q_wg, k_tile(s));
      wgmma_commit();
      w.issue_pv(v_tile(prev));
      wgmma_commit();
      wgmma_wait<1>();          // S has landed, P·V may still run
      fence_regs(w.sc);
      softmax(kt * BK);
      wgmma_wait<0>();
      fence_regs(w.acc);
      fence_regs(w.p_hi);
      fence_regs(w.p_lo);
      mbar_arrive(empty(prev));
      w.rescale_and_split();
    }

    wgmma_fence();
    w.issue_pv(v_tile((n_kt - 1) % S));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(w.acc);
    fence_regs(w.p_hi);
    fence_regs(w.p_lo);
    mbar_arrive(empty((n_kt - 1) % S));
    w.store(o, bh, sq);
  }
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault);
    found = cudaDriverEntryPointSuccess;
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map over x [heads, rows, D] bf16 whose box is `box_rows` rows of one
// swizzle width.
template <int D>
bool make_map(CUtensorMap* map, const void* x, int heads, int rows,
              int box_rows) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)C::kRowBytes,
                                 (cuuint64_t)C::kRowBytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(C::kSwizzle / 2),
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const long long n_qt = (sq + kRows - 1) / kRows;
  if ((long long)b * hq > 0x7fffffffLL || n_qt > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<D>(&tm_q, q, b * hq, sq, kRows) ||
      !make_map<D>(&tm_k, k, b * hkv, skv, C::kBK) ||
      !make_map<D>(&tm_v, v, b * hkv, skv, C::kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  // 1/√d rounded once from double, as the JAX package's Python float is,
  // times log2(e) so that the softmax runs on exp2
  const float scale_log2 =
      (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  const dim3 grid((unsigned)(b * hq), (unsigned)n_qt);
  fa_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, skv,
      causal, scale_log2);
  return (int)cudaGetLastError();
}

inline int launch_d(const void* q, const void* k, const void* v, void* o,
                    int b, int hq, int hkv, int sq, int skv, int d,
                    int causal, cudaStream_t stream) {
#define FA_BF16_LAUNCH(D) \
  return launch<D>(q, k, v, o, b, hq, hkv, sq, skv, causal, stream)
  switch (d) {
    case 16: FA_BF16_LAUNCH(16);
    case 32: FA_BF16_LAUNCH(32);
    case 64: FA_BF16_LAUNCH(64);
    case 128: FA_BF16_LAUNCH(128);
    case 160: FA_BF16_LAUNCH(160);
    case 192: FA_BF16_LAUNCH(192);
    case 256: FA_BF16_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BF16_LAUNCH
}

}  // namespace fa_bf16
