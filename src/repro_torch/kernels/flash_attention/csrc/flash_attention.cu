// Flash attention on Hopper (sm_90a): softmax(q·kᵀ/√d)·v with an online
// softmax, GQA without repeating K/V, optional causal mask.
//
// Replaces src/repro/kernels/flash_attention/fa_kernel.py::
// flash_attention_pallas (body _fa_kernel). The TPU kernel walks the KV
// blocks on a sequential grid axis and carries m, l and acc in VMEM
// scratch; here one block owns a tile of query rows of one (batch, query
// head) and walks the KV tiles in a loop inside itself, with m, l and acc
// in registers.
//
//   q [B, Hq, Sq, d]    f32 | bf16
//   k [B, Hkv, Skv, d]  same type; query head h reads KV head h / (Hq/Hkv)
//   v [B, Hkv, Skv, d]
//   o [B, Hq, Sq, d]    q's type
//
// Semantics, as the TPU kernel: scores are q·kᵀ/√d; scores of keys j > i
// (causal, aligned top-left) are filled with -1e30; m starts at -1e30, and
// each KV tile rescales acc and l by exp(m_prev - m_new) before its P·V is
// added; the output is acc / max(l, 1e-30) in q's type. Tiles wholly above
// the diagonal are skipped. Unlike the TPU kernel any Sq and Skv are taken:
// query rows past Sq are not written, keys past Skv get the -1e30 fill (and
// V rows of 0), so they contribute nothing. Every head width of the repo's
// configurations (16, 32, 64, 128, 160, 256, and MLA's nope + rope = 192)
// is a template instance. Sums
// run in a fixed order with no atomics, so two launches give the same bits.
//
// Two designs, one per type:
//  - bf16 runs on the tensor cores (wgmma fed by TMA through an mbarrier
//    ring): flash_attention_bf16.cuh, whose note gives its bound and design.
//  - fp32 runs the SIMT kernel below (fa_kernel<D>).
//
// fp32 bound. At the serving shape of smollm-135m (B = 8, Hq = 9, Hkv = 3,
// S = 2,048, d = 64, causal) the function needs 4·B·Hq·d·pairs = 38.7 G
// operations (pairs = Σ min(i + 1, Skv)): 0.58 ms at 67 TFLOP/s, against
// 101 MB of inputs and output, 0.03 ms at 3.35 TB/s. Operations bound it at
// every prefill shape of the repo's models. They run as fp32 FMAs on the
// CUDA cores: TF32 on the tensor cores keeps about three digits and misses
// the kernel's 2e-5 limit (tests/test_torch_flash_attention.py shows it).
//
// fp32 design (fa_kernel<D>). The key splits come from the wrapper
// (ops.py::fp32_plan, which the CPU tests hold); the tile of each d is
// Shape<D> below and the ring depth kStages, chosen on the card by
// scripts/probe_torch_flash_attention.py.
//  - Register tiles. A block of 64 query rows has 16·CX threads, CX = 8
//    threads a row (4 at d = 16, 16 at d = 256). Thread (ry, cx) owns rows
//    ry + 16i (i < 4), keys cx + CX·j of each tile of BK keys, and the
//    float4 columns cx + CX·c of O. A thread reads four values of a row as
//    one 16-byte vector. Q's rows are padded to d + 4 floats and K's and
//    V's 16-byte chunks swizzled (below), so the rows a warp reads at once
//    fall in distinct banks; P's rows are padded by CX floats, so its
//    scalar stores and 16-byte reads are free of conflicts too. Each
//    shared-memory wavefront (128 bytes of distinct addresses) feeds
//    4–10.7 FMAs in S and 7.1–13.7 in P·V (ops.py::fp32_plan counts them;
//    the earlier SIMT design fed 2).
//  - Softmax. Each thread takes its rows' maxima over its keys, then over
//    the CX lanes of a row by shuffles; acc and its partial l are rescaled
//    by exp(m_prev - m_new). P goes through shared memory once a tile. A
//    row's P is written and read by the CX lanes of one warp, so a warp
//    barrier orders it: one block barrier a tile remains.
//  - Copies. K and V tiles arrive by TMA into a ring of 2 slots, in boxes
//    of 32 floats a row swizzled at 128 bytes (chunk c of key r at
//    c ^ (r % 8); at d = 16, 16 floats unswizzled), over tensor maps the
//    host encodes at each launch (with
//    flash_attention_bf16.cuh's helpers); rows past Skv arrive as zeros. At
//    the top of tile t the block syncs (every warp is done with tile t - 1),
//    thread 0 issues tile t + 1 into the slot tile t - 1 left, so it lands
//    while tile t computes, and every thread waits on tile t's mbarrier.
//    Q is loaded once with 16-byte loads, scaled by 1/√d, while the first
//    tile copies.
//  - Resident warps. BK = 32 keys, 16 at d = 160 and 192: three blocks of
//    4 warps stay resident at d = 64 (12 warps a SM), two at d = 128–192
//    (8), one block of 8 warps at d = 256 (211 KB of shared memory), 16
//    warps at d = 16 and 32 (chip_smoke.py logs the card's counts through
//    flash_attention_fp32_config).
//  - Short queries. Where ceil(Sq/64)·Hq·B blocks are fewer than the 132
//    SMs, the plan splits the keys into `splits` <= 8 chunks of whole tiles.
//    The splits of a query tile form a thread block cluster: each writes
//    its partial (m, l, acc) to its own shared memory and, after a cluster
//    barrier, combines a share of the rows from every split's shared memory
//    in key-chunk order. No scratch, no atomics. (On an H100, whisper-tiny's
//    cross attention ran 2.6x faster in 4 splits than in 16-row tiles.)
//  - The heaviest causal tiles (the last rows) are launched first.
// What bounds it (clock64 phases, PERF.md): S and P·V keep the FMA pipe
// 80% busy or more while they run; the wait for a tile, the block barrier
// and the softmax take 9–13% of a tile's time at d >= 128 and 29% at
// d = 64, and the kernel reaches 32–54% of the bound. Tried on the card
// and not faster: 8-row register tiles, cp.async copies from every thread,
// TMA whose slots are handed back on per-slot mbarriers instead of the
// block barrier, and a third ring slot.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;   // what one block may use
constexpr int kMaxSplits = 8;            // a portable cluster
// K/V ring slots: a third halves the resident blocks at d = 64, 128 and
// 192 and was slower at every prefill shape (PERF.md)
constexpr int kStages = 2;

// The tile of each head width (ops.py::FP32_TILES holds the same): TR query
// rows a thread, CX threads a row (key groups), BK keys a tile, BQ query
// rows a block.
template <int D> struct Shape;
template <> struct Shape<16> { static constexpr int TR = 4, CX = 4, BK = 32, BQ = 64; };
template <> struct Shape<32> { static constexpr int TR = 4, CX = 8, BK = 32, BQ = 64; };
template <> struct Shape<64> { static constexpr int TR = 4, CX = 8, BK = 32, BQ = 64; };
template <> struct Shape<128> { static constexpr int TR = 4, CX = 8, BK = 32, BQ = 64; };
template <> struct Shape<160> { static constexpr int TR = 4, CX = 8, BK = 16, BQ = 64; };
template <> struct Shape<192> { static constexpr int TR = 4, CX = 8, BK = 16, BQ = 64; };
template <> struct Shape<256> { static constexpr int TR = 4, CX = 16, BK = 32, BQ = 64; };

template <int D>
struct Tile : Shape<D> {
  using S = Shape<D>;
  static constexpr int RG = S::BQ / S::TR;       // row groups
  static constexpr int NT = RG * S::CX;          // threads
  static constexpr int TK = S::BK / S::CX;       // keys a thread
  static constexpr int NC = D / (4 * S::CX);     // float4 columns of O
  static constexpr int QS = D + 4;               // floats a Q row
  static constexpr int PS = S::BK + S::CX;       // floats a P row
  // K and V tiles arrive by TMA as boxes of W floats a row, swizzled at
  // 128 bytes (W = 32): the 16-byte chunk c of key r sits at c ^ (r % 8)
  static constexpr int W = D < 32 ? D : 32;
  static constexpr bool kSwizzle = W == 32;
  static constexpr int NB = D / W;               // boxes a row
  static constexpr int CW = W / 4;               // chunks a box row
  static constexpr int TILE = S::BK * D * 4;     // bytes of a K or V tile
  // alignment slack, the ring, Q, P and the ring's barriers
  static constexpr size_t kSmem = 1024 + (size_t)kStages * 2 * TILE +
                                  (size_t)S::BQ * QS * 4 +
                                  (size_t)S::BQ * PS * 4 + 8 * kStages;
  static_assert(D % (4 * S::CX) == 0 && S::BK % S::CX == 0 &&
                S::BQ % S::TR == 0 && 32 % S::CX == 0 && NT % 32 == 0 &&
                (!kSwizzle || S::CX % 8 == 0) && TILE % 1024 == 0 &&
                kSmem <= kMaxSmem,
                "tile");
};

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::NT, 1)
fa_kernel(const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ q, float* __restrict__ o, int hq,
          int hkv, int sq, int skv, int causal, int splits, float scale) {
  using T = Tile<D>;
  constexpr int TR = T::TR, RG = T::RG, CX = T::CX, BK = T::BK, BQ = T::BQ;
  constexpr int TK = T::TK, NC = T::NC, NT = T::NT;
  constexpr int QS = T::QS, PS = T::PS, W = T::W, NB = T::NB, CW = T::CW;
  constexpr int CH = D / 4;                 // float4 chunks a row
  constexpr int TILE = T::TILE;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  const uint32_t raw = fa_bf16::smem_addr(smem_raw);
  const uint32_t ring_s = (raw + 1023) & ~1023u;
  float* ring = reinterpret_cast<float*>(smem_raw + (ring_s - raw));
  float* qs = ring + kStages * 2 * TILE / 4;  // [BQ][QS], scaled Q
  float* ps = qs + BQ * QS;                   // [BQ][PS], P of one tile
  const uint32_t full = fa_bf16::smem_addr(ps + BQ * PS);   // + 8·slot

  const int tid = threadIdx.x;
  const int cx = tid % CX;
  const int ry = tid / CX;
  const int split = blockIdx.z % splits;
  const int b = blockIdx.z / splits;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long long qrow0 = ((long long)b * hq + head) * sq;
  const int bh_kv = b * hkv + head / (hq / hkv);

  // keys this tile of rows can see, and this split's whole tiles of them
  const int last_row = min(q0 + BQ, sq) - 1;
  const int kend = causal ? min(skv, last_row + 1) : skv;
  const int n_all = (kend + BK - 1) / BK;
  const int per = (n_all + splits - 1) / splits;
  const int kt0 = split * per;
  const int n_kt = max(0, min(n_all, kt0 + per) - kt0);

  // thread 0 loads this split's tile t (K and V) into slot t % kStages by
  // TMA; rows past Skv come in as zeros
  auto issue = [&](int t) {
    if (t >= n_kt) return;
    const int s = t % kStages;
    fa_bf16::mbar_expect_tx(full + 8 * s, 2 * TILE);
    const uint32_t kd = ring_s + s * 2 * TILE;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      fa_bf16::tma_load_3d(kd + c * BK * W * 4, &tm_k, full + 8 * s, c * W,
                           (kt0 + t) * BK, bh_kv);
      fa_bf16::tma_load_3d(kd + TILE + c * BK * W * 4, &tm_v, full + 8 * s,
                           c * W, (kt0 + t) * BK, bh_kv);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) fa_bf16::mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }
  for (int e = tid; e < BQ * CH; e += NT) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int row = q0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < sq)
      x = __ldg(reinterpret_cast<const float4*>(q + (qrow0 + row) * D) + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * QS + 4 * c) = x;
  }

  // the thread's keys are cx + CX·j, and r % 8 = cx % 8 for each of them:
  // chunk c of a box row of its keys sits at kc[c]; V's chunk cx of key r
  // at vc[r % 8]
  int kc[CW], vc[8];
#pragma unroll
  for (int c = 0; c < CW; ++c) kc[c] = 4 * (T::kSwizzle ? c ^ (cx & 7) : c);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    vc[r] = (cx / CW) * BK * W + 4 * (T::kSwizzle ? (cx & 7) ^ r : cx % CW);

  float m[TR], l[TR];
  float4 acc[TR][NC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int t = 0; t < n_kt; ++t) {
    // every warp is done with tile t - 1 (and Q is in, at t = 0): its slot
    // takes tile t + kStages - 1
    __syncthreads();
    if (tid == 0) issue(t + kStages - 1);
    fa_bf16::mbar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
    const float* ks = ring + (t % kStages) * 2 * TILE / 4 + cx * W;
    const float* vs = ring + (t % kStages) * 2 * TILE / 4 + TILE / 4;
    const int k0 = (kt0 + t) * BK;

    // S = Q·Kᵀ: per four values of d, TK keys and then TR rows as 16-byte
    // reads, 4·TR·TK FMAs
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.0f;
#pragma unroll(TR * TK <= 16 ? 2 : 1)
    for (int cb = 0; cb < NB; ++cb) {
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const int c = cb * CW + cc;
        float4 kv[TK];
#pragma unroll
        for (int j = 0; j < TK; ++j)
          kv[j] = *reinterpret_cast<const float4*>(ks + cb * BK * W +
                                                   CX * j * W + kc[cc]);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              qs + (ry + RG * i) * QS + 4 * c);
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            s[i][j] = fmaf(a.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(a.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(a.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(a.w, kv[j].w, s[i][j]);
          }
        }
      }
    }

    // the mask, on tiles that cross Skv or the diagonal
    if (k0 + BK > skv || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int row = q0 + ry + RG * i;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          const int key = k0 + cx + CX * j;
          if (key >= skv || (causal && key > row)) s[i][j] = kNegInf;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < TK; ++j) mt = fmaxf(mt, s[i][j]);
      // the row's maximum over the CX lanes that hold it
#pragma unroll
      for (int off = CX / 2; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = __expf(m[i] - m_new);
      m[i] = m_new;
      float ls = 0.0f;
      float* prow = ps + (ry + RG * i) * PS + cx;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = __expf(s[i][j] - m_new);
        prow[CX * j] = p;
        ls += p;
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    // P's rows are written and read by the CX lanes of one warp
    __syncwarp();

    // O += P·V: per four keys, TR rows of P and 4·NC columns of V as 16-byte
    // reads, 16·TR·NC FMAs
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (ry + RG * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + vc[(kk + u) % 8] + (kk + u) * W + c * (CX / CW) * BK * W);
#pragma unroll
          for (int i = 0; i < TR; ++i) fma4(acc[i][c], lane_of(p[i], u), vv);
        }
      }
    }
  }

  // each row's l over the CX lanes that hold it
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int off = CX / 2; off > 0; off /= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ry + RG * i;
      if (row >= sq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      float4* out = reinterpret_cast<float4*>(o + (qrow0 + row) * D);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 a = acc[i][c];
        a.x /= denom;
        a.y /= denom;
        a.z /= denom;
        a.w /= denom;
        out[cx + CX * c] = a;
      }
    }
    return;
  }

  // split keys: the partial (m, l, acc) of each split, combined in
  // key-chunk order across the cluster's shared memory
  __syncthreads();   // Q, P and the ring are no longer read
  float* pm = qs;               // [BQ]
  float* pl = pm + BQ;          // [BQ]
  float* pa = pl + BQ;          // [BQ][D]
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ry + RG * i;
    if (cx == 0) {
      pm[r] = m[i];
      pl[r] = l[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      reinterpret_cast<float4*>(pa + r * D)[cx + CX * c] = acc[i][c];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (BQ + splits - 1) / splits;
  for (int e = tid; e < rows * CH; e += NT) {
    const int r = split * rows + e / CH;
    const int c = e % CH;
    if (r >= BQ || q0 + r >= sq) continue;
    float mm = kNegInf;
    for (int s = 0; s < splits; ++s)
      mm = fmaxf(mm, cluster.map_shared_rank(pm, s)[r]);
    float ll = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < splits; ++s) {
      const float w = __expf(cluster.map_shared_rank(pm, s)[r] - mm);
      ll = fmaf(cluster.map_shared_rank(pl, s)[r], w, ll);
      fma4(a, w, reinterpret_cast<const float4*>(
                     cluster.map_shared_rank(pa, s) + r * D)[c]);
    }
    const float denom = fmaxf(ll, 1e-30f);
    a.x /= denom;
    a.y /= denom;
    a.z /= denom;
    a.w /= denom;
    reinterpret_cast<float4*>(o + (qrow0 + q0 + r) * D)[c] = a;
  }
  cluster.sync();   // no split leaves while another reads its partials
}

// A map over x [heads, rows, D] fp32 whose box is `rows_box` rows of W
// floats, swizzled at 128 bytes where W = 32.
template <int D>
bool make_map(CUtensorMap* map, const void* x, int heads, int rows,
              int rows_box) {
  using T = Tile<D>;
  const fa_bf16::EncodeTiled encode = fa_bf16::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                 (cuuint64_t)D * 4 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)T::W, (cuuint32_t)rows_box, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::kSwizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets fa_kernel<D> take its shared memory on the current device: once a
// device, not at every launch.
template <int D>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fa_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<D>::kSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int D>
int launch_plan(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, int causal, int splits,
                cudaStream_t stream) {
  using T = Tile<D>;
  if ((long long)b * hkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_k, tm_v;
  if (!make_map<D>(&tm_k, k, b * hkv, skv, T::BK) ||
      !make_map<D>(&tm_v, v, b * hkv, skv, T::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((sq + T::BQ - 1) / T::BQ, hq, b * splits);
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  // 1/√d rounded once from double, as the JAX package's Python float is
  const float scale = (float)(1.0 / sqrt((double)D));
  err = cudaLaunchKernelEx(&cfg, fa_kernel<D>, tm_k, tm_v,
                           static_cast<const float*>(q),
                           static_cast<float*>(o), hq, hkv, sq, skv, causal,
                           splits, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// query rows, threads, shared-memory bytes, resident blocks a SM and ring
// slots of the instance of head width D
template <int D>
int describe(int* out) {
  using T = Tile<D>;
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fa_kernel<D>,
                                                      T::NT, T::kSmem);
  out[0] = T::BQ;
  out[1] = T::NT;
  out[2] = (int)T::kSmem;
  out[3] = blocks;
  out[4] = kStages;
  return (int)err;
}

#define FA32_DISPATCH(CALL)                \
  switch (d) {                             \
    case 16: return CALL(16);              \
    case 32: return CALL(32);              \
    case 64: return CALL(64);              \
    case 128: return CALL(128);            \
    case 160: return CALL(160);            \
    case 192: return CALL(192);            \
    case 256: return CALL(256);            \
    default: return (int)cudaErrorInvalidValue; \
  }

int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int d, int causal,
               int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
#define FA32_LAUNCH(D) \
  launch_plan<D>(q, k, v, o, b, hq, hkv, sq, skv, causal, splits, stream)
  FA32_DISPATCH(FA32_LAUNCH)
#undef FA32_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = launched). `elem_bytes` is 4 for float32 and 2 for bfloat16. Shapes
// are validated by the Python wrapper (Hq a multiple of Hkv >= 1, Sq >= 1,
// Skv >= 1, d in {16, 32, 64, 128, 160, 192, 256}). float32 takes the key
// splits of ops.py::fp32_plan (`splits`, 1 to 8); bfloat16 ignores them.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int elem_bytes, int b, int hq, int hkv,
                           int sq, int skv, int d, int causal, int splits,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1)
    return (int)cudaErrorInvalidValue;
  switch (elem_bytes) {
    case 4:
      return launch_f32(q, k, v, o, b, hq, hkv, sq, skv, d, causal, splits,
                        st);
    case 2:
      return fa_bf16::launch_d(q, k, v, o, b, hq, hkv, sq, skv, d, causal,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 instance of head width `d`: out[0] query rows a block, out[1]
// threads a block, out[2] shared-memory bytes a block, out[3] blocks
// resident on a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[4]
// K/V ring slots.
int flash_attention_fp32_config(int d, int* out) {
#define FA32_DESCRIBE(D) describe<D>(out)
  FA32_DISPATCH(FA32_DESCRIBE)
#undef FA32_DESCRIBE
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
