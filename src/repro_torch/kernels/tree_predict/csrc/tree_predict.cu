// Packed-forest inference on Hopper (sm_90a): one call evaluates every
// forest of one solver step, for all classes and sub-forests at once.
//
// Replaces src/repro/kernels/tree_predict/tree_kernel.py::forest_predict_pallas
// (body _predict_kernel). The TPU kernel selects feature values and
// thresholds with one-hot matmuls, because a TPU has no cheap gather, and so
// clips the +inf "never go right" sentinels to 1e30. Here a thread gathers
// x[b, row, feat[h]] and thr[h] and compares them strictly, with no clip.
//
//   x    [B, n, p]            f32   rows of class b
//   feat [B, S, T, H]         i32   heap order, H = 2^depth - 1
//   thr  [B, S, T, H]         f32   +inf = never go right
//   leaf [B, S, T, L, out]    f32   L = 2^depth, depth <= 16
//   y    [B, S, n, out]       f32   y[b,s,i,:] = sum_t leaf[b,s,t,node_t(i),:]
//
// Every output sums its trees in order, t = 0 … T-1, from 0.0f in fp32, as
// the plain version and the JAX reference's scan do: the three agree to the
// bit, and every run gives the same result.
//
// Bound by memory at the generation path's MO shape: each input read once
// and the output written once is 4·(B·n·p + 2·B·S·T·H + B·S·T·L·out +
// B·S·n·out) bytes, 410 MB for the CaloForest photons step (B=15, S=1, T=20,
// depth 7, p=out=368, n=8,000), 0.12 ms at 3.35 TB/s. The port's first
// kernel re-read a 1,472-byte leaf row through L2 for every (row, tree),
// 3.53 GB a launch, and took 1.57 ms. Here out > 1 takes two kernels
// (PERF.md §6 has the probe that chose them):
//
//   route_kernel: a block copies 32 rows of x (cp.async, as they lie) and a
//     tile of trees' feat / thr into shared memory, walks each (row, tree)
//     through `depth` levels there, and writes the leaf index to a uint16
//     scratch [B, S, tc, npad] (4.8 MB at the photons step). Its time is
//     the copying; the walks cost a few microseconds.
//   sum_tma_kernel / sum_kernel: a block owns 256 (sum_kernel: 512) rows ×
//     64 columns of one (b, s); lane l adds columns 2l and 2l + 1 of its
//     warp's 32 rows, one 8-byte shared load a row and tree, the 64 sums in
//     registers. Each tree's leaf tile leaf[b, s, t, :, c0:c0+64] (32 KB at depth 7) and its
//     rows' indices stream through a ring of stages: where n_out % 4 == 0
//     and depth <= 8, a copying warp fills them by TMA and mbarriers, so no
//     adding warp waits for another; else all threads copy by cp.async with
//     one block barrier a tree. The leaf bytes a block reads do not grow
//     with its rows (32 × 56.5 MB through L2 at the photons step, not 3.53
//     GB). Depth > 8 reads the leaves through L1.
//
// out = 1 (SO: a sub-forest per output, S of them) is one fused kernel,
// so_kernel. Its work is the walks, not the bytes: at the photons SO step
// (S = 368, out = 1, otherwise as above) the bound is 522 MB, 0.156 ms, but
// the 883 M walks take 22 shared loads each (7 levels × feat, thr and x,
// then the leaf), ~2.3 ms of the shared-memory pipe at one warp load a
// clock, and ~75 instructions each. So no thread hands work to
// another: a block stages R rows of x once (feature-major, so a
// warp's 32 rows gather from 32 banks), and thread r of ring k owns row r
// of the block's k-th, (k + K)-th, … sub-forests. It walks 4 trees at once
// as independent chains, in byte offsets, and adds their leaves in tree
// order to one fp32 register, then writes y after tree T-1: no value tile,
// no block barrier in the loop. Lane k of a copying warp feeds ring k, a
// slice of TS trees (feat, thr, leaf) at a time, by three bulk copies of
// the 16-byte-aligned spans that hold them, into stages with a full and an
// empty mbarrier each: a walking warp waits only for its own stage, and no
// ring for another. R, K and TS come from the wrapper's plan
// (ops.so_plan), a pure function of the shapes. Shapes whose rows and one
// slice do not fit shared memory (deep trees, wide x) take so_l1_kernel:
// the same walks, x and the trees read through L1.
//
// Ragged rows and columns are masked. The kernels allocate nothing (the
// scratch comes from the wrapper) and do not synchronise; the launches run on
// the caller's stream.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 32;            // rows of x a routing block stages
constexpr int kRouteWarps = 8;       // route_kernel: 256 threads
constexpr int kForestBytes = 32 * 1024;   // route_kernel's tile of trees
constexpr int kSumWarps = 8;         // sum_tma_kernel: adding warps, 32 rows each
constexpr int kCpWarps = 16;         // sum_kernel: warps, 32 rows each
constexpr int kCpRows = kCpWarps * kWarp;
constexpr int kCols = 64;            // sum_kernel: columns a block, 2 a lane
constexpr int kSoWarps = 16;         // so_kernel: 512 threads at most
constexpr int kSoStages = 2;         // so_kernel: slices a ring
constexpr int kSoChains = 4;         // so_kernel: walks a thread keeps going
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSms = 132;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// the generic proxy's reads of a stage are ordered before the TMA's writes
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a TMA box of a 2-D tensor map into shared memory, completing on the
// mbarrier at `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Rows [row0, row0 + R) of x[b] (rows >= n as zeros) into x_s[f * R + r],
// R a multiple of 32, by warps 0 … nw-1, lane = row: a warp loads 8 pieces
// of each of its 32 rows at once (4 features a piece where vec: p % 4 == 0
// and x 16-byte aligned, else 1), then stores them, each store to 32 banks.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x_b,
                                           int row0, int R, int n, int p,
                                           float* __restrict__ x_s, int nw,
                                           int vec) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int width = vec ? 4 : 1;
  const int pieces = (p + width - 1) / width;
  const int row_groups = R / kWarp;
  for (int it = warp; it < row_groups * ((pieces + 7) / 8); it += nw) {
    const int r = (it % row_groups) * kWarp + lane;
    const int q0 = (it / row_groups) * 8;
    const bool live = row0 + r < n;
    const float* xr = x_b + (long long)(live ? row0 + r : 0) * p;
    float* xs = x_s + r;
    if (vec) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = live && q0 + u < pieces
                   ? __ldg(reinterpret_cast<const float4*>(xr) + q0 + u)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (q0 + u >= pieces) break;
        float* d = xs + 4 * (q0 + u) * R;
        d[0] = v[u].x;
        d[R] = v[u].y;
        d[2 * R] = v[u].z;
        d[3 * R] = v[u].w;
      }
    } else {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = live && q0 + u < pieces ? __ldg(xr + q0 + u) : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < pieces) xs[(q0 + u) * R] = v[u];
    }
  }
}

// Two independent walks at once (one warp's latency covers the other's).
template <bool kXShared>
__device__ __forceinline__ void walk2(
    const float* __restrict__ xa_col, const float* __restrict__ xb_col, int R,
    const float* __restrict__ xa_row, const float* __restrict__ xb_row,
    const int* __restrict__ fa, const float* __restrict__ ha,
    const int* __restrict__ fb, const float* __restrict__ hb, int depth,
    int& na, int& nb) {
  na = 0;
  nb = 0;
  for (int level = 0; level < depth; ++level) {
    const int off = (1 << level) - 1;
    const int f_a = fa[na + off], f_b = fb[nb + off];
    const float t_a = ha[na + off], t_b = hb[nb + off];
    const float v_a = kXShared ? xa_col[f_a * R] : __ldg(xa_row + f_a);
    const float v_b = kXShared ? xb_col[f_b * R] : __ldg(xb_row + f_b);
    na = 2 * na + (v_a > t_a);
    nb = 2 * nb + (v_b > t_b);
  }
}

// route_kernel's shared memory: x_s, the transposing buffer, the tree tile
// route_kernel's x_s: 32 rows, row-major, copied as they lie in x. A row's
// stride is p where rows are 16-byte aligned (p % 4 == 0), plus 4 floats
// where p is a multiple of 8, so a warp's 32 rows at one feature spread
// over 8 banks; p | 1 (32 banks) where they are not.
__host__ __device__ inline int route_stride(int p) {
  if (p % 4) return p | 1;
  return p % 8 ? p : p + 4;
}

__host__ __device__ inline size_t route_x_bytes(int p) {
  return (size_t)route_stride(p) * kRows * 4;
}

// grid: B·S·row_tiles blocks (b, s, 32 rows), kRouteWarps warps. The
// block copies its 32 rows of x into x_s by cp.async (16-byte pieces where
// rows allow), then walks trees t0 … t0+tc-1 in tiles of `tile`
// (kForestShared: each tile's feat / thr copied beside x_s; else read
// through L1): warp w walks trees w, w + 8, … of a tile, two at once, for
// the 32 rows (lane = row) and writes their leaf indices to idx[b, s, t -
// t0, row].
template <bool kXShared, bool kForestShared>
__global__ void __launch_bounds__(kRouteWarps * kWarp)
route_kernel(const float* __restrict__ x, const int* __restrict__ feat,
             const float* __restrict__ thr, uint16_t* __restrict__ idx, int n,
             int p, int S, int T, int t0, int tc, int depth, int npad,
             int row_tiles, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long bs = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x % row_tiles) * kRows;
  const int row = row0 + lane;
  const int b = (int)(bs / S);
  const int H = (1 << depth) - 1;
  const int stride = route_stride(p);
  const float* x_b = x + (long long)b * n * p;
  const float* x_row = x_b + (long long)min(row, n - 1) * p;
  float* x_s = smem;
  int* f_s = (int*)(smem + (kXShared ? stride * kRows : 0));
  float* t_s = (float*)(f_s + (kForestShared ? tile * H : 0));
  const int* feat_c = feat + (bs * T + t0) * H;
  const float* thr_c = thr + (bs * T + t0) * H;
  // route: stage
  if (kXShared) {               // rows past n copy row n - 1, never written
    if (p % 4 == 0) {
      const int q4 = p / 4;
      for (int i = threadIdx.x; i < kRows * q4; i += blockDim.x) {
        const int r = i / q4, q = (i % q4) * 4;
        cp_async16(x_s + r * stride + q,
                   x_b + (long long)min(row0 + r, n - 1) * p + q);
      }
    } else {
      for (int i = threadIdx.x; i < kRows * p; i += blockDim.x) {
        const int r = i / p, f = i % p;
        cp_async4(x_s + r * stride + f,
                  x_b + (long long)min(row0 + r, n - 1) * p + f);
      }
    }
  }
  for (int u0 = 0; u0 < tc; u0 += tile) {
    const int un = min(tile, tc - u0);
    const int* f_u = feat_c + (long long)u0 * H;
    const float* t_u = thr_c + (long long)u0 * H;
    if (kForestShared) {
      if (u0 > 0) __syncthreads();          // the previous tile is walked
      for (int i = threadIdx.x; i < un * H; i += blockDim.x) {
        cp_async4(f_s + i, f_u + i);
        cp_async4(t_s + i, t_u + i);
      }
      f_u = f_s;
      t_u = t_s;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // route: walk
    for (int ua = warp; ua < un; ua += 2 * kRouteWarps) {
      const int ub = min(ua + kRouteWarps, un - 1);   // a repeat past the end
      int na, nb;
      walk2<kXShared>(x_s + lane * stride, x_s + lane * stride, 1, x_row,
                      x_row, f_u + (long long)ua * H, t_u + (long long)ua * H,
                      f_u + (long long)ub * H, t_u + (long long)ub * H, depth,
                      na, nb);
      if (row < npad) {
        idx[(bs * tc + u0 + ua) * npad + row] = (uint16_t)na;
        if (ua + kRouteWarps < un)
          idx[(bs * tc + u0 + ub) * npad + row] = (uint16_t)nb;
      }
    }
  }
}  // route_kernel

// A warp's 32 rows × 2 columns of sums, from r0 and col_a: 0.0f for the
// first chunk of trees, else what the previous chunk left in y.
__device__ __forceinline__ void load_sums(float2 (&acc)[kWarp],
                                          const float* __restrict__ y_bs,
                                          int r0, int n, int n_out, int col_a,
                                          int first) {
#pragma unroll
  for (int k = 0; k < kWarp; ++k) {
    const float* yr = y_bs + (long long)(r0 + k) * n_out;
    const bool row = !first && r0 + k < n;
    acc[k].x = row && col_a < n_out ? yr[col_a] : 0.0f;
    acc[k].y = row && col_a + 1 < n_out ? yr[col_a + 1] : 0.0f;
  }
}

__device__ __forceinline__ void store_sums(const float2 (&acc)[kWarp],
                                           float* __restrict__ y_bs, int r0,
                                           int n, int n_out, int col_a) {
#pragma unroll
  for (int k = 0; k < kWarp; ++k) {
    float* yr = y_bs + (long long)(r0 + k) * n_out;
    if (r0 + k < n && col_a < n_out) yr[col_a] = acc[k].x;
    if (r0 + k < n && col_a + 1 < n_out) yr[col_a + 1] = acc[k].y;
  }
}

// One tree for one warp's 32 rows, in order: each row's leaf index from
// the stage's indices, then its two columns from the stage's tile (one
// 8-byte shared load) or, !kStaged, from the leaves through L1 (leaf_t:
// the tree's leaves, ca / cb: the columns, clamped), added to the sums.
template <bool kStaged>
__device__ __forceinline__ void add_tree(float2 (&acc)[kWarp],
                                         const float2* __restrict__ tile,
                                         const uint4* __restrict__ ids,
                                         int mask,
                                         const float* __restrict__ leaf_t,
                                         int n_out, int ca, int cb) {
#pragma unroll
  for (int q = 0; q < kWarp / 8; ++q) {
    const uint4 w4 = ids[q];
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int node = (int)(words[k / 2] >> (16 * (k % 2))) & mask;
      float2 v;
      if (kStaged) {
        v = tile[node * (kCols / 2)];
      } else {
        const float* lr = leaf_t + (long long)node * n_out;
        v = make_float2(__ldg(lr + ca), __ldg(lr + cb));
      }
      acc[8 * q + k].x = __fadd_rn(acc[8 * q + k].x, v.x);
      acc[8 * q + k].y = __fadd_rn(acc[8 * q + k].y, v.y);
    }
  }
}

// One tree's leaf tile and leaf indices into a stage of sum_kernel's ring,
// by all threads of the block: 16-byte pieces where the columns allow (vec:
// n_out % 4 == 0), else 4-byte ones.
template <bool kStaged>
__device__ __forceinline__ void fill_stage(
    unsigned char* base, const float* __restrict__ leaf_t,
    const uint16_t* __restrict__ idx_t, int L, int c0, int n_out, int row0,
    int npad, int tile_bytes, int vec) {
  if (kStaged) {
    float* tile = (float*)base;
    const float* src = leaf_t + c0;
    if (vec) {
      for (int i = threadIdx.x; i < L * (kCols / 4); i += blockDim.x) {
        const int l = i / (kCols / 4), q = (i % (kCols / 4)) * 4;
        if (c0 + q < n_out)
          cp_async16(tile + l * kCols + q, src + (long long)l * n_out + q);
      }
    } else {
      for (int i = threadIdx.x; i < L * kCols; i += blockDim.x) {
        const int l = i / kCols, c = i % kCols;
        if (c0 + c < n_out)
          cp_async4(tile + l * kCols + c, src + (long long)l * n_out + c);
      }
    }
  }
  uint16_t* ids = (uint16_t*)(base + tile_bytes);
  for (int i = threadIdx.x * 8; i < kCpRows; i += blockDim.x * 8)
    if (row0 + i < npad) cp_async16(ids + i, idx_t + row0 + i);
}

// grid: B·S·row_tiles·col_tiles blocks (b, s, 512 rows, 64 columns), 16
// warps; lane l = columns c0 + 2l and c0 + 2l + 1, warp w = rows row0 + 32w
// … +31: a row's tree costs a warp one 8-byte shared load for 64 adds.
// Trees t0 … t0+tc-1 stream through an NST-stage cp.async ring, a stage the
// tree's leaf tile [L][64] (kStaged; else leaves are read through L1) and
// its 512 leaf indices, NST - 2 trees ahead: the one barrier a tree, after
// a stage lands, also tells that every warp is done with the stage refilled
// next. first: sums start from 0.0f, else from y (a later tree chunk).
template <int NST, bool kStaged>
__global__ void __launch_bounds__(kCpRows, 1)
sum_kernel(const float* __restrict__ leaf, const uint16_t* __restrict__ idx,
           float* __restrict__ y, int n, int T, int t0, int tc, int depth,
           int n_out, int npad, int row_tiles, int col_tiles, int first,
           int vec) {
  constexpr int kAhead = NST - 2;
  extern __shared__ __align__(16) unsigned char sbuf[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int ct = blockIdx.x % col_tiles;
  const int rest = blockIdx.x / col_tiles;
  const int row0 = (rest % row_tiles) * kCpRows;
  const long long bs = rest / row_tiles;
  const int c0 = ct * kCols;
  const int col_a = c0 + 2 * lane;
  const int ca = min(col_a, n_out - 1), cb = min(col_a + 1, n_out - 1);
  const int L = 1 << depth;
  const int mask = L - 1;
  const int tile_bytes = kStaged ? L * kCols * 4 : 0;
  const int stage_bytes = tile_bytes + kCpRows * 2;
  const long long tree_floats = (long long)L * n_out;
  const float* leaf_c = leaf + (bs * T + t0) * tree_floats;
  const uint16_t* idx_c = idx + bs * tc * (long long)npad;
  float* y_bs = y + bs * n * (long long)n_out;

  // sum: start
  float2 acc[kWarp];
  load_sums(acc, y_bs, row0 + warp * kWarp, n, n_out, col_a, first);
#pragma unroll
  for (int st = 0; st < kAhead; ++st) {
    if (st < tc)
      fill_stage<kStaged>(sbuf + st * stage_bytes, leaf_c + st * tree_floats,
                          idx_c + (long long)st * npad, L, c0, n_out, row0,
                          npad, tile_bytes, vec);
    cp_async_commit();
  }
  for (int tt = 0; tt < tc; ++tt) {
    // stage (tt + kAhead) % NST last held tree tt - 2, which every warp
    // finished before the barrier of tree tt - 1
    const int nx = tt + kAhead;
    if (nx < tc)
      fill_stage<kStaged>(sbuf + (nx % NST) * stage_bytes,
                          leaf_c + nx * tree_floats,
                          idx_c + (long long)nx * npad, L, c0, n_out, row0,
                          npad, tile_bytes, vec);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncthreads();
    // sum: staged
    const unsigned char* base = sbuf + (tt % NST) * stage_bytes;
    add_tree<kStaged>(acc, (const float2*)base + lane,
                      (const uint4*)(base + tile_bytes) + warp * (kWarp / 8),
                      mask, leaf_c + tt * tree_floats, n_out, ca, cb);
    // sum: added
  }
  store_sums(acc, y_bs, row0 + warp * kWarp, n, n_out, col_a);
}  // sum_kernel

// sum_kernel's tiles and work (W adding warps) where n_out % 4 == 0 and
// depth <= 8, with a copying warp: its lane 0 fills a stage once every adding warp has
// released it (the stage's `empty` mbarrier), the leaf tile as one TMA box
// of the 2-D map `tm_leaf` ([B·S·T·L rows][n_out], box [L][64]; columns
// past n_out read as zeros) and the indices as one bulk copy, both
// completing the stage's `full` mbarrier. No block barrier in the loop: an
// adding warp waits only for its stage.
template <int NST, int W, int MINB>
__global__ void __launch_bounds__((W + 1) * kWarp, MINB)
sum_tma_kernel(const __grid_constant__ CUtensorMap tm_leaf,
               const uint16_t* __restrict__ idx, float* __restrict__ y, int n,
               int T, int t0, int tc, int depth, int n_out, int npad,
               int row_tiles, int col_tiles, int first) {
  extern __shared__ __align__(128) unsigned char sbuf[];
  __shared__ __align__(8) uint64_t bars[2 * NST];   // full, then empty
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int ct = blockIdx.x % col_tiles;
  const int rest = blockIdx.x / col_tiles;
  const int row0 = (rest % row_tiles) * W * kWarp;
  const long long bs = rest / row_tiles;
  const int c0 = ct * kCols;
  const int L = 1 << depth;
  const int tile_bytes = L * kCols * 4;
  const int stage_bytes = tile_bytes + W * kWarp * 2;
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + NST);
  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {      // the copying warp
    if (lane == 0) {
      const int id_bytes = min(W * kWarp, npad - row0) * 2;
      const uint16_t* idx_c = idx + bs * tc * (long long)npad + row0;
      const int leaf_row0 = (int)((bs * T + t0) * L);
      for (int tt = 0; tt < tc; ++tt) {
        const int st = tt % NST;
        unsigned char* stage = sbuf + st * stage_bytes;
        if (tt >= NST) mbar_wait(empty0 + 8 * st, (tt / NST - 1) & 1);
        fence_proxy();
        mbar_expect_tx(full0 + 8 * st, tile_bytes + id_bytes);
        tma_2d(stage, &tm_leaf, full0 + 8 * st, c0, leaf_row0 + tt * L);
        bulk_copy(stage + tile_bytes, idx_c + (long long)tt * npad, id_bytes,
                  full0 + 8 * st);
      }
    }
    return;
  }

  const int col_a = c0 + 2 * lane;
  float* y_bs = y + bs * n * (long long)n_out;
  // sum: start
  float2 acc[kWarp];
  load_sums(acc, y_bs, row0 + warp * kWarp, n, n_out, col_a, first);
  for (int tt = 0; tt < tc; ++tt) {
    const int st = tt % NST;
    mbar_wait(full0 + 8 * st, (tt / NST) & 1);
    // sum: staged
    const unsigned char* base = sbuf + st * stage_bytes;
    add_tree<true>(acc, (const float2*)base + lane,
                   (const uint4*)(base + tile_bytes) + warp * (kWarp / 8),
                   L - 1, nullptr, n_out, 0, 0);
    // sum: added
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
  store_sums(acc, y_bs, row0 + warp * kWarp, n, n_out, col_a);
}  // sum_kernel

// so_kernel's shared memory: the mbarriers (full, then empty: K·kSoStages
// each), x_s [p][R], then K rings of kSoStages slices; a slice holds TS
// trees' feat, thr and leaf, each copied as the 16-byte-aligned span that
// covers it, so each part has room for TS·H (TS·L) values and 3 more
// (ops.so_smem_bytes is the same sum)
__host__ __device__ inline size_t so_bar_bytes(int K) {
  return ((size_t)16 * K * kSoStages + 127) / 128 * 128;
}

__host__ __device__ inline int so_part(int values) {   // floats, 16-byte units
  return (values + 3 + 3) / 4 * 4;
}

__host__ __device__ inline size_t so_slice_bytes(int TS, int depth) {
  const int H = (1 << depth) - 1, L = 1 << depth;
  return (size_t)4 * (2 * so_part(TS * H) + so_part(TS * L));
}

size_t so_bytes(int p, int R, int K, int TS, int depth) {
  return so_bar_bytes(K) + (size_t)4 * p * R +
         (size_t)K * kSoStages * so_slice_bytes(TS, depth);
}

template <bool kShared, typename V>
__device__ __forceinline__ V so_load(const V* p) {
  return kShared ? *p : __ldg(p);
}

// A float of shared memory at its 32-bit shared address, so that x's
// gather costs one multiply-add for its address. x_s is read only after it
// is staged, so the load needs no ordering against other memory.
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// The walks of trees 0 … m-1 (m <= kSoChains; past m, tree m-1 again) for
// one row, as independent chains: o[c] ends at 4 × (1 + the heap index of
// tree c's leaf), in [4H + 4, 8H + 4]. f / t: the first tree's feat and thr
// (trees H apart), x_r[f * xs]: the row's feature f. Offsets are kept in
// bytes, one past the node (o' = 2·o, plus 4 to go right), so that a level
// costs two adds, three loads, a multiply-add, a compare and the update.
template <bool kShared>
__device__ __forceinline__ void so_walk(int (&o)[kSoChains],
                                        const int* __restrict__ f,
                                        const float* __restrict__ t, int m,
                                        int H, int depth,
                                        const float* __restrict__ x_r,
                                        int xs) {
  const char* fc[kSoChains];
  const char* tc[kSoChains];
#pragma unroll
  for (int c = 0; c < kSoChains; ++c) {
    fc[c] = (const char*)(f + min(c, m - 1) * H - 1);
    tc[c] = (const char*)(t + min(c, m - 1) * H - 1);
    o[c] = 4;
  }
  const char* xb = (const char*)x_r;
  const uint32_t xa = kShared ? smem_addr(x_r) : 0u;
  const int xs4 = 4 * xs;
  for (int level = 0; level < depth; ++level) {
#pragma unroll
    for (int c = 0; c < kSoChains; ++c) {
      const int fi = so_load<kShared>((const int*)(fc[c] + o[c]));
      const float th = so_load<kShared>((const float*)(tc[c] + o[c]));
      const float v = kShared ? lds_f32(xa + fi * xs4)
                              : __ldg((const float*)(xb + fi * xs4));
      o[c] = 2 * o[c] + (v > th ? 4 : 0);
    }
  }
}

// acc plus the leaves of trees 0 … m-1 at o[] (so_walk's), in tree order
// (l: the first tree's leaves, trees L apart)
template <bool kShared>
__device__ __forceinline__ float so_add(float acc, const int (&o)[kSoChains],
                                        const float* __restrict__ l, int m,
                                        int H, int L) {
  float v[kSoChains];
#pragma unroll
  for (int c = 0; c < kSoChains; ++c)
    v[c] = so_load<kShared>(
        (const float*)((const char*)(l + min(c, m - 1) * L - H - 1) + o[c]));
#pragma unroll
  for (int c = 0; c < kSoChains; ++c)
    if (c < m) acc = __fadd_rn(acc, v[c]);
  return acc;
}

// Bytes of the 16-byte-aligned span of global memory that holds the n
// floats at src, copied to dst by one bulk copy completing on `bar` if
// `go`. The span reaches at most 12 bytes past either end of the values,
// inside their allocation, whose ends are 16-byte aligned.
__device__ __forceinline__ int so_copy(float* dst, const void* src, int n,
                                       uint32_t bar, bool go) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const int bytes =
      (int)((((uintptr_t)src + 4 * (uintptr_t)n + 15) & ~(uintptr_t)15) - a);
  if (go) bulk_copy(dst, (const void*)a, bytes, bar);
  return bytes;
}

// where the value at `base` + i lands in its part of a stage: floats past
// the part's start
__device__ __forceinline__ int so_lead(const void* base, long long i) {
  return (int)(((uint32_t)(uintptr_t)base / 4 + (uint32_t)i) & 3);
}

// Trees [tree0, tree0 + tn) of one sub-forest into a stage laid out for TS
// trees, by this thread: three bulk copies completing the stage's `full`
// mbarrier.
__device__ __forceinline__ void so_fill(float* stage,
                                        const int* __restrict__ feat,
                                        const float* __restrict__ thr,
                                        const float* __restrict__ leaf,
                                        long long tree0, int tn, int TS,
                                        int H, int L, uint32_t full) {
  float* t_s = stage + so_part(TS * H);
  float* l_s = t_s + so_part(TS * H);
  const int* f_g = feat + tree0 * H;
  const float* t_g = thr + tree0 * H;
  const float* l_g = leaf + tree0 * L;
  fence_proxy();
  mbar_expect_tx(full, so_copy(stage, f_g, tn * H, full, false) +
                           so_copy(t_s, t_g, tn * H, full, false) +
                           so_copy(l_s, l_g, tn * L, full, false));
  so_copy(stage, f_g, tn * H, full, true);
  so_copy(t_s, t_g, tn * H, full, true);
  so_copy(l_s, l_g, tn * L, full, true);
}

// out = 1. grid: B·row_tiles·groups blocks (b, R rows, sub-forests [s0,
// s1)); W = K·R/32 walking warps and one copying warp. Walking warp w is
// rows 32·(w % (R/32)) … +31 of ring k = w / (R/32), whose sub-forests are
// the k-th, (k + K)-th, … of the block's; their trees stream through the
// ring's kSoStages stages, TS trees a slice, in order. Lane k of the
// copying warp fills ring k, a stage as soon as the ring's R/32 warps have
// released it: the lanes poll their rings without waiting, so no ring
// waits for another's. The walking warps stage x meanwhile.
__global__ void __launch_bounds__(kSoWarps * kWarp, 1)
so_kernel(const float* __restrict__ x, const int* __restrict__ feat,
          const float* __restrict__ thr, const float* __restrict__ leaf,
          float* __restrict__ y, int n, int p, int S, int T, int depth, int R,
          int K, int TS, int row_tiles, int groups, int group, int vec) {
  extern __shared__ __align__(128) unsigned char sbuf[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = blockIdx.x % groups;
  const int rest = blockIdx.x / groups;
  const int row0 = (rest % row_tiles) * R;
  const int b = rest / row_tiles;
  const int s0 = g * group, N = min(S, s0 + group) - s0;
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  const int W = K * (R / kWarp);
  const int slice_floats = (int)(so_slice_bytes(TS, depth) / 4);
  const uint32_t full0 = smem_addr(sbuf);
  const uint32_t empty0 = full0 + 8 * K * kSoStages;
  float* x_s = (float*)(sbuf + so_bar_bytes(K));
  float* rings = x_s + (size_t)p * R;
  if (threadIdx.x == 0) {
    for (int i = 0; i < K * kSoStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, R / kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {      // the copying warp: lane k fills ring k
    const int k = lane;
    // the ring's next slice: trees t0 … of sub-forest s0 + s, into stage
    // st for the use-th time
    int s = k, t0 = 0, st = 0, use = 0;
    long long idle = 0;
    while (__any_sync(0xffffffffu, k < K && s < N)) {
      const int slot = k * kSoStages + st;
      const bool go = k < K && s < N &&
                      (use == 0 || mbar_test(empty0 + 8 * slot, (use - 1) & 1));
      if (go) {
        so_fill(rings + slot * slice_floats, feat, thr, leaf,
                ((long long)b * S + s0 + s) * T + t0, min(TS, T - t0), TS, H,
                L, full0 + 8 * slot);
        if (++st == kSoStages) st = 0, ++use;
        if ((t0 += TS) >= T) {
          t0 = 0;
          s += K;
        }
      }
      // no ring refilled for ~2^32 cycles (seconds): a broken pipeline
      if (__any_sync(0xffffffffu, go)) {
        idle = 0;
      } else if (idle == 0) {
        idle = clock64();
      } else if (clock64() - idle > (1LL << 32)) {
        __trap();
      }
    }
    return;
  }

  const int k = warp / (R / kWarp);
  const int r = (warp % (R / kWarp)) * kWarp + lane;
  // so: stage
  stage_rows(x + (long long)b * n * p, row0, R, n, p, x_s, W, vec);
  asm volatile("bar.sync 1, %0;\n" ::"r"(W * kWarp) : "memory");
  // so: start
  const float* x_r = x_s + r;
  int j = 0;
  for (int s = s0 + k; s < s0 + N; s += K) {
    float acc = 0.0f;
    for (int t0 = 0; t0 < T; t0 += TS, ++j) {
      const int slot = k * kSoStages + j % kSoStages;
      mbar_wait(full0 + 8 * slot, (j / kSoStages) & 1);
      // so: staged
      const long long tree0 = ((long long)b * S + s) * T + t0;
      const float* stage = rings + slot * slice_floats;
      const int* f_u = (const int*)stage + so_lead(feat, tree0 * H);
      const float* t_u = stage + so_part(TS * H) + so_lead(thr, tree0 * H);
      const float* l_u = stage + 2 * so_part(TS * H) + so_lead(leaf, tree0 * L);
      const int tn = min(TS, T - t0);
      for (int u0 = 0; u0 < tn; u0 += kSoChains) {
        const int m = min(kSoChains, tn - u0);
        int hb[kSoChains];
        so_walk<true>(hb, f_u + u0 * H, t_u + u0 * H, m, H, depth, x_r, R);
        // so: walked
        acc = so_add<true>(acc, hb, l_u + u0 * L, m, H, L);
        // so: added
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
    if (row0 + r < n) y[((long long)b * S + s) * n + row0 + r] = acc;
  }
  // so: done
}  // so_kernel

// out = 1 where so_kernel cannot stage a slice: grid B·row_tiles·groups
// blocks (b, 32 rows, sub-forests [s0, s1)), 16 warps; warp w walks
// sub-forests s0 + w, s0 + w + 16, … for lane = row, in tree order,
// reading x and the trees through L1.
__global__ void __launch_bounds__(kSoWarps * kWarp)
so_l1_kernel(const float* __restrict__ x, const int* __restrict__ feat,
             const float* __restrict__ thr, const float* __restrict__ leaf,
             float* __restrict__ y, int n, int p, int S, int T, int depth,
             int row_tiles, int groups, int group) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = blockIdx.x % groups;
  const int rest = blockIdx.x / groups;
  const int row = (rest % row_tiles) * kWarp + lane;
  const int b = rest / row_tiles;
  const int s1 = min(S, (g + 1) * group);
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  const float* x_r = x + ((long long)b * n + min(row, n - 1)) * p;
  for (int s = g * group + warp; s < s1; s += kSoWarps) {
    const long long tree0 = ((long long)b * S + s) * T;
    float acc = 0.0f;
    for (int u0 = 0; u0 < T; u0 += kSoChains) {
      const int m = min(kSoChains, T - u0);
      int hb[kSoChains];
      so_walk<false>(hb, feat + (tree0 + u0) * H, thr + (tree0 + u0) * H, m,
                     H, depth, x_r, 1);
      acc = so_add<false>(acc, hb, leaf + (tree0 + u0) * L, m, H, L);
    }
    if (row < n) y[((long long)b * S + s) * n + row] = acc;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool kXShared, bool kForestShared>
cudaError_t launch_route(const float* x, const int* feat, const float* thr,
                         uint16_t* idx, int BS, int n, int p, int S, int T,
                         int t0, int tc, int depth, int npad,
                         cudaStream_t stream) {
  const int H = (1 << depth) - 1;
  const int tile = kForestShared ? kForestBytes / (8 * H) : tc;
  const int row_tiles = (n + kRows - 1) / kRows;
  const size_t smem = (kXShared ? route_x_bytes(p) : 0) +
                      (kForestShared ? (size_t)tile * H * 8 : 0);
  auto kernel = route_kernel<kXShared, kForestShared>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)BS * row_tiles), kRouteWarps * kWarp, smem,
           stream>>>(x, feat, thr, idx, n, p, S, T, t0, tc, depth, npad,
                     row_tiles, tile);
  return cudaGetLastError();
}

template <int NST, bool kStaged>
cudaError_t launch_sum(const float* leaf, const uint16_t* idx, float* y,
                       int BS, int n, int T, int t0, int tc, int depth,
                       int n_out, int npad, int first, cudaStream_t stream) {
  const int row_tiles = (n + kCpRows - 1) / kCpRows;
  const int col_tiles = (n_out + kCols - 1) / kCols;
  const size_t stage = (kStaged ? ((size_t)kCols * 4) << depth : 0) +
                       (size_t)kCpRows * 2;
  const size_t smem = NST * stage;
  auto kernel = sum_kernel<NST, kStaged>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)BS * row_tiles * col_tiles;
  kernel<<<(unsigned)blocks, kCpRows, smem, stream>>>(
      leaf, idx, y, n, T, t0, tc, depth, n_out, npad, row_tiles, col_tiles,
      first, n_out % 4 == 0);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links -lcuda
EncodeTiled encode_tiled() {
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

// The leaves as a 2-D map [rows = B·S·T·L][n_out] f32 with box [L][64]
// (n_out % 4 == 0: rows 16-byte aligned); false if it cannot be made.
bool leaf_map(CUtensorMap* map, const float* leaf, long long rows, int n_out,
              int L) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || rows >= (1LL << 31)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n_out, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_out * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)L};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(leaf), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NST, int W, int MINB>
cudaError_t launch_sum_tma(const CUtensorMap& map, const uint16_t* idx,
                           float* y, int BS, int n, int T, int t0, int tc,
                           int depth, int n_out, int npad, int first,
                           cudaStream_t stream) {
  const int row_tiles = (n + W * kWarp - 1) / (W * kWarp);
  const int col_tiles = (n_out + kCols - 1) / kCols;
  const size_t smem =
      NST * ((((size_t)kCols * 4) << depth) + (size_t)W * kWarp * 2);
  auto kernel = sum_tma_kernel<NST, W, MINB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)BS * row_tiles * col_tiles;
  kernel<<<(unsigned)blocks, (W + 1) * kWarp, smem, stream>>>(
      map, idx, y, n, T, t0, tc, depth, n_out, npad, row_tiles, col_tiles,
      first);
  return cudaGetLastError();
}

// R > 0: so_kernel with the plan (R rows, K rings, TS trees a slice);
// R = 0: so_l1_kernel. The sub-forests are split into groups until the
// launch fills the card twice, keeping at least 16 a block and the same
// number for each of a block's K rings (16 warps for so_l1_kernel).
cudaError_t launch_so(const float* x, const int* feat, const float* thr,
                      const float* leaf, float* y, int B, int S, int n, int p,
                      int T, int depth, int R, int K, int TS,
                      cudaStream_t stream) {
  const int rows = R > 0 ? R : kWarp;
  const int streams = R > 0 ? K : kSoWarps;
  const int row_tiles = (n + rows - 1) / rows;
  int groups = (2 * kSms + B * row_tiles - 1) / (B * row_tiles);
  groups = max(1, min(groups, (S + 15) / 16));
  const int each = ((S + streams - 1) / streams + groups - 1) / groups;
  const int group = each * streams;
  groups = (S + group - 1) / group;
  const unsigned blocks = (unsigned)((long long)B * row_tiles * groups);
  if (R == 0) {
    so_l1_kernel<<<blocks, kSoWarps * kWarp, 0, stream>>>(
        x, feat, thr, leaf, y, n, p, S, T, depth, row_tiles, groups, group);
    return cudaGetLastError();
  }
  const size_t smem = so_bytes(p, R, K, TS, depth);
  if (R % kWarp || K < 1 || TS < 1 || K * (R / kWarp) >= kSoWarps ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const int vec = p % 4 == 0 && (uintptr_t)x % 16 == 0;
  cudaError_t err = allow_smem(so_kernel, smem);
  if (err != cudaSuccess) return err;
  so_kernel<<<blocks, (K * (R / kWarp) + 1) * kWarp, smem, stream>>>(
      x, feat, thr, leaf, y, n, p, S, T, depth, R, K, TS, row_tiles, groups,
      group, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernels on `stream` and returns a cudaError_t as an int (0 =
// launched). out > 1: for each chunk of tc trees, route_kernel writes the
// chunk's leaf indices to `scratch` ([B, S, tc, npad] uint16, npad = n
// rounded up to 8) and sum_kernel adds them to y in tree order. out = 1:
// so_kernel with the wrapper's plan (so_rows rows, so_rings rings, so_trees
// trees a slice), or so_l1_kernel where so_rows is 0; no scratch. Shapes
// are validated by the Python wrapper. Each summing kernel launched adds
// one to sums[0] (sum_tma_kernel) or sums[1] (sum_kernel), so the caller
// learns which path this launcher chose without deciding it again.
int tree_predict_launch(const float* x, const int* feat, const float* thr,
                        const float* leaf, float* y, uint16_t* scratch, int B,
                        int S, int n, int p, int T, int depth, int n_out,
                        int tc, int npad, int so_rows, int so_rings,
                        int so_trees, void* stream_ptr, int* sums) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if (n_out == 1)
    return (int)launch_so(x, feat, thr, leaf, y, B, S, n, p, T, depth,
                          so_rows, so_rings, so_trees, stream);
  const bool x_shared =
      route_x_bytes(p) + kForestBytes <= kMaxSmem;
  const bool forest_shared = 8 * ((1 << depth) - 1) <= kForestBytes;
  CUtensorMap map;
  const bool tma = n_out % 4 == 0 && depth <= 8 &&
                   leaf_map(&map, leaf, (long long)B * S * T << depth, n_out,
                            1 << depth);
  const int run_route = 1, run_sum = 1;
  for (int t0 = 0; t0 < T; t0 += tc) {
    const int tcur = T - t0 < tc ? T - t0 : tc;
    if (run_route) {
      if (x_shared && forest_shared)
        err = launch_route<true, true>(x, feat, thr, scratch, B * S, n, p, S,
                                       T, t0, tcur, depth, npad, stream);
      else if (x_shared)
        err = launch_route<true, false>(x, feat, thr, scratch, B * S, n, p,
                                        S, T, t0, tcur, depth, npad, stream);
      else if (forest_shared)
        err = launch_route<false, true>(x, feat, thr, scratch, B * S, n, p,
                                        S, T, t0, tcur, depth, npad, stream);
      else
        err = launch_route<false, false>(x, feat, thr, scratch, B * S, n, p,
                                         S, T, t0, tcur, depth, npad, stream);
      if (err != cudaSuccess) return (int)err;
    }
    if (run_sum) {
      const int first = t0 == 0;
      if (tma && depth <= 7)
        err = launch_sum_tma<5, kSumWarps, 1>(map, scratch, y, B * S, n, T,
                                              t0, tcur, depth, n_out, npad,
                                              first, stream);
      else if (tma)
        err = launch_sum_tma<3, kSumWarps, 1>(map, scratch, y, B * S, n, T,
                                              t0, tcur, depth, n_out, npad,
                                              first, stream);
      else if (depth <= 7)
        err = launch_sum<5, true>(leaf, scratch, y, B * S, n, T, t0, tcur,
                                  depth, n_out, npad, first, stream);
      else if (depth == 8)
        err = launch_sum<3, true>(leaf, scratch, y, B * S, n, T, t0, tcur,
                                  depth, n_out, npad, first, stream);
      else
        err = launch_sum<4, false>(leaf, scratch, y, B * S, n, T, t0, tcur,
                                   depth, n_out, npad, first, stream);
      if (err != cudaSuccess) return (int)err;
      ++sums[tma ? 0 : 1];
    }
  }
  return 0;
}

const char* tree_predict_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
