// Gradient histograms on Hopper (sm_90a): one launch builds the histograms
// of one tree level for every lane (the SO outputs, or the one MO tree).
//
// Replaces src/repro/kernels/hist/hist_kernel.py::histogram_pallas (body
// _hist_kernel). The TPU kernel turns the scatter-add into a one-hot matmul
// on the MXU, because a TPU has no scatter unit. Here each cell is a plain
// add in shared memory: a one-hot product on the tensor cores would do 64x
// the adds, and would not add a cell's rows one after another in row order.
//
// Inputs (ops.launch): codes [n, p] (int8/16/32), g [S, n, out] f32, w [n]
// f32, and the node-ordered layout of each lane's rows (ops.node_layout):
// src [S, L] (the row at each position, -1 for padding) and offsets [S,
// n_nodes + 1] (node k owns positions offsets[k] : offsets[k + 1], from a
// multiple of 32, in whole chunks of 32). Outputs: sum_g [S, n_nodes, p,
// n_bins, out] (sums of w_i·g[s, i, :]) and count [S, n_nodes, p, n_bins]
// (sums of w_i).
//
// Exactness. The counts are one more output column whose value is w_i. A
// thread owns the cells of its (feature, column), for every bin, and adds
// its node's rows to them in row order. Two threads never write one cell,
// so there are no atomics. The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version's
// `g * w` and then `index_add_` do on the CPU: the kernel equals the plain
// CPU version to the bit, and two launches give the same bits. A code
// outside [0, n_bins) and padding go to a spare bin never written out.
//
// Bin windows. A code is one byte in the kernel, and a window's spare bin
// is one more code, so one pass takes at most kByteBins bins. More bins
// are split into contiguous windows [lo, lo + n_bins) (ops.bin_windows):
// one pass each, over the same node layout. A pass narrows a code c to
// c - lo inside its window and to its spare bin outside, and writes its
// cells straight into the full output at bin lo, with a row of bin_stride
// bins. A cell still sums the same rows in the same order.
//
// What bounds it on the H100. At CaloForest photons width (n = 160,000,
// p = out = 368, 64 bins) one level is 21.7 G adds (MO; SO with 368 lanes
// twice that) and must move 2.7 GB (MO level 6; SO 5.2 GB): 0.32 ms of
// fp32 adds at 67 TFLOP/s, 0.81 ms of bytes at 3.35 TB/s. Neither is in
// reach: a cell's adds must run one after another in row order, so each is
// a read-modify-write of a cell in shared memory, and the loop is bound by
// the SM's shared-memory pipe, about one warp-wide access a cycle when 24
// warps keep it busy. The probe (scripts/probe_torch_hist.py, PERF.md)
// found two limits before that one: a thread must never wait on a gather
// it has just issued (74% of PR 12's time), and no warp may keep issuing
// gathers through the load/store pipe while others add, since the adds'
// shared-memory accesses queue behind them (a copying warp issuing
// cp.async slowed the adders 2-2.5x).
//
// Design:
//  * A layout pass per launch (small kernels below) writes each lane's
//    rows in node order: MO, g·w with w as the count column ([S, L, out +
//    1 padded]) and the codes, one byte, transposed ([S, p, L]); SO, g and
//    w ([S, L]) and the codes narrowed to one byte ([n + 1, p padded]).
//  * MO: a block is W warps of one (lane, node) over K W features x 32
//    columns (K = 2, W = 6: two blocks share an SM; at a level of one node,
//    K = 1, W = 12: more blocks for its tail); thread (warp, lane)
//    owns the cells of K features in column lane, and reads a row's value
//    once for its K cells, so a row costs 2K + 1 shared-memory accesses a
//    warp for 32 K adds. Each chunk of 32 rows is two TMA boxes (values,
//    codes by feature) that thread 0 issues into a ring on mbarriers: no
//    thread issues a gather, every warp adds. 16 rows' codes are one load.
//  * SO: a block is one copying warp and 3 adding warps over 384 features
//    of one (lane, node); a lane owns 4 features with both columns (g·w,
//    w) as float2 cells laid out [feature slot][bin][lane], so that a
//    warp's 32 cells fall on separate banks whatever their bins. The
//    copier brings each chunk of 16 rows by TMA (a bulk copy of a row's
//    codes, a box each of g and w) into a ring of 4 stages, handed over by
//    full and empty mbarriers; a row's 4 codes are one 32-bit load. One
//    TMA request a row (~76 cycles each) bounds it.
//  * A block walks only its node's positions: no cell's rows are split
//    between blocks, and rows keep their order.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 768;
constexpr size_t kMaxSmem = 227 * 1024;    // what one block may use
constexpr int kBars = 128;                 // bytes for the mbarriers
constexpr int kByteBins = 255;             // a window's bins: one-byte codes
                                           // with one code to spare
// MO: chunks of 32 rows in a ring of up to 4 (the launch picks)
constexpr int kColsRows = 32, kColsMaxStages = 4;
// SO: chunks of 16 rows in a ring of 4; a lane owns 4 features
constexpr int kFeatsRows = 16, kFeatsStages = 4, kFeatsPerLane = 4;
constexpr int kGroup = 8;                  // SO: rows read into registers
constexpr int kIdsAhead = 4;               // SO: chunks of row ids read
                                           // ahead of their copies

__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// -- copies and barriers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// the generic proxy's reads of a stage are ordered before the TMA's writes
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a TMA box of a 2-D / 3-D tensor map into shared memory, completing on
// the mbarrier at `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
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

// the row of position i of a node's rows, or -1 past its end
__device__ __forceinline__ int row_at(const int* ord, int i, int end) {
  return i < end ? __ldg(ord + i) : -1;
}

// The row ids of the next chunks to copy, read kIdsAhead chunks before
// their copies are issued: lane r % R holds the row of position r of a
// chunk of R rows.
struct RowQueue {
  int q[kIdsAhead];
  const int* ord;
  int at, end, step;
  __device__ RowQueue(const int* ord_, int begin, int end_, int rows,
                      int lane)
      : ord(ord_), at(begin + lane % rows), end(end_), step(rows) {
#pragma unroll
    for (int i = 0; i < kIdsAhead; ++i) {
      q[i] = row_at(ord, at, end);
      at += step;
    }
  }
  __device__ int pop() {
    const int r = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kIdsAhead; ++i) q[i] = q[i + 1];
    q[kIdsAhead - 1] = row_at(ord, at, end);
    at += step;
    return r;
  }
};

// Cells are read and written by inline PTX on 32-bit shared addresses (one
// address add a cell, where C++ pointers cost 64-bit arithmetic). The asm
// statements are volatile and keep the order they are written in: a cell's
// reads and writes stay in row order.
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts2(uint32_t a, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v.x),
               "f"(v.y));
}

// -- the layout passes (one launch each, before the kernel) -------------------

// The layout passes read `src` [S, L]: the row at each position of the
// node-ordered layout, -1 for padding (each node's rows start at a multiple
// of 32; ops.node_layout).

// MO values: vals[s][i][c] = g·w (c < out), w (c = out) or 0 of row
// src[s][i]; 0 for padding. A warp a position.
__global__ void layout_vals_kernel(const int* __restrict__ src,
                                   const float* __restrict__ g,
                                   const float* __restrict__ w,
                                   float* __restrict__ vals, int n, int L,
                                   int out, int out_pad) {
  const int i = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s = blockIdx.y;
  if (i >= L) return;
  float* dst = vals + (s * L + i) * out_pad;
  const int o = __ldg(src + s * L + i);
  if (o < 0) {
    for (int c = lane; c < out_pad; c += kWarp) dst[c] = 0.0f;
    return;
  }
  const float wr = __ldg(w + o);
  const float* grow = g + (s * n + o) * out;
  for (int c = lane; c < out_pad; c += kWarp)
    dst[c] = c < out ? __fmul_rn(__ldg(grow + c), wr) : c == out ? wr : 0.0f;
}

// MO codes, transposed: codes_t[s][j][i] = the code of row src[s][i],
// feature j, less lo, or n_bins where that lies outside [0, n_bins) (the
// window's bins), and for padding. Tiles of 32 x 32 through shared memory.
template <typename InT>
__global__ void layout_codes_kernel(const InT* __restrict__ codes,
                                    const int* __restrict__ src,
                                    uint8_t* __restrict__ codes_t, int L,
                                    int p, int p_pad, int n_bins, int lo) {
  __shared__ uint8_t t[32][33];
  const int i0 = blockIdx.x * 32, j0 = blockIdx.y * 32;
  const long long s = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += blockDim.y) {
    const int i = i0 + r, j = j0 + tx;
    const int o = i < L ? __ldg(src + s * L + i) : -1;
    int v = n_bins;
    if (o >= 0 && j < p) {
      const int c = (int)__ldg(codes + (long long)o * p + j) - lo;
      if (c >= 0 && c < n_bins) v = c;
    }
    t[r][tx] = (uint8_t)v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += blockDim.y) {
    const int j = j0 + r, i = i0 + tx;
    if (j < p_pad && i < L) codes_t[(s * p_pad + j) * L + i] = t[tx][r];
  }
}

// SO g and w: gs[s][i] = g[s][src[s][i]], ws[s][i] = w[src[s][i]]; 0 for
// padding.
__global__ void layout_rows_kernel(const int* __restrict__ src,
                                   const float* __restrict__ g,
                                   const float* __restrict__ w,
                                   float* __restrict__ gs,
                                   float* __restrict__ ws, int n, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long s = blockIdx.y;
  if (i >= L) return;
  const int o = __ldg(src + s * L + i);
  gs[s * L + i] = o < 0 ? 0.0f : __ldg(g + s * n + o);
  ws[s * L + i] = o < 0 ? 0.0f : __ldg(w + o);
}

// -- MO: W warps of K features each, over 32 columns ----------------------------

// Shared memory: mbarriers, hist [nb1][FT][32] f32 (cell (b, f, c), FT = W
// K features), then `stages` stages of values [32 rows][32 columns] f32
// and codes [FT features][32 rows] u8, as the two TMA boxes land.
struct ColsLayout {
  int FT, S, nb1, stage;
  size_t hist;
  __host__ __device__ ColsLayout(int n_bins, int feats, int stages)
      : FT(feats), S(stages), nb1(n_bins + 1),
        stage(round_up(kColsRows * kWarp * 4 + feats * kColsRows, 128)),
        hist((size_t)(n_bins + 1) * feats * kWarp * 4) {}
  __host__ __device__ size_t ring() const { return kBars + hist; }
  __host__ __device__ size_t bytes() const {
    return ring() + (size_t)S * stage;
  }
};

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
hist_cols_kernel(const __grid_constant__ CUtensorMap tm_vals,
                 const __grid_constant__ CUtensorMap tm_codes,
                 const int* __restrict__ offsets, float* __restrict__ sum_g,
                 float* __restrict__ count, int p, int out, int n_nodes,
                 int n_bins, int lo, int bin_stride, int col_tiles, int S) {
  constexpr int R = kColsRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x;
  const int FT = T / kWarp * K;              // the block's features
  const ColsLayout L(n_bins, FT, S);
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int s = blockIdx.z;
  const int node = blockIdx.y;
  const int tile = blockIdx.x / col_tiles;
  const int j0 = tile * FT;
  const int c0 = (blockIdx.x % col_tiles) * kWarp;
  const uint32_t bars = smem_addr(smem);
  float* hist = reinterpret_cast<float*>(smem + kBars);
  auto vals = [&](int st) {
    return reinterpret_cast<float*>(smem + L.ring() + st * L.stage);
  };
  auto codes = [&](int st) {
    return smem + L.ring() + st * L.stage + R * kWarp * 4;
  };

  for (int e = tid; e < (int)(L.hist / 16); e += T)
    reinterpret_cast<float4*>(hist)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int st = 0; st < S; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the node's positions in the layout: whole chunks, from a multiple of 32
  const int* off = offsets + (long long)s * (n_nodes + 1);
  const int begin = off[node];
  const int chunks = (off[node + 1] - begin) / R;
  // chunk k's values and codes, two TMA boxes, by thread 0
  auto issue = [&](int k) {
    if (k < chunks) {
      const int st = k % S;
      const uint32_t bar = bars + 8 * st;
      fence_proxy();
      mbar_expect_tx(bar, R * kWarp * 4 + FT * R);
      tma_3d(vals(st), &tm_vals, bar, c0, begin + k * R, s);
      tma_3d(codes(st), &tm_codes, bar, begin + k * R, j0, s);
    }
  };
  if (tid == 0)
    for (int k = 0; k < S - 1; ++k) issue(k);

  // thread (warp, lane) owns the cells (b, K warp + q, lane), q < K, at
  // cell0[q] + b * bin_step: K features of one column
  uint32_t cell0[K];
#pragma unroll
  for (int q = 0; q < K; ++q)
    cell0[q] = smem_addr(hist + (warp * K + q) * kWarp + lane);
  const int bin_step = FT * kWarp * 4;
  for (int k = 0; k < chunks; ++k) {
    const int st = k % S;
    if (tid == 0) issue(k + S - 1);   // into the stage chunk k - 1 freed
    mbar_wait(bars + 8 * st, (k / S) & 1);
    const float* sv = vals(st);
    const uint4* my_codes = reinterpret_cast<const uint4*>(codes(st) +
                                                           warp * K * R);
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += 16) {
      // 16 rows' codes and values to registers first: only the cells'
      // reads and writes wait on each other. The row's value is read once
      // for its K cells. Padding rows add 0 to the spare bin.
      uint32_t words[K][4];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const uint4 cw = my_codes[q * (R / 16) + r0 / 16];
        words[q][0] = cw.x;
        words[q][1] = cw.y;
        words[q][2] = cw.z;
        words[q][3] = cw.w;
      }
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = sv[(r0 + r) * kWarp + lane];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        uint32_t a[K];
        float cur[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          a[q] = cell0[q] +
                 __byte_perm(words[q][r / 4], 0, 0x4440 | (r % 4)) * bin_step;
          cur[q] = lds(a[q]);
        }
#pragma unroll
        for (int q = 0; q < K; ++q) sts(a[q], __fadd_rn(cur[q], v[r]));
      }
    }
    __syncthreads();   // every warp is done with stage st
  }

  // each warp writes its own cells out, neighbouring lanes on neighbouring
  // columns; column `out` is the count. The window's bins start at bin lo
  // of a row of bin_stride bins.
  const int col = c0 + lane;
  if (col > out) return;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = j0 + warp * K + q;
    if (j >= p) break;
    const long long cell =
        (((long long)s * n_nodes + node) * p + j) * bin_stride + lo;
    for (int b = 0; b < n_bins; ++b) {
      const float v = lds(cell0[q] + b * bin_step);
      if (col < out)
        sum_g[(cell + b) * out + col] = v;
      else
        count[cell + b] = v;
    }
  }
}

// -- SO (out = 1): a copying warp, W adding warps of 128 features ---------------

// Shared memory: mbarriers, hist [W][4][nb1][32 lanes] float2 (cell (g·w,
// w) of slot k of a lane at bin b), then kFeatsStages stages of g [16] f32
// (128 bytes), w [16] f32 (128 bytes) and codes [16][128 W] u8.
struct FeatsLayout {
  int W, nb1, row_bytes, stage;
  size_t hist;
  __host__ __device__ FeatsLayout(int n_bins, int warps)
      : W(warps), nb1(n_bins + 1), row_bytes(kWarp * kFeatsPerLane * warps),
        stage(round_up(256 + kFeatsRows * kWarp * kFeatsPerLane * warps,
                       128)),
        hist((size_t)warps * kFeatsPerLane * (n_bins + 1) * kWarp * 8) {}
  __host__ __device__ size_t ring() const { return kBars + hist; }
  __host__ __device__ size_t bytes() const {
    return ring() + (size_t)kFeatsStages * stage;
  }
};

__global__ void __launch_bounds__(kMaxThreads)
hist_feats_kernel(const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_w,
                  const uint8_t* __restrict__ codes, int code_stride,
                  const int* __restrict__ src,
                  const int* __restrict__ offsets,
                  float* __restrict__ sum_g, float* __restrict__ count,
                  int n, int len, int p, int n_nodes, int n_bins, int lo,
                  int bin_stride, int vec_out) {
  constexpr int R = kFeatsRows, S = kFeatsStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x;
  const int W = T / kWarp - 1;               // adding warps; the last copies
  const FeatsLayout L(n_bins, W);
  const int FT = L.row_bytes;                // the block's features
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int s = blockIdx.z;
  const int node = blockIdx.y;
  const int j0 = blockIdx.x * FT;
  const uint32_t bars = smem_addr(smem);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (S + st); };
  float2* hist = reinterpret_cast<float2*>(smem + kBars);
  auto stage_g = [&](int st) {               // g [16], then w [16] at +32
    return reinterpret_cast<float*>(smem + L.ring() + st * L.stage);
  };
  auto stage_c = [&](int st) {
    return smem + L.ring() + st * L.stage + 256;
  };

  for (int e = tid; e < (int)(L.hist / 16); e += T)
    reinterpret_cast<float4*>(hist)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the node's positions in the layout: whole chunks, from a multiple of 32
  const int* off = offsets + (long long)s * (n_nodes + 1);
  const int begin = off[node];
  const int end = off[node + 1];
  const int chunks = (end - begin) / R;

  if (warp == W) {
    // the copier: each chunk's codes, one bulk copy a row (padding rows
    // copy row n, all spare), and its g and w, one TMA box each, up to S
    // chunks ahead of the adders
    RowQueue ids(src + (long long)s * len, begin, end, R, lane);
    for (int k = 0; k < chunks; ++k) {
      const int st = k % S;
      if (k >= S) mbar_wait(empty(st), (k / S - 1) & 1);
      const int row = ids.pop();
      if (lane == 0) {
        fence_proxy();
        mbar_expect_tx(full(st), R * FT + 2 * R * 4);
        tma_2d(stage_g(st), &tm_g, full(st), begin + k * R, s);
        tma_2d(stage_g(st) + 32, &tm_w, full(st), begin + k * R, s);
      }
      __syncwarp();
      if (lane < R)
        bulk_copy(stage_c(st) + lane * FT,
                  codes + (long long)(row < 0 ? n : row) * code_stride + j0,
                  FT, full(st));
    }
  } else {
    // an adding warp: lane owns features j0 + 4 (32 warp + lane) + k, their
    // cell (slot k, bin b) at cell_k[k] + b * 256
    uint32_t cell_k[kFeatsPerLane];
#pragma unroll
    for (int k = 0; k < kFeatsPerLane; ++k)
      cell_k[k] = smem_addr(hist +
                            ((warp * kFeatsPerLane + k) * L.nb1) * kWarp +
                            lane);
    const int cfirst = (warp * kWarp + lane) * kFeatsPerLane;
    for (int k = 0; k < chunks; ++k) {
      const int st = k % S;
      mbar_wait(full(st), (k / S) & 1);
      const unsigned char* sc = stage_c(st);
      const float* sg = stage_g(st);
#pragma unroll 1
      for (int r0 = 0; r0 < R; r0 += kGroup) {
        // kGroup rows' codes and values to registers first
        uint32_t words[kGroup];
        float2 val[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          words[r] = *reinterpret_cast<const uint32_t*>(sc + (r0 + r) * FT +
                                                        cfirst);
          const float wr = sg[32 + r0 + r];
          val[r] = make_float2(__fmul_rn(sg[r0 + r], wr), wr);
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          uint32_t a[kFeatsPerLane];
          float2 cur[kFeatsPerLane];
#pragma unroll
          for (int q = 0; q < kFeatsPerLane; ++q)
            a[q] = cell_k[q] + __byte_perm(words[r], 0, 0x4440 | q) * 256;
#pragma unroll
          for (int q = 0; q < kFeatsPerLane; ++q) cur[q] = lds2(a[q]);
#pragma unroll
          for (int q = 0; q < kFeatsPerLane; ++q)
            sts2(a[q], make_float2(__fadd_rn(cur[q].x, val[r].x),
                                   __fadd_rn(cur[q].y, val[r].y)));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }
  __syncthreads();   // every cell is final
  if (warp == W) return;

  // write out: each lane its features' runs of n_bins cells, from bin lo
  // of a row of bin_stride bins, 4 at a time where the bins allow
  const long long sn = (long long)s * n_nodes + node;
  for (int k = 0; k < kFeatsPerLane; ++k) {
    const int j = j0 + (warp * kWarp + lane) * kFeatsPerLane + k;
    if (j >= p) break;
    const uint32_t h =
        smem_addr(hist + ((warp * kFeatsPerLane + k) * L.nb1) * kWarp + lane);
    const long long cell0 = (sn * p + j) * bin_stride + lo;
    if (vec_out) {
      for (int b = 0; b < n_bins; b += 4) {
        float2 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = lds2(h + (b + i) * 256);
        *reinterpret_cast<float4*>(sum_g + cell0 + b) =
            make_float4(a[0].x, a[1].x, a[2].x, a[3].x);
        *reinterpret_cast<float4*>(count + cell0 + b) =
            make_float4(a[0].y, a[1].y, a[2].y, a[3].y);
      }
    } else {
      for (int b = 0; b < n_bins; ++b) {
        const float2 a = lds2(h + b * 256);
        sum_g[cell0 + b] = a.x;
        count[cell0 + b] = a.y;
      }
    }
  }
}

// -- the narrowing pass -------------------------------------------------------

// o[i, t * tile + q] = code (i, t * feats + q) less lo for q < feats,
// j < p, that in [0, n_bins) (the window's bins); else n_bins, and all of
// row n (the spare row that padding positions copy). Grid: x over a row's
// stride, y over rows
template <typename InT>
__global__ void narrow_kernel(const InT* __restrict__ in,
                              uint8_t* __restrict__ o, int n, int p,
                              int feats, int tile, int stride, int n_bins,
                              int lo) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= stride) return;
  const int q = x % tile;
  const int j = (x / tile) * feats + q;
  const bool real = q < feats && j < p;
  for (int i = blockIdx.y; i <= n; i += gridDim.y) {
    int v = n_bins;
    if (real && i < n) {
      const int c = (int)__ldg(in + (long long)i * p + j) - lo;
      if (c >= 0 && c < n_bins) v = c;
    }
    o[(long long)i * stride + x] = (uint8_t)v;
  }
}

template <typename InT>
int narrow_from(const void* in, void* o, int n, int p, int feats, int tile,
                int stride, int n_bins, int lo, cudaStream_t st) {
  if (stride == 0) return 0;
  const int threads = 128;
  const dim3 blocks((stride + threads - 1) / threads, n < 8192 ? n + 1 : 8192);
  narrow_kernel<InT><<<blocks, threads, 0, st>>>(
      static_cast<const InT*>(in), static_cast<uint8_t*>(o), n, p, feats,
      tile, stride, n_bins, lo);
  return (int)cudaGetLastError();
}

// -- host side ----------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// A map over a row-major tensor of `rank` dims (innermost first, strides in
// bytes between consecutive indices of dims 1, 2) with box `box`; reads
// outside the tensor fill zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
              const void* base, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Writes codes [n, p] (code_bytes 1, 2 or 4, signed) as u8 [n + 1, stride]
// in tiles: feature t * feats + q at column t * tile + q; each code less
// lo, or n_bins (the window's spare bin) where that lies outside [0,
// n_bins), in the padding and in all of row n. Returns a cudaError_t as an
// int.
int hist_narrow(const void* codes, int code_bytes, void* out, int n, int p,
                int feats, int tile, int stride, int n_bins, int lo,
                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (feats < 1 || tile < feats || n_bins < 1 || n_bins > kByteBins ||
      lo < 0)
    return (int)cudaErrorInvalidValue;
  switch (code_bytes) {
    case 1: return narrow_from<int8_t>(codes, out, n, p, feats, tile, stride,
                                       n_bins, lo, st);
    case 2: return narrow_from<int16_t>(codes, out, n, p, feats, tile,
                                        stride, n_bins, lo, st);
    case 4: return narrow_from<int32_t>(codes, out, n, p, feats, tile,
                                        stride, n_bins, lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// MO: the layout pass and the kernel. `src` [S, L] (L a multiple of 32)
// gives the row at each position of the node-ordered layout, -1 for
// padding, and `offsets` [S, n_nodes + 1] each node's positions (from a
// multiple of 32, in whole chunks of 32; ops.node_layout). Writes vals
// [S, L, out_pad] f32 (g·w, then w, then 0) and codes_t [S, p_pad, L] u8
// (the codes of the window [lo, lo + n_bins), transposed), then launches
// blocks of `warps` warps of `per` (1 or 2) features each, with a ring of
// `stages` (2-4) chunks, writing bins lo ... of sum_g and count, whose
// rows hold bin_stride bins. `layout_vals` 0 keeps vals as an earlier
// window's pass wrote them. Returns a cudaError_t as an int.
int hist_launch_cols(const void* codes, int code_bytes, const int* src,
                     const int* offsets, const float* g, const float* w,
                     float* vals, uint8_t* codes_t, float* sum_g,
                     float* count, int S, int n, int L, int p, int p_pad,
                     int out, int out_pad, int n_nodes, int n_bins, int lo,
                     int bin_stride, int layout_vals, int warps, int per,
                     int stages, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int feats = warps * per;
  const ColsLayout Lay(n_bins, feats, stages);
  const int tiles = (p + feats - 1) / feats;
  if (warps < 1 || warps * kWarp > kMaxThreads || n_bins < 1 ||
      n_bins > kByteBins || lo < 0 || lo + n_bins > bin_stride ||
      (per != 1 && per != 2) || feats > 256 || stages < 2 ||
      stages > kColsMaxStages || L % kColsRows || out_pad % 4 ||
      out_pad <= out || p_pad < tiles * feats || Lay.bytes() > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (L > 0) {
    if (layout_vals)
      layout_vals_kernel<<<dim3((L + 7) / 8, S), 256, 0, st>>>(
          src, g, w, vals, n, L, out, out_pad);
    const dim3 grid((L + 31) / 32, (p_pad + 31) / 32, S);
    const dim3 block(32, 8);
    switch (code_bytes) {
      case 1:
        layout_codes_kernel<int8_t><<<grid, block, 0, st>>>(
            static_cast<const int8_t*>(codes), src, codes_t, L, p, p_pad,
            n_bins, lo);
        break;
      case 2:
        layout_codes_kernel<int16_t><<<grid, block, 0, st>>>(
            static_cast<const int16_t*>(codes), src, codes_t, L, p, p_pad,
            n_bins, lo);
        break;
      case 4:
        layout_codes_kernel<int32_t><<<grid, block, 0, st>>>(
            static_cast<const int32_t*>(codes), src, codes_t, L, p, p_pad,
            n_bins, lo);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  CUtensorMap tm_vals, tm_codes;
  const cuuint64_t vdims[3] = {(cuuint64_t)out_pad, (cuuint64_t)L,
                               (cuuint64_t)S};
  const cuuint64_t vstrides[2] = {(cuuint64_t)out_pad * 4,
                                  (cuuint64_t)out_pad * 4 * L};
  const cuuint32_t vbox[3] = {kWarp, kColsRows, 1};
  const cuuint64_t cdims[3] = {(cuuint64_t)L, (cuuint64_t)p_pad,
                               (cuuint64_t)S};
  const cuuint64_t cstrides[2] = {(cuuint64_t)L, (cuuint64_t)L * p_pad};
  const cuuint32_t cbox[3] = {kColsRows, (cuuint32_t)feats, 1};
  if (L > 0 &&
      (!make_map(&tm_vals, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, vals, vdims,
                 vstrides, vbox) ||
       !make_map(&tm_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, codes_t, cdims,
                 cstrides, cbox)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = per == 2 ? hist_cols_kernel<2> : hist_cols_kernel<1>;
  int err = set_smem(kernel, Lay.bytes());
  if (err) return err;
  const int col_tiles = (out + 1 + kWarp - 1) / kWarp;
  kernel<<<dim3(tiles * col_tiles, n_nodes, S), warps * kWarp, Lay.bytes(),
           st>>>(tm_vals, tm_codes, offsets, sum_g, count, p, out, n_nodes,
                 n_bins, lo, bin_stride, col_tiles, stages);
  return (int)cudaGetLastError();
}

// SO (out = 1): the layout pass of g and w and the kernel, over the same
// node-ordered layout (`src`, `offsets`). Writes gs, ws [S, L] f32 (g and
// w, 0 for padding; `layout_rows` 0 keeps them as an earlier window's pass
// wrote them), then launches `warps` adding warps and one copying warp a
// block over them and the codes of the window [lo, lo + n_bins) from
// hist_narrow (n + 1 rows of code_stride, row n all spare), writing bins
// lo ... of sum_g and count, whose rows hold bin_stride bins. Returns a
// cudaError_t as an int.
int hist_launch_feats(const void* codes, int code_stride, const int* src,
                      const int* offsets, const float* g, const float* w,
                      float* gs, float* ws, float* sum_g, float* count, int S,
                      int n, int L, int p, int n_nodes, int n_bins, int lo,
                      int bin_stride, int layout_rows, int warps,
                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const FeatsLayout Lay(n_bins, warps);
  const int tiles = (p + Lay.row_bytes - 1) / Lay.row_bytes;
  if (warps < 1 || (warps + 1) * kWarp > kMaxThreads || n_bins < 1 ||
      n_bins > kByteBins || lo < 0 || lo + n_bins > bin_stride ||
      L % kColsRows || code_stride % 16 ||
      code_stride < tiles * Lay.row_bytes || Lay.bytes() > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_g, tm_w;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)S};
  const cuuint64_t strides[1] = {(cuuint64_t)L * 4};
  const cuuint32_t box[2] = {kFeatsRows, 1};
  if (L > 0) {
    if (layout_rows)
      layout_rows_kernel<<<dim3((L + 255) / 256, S), 256, 0, st>>>(
          src, g, w, gs, ws, n, L);
    if (!make_map(&tm_g, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, gs, dims,
                  strides, box) ||
        !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ws, dims,
                  strides, box))
      return (int)cudaErrorInvalidValue;
  }
  int err = set_smem(hist_feats_kernel, Lay.bytes());
  if (err) return err;
  const int vec_out = n_bins % 4 == 0 && lo % 4 == 0 &&
                      bin_stride % 4 == 0 && ((uintptr_t)sum_g % 16) == 0 &&
                      ((uintptr_t)count % 16) == 0;
  hist_feats_kernel<<<dim3(tiles, n_nodes, S), (warps + 1) * kWarp,
                      Lay.bytes(), st>>>(
      tm_g, tm_w, static_cast<const uint8_t*>(codes), code_stride, src,
      offsets, sum_g, count, n, L, p, n_nodes, n_bins, lo, bin_stride,
      vec_out);
  return (int)cudaGetLastError();
}

const char* hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
