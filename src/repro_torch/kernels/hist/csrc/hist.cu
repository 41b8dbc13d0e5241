// Gradient histograms on Hopper (sm_90a): one launch builds the histograms
// of one tree level for every lane (the SO outputs, or the one MO tree).
//
// Replaces src/repro/kernels/hist/hist_kernel.py::histogram_pallas (body
// _hist_kernel). The TPU kernel turns the scatter-add into a one-hot matmul
// on the MXU, because a TPU has no scatter unit. Here each cell is a plain
// add in shared memory: a one-hot product on the tensor cores would have to
// run in TF32 to be fast, and TF32 would round g to 10 bits of mantissa.
//
//   codes   [n, p]           int8 | int16 | int32  bin of row i, feature j
//   order   [S, n]           i32  lane s's rows, stably sorted by node
//   offsets [S, n_nodes + 1] i32  node k of lane s owns
//                                 order[s, offsets[s, k] : offsets[s, k+1]]
//   g       [S, n, out]      f32
//   w       [n]              f32
//   sum_g   [S, n_nodes, p, n_bins, out]  f32  sum of w_i·g[s, i, :]
//   count   [S, n_nodes, p, n_bins]       f32  sum of w_i
//
// Design. The counts are one more output column whose value is w_i, so a
// lane has out + 1 columns. A block owns one (lane, node) and a tile of FT
// features × CT columns (CT a power of two up to 32, FT·CT threads), and
// walks only that node's rows, in row order, kRows at a time. For each
// chunk it stages the rows' codes and the products g·w in shared memory;
// then thread (f, c), which owns the cells hist[f][b][c] of its feature and
// column for every bin b, reads kGroup rows' codes and values into
// registers and adds each value to the cell of its row's code, while the
// loads of the next chunk are in flight. Two threads never write one cell,
// so there are no atomics, in shared or in global memory. The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version's
// `g * w` and then `index_add_` do on the CPU, and every cell adds its rows
// in row order: the kernel equals the plain CPU version to the bit, and two
// launches on the same inputs give the same bits. Rows with w = 0 add ±0
// to their cells, which changes no sum. Codes outside [0, n_bins), and the
// padding of a chunk past the node's last row, go to a spare bin that is
// never written out. Any n is taken.
//
// Bound. MO level 6 at CaloForest photons width (n = 160,000, p = out =
// 368, 64 bins, 64 nodes, int32 codes) must move 2.70 GB, the output
// 2.22 GB of it: 0.81 ms at 3.35 TB/s, while its 21.7 G adds take 0.32 ms
// at 67 TFLOP/s, so bytes bound it. Level 0 writes 35 MB and is bound by the
// adds. This design stages each g row once per feature tile (p/FT times in
// all, mostly from L2), an SO lane's codes once per lane, and does one
// shared-memory read-modify-write per add; a cell's adds wait on each other
// (the row order that makes the sums exact), so the read-modify-write
// latency of the few warps that fit beside their histograms in shared
// memory bounds it in practice, well above the bound: the simple version
// that is right first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                  // rows staged per chunk
constexpr int kGroup = 16;                 // rows added per register batch
// a feature's staged codes, padded to 80 bytes: 16-byte aligned rows whose
// banks differ between neighbouring features
constexpr int kCodeStride = kRows + 8;
constexpr size_t kMaxSmem = 227 * 1024;    // what one block may use

// threads = FT·CT: 256 for 32 columns, else 128
__host__ __device__ constexpr int tile_feats(int ct) {
  return (ct == 32 ? 256 : 128) / ct;
}

size_t tile_smem(int ft, int ct, int n_bins) {
  return (size_t)ft * (n_bins + 1) * ct * sizeof(float)   // cells + spare bin
         + (size_t)kRows * (2 * sizeof(int)               // rows, twice
                            + ct * sizeof(float))         // values
         + (size_t)ft * kCodeStride * sizeof(uint16_t);   // codes
}

// Stage one chunk in registers: the codes of rows c, c + CT, ... for
// feature j, and the values of rows f, f + FT, ... for column col (g·w, or
// w for the count column `out`). Rows past the node's last (-1), and
// features past p, get the spare bin n_bins and the value 0.
template <typename CodeT, int CT, int FT>
__device__ __forceinline__ void load_chunk(
    const int* rows, const CodeT* __restrict__ codes,
    const float* __restrict__ g_s, const float* __restrict__ w, int p, int j,
    int col, int n_bins, int out, int (&code)[kRows / CT],
    float (&val)[(kRows + FT - 1) / FT]) {
  const int f = threadIdx.x / CT;
  const int c = threadIdx.x % CT;
#pragma unroll
  for (int k = 0; k < kRows / CT; ++k) {
    const int row = rows[c + CT * k];
    int b = n_bins;
    if (row >= 0 && j < p) {
      const int v = (int)__ldg(codes + (long long)row * p + j);
      if (v >= 0 && v < n_bins) b = v;
    }
    code[k] = b;
  }
#pragma unroll
  for (int k = 0; k < (kRows + FT - 1) / FT; ++k) {
    const int row = f + FT * k < kRows ? rows[f + FT * k] : -1;
    float v = 0.0f;
    if (row >= 0 && col <= out) {
      const float wr = __ldg(w + row);
      v = col < out ? __fmul_rn(__ldg(g_s + (long long)row * out + col), wr)
                    : wr;
    }
    val[k] = v;
  }
}

template <typename CodeT, int CT>
__global__ void __launch_bounds__(tile_feats(CT) * CT)
hist_kernel(const CodeT* __restrict__ codes, const int* __restrict__ order,
            const int* __restrict__ offsets, const float* __restrict__ g,
            const float* __restrict__ w, float* __restrict__ sum_g,
            float* __restrict__ count, int n, int p, int out, int n_nodes,
            int n_bins, int col_tiles) {
  constexpr int FT = tile_feats(CT);
  constexpr int kThreads = FT * CT;
  extern __shared__ __align__(16) float smem[];
  const int nb1 = n_bins + 1;                // bin n_bins is the spare one
  float* hist = smem;                        // [FT][nb1][CT]
  float* sval = hist + FT * nb1 * CT;        // [kRows][CT]  g·w, or w
  int* srow = reinterpret_cast<int*>(sval + kRows * CT);     // [2][kRows]
  uint16_t* scode = reinterpret_cast<uint16_t*>(srow + 2 * kRows);
                                             // [FT][kCodeStride]
  const int tid = threadIdx.x;
  const int f = tid / CT;
  const int c = tid % CT;
  const long long lane = blockIdx.z;
  const int node = blockIdx.y;
  const int j0 = (blockIdx.x / col_tiles) * FT;
  const int c0 = (blockIdx.x % col_tiles) * CT;
  const int j = j0 + f;

  for (int e = tid; e < FT * nb1 * CT; e += kThreads) hist[e] = 0.0f;

  const int* off = offsets + lane * (n_nodes + 1);
  const int begin = off[node];
  const int end = off[node + 1];
  const int* ord = order + lane * n;
  const float* g_s = g + lane * n * out;
  float* h = hist + f * nb1 * CT + c;      // cell (f, b, c) is h[b * CT]

  // chunk i's rows sit in srow[i % 2]; while chunk i is added up, the loads
  // of chunk i + 1 are in flight and chunk i + 2's rows are read
  int code[kRows / CT];
  float val[(kRows + FT - 1) / FT];
  int next = -1;
  if (tid < kRows) {
    srow[tid] = begin + tid < end ? __ldg(ord + begin + tid) : -1;
    next = begin + kRows + tid < end ? __ldg(ord + begin + kRows + tid) : -1;
  }
  __syncthreads();
  if (begin < end)
    load_chunk<CodeT, CT, FT>(srow, codes, g_s, w, p, j, c0 + c, n_bins, out,
                              code, val);
  int buf = 0;
  for (int base = begin; base < end; base += kRows, buf ^= 1) {
#pragma unroll
    for (int k = 0; k < kRows / CT; ++k)
      scode[f * kCodeStride + c + CT * k] = code[k];
#pragma unroll
    for (int k = 0; k < (kRows + FT - 1) / FT; ++k)
      if (f + FT * k < kRows) sval[(f + FT * k) * CT + c] = val[k];
    if (tid < kRows) srow[(buf ^ 1) * kRows + tid] = next;
    __syncthreads();
    if (base + kRows < end) {
      load_chunk<CodeT, CT, FT>(srow + (buf ^ 1) * kRows, codes, g_s, w, p, j,
                                c0 + c, n_bins, out, code, val);
      if (tid < kRows) {
        const int i = base + 2 * kRows + tid;
        next = i < end ? __ldg(ord + i) : -1;
      }
    }
    // add, rows in order. The codes and values of kGroup rows go to
    // registers first, so that only the cells' read-modify-writes wait on
    // each other, not the reads of the staging area.
    const uint4* my_codes =
        reinterpret_cast<const uint4*>(scode + f * kCodeStride);
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += kGroup) {
      uint32_t pairs[kGroup / 2];
#pragma unroll
      for (int q = 0; q < kGroup / 8; ++q) {
        const uint4 v = my_codes[(r0 + 8 * q) / 8];
        pairs[4 * q] = v.x;
        pairs[4 * q + 1] = v.y;
        pairs[4 * q + 2] = v.z;
        pairs[4 * q + 3] = v.w;
      }
      float vals[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) vals[r] = sval[(r0 + r) * CT + c];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int b = (pairs[r / 2] >> (16 * (r % 2))) & 0xFFFF;
        float* cell = h + b * CT;
        *cell = __fadd_rn(*cell, vals[r]);
      }
    }
    __syncthreads();   // this chunk's staging area and rows are free again
  }

  // write the tile out, neighbouring threads on neighbouring addresses;
  // column `out` is the count
  const long long sn = lane * n_nodes + node;
  for (int e = tid; e < FT * n_bins * CT; e += kThreads) {
    const int fe = e / (n_bins * CT);
    const int r = e - fe * n_bins * CT;
    const int b = r / CT;
    const int cw = c0 + r % CT;
    if (j0 + fe >= p || cw > out) continue;
    const float v = hist[(fe * nb1 + b) * CT + cw - c0];
    const long long cell = (sn * p + j0 + fe) * n_bins + b;
    if (cw < out)
      sum_g[cell * out + cw] = v;
    else
      count[cell] = v;
  }
}

template <typename CodeT, int CT>
int launch(const void* codes, const int* order, const int* offsets,
           const float* g, const float* w, float* sum_g, float* count, int S,
           int n, int p, int out, int n_nodes, int n_bins,
           cudaStream_t stream) {
  constexpr int FT = tile_feats(CT);
  const size_t smem = tile_smem(FT, CT, n_bins);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<CodeT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (out + 1 + CT - 1) / CT;   // + the count column
  const dim3 grid(((p + FT - 1) / FT) * col_tiles, n_nodes, S);
  hist_kernel<CodeT, CT><<<grid, FT * CT, smem, stream>>>(
      static_cast<const CodeT*>(codes), order, offsets, g, w, sum_g, count,
      n, p, out, n_nodes, n_bins, col_tiles);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_cols(const void* codes, const int* order, const int* offsets,
                const float* g, const float* w, float* sum_g, float* count,
                int S, int n, int p, int out, int n_nodes, int n_bins,
                cudaStream_t stream) {
  // the widest power-of-two column tile that the out + 1 columns fill
  const int cols = out + 1;
#define HIST_LAUNCH(CT)                                                     \
  return launch<CodeT, CT>(codes, order, offsets, g, w, sum_g, count, S, n, \
                           p, out, n_nodes, n_bins, stream)
  if (cols >= 32) HIST_LAUNCH(32);
  if (cols >= 16) HIST_LAUNCH(16);
  if (cols >= 8) HIST_LAUNCH(8);
  if (cols >= 4) HIST_LAUNCH(4);
  HIST_LAUNCH(2);
#undef HIST_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = launched). `code_bytes` (1, 2 or 4) is the width of the codes' type.
// Shapes are validated by the Python wrapper; n_bins is limited by shared
// memory (at least 220 bins fit every tile).
int hist_launch(const void* codes, int code_bytes, const int* order,
                const int* offsets, const float* g, const float* w,
                float* sum_g, float* count, int S, int n, int p, int out,
                int n_nodes, int n_bins, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1:
      return launch_cols<int8_t>(codes, order, offsets, g, w, sum_g, count,
                                 S, n, p, out, n_nodes, n_bins, st);
    case 2:
      return launch_cols<int16_t>(codes, order, offsets, g, w, sum_g, count,
                                  S, n, p, out, n_nodes, n_bins, st);
    case 4:
      return launch_cols<int32_t>(codes, order, offsets, g, w, sum_g, count,
                                  S, n, p, out, n_nodes, n_bins, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
