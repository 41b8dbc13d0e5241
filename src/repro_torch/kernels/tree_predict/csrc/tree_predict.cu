// Packed-forest inference on Hopper (sm_90a): one launch evaluates every
// forest of one solver step, for all classes and sub-forests at once.
//
// Replaces src/repro/kernels/tree_predict/tree_kernel.py::forest_predict_pallas
// (body _predict_kernel). The TPU kernel selects feature values and
// thresholds with one-hot matmuls, because a TPU has no cheap gather, and so
// clips the +inf "never go right" sentinels to 1e30. Here a thread loads
// x[b, row, feat[h]] and thr[h] directly and compares them strictly, with no
// clip.
//
//   x    [B, n, p]            f32   rows of class b
//   feat [B, S, T, H]         i32   heap order, H = 2^depth - 1
//   thr  [B, S, T, H]         f32   +inf = never go right
//   leaf [B, S, T, L, out]    f32   L = 2^depth <= 256
//   y    [B, S, n, out]       f32   y[b,s,i,:] = sum_t leaf[b,s,t,node_t(i),:]
//
// Bound by memory. Each input is read once and the output written once at
// best: 4·(B·n·p + 2·B·S·T·H + B·S·T·L·out + B·S·n·out) bytes, about 410 MB
// for the CaloForest photons step (B=15, S=1, T=20, depth 7, p=out=368,
// n=8000), or 0.12 ms at 3.35 TB/s. The design aims at being right and
// deterministic first:
//
//   grid  (ceil(n / ROWS), S, B); a block takes ROWS rows of one (b, s).
//   phase 1: the block routes its (row, tree) pairs through `depth` levels
//            and keeps the leaf index of each as a uint8 in shared memory.
//   phase 2: the block sweeps (row, column) pairs with neighbouring threads
//            on neighbouring columns, so leaf rows are read and outputs
//            written coalesced, and sums leaf[t, idx, c] over t = 0 … T-1 in
//            order, in fp32 — the order of the plain version, so the two
//            agree to the bit and every run gives the same result.
//
// The ragged row edge is masked, not padded. The kernel allocates nothing
// and does not synchronise; the launch runs on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // rows per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
tree_predict_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                    const float* __restrict__ thr,
                    const float* __restrict__ leaf, float* __restrict__ y,
                    int n, int p, int S, int T, int depth, int n_out) {
  extern __shared__ uint8_t leaf_idx[];  // [T][kRows]
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  const long long bs = (long long)b * S + s;
  const int* feat_bs = feat + bs * T * H;
  const float* thr_bs = thr + bs * T * H;
  const float* leaf_bs = leaf + bs * T * (long long)L * n_out;
  const float* x_blk = x + ((long long)b * n + row0) * p;
  float* y_blk = y + (bs * n + row0) * n_out;

  // phase 1: route each (row, tree) pair; neighbouring threads share a tree
  for (int i = threadIdx.x; i < kRows * T; i += kThreads) {
    const int t = i / kRows;
    const int r = i - t * kRows;
    if (r >= rows) continue;
    const float* xr = x_blk + (long long)r * p;
    const int* f_t = feat_bs + t * H;
    const float* thr_t = thr_bs + t * H;
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int h = node + (1 << level) - 1;
      node = 2 * node + (__ldg(xr + __ldg(f_t + h)) > __ldg(thr_t + h));
    }
    leaf_idx[t * kRows + r] = (uint8_t)node;
  }
  __syncthreads();

  // phase 2: sum the leaves tree by tree, in order
  const int total = rows * n_out;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / n_out;
    const int c = i - r * n_out;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      const int node = leaf_idx[t * kRows + r];
      acc += __ldg(leaf_bs + ((long long)t * L + node) * n_out + c);
    }
    y_blk[(long long)r * n_out + c] = acc;
  }
}

}  // namespace

extern "C" {

// Rows handled by one block; the wrapper needs it for the shared-memory
// budget (T·kRows bytes).
int tree_predict_rows_per_block() { return kRows; }

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched). Shapes are validated by the Python wrapper.
int tree_predict_launch(const float* x, const int* feat, const float* thr,
                        const float* leaf, float* y, int B, int S, int n,
                        int p, int T, int depth, int n_out, void* stream) {
  const dim3 grid((n + kRows - 1) / kRows, S, B);
  const size_t smem = (size_t)T * kRows;
  tree_predict_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, feat, thr, leaf, y, n, p, S, T, depth, n_out);
  return (int)cudaGetLastError();
}

const char* tree_predict_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
