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
//  - fp32 runs the SIMT kernel below (fa_kernel<float, D>).
//
// fp32 design. A block has 256 threads as a 16 × 16 grid (ty, tx). Each
// tile of Q (pre-scaled by 1/√d), K and V is staged in shared memory as
// fp32; thread (ty, tx) computes the scores of rows ty + 16i and keys tx +
// 16j (i, j < 4) with scalar FMAs, reduces the row maxima over its 16 lanes
// with shuffles, writes its exp()s to a shared P tile, and then accumulates
// the output columns tx + 16j (j < d/16) of its four rows. Q and K rows are
// padded to d + 1 floats, so the 16 keys a half-warp reads sit in 16
// banks. l stays a per-thread partial sum (alpha is the same for every
// thread of a row) and is reduced once at the end. The heaviest causal
// tiles (the last rows) are launched first.
//
// fp32 bound. At the serving shape of smollm-135m (B = 8, Hq = 9, Hkv = 3,
// S = 2,048, d = 64, causal) the function needs 4·B·Hq·d·pairs = 38.7 G
// operations (pairs = Σ min(i + 1, Skv)): 0.58 ms at 67 TFLOP/s, against
// 101 MB of inputs and output, 0.03 ms at 3.35 TB/s. So operations bound
// it. This kernel runs them as fp32 FMAs on the CUDA cores, with the causal
// half skipped at tile granularity; each score FMA needs half a
// shared-memory load (8 loads per 16 FMAs), so shared-memory bandwidth,
// not the FMA pipe, is its own limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention_bf16.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;    // 16 × 16
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;   // what one block may use

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * (d + 1)      // Q
                          + (size_t)kBK * (d + 1)    // K
                          + (size_t)kBK * d          // V
                          + (size_t)kBQ * (kBK + 1));  // P
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int sq, int skv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][DP]
  float* ks = qs + kBQ * DP;     // [kBK][DP]
  float* vs = ks + kBK * DP;     // [kBK][D]
  float* ps = vs + kBK * D;      // [kBQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long qrow0 = ((long long)b * hq + h) * sq;
  const long long krow0 = ((long long)b * hkv + h / (hq / hkv)) * skv;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = q0 + r;
    qs[r * DP + c] =
        row < sq ? to_float(q[(qrow0 + row) * D + c]) * scale : 0.0f;
  }

  // keys this tile of rows can see
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int kend = causal ? min(skv, last_row + 1) : skv;
  const int n_kt = (kend + kBK - 1) / kBK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the last tile's K, V and P are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int key = k0 + r;
      const bool in = key < skv;
      ks[r * DP + c] = in ? to_float(k[(krow0 + key) * D + c]) : 0.0f;
      vs[r * D + c] = in ? to_float(v[(krow0 + key) * D + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= skv || (causal && key > row)) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      // the row's maximum over the 16 lanes that hold it
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        ls += p;
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      const float denom = fmaxf(lt, 1e-30f);
      T* out = o + (qrow0 + row) * D + tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  // 1/√d rounded once from double, as the JAX package's Python float is
  const float scale = (float)(1.0 / sqrt((double)D));
  fa_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int d, int causal,
             cudaStream_t stream) {
#define FA_LAUNCH(D) \
  return launch<T, D>(q, k, v, o, b, hq, hkv, sq, skv, causal, stream)
  switch (d) {
    case 16: FA_LAUNCH(16);
    case 32: FA_LAUNCH(32);
    case 64: FA_LAUNCH(64);
    case 128: FA_LAUNCH(128);
    case 160: FA_LAUNCH(160);
    case 192: FA_LAUNCH(192);
    case 256: FA_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = launched). `elem_bytes` is 4 for float32 and 2 for bfloat16. Shapes
// are validated by the Python wrapper (Hq a multiple of Hkv >= 1, Sq >= 1,
// Skv >= 1, d in {16, 32, 64, 128, 160, 192, 256}).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int elem_bytes, int b, int hq, int hkv,
                           int sq, int skv, int d, int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1)
    return (int)cudaErrorInvalidValue;
  switch (elem_bytes) {
    case 4:
      return launch_d<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, st);
    case 2:
      return fa_bf16::launch_d(q, k, v, o, b, hq, hkv, sq, skv, d, causal,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
