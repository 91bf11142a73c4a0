// Gossip kernel for Hopper (sm_90a): x' = W X - B U over the agent axis.
//
// Replaces repro/kernels/gossip.py::gossip_update (_gossip_kernel, pallas_call
// at :78).  X and U are (m, n) agent-stacked flattened parameters and
// obfuscated gradients, W and B the (m, m) f32 coupling matrices, m <= 32.
//
// What bounds it on an H100.  Per column it reads m values of X and m of U
// and writes m values of x', doing 4 m^2 float operations: at m = 4 in bf16
// that is 24 B against 64 operations, far below the card's ratio of
// operations to bytes, so device memory bounds it.  The products are too
// thin (m rows) for tensor cores to matter; they run on the float units.
//
// Design.  W and B sit in shared memory for the whole block.  One thread owns
// VEC consecutive columns across all m rows: it loads its X and U columns
// (VEC-wide vector loads, neighbouring threads on neighbouring addresses),
// accumulates sum_j W[i,j] X[j,c] and sum_j B[i,j] U[j,c] in f32 registers,
// and writes x'[i,c] = mixed - desc in X's dtype.  VEC shrinks as m grows so
// the 2 m VEC accumulators stay in registers (M bucket 4/8/16/32 -> VEC
// 8/4/2/1).  Because a thread reads every row of its columns before it writes
// any, x' may be written over X in place; the PDSGD step does that.  The sums
// use fused multiply-adds in ascending j, an order other than the reference's
// dot product, so parity with the plain version is to a tolerance.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) VecT {
  T v[VEC];
};

template <typename T, int M, int VEC>
__global__ void gossip_kernel(const float* __restrict__ W,
                              const float* __restrict__ B, const T* X,
                              const T* __restrict__ U, T* out, int m,
                              int64_t n) {
  __shared__ float w_s[M * M];
  __shared__ float b_s[M * M];
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) {
    const int r = i / M, c = i % M;
    const bool in = r < m && c < m;
    w_s[i] = in ? W[r * m + c] : 0.0f;
    b_s[i] = in ? B[r * m + c] : 0.0f;
  }
  __syncthreads();
  const int64_t nv = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < nv;
       t += stride) {
    float mixed[M][VEC];
    float desc[M][VEC];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mixed[i][v] = 0.0f;
        desc[i][v] = 0.0f;
      }
    }
    // unrolled by 4, not fully: at M = 32 a full unroll hoists all 2 M
    // loads next to the 2 M accumulators and spills
#pragma unroll 4
    for (int j = 0; j < M; ++j) {
      if (j < m) {
        const VecT<T, VEC> xv =
            reinterpret_cast<const VecT<T, VEC>*>(X + (int64_t)j * n)[t];
        const VecT<T, VEC> uv =
            reinterpret_cast<const VecT<T, VEC>*>(U + (int64_t)j * n)[t];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float wij = w_s[i * M + j];
          const float bij = b_s[i * M + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            mixed[i][v] = fmaf(wij, to_f(xv.v[v]), mixed[i][v]);
            desc[i][v] = fmaf(bij, to_f(uv.v[v]), desc[i][v]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        VecT<T, VEC> ov;
#pragma unroll
        for (int v = 0; v < VEC; ++v) from_f(&ov.v[v], mixed[i][v] - desc[i][v]);
        reinterpret_cast<VecT<T, VEC>*>(out + (int64_t)i * n)[t] = ov;
      }
    }
  }
}

template <typename T, int M, int VEC>
int launch(const float* W, const float* B, const void* X, const void* U,
           void* out, int m, int64_t n, cudaStream_t s) {
  if (n % VEC != 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n / VEC + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  gossip_kernel<T, M, VEC><<<(int)blocks, kThreads, 0, s>>>(
      W, B, (const T*)X, (const T*)U, (T*)out, m, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const float* W, const float* B, const void* X, const void* U,
             void* out, int m, int64_t n, cudaStream_t s) {
  if (m <= 4) return launch<T, 4, 8>(W, B, X, U, out, m, n, s);
  if (m <= 8) return launch<T, 8, 4>(W, B, X, U, out, m, n, s);
  if (m <= 16) return launch<T, 16, 2>(W, B, X, U, out, m, n, s);
  if (m <= 32) return launch<T, 32, 1>(W, B, X, U, out, m, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (X, U and out share it).  W, B: (m, m)
// float32, row-major.  X, U, out: (m, n) row-major; out may alias X.
// n must be a multiple of the column vector width (8 covers every m) and the
// rows must be aligned to it; the Python wrapper checks both.
extern "C" int gossip_update(int dtype, const void* W, const void* B,
                             const void* X, const void* U, void* out, int m,
                             long long n, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch<float>((const float*)W, (const float*)B, X, U, out, m, n, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>((const float*)W, (const float*)B, X, U, out,
                                   m, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
