// B11: the Mamba2 SSD intra-chunk block, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py::ssd_intra_chunk (Pallas kernel
// `_ssd_chunk_kernel`, pallas_call at :64).  For every chunk g and head h:
//
//   y[g,i,h,:]   = sum_{j<=i} (C_i . B_j) exp(a_i - a_j) dt_j x[g,j,h,:]
//   S[g,h,p,n]   = sum_j exp(a_{Q-1} - a_j) dt_j x[g,j,h,p] B[g,j,n]
//
// with x (G, Q, H, P) and y in x's dtype (f32 or bf16), dt and a (the
// inclusive cumsum of the log-decay) (G, Q, H) f32, Bm and Cm (G, Q, N) in
// x's dtype shared by the H heads, S (G, H, P, N) f32.  Everything is
// computed in f32; only y is rounded, as the TPU kernel does.
//
// The TPU kernel holds a whole chunk in VMEM.  The shapes the xLSTM path
// gives (heads folded into G: H = 1, P = N = 384, Q = 64) need
// Q (P + 2N) f32 = 288 KB, more than a block's 227 KB of shared memory, so
// the work is split into three tiled passes, all launched on the caller's
// stream from one entry point:
//   1. scores: the lower-triangular 64 x 64 tiles of C B^T, N streamed in
//      chunks of 32, into an f32 (G, Q, Q) scratch the wrapper allocates;
//   2. y: one block per (g, h, 64 columns of P) builds the masked decay
//      weights W (Q x Q) in shared memory from the scores (the exp is taken
//      only for j <= i: anti-causal exponents are positive and overflow),
//      then W times the x tile;
//   3. states: one block per (g, h, 64 x 64 tile of (P, N)), the Q rows
//      streamed in chunks of 32 (an outer-product sum, K = Q).
// f32 FMAs on the CUDA cores.  Bound at the xLSTM prefill shape (G = 32,
// Q = 64, P = N = 384, bf16): its f32 operations (state 2 Q P N a chunk
// dominates) over 67 TFLOP/s; the bytes (mostly the f32 states) come second.
// Tensor cores, cp.async and TMA are later work.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // output tile edge
constexpr int KC = 32;    // reduction chunk
constexpr int MAX_Q = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 1. scores[g][i][j] = sum_n C[g,i,n] B[g,j,n] on tiles with j0 <= i0.
// grid (G, row tiles, col tiles); thread (tx, ty) owns rows ty + 16 r and
// columns tx + 16 c (r, c < 4).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scores_kernel(const T* __restrict__ Cm, const T* __restrict__ Bm,
                  float* __restrict__ scores, int Q, int N) {
  const int ti = blockIdx.y, tj = blockIdx.z;
  if (tj > ti) return;  // above the diagonal: never read
  const long long g = blockIdx.x;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __shared__ float Cs[TILE][KC + 1];
  __shared__ float Bs[TILE][KC + 1];
  const T* Cg = Cm + g * Q * N;
  const T* Bg = Bm + g * Q * N;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
      const int r = e / KC, k = e % KC, n = n0 + k;
      const int i = i0 + r, j = j0 + r;
      Cs[r][k] = (i < Q && n < N) ? to_f(Cg[(long long)i * N + n]) : 0.f;
      Bs[r][k] = (j < Q && n < N) ? to_f(Bg[(long long)j * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Cs[ty + 16 * r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[tx + 16 * c][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* Sg = scores + g * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < Q) Sg[(long long)i * Q + j] = acc[r][c];
    }
  }
}

// 2. y tile (Q rows x 64 columns of P) of one (g, h).  grid (G H, P tiles).
// Dynamic shared memory: W[Q][Q + 1], X[Q][64], a[Q], dt[Q] (f32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_cum,
             const float* __restrict__ scores, T* __restrict__ y, int Q,
             int H, int P) {
  extern __shared__ float smem[];
  const int ld = Q + 1;
  float* W = smem;             // Q * ld
  float* X = W + Q * ld;       // Q * TILE
  float* as = X + Q * TILE;    // Q
  float* dts = as + Q;         // Q
  const long long gh = blockIdx.x;
  const long long g = gh / H;
  const int h = (int)(gh % H);
  const int p0 = blockIdx.y * TILE;
  for (int j = threadIdx.x; j < Q; j += THREADS) {
    as[j] = a_cum[(g * Q + j) * H + h];
    dts[j] = dt[(g * Q + j) * H + h];
  }
  for (int e = threadIdx.x; e < Q * TILE; e += THREADS) {
    const int j = e / TILE, pp = e % TILE, p = p0 + pp;
    X[j * TILE + pp] =
        p < P ? to_f(x[((g * Q + j) * H + h) * (long long)P + p]) : 0.f;
  }
  __syncthreads();
  const float* Sg = scores + g * Q * Q;
  for (int e = threadIdx.x; e < Q * Q; e += THREADS) {
    const int i = e / Q, j = e % Q;
    // the mask is taken before the exp: exp(a_i - a_j) for j > i overflows
    W[i * ld + j] =
        j <= i ? Sg[(long long)i * Q + j] * expf(as[i] - as[j]) * dts[j]
               : 0.f;
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[MAX_Q / 16][4] = {};
  const int rows = (Q + 15) / 16;
  // row ty + 16 r needs columns j <= ty + 16 r only
  const int jmax = min(Q, ty + 16 * (rows - 1) + 1);
  for (int j = 0; j < jmax; ++j) {
    float xv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) xv[c] = X[j * TILE + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < MAX_Q / 16; ++r) {
      if (r >= rows) break;
      const int i = ty + 16 * r;
      const float w = i < Q ? W[i * ld + j] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(w, xv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_Q / 16; ++r) {
    if (r >= rows) break;
    const int i = ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + tx + 16 * c;
      if (p < P)
        y[((g * Q + i) * H + h) * (long long)P + p] = from_f<T>(acc[r][c]);
    }
  }
}

// 3. state tile (64 of P x 64 of N) of one (g, h): S[p][n] = sum_j wx[j][p]
// B[j][n], wx = x (dt exp(a_{Q-1} - a_j)).  grid (G H, P tiles, N tiles);
// thread (tx, ty) owns p = ty + 16 r and n = tx + 16 c.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_cum, const T* __restrict__ Bm,
                 float* __restrict__ states, int Q, int H, int P, int N) {
  __shared__ float fac[MAX_Q];
  __shared__ float WX[KC][TILE];
  __shared__ float Bs[KC][TILE];
  const long long gh = blockIdx.x;
  const long long g = gh / H;
  const int h = (int)(gh % H);
  const int p0 = blockIdx.y * TILE, n0 = blockIdx.z * TILE;
  const float a_end = a_cum[(g * Q + Q - 1) * H + h];
  for (int j = threadIdx.x; j < Q; j += THREADS) {
    const long long o = (g * Q + j) * H + h;
    fac[j] = dt[o] * expf(a_end - a_cum[o]);
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int q0 = 0; q0 < Q; q0 += KC) {
    for (int e = threadIdx.x; e < KC * TILE; e += THREADS) {
      const int k = e / TILE, c = e % TILE, j = q0 + k;
      const int p = p0 + c, n = n0 + c;
      WX[k][c] = (j < Q && p < P)
                     ? to_f(x[((g * Q + j) * H + h) * (long long)P + p]) *
                           fac[j]
                     : 0.f;
      Bs[k][c] = (j < Q && n < N) ? to_f(Bm[(g * Q + j) * (long long)N + n])
                                  : 0.f;
    }
    __syncthreads();
    const int kend = min(KC, Q - q0);
    for (int k = 0; k < kend; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = WX[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* Sg = states + gh * (long long)P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) Sg[(long long)p * N + n] = acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_cum, const void* Bm,
           const void* Cm, void* y, void* states, void* scores,
           long long G, int Q, int H, int P, int N, cudaStream_t s) {
  const int qt = (Q + TILE - 1) / TILE;
  const int pt = (P + TILE - 1) / TILE;
  const int nt = (N + TILE - 1) / TILE;
  ssd_scores_kernel<T><<<dim3((unsigned)G, qt, qt), THREADS, 0, s>>>(
      static_cast<const T*>(Cm), static_cast<const T*>(Bm),
      static_cast<float*>(scores), Q, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * ((size_t)Q * (Q + 1) + (size_t)Q * TILE + 2 * Q);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_y_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_y_kernel<T><<<dim3((unsigned)(G * H), pt), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_cum), static_cast<const float*>(scores),
      static_cast<T*>(y), Q, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<T><<<dim3((unsigned)(G * H), pt, nt), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_cum), static_cast<const T*>(Bm),
      static_cast<float*>(states), Q, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, Bm, Cm, y).  scores: f32 (G, Q, Q) scratch.
// 1 <= Q <= 128; G H < 2^31; P and N tiles < 65536.
extern "C" int ssd_intra_chunk_fwd(int dtype, const void* x, const void* dt,
                                   const void* a_cum, const void* Bm,
                                   const void* Cm, void* y, void* states,
                                   void* scores, long long G, int Q, int H,
                                   int P, int N, void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_cum, Bm, Cm, y, states, scores, G, Q, H, P,
                         N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_cum, Bm, Cm, y, states, scores, G,
                                 Q, H, P, N, s);
  return (int)cudaErrorInvalidValue;
}
