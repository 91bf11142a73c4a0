// Gossip kernels for Hopper (sm_90a): x' = W X - B U over the agent axis, and
// its time-varying and fault-tolerant variants.
//
// Replaces, in repro/kernels/gossip.py:
//   gossip_update              <- gossip_update (_gossip_kernel, pallas_call
//                                 at :78); W is an input.
//   masked_gossip_update       <- masked_gossip_update (_masked_gossip_kernel,
//                                 pallas_call at :151): W_k is computed on
//                                 chip from the step's (m, m) edge mask.
//   masked_gossip_update_krng  <- masked_gossip_update_krng
//                                 (_masked_gossip_krng_kernel, pallas_call at
//                                 :228): the edge mask is drawn in-kernel too.
//   guarded_gossip_update      <- guarded_gossip_update
//                                 (_guarded_gossip_kernel, pallas_call at
//                                 :316): every off-diagonal link is passed
//                                 through a finite guard before the sum.
// X and U are (m, n) agent-stacked flattened parameters and obfuscated
// gradients, B (and W) the (m, m) f32 coupling matrices, m <= 32.
//
// What bounds them on an H100.  Per column each reads m values of X and m of
// U and writes m values of x', doing about 4 m^2 float operations (the
// guarded one about 7 m^2): at m = 4 in bf16 that is 24 B against 64-112
// operations, far below the card's ratio of operations to bytes, so device
// memory bounds all four.  The products are too thin (m rows) for tensor
// cores to matter; they run on the float units.
//
// Design.  The (m, m) matrices sit in shared memory for the whole block.  One
// thread owns VEC consecutive columns across all m rows: it loads its X and U
// columns (VEC-wide vector loads, neighbouring threads on neighbouring
// addresses), accumulates in f32 registers, and writes x' in X's dtype.  VEC
// shrinks as m grows so the 2 m VEC accumulators stay in registers (M bucket
// 4/8/16/32 -> VEC 8/4/2/1).  Because a thread reads every row of its columns
// before it writes any, x' may be written over X in place; the PDSGD step
// does that.  The W X - B U sums use fused multiply-adds in ascending j, an
// order other than the reference's dot product, so parity with the plain
// version is to a tolerance.
//
// Masked weights.  Each block turns the mask into W_k in shared memory:
// deg_i = sum_j mask_ij (integers, exact), w_ij = mask_ij / (1 + max(deg_i,
// deg_j)) with a correctly rounded division (__fdiv_rn), w_ii = 1 - sum_j
// w_ij with the row summed in ascending j by __fadd_rn.  That is the plain
// version's order and rounding (kernels/ref.py::metropolis_ref), so W_k is
// bitwise the plain version's; nvcc may neither contract nor reorder
// these.  The work is m^2 per block, nothing next to the columns.
//
// In-kernel mask.  The TPU kernel seeds the TPU's generator without the
// program id, so every tile redraws one mask from a stream no other device
// reproduces.  Here every block runs threefry2x32 (threefry.cuh) over the m^2
// counters of jax.random.bits(key, (m, m)) and applies the mantissa trick
// (bits >> 9 | 0x3F800000, minus 1): one U[0, 1) per undirected edge (strict
// upper triangle, mirrored), kept if u < keep_prob and adj says the edge
// exists.  With the key fold_in(key(mix_seed), step) that is
// core/mixing.py's MixingProcess.realize(step) mask bit for bit.  Each block
// draws the same m^2 words (cheap); block 0 writes the mask out.
//
// Guarded gossip.  x'_i = (w_ii x_i - b_ii u_i) + sum_j guard(w_ij xt_j -
// b_ij ut_j), the sum over every j (the zero diagonal and non-neighbours
// too, as in the reference: with no guard, 0 * nan reaches every receiver),
// guard(v) = isfinite(v) ? clamp(v, -clip, clip) : 0 (isfinite first: a clamp
// would pass nan on).  The transmit values xt, ut are formed in registers
// from the clean x, u and the (m,) corrupt vector: nan, +inf, or x * scale
// rounded to X's dtype (the reference poisons in the buffer's dtype: in bf16
// scale 1e4 is 9984 and the product is rounded to bf16 before the f32 sum).
// So the kernel moves the bytes of plain gossip; staging XT and UT would add
// two (m, n) buffers and 2 m n reads.  The staged form (XT, UT inputs) is
// kept for the tests.  Products and differences are __fmul_rn/__fsub_rn,
// each rounded once as in the plain version; only the sum's order differs.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "threefry.cuh"

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
// v rounded to T and back (the value a T buffer would hold)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) VecT {
  T v[VEC];
};

// Where a kernel's (m, m) mixing weights come from.
enum WeightSource { kWeightsGiven = 0, kMaskGiven = 1, kMaskDrawn = 2 };

struct MaskDraw {
  uint32_t k0, k1;      // threefry key of the step's mask
  float keep_prob;      // per-edge keep probability
  const float* adj;     // (m, m) off-diagonal 0/1 gate
  float* mask_out;      // (m, m), written by block 0
};

// src (m, m) row-major -> dst (M, M) zero-padded.  No sync.
template <int M>
__device__ __forceinline__ void load_padded(const float* src, float* dst,
                                            int m) {
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) {
    const int r = i / M, c = i % M;
    dst[i] = (r < m && c < m) ? src[r * m + c] : 0.0f;
  }
}

// The symmetric edge mask of jax.random.bits(key, (m, m)) into mask_s (M, M)
// zero-padded.  No sync.
template <int M>
__device__ __forceinline__ void draw_mask(const MaskDraw& d, float* mask_s,
                                          int m) {
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) {
    const int r = i / M, c = i % M;
    float v = 0.0f;
    if (r < m && c < m && r != c) {
      // the upper-triangle draw of the edge {r, c}
      const uint32_t ctr = (uint32_t)(min(r, c) * m + max(r, c));
      const uint32_t bits = threefry_bits(d.k0, d.k1, 0u, ctr);
      const float u =
          __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
      v = __fmul_rn(u < d.keep_prob ? 1.0f : 0.0f, d.adj[r * m + c]);
    }
    mask_s[i] = v;
  }
}

// mask (M, M) in shared memory -> Metropolis weights, in place.  Starts and
// ends with a sync.
template <int M>
__device__ __forceinline__ void metropolis(float* w_s, float* deg_s, int m) {
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    float d = 0.0f;
    for (int j = 0; j < M; ++j) d += w_s[i * M + j];  // 0/1: exact
    deg_s[i] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) {
    const int r = i / M, c = i % M;
    w_s[i] = __fdiv_rn(w_s[i], 1.0f + fmaxf(deg_s[r], deg_s[c]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    float s = w_s[i * M];
    for (int j = 1; j < m; ++j) s = __fadd_rn(s, w_s[i * M + j]);
    w_s[i * M + i] = __fadd_rn(w_s[i * M + i], __fsub_rn(1.0f, s));
  }
  __syncthreads();
}

template <typename T, int M, int VEC, int SRC>
__global__ void gossip_kernel(const float* __restrict__ wm,
                              const float* __restrict__ B, const T* X,
                              const T* __restrict__ U, T* out, int m,
                              int64_t n, MaskDraw draw) {
  __shared__ float w_s[M * M];
  __shared__ float b_s[M * M];
  __shared__ float deg_s[M];
  if (SRC == kMaskDrawn) {
    draw_mask<M>(draw, w_s, m);
  } else {
    load_padded<M>(wm, w_s, m);
  }
  load_padded<M>(B, b_s, m);
  if (SRC == kMaskDrawn && blockIdx.x == 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
      draw.mask_out[i] = w_s[(i / m) * M + i % m];
    }
  }
  if (SRC == kWeightsGiven) {
    __syncthreads();
  } else {
    metropolis<M>(w_s, deg_s, m);
  }
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

// What a corrupt sender transmits in place of x: mode 0 nan, 1 +inf, 2 x *
// scale rounded to T (scale is already a T value).
template <typename T>
__device__ __forceinline__ float poison(float x, int mode, float scale) {
  if (mode == 0) return __int_as_float(0x7fc00000);
  if (mode == 1) return __int_as_float(0x7f800000);
  return round_to(__fmul_rn(x, scale), (const T*)nullptr);
}

struct Guard {
  const float* corrupt;  // (m,) 0/1, or null: nobody is corrupt
  int mode;
  float scale;
  float clip;
  int use_clip;          // 0: no guard, raw transmits reach the sum
};

template <typename T, int M, int VEC, bool STAGED>
__global__ void guarded_kernel(const float* __restrict__ mask,
                               const float* __restrict__ B, const T* X,
                               const T* U, const T* __restrict__ XT,
                               const T* __restrict__ UT, T* out, int m,
                               int64_t n, Guard g) {
  __shared__ float w_s[M * M];
  __shared__ float b_s[M * M];
  __shared__ float deg_s[M];
  __shared__ float bad_s[M];
  load_padded<M>(mask, w_s, m);
  load_padded<M>(B, b_s, m);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    bad_s[i] = (!STAGED && g.corrupt != nullptr && i < m) ? g.corrupt[i] : 0.0f;
  }
  metropolis<M>(w_s, deg_s, m);
  const int64_t nv = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < nv;
       t += stride) {
    float self[M][VEC];
    float acc[M][VEC];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        self[i][v] = 0.0f;
        acc[i][v] = 0.0f;
      }
    }
#pragma unroll 4
    for (int j = 0; j < M; ++j) {
      if (j < m) {
        const VecT<T, VEC> xv =
            reinterpret_cast<const VecT<T, VEC>*>(X + (int64_t)j * n)[t];
        const VecT<T, VEC> uv =
            reinterpret_cast<const VecT<T, VEC>*>(U + (int64_t)j * n)[t];
        float x[VEC], u[VEC], xt[VEC], ut[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          x[v] = to_f(xv.v[v]);
          u[v] = to_f(uv.v[v]);
        }
        if (STAGED) {
          const VecT<T, VEC> xtv =
              reinterpret_cast<const VecT<T, VEC>*>(XT + (int64_t)j * n)[t];
          const VecT<T, VEC> utv =
              reinterpret_cast<const VecT<T, VEC>*>(UT + (int64_t)j * n)[t];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            xt[v] = to_f(xtv.v[v]);
            ut[v] = to_f(utv.v[v]);
          }
        } else {
          const bool bad = bad_s[j] > 0.0f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            xt[v] = bad ? poison<T>(x[v], g.mode, g.scale) : x[v];
            ut[v] = bad ? poison<T>(u[v], g.mode, g.scale) : u[v];
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const bool diag = i == j;
          const float wij = diag ? 0.0f : w_s[i * M + j];
          const float bij = diag ? 0.0f : b_s[i * M + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (diag) {
              self[i][v] = __fsub_rn(__fmul_rn(w_s[i * M + i], x[v]),
                                     __fmul_rn(b_s[i * M + i], u[v]));
            }
            float link = __fsub_rn(__fmul_rn(wij, xt[v]), __fmul_rn(bij, ut[v]));
            if (g.use_clip) {
              link = isfinite(link) ? fminf(fmaxf(link, -g.clip), g.clip)
                                    : 0.0f;
            }
            acc[i][v] = __fadd_rn(acc[i][v], link);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        VecT<T, VEC> ov;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          from_f(&ov.v[v], __fadd_rn(self[i][v], acc[i][v]));
        }
        reinterpret_cast<VecT<T, VEC>*>(out + (int64_t)i * n)[t] = ov;
      }
    }
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

// The launch arguments shared by every kernel of this file.
struct Args {
  const void* wm;  // W, or the mask
  const float* B;
  const void* X;
  const void* U;
  const void* XT;  // guarded, staged form only
  const void* UT;
  void* out;
  int m;
  int64_t n;
  cudaStream_t s;
};

template <typename T, int M, int VEC, int SRC>
int launch_gossip(const Args& a, const MaskDraw& d) {
  if (a.n % VEC != 0) return (int)cudaErrorInvalidValue;
  gossip_kernel<T, M, VEC, SRC><<<grid_for(a.n / VEC), kThreads, 0, a.s>>>(
      (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U, (T*)a.out, a.m,
      a.n, d);
  return (int)cudaGetLastError();
}

template <typename T, int M, int VEC>
int launch_guarded(const Args& a, const Guard& g) {
  if (a.n % VEC != 0) return (int)cudaErrorInvalidValue;
  const int grid = grid_for(a.n / VEC);
  if (a.XT != nullptr) {
    guarded_kernel<T, M, VEC, true><<<grid, kThreads, 0, a.s>>>(
        (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U,
        (const T*)a.XT, (const T*)a.UT, (T*)a.out, a.m, a.n, g);
  } else {
    guarded_kernel<T, M, VEC, false><<<grid, kThreads, 0, a.s>>>(
        (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U, nullptr,
        nullptr, (T*)a.out, a.m, a.n, g);
  }
  return (int)cudaGetLastError();
}

// kind: 0-2 a WeightSource of gossip_kernel, 3 the guarded kernel.
template <typename T, int M, int VEC>
int launch_kind(int kind, const Args& a, const MaskDraw& d, const Guard& g) {
  switch (kind) {
    case kWeightsGiven: return launch_gossip<T, M, VEC, kWeightsGiven>(a, d);
    case kMaskGiven: return launch_gossip<T, M, VEC, kMaskGiven>(a, d);
    case kMaskDrawn: return launch_gossip<T, M, VEC, kMaskDrawn>(a, d);
    case 3: return launch_guarded<T, M, VEC>(a, g);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_m(int kind, const Args& a, const MaskDraw& d, const Guard& g) {
  if (a.m <= 4) return launch_kind<T, 4, 8>(kind, a, d, g);
  if (a.m <= 8) return launch_kind<T, 8, 4>(kind, a, d, g);
  if (a.m <= 16) return launch_kind<T, 16, 2>(kind, a, d, g);
  if (a.m <= 32) return launch_kind<T, 32, 1>(kind, a, d, g);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, int kind, const Args& a, const MaskDraw& d,
             const Guard& g) {
  if (a.m < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_m<float>(kind, a, d, g);
  if (dtype == 1) return dispatch_m<__nv_bfloat16>(kind, a, d, g);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common to every entry point: dtype 0 = float32, 1 = bfloat16 (X, U, XT, UT
// and out share it).  (m, m) matrices are float32 row-major; X, U, out are
// (m, n) row-major and out may alias X.  n must be a multiple of the column
// vector width (8 covers every m) and the rows aligned to it; the Python
// wrappers check both.

extern "C" int gossip_update(int dtype, const void* W, const void* B,
                             const void* X, const void* U, void* out, int m,
                             long long n, void* stream) {
  const Args a{W, (const float*)B, X, U, nullptr, nullptr, out, m, n,
               (cudaStream_t)stream};
  return dispatch(dtype, kWeightsGiven, a, MaskDraw{}, Guard{});
}

// mask: (m, m) symmetric 0/1 with a zero diagonal.
extern "C" int masked_gossip_update(int dtype, const void* mask,
                                    const void* B, const void* X,
                                    const void* U, void* out, int m,
                                    long long n, void* stream) {
  const Args a{mask, (const float*)B, X, U, nullptr, nullptr, out, m, n,
               (cudaStream_t)stream};
  return dispatch(dtype, kMaskGiven, a, MaskDraw{}, Guard{});
}

// (k0, k1): the mask's threefry key; adj: (m, m) off-diagonal 0/1 gate;
// mask_out: (m, m) float32, written.
extern "C" int masked_gossip_update_krng(int dtype, unsigned int k0,
                                         unsigned int k1, float keep_prob,
                                         const void* adj, const void* B,
                                         const void* X, const void* U,
                                         void* out, void* mask_out, int m,
                                         long long n, void* stream) {
  const Args a{nullptr, (const float*)B, X, U, nullptr, nullptr, out, m, n,
               (cudaStream_t)stream};
  const MaskDraw d{k0, k1, keep_prob, (const float*)adj, (float*)mask_out};
  return dispatch(dtype, kMaskDrawn, a, d, Guard{});
}

// XT, UT: the transmit buffers, or both null to form them in registers from
// X, U and corrupt ((m,) float32 0/1, or null) by mode (0 nan, 1 inf, 2
// scale; scale already rounded to the dtype).  use_clip 0 disables the guard.
extern "C" int guarded_gossip_update(int dtype, const void* mask,
                                     const void* B, const void* X,
                                     const void* U, const void* XT,
                                     const void* UT, const void* corrupt,
                                     int mode, float scale, float clip,
                                     int use_clip, void* out, int m,
                                     long long n, void* stream) {
  if ((XT == nullptr) != (UT == nullptr) || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{mask, (const float*)B, X, U, XT, UT, out, m, n,
               (cudaStream_t)stream};
  const Guard g{(const float*)corrupt, mode, scale, clip, use_clip};
  return dispatch(dtype, 3, a, MaskDraw{}, g);
}
