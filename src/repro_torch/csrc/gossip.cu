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
// Strided leaves.  The leafwise layout runs a kernel on one leaf's columns
// [o, o + n) of the (m, width) flat buffers, read in place: rows ld = width
// apart, the start o on no particular boundary.  The columns up to the first
// VEC-aligned one and after the last whole vector go one at a time, in a
// second launch of one block (the same sums, so each column's value does not
// depend on the split); a call on a whole contiguous buffer with n a
// multiple of VEC has ld = n and no such columns, and one launch.  The
// wrapper counts a call as one launch of its kernel either way.  The
// in-kernel mask draw (masked_gossip_update_krng) takes whole vectors only:
// an edge launch would draw the mask a second time.
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
// draws the same m^2 words (cheap); block 0 writes the mask out.  The key is
// read from device memory, so a CUDA graph replays the launch with each
// step's key (derived on the card from the graph's step counter).
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
  const uint32_t* key;  // (2,) threefry key of the step's mask, on device
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
      const uint32_t bits = threefry_bits(d.key[0], d.key[1], 0u, ctr);
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

// V consecutive columns of row r, starting at column c (aligned to V).
template <int V, typename T>
__device__ __forceinline__ VecT<T, V> cols_at(const T* p, int64_t ld, int r,
                                              int64_t c) {
  return *reinterpret_cast<const VecT<T, V>*>(p + (int64_t)r * ld + c);
}

template <int V, typename T>
__device__ __forceinline__ void store_cols(T* p, int64_t ld, int r, int64_t c,
                                           const VecT<T, V>& v) {
  *reinterpret_cast<VecT<T, V>*>(p + (int64_t)r * ld + c) = v;
}

// The columns [c, c + V) of every row: x'_i = sum_j w_ij x_j - b_ij u_j.
template <typename T, int M, int V>
__device__ __forceinline__ void gossip_cols(const float* w_s,
                                            const float* b_s, const T* X,
                                            const T* U, T* out, int m,
                                            int64_t ld, int64_t c) {
  float mixed[M][V];
  float desc[M][V];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mixed[i][v] = 0.0f;
      desc[i][v] = 0.0f;
    }
  }
  // unrolled by 4, not fully: at M = 32 a full unroll hoists all 2 M
  // loads next to the 2 M accumulators and spills
#pragma unroll 4
  for (int j = 0; j < M; ++j) {
    if (j < m) {
      const VecT<T, V> xv = cols_at<V>(X, ld, j, c);
      const VecT<T, V> uv = cols_at<V>(U, ld, j, c);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float wij = w_s[i * M + j];
        const float bij = b_s[i * M + j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          mixed[i][v] = fmaf(wij, to_f(xv.v[v]), mixed[i][v]);
          desc[i][v] = fmaf(bij, to_f(uv.v[v]), desc[i][v]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < m) {
      VecT<T, V> ov;
#pragma unroll
      for (int v = 0; v < V; ++v) from_f(&ov.v[v], mixed[i][v] - desc[i][v]);
      store_cols<V>(out, ld, i, c, ov);
    }
  }
}

// Column split of a launch: [0, head) and [tail0, n) one column
// at a time, the aligned middle VEC columns at a time.
struct Cols {
  int64_t n;      // columns
  int64_t ld;     // row stride of every (m, .) buffer, in elements
  int64_t head;   // leading columns before the first VEC-aligned one
  int64_t tail0;  // the first column after the last whole vector
};

template <typename T, int M, int VEC, int SRC, bool EDGE>
__global__ void gossip_kernel(const float* __restrict__ wm,
                              const float* __restrict__ B, const T* X,
                              const T* __restrict__ U, T* out, int m,
                              Cols cols, MaskDraw draw) {
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
  const int64_t body = (cols.tail0 - cols.head) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (EDGE) {
    for (int64_t t = tid; t < cols.head + cols.n - cols.tail0; t += stride) {
      const int64_t c = t < cols.head ? t : cols.tail0 + (t - cols.head);
      gossip_cols<T, M, 1>(w_s, b_s, X, U, out, m, cols.ld, c);
    }
  } else {
    for (int64_t t = tid; t < body; t += stride) {
      gossip_cols<T, M, VEC>(w_s, b_s, X, U, out, m, cols.ld,
                             cols.head + t * VEC);
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

// The columns [c, c + V) of every row of the guarded update.
template <typename T, int M, int V, bool STAGED>
__device__ __forceinline__ void guarded_cols(
    const float* w_s, const float* b_s, const float* bad_s, const T* X,
    const T* U, const T* XT, const T* UT, T* out, int m, int64_t ld,
    int64_t c, const Guard& g) {
  float self[M][V];
  float acc[M][V];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      self[i][v] = 0.0f;
      acc[i][v] = 0.0f;
    }
  }
#pragma unroll 4
  for (int j = 0; j < M; ++j) {
    if (j < m) {
      const VecT<T, V> xv = cols_at<V>(X, ld, j, c);
      const VecT<T, V> uv = cols_at<V>(U, ld, j, c);
      float x[V], u[V], xt[V], ut[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x[v] = to_f(xv.v[v]);
        u[v] = to_f(uv.v[v]);
      }
      if (STAGED) {
        const VecT<T, V> xtv = cols_at<V>(XT, ld, j, c);
        const VecT<T, V> utv = cols_at<V>(UT, ld, j, c);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xt[v] = to_f(xtv.v[v]);
          ut[v] = to_f(utv.v[v]);
        }
      } else {
        const bool bad = bad_s[j] > 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
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
        for (int v = 0; v < V; ++v) {
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
      VecT<T, V> ov;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        from_f(&ov.v[v], __fadd_rn(self[i][v], acc[i][v]));
      }
      store_cols<V>(out, ld, i, c, ov);
    }
  }
}

template <typename T, int M, int VEC, bool STAGED, bool EDGE>
__global__ void guarded_kernel(const float* __restrict__ mask,
                               const float* __restrict__ B, const T* X,
                               const T* U, const T* __restrict__ XT,
                               const T* __restrict__ UT, T* out, int m,
                               Cols cols, Guard g) {
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
  const int64_t body = (cols.tail0 - cols.head) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (EDGE) {
    for (int64_t t = tid; t < cols.head + cols.n - cols.tail0; t += stride) {
      const int64_t c = t < cols.head ? t : cols.tail0 + (t - cols.head);
      guarded_cols<T, M, 1, STAGED>(w_s, b_s, bad_s, X, U, XT, UT, out, m,
                                    cols.ld, c, g);
    }
  } else {
    for (int64_t t = tid; t < body; t += stride) {
      guarded_cols<T, M, VEC, STAGED>(w_s, b_s, bad_s, X, U, XT, UT, out,
                                      m, cols.ld, cols.head + t * VEC, g);
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
  int64_t ld;
  cudaStream_t s;
};

// Where the VEC-aligned columns start: every (m, .) buffer must sit at the
// same offset from a VEC boundary (and its rows ld apart, ld a multiple of
// VEC), else every column takes the one-column path.
template <typename T, int VEC>
Cols cols_for(const Args& a) {
  auto mis = [](const void* p) {
    return (int64_t)(((uintptr_t)p / sizeof(T)) % VEC);
  };
  const int64_t m0 = mis(a.X);
  const bool same = (a.m == 1 || a.ld % VEC == 0) && mis(a.U) == m0 &&
                    mis(a.out) == m0 &&
                    (a.XT == nullptr || (mis(a.XT) == m0 && mis(a.UT) == m0));
  const int64_t lead = (VEC - m0) % VEC;
  const int64_t head = same ? (lead < a.n ? lead : a.n) : a.n;
  return Cols{a.n, a.ld, head, head + (a.n - head) / VEC * VEC};
}

// The aligned middle and, when there are any, the edge columns, as two
// launches: compiled into the middle's loop, the one-column path raised the
// guarded kernel's registers from 118 to 168 at M = 4 and its time by half.
// The edge launch (a few columns, one block) is the M = 32 instance for any
// m, so each weight source compiles it once.
template <typename T, int M, int VEC, int SRC>
int launch_gossip(const Args& a, const MaskDraw& d) {
  const Cols c = cols_for<T, VEC>(a);
  const int64_t body = (c.tail0 - c.head) / VEC;
  if (body > 0) {
    gossip_kernel<T, M, VEC, SRC, false><<<grid_for(body), kThreads, 0,
                                           a.s>>>(
        (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U, (T*)a.out,
        a.m, c, d);
  }
  if (c.n > body * VEC) {
    gossip_kernel<T, 32, 1, SRC, true><<<1, kThreads, 0, a.s>>>(
        (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U, (T*)a.out,
        a.m, c, d);
  }
  return (int)cudaGetLastError();
}

template <typename T, int M, int VEC, bool STAGED, bool EDGE>
void launch_guarded_part(int grid, const Args& a, const Cols& c,
                         const Guard& g) {
  guarded_kernel<T, M, VEC, STAGED, EDGE><<<grid, kThreads, 0, a.s>>>(
      (const float*)a.wm, a.B, (const T*)a.X, (const T*)a.U,
      (const T*)a.XT, (const T*)a.UT, (T*)a.out, a.m, c, g);
}

template <typename T, int M, int VEC>
int launch_guarded(const Args& a, const Guard& g) {
  const Cols c = cols_for<T, VEC>(a);
  const int64_t body = (c.tail0 - c.head) / VEC;
  const bool staged = a.XT != nullptr;
  if (body > 0) {
    if (staged) {
      launch_guarded_part<T, M, VEC, true, false>(grid_for(body), a, c, g);
    } else {
      launch_guarded_part<T, M, VEC, false, false>(grid_for(body), a, c, g);
    }
  }
  if (c.n > body * VEC) {
    if (staged) {
      launch_guarded_part<T, 32, 1, true, true>(1, a, c, g);
    } else {
      launch_guarded_part<T, 32, 1, false, true>(1, a, c, g);
    }
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
// (m, n) with row stride ld >= n elements (ld = n: contiguous; a leaf's
// columns inside a wider flat buffer otherwise), and out may alias X.  Any
// n and any start column: the columns before the first vector-aligned one
// and after the last whole vector take the one-column path.

extern "C" int gossip_update(int dtype, const void* W, const void* B,
                             const void* X, const void* U, void* out, int m,
                             long long n, long long ld, void* stream) {
  const Args a{W, (const float*)B, X, U, nullptr, nullptr, out, m, n, ld,
               (cudaStream_t)stream};
  return dispatch(dtype, kWeightsGiven, a, MaskDraw{}, Guard{});
}

// mask: (m, m) symmetric 0/1 with a zero diagonal.
extern "C" int masked_gossip_update(int dtype, const void* mask,
                                    const void* B, const void* X,
                                    const void* U, void* out, int m,
                                    long long n, long long ld,
                                    void* stream) {
  const Args a{mask, (const float*)B, X, U, nullptr, nullptr, out, m, n, ld,
               (cudaStream_t)stream};
  return dispatch(dtype, kMaskGiven, a, MaskDraw{}, Guard{});
}

// key: the mask's threefry key, (2,) uint32 words in device memory; adj:
// (m, m) off-diagonal 0/1 gate; mask_out: (m, m) float32, written.
extern "C" int masked_gossip_update_krng(int dtype, const void* key,
                                         float keep_prob,
                                         const void* adj, const void* B,
                                         const void* X, const void* U,
                                         void* out, void* mask_out, int m,
                                         long long n, void* stream) {
  // whole vectors only: an edge launch would draw the mask again
  if (n % 8 != 0) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, (const float*)B, X, U, nullptr, nullptr, out, m, n,
               n, (cudaStream_t)stream};
  const MaskDraw d{(const uint32_t*)key, keep_prob, (const float*)adj,
                   (float*)mask_out};
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
                                     long long n, long long ld,
                                     void* stream) {
  if ((XT == nullptr) != (UT == nullptr) || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{mask, (const float*)B, X, U, XT, UT, out, m, n, ld,
               (cudaStream_t)stream};
  const Guard g{(const float*)corrupt, mode, scale, clip, use_clip};
  return dispatch(dtype, 3, a, MaskDraw{}, g);
}
