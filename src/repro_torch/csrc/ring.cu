// Ring-layout gossip kernels for Hopper (sm_90a): the PDSGD update of Eq. (4)
// from per-direction tables, the obfuscation fused in.
//
// Replaces, in repro/kernels/gossip.py:
//   ring_gossip_update          <- ring_gossip_update (_ring_gossip_kernel
//                                  and _ring_accumulate, pallas_call at :446);
//                                  u is an input.
//   ring_obfuscate_gossip       <- ring_obfuscate_gossip
//                                  (_ring_obfuscate_kernel, pallas_call at
//                                  :506); u = Lambda o g from bits in memory.
//   ring_obfuscate_gossip_krng  <- ring_obfuscate_gossip_krng
//                                  (_ring_obfuscate_krng_kernel, pallas_call
//                                  at :598); Lambda's bits drawn in-kernel.
//
// What they compute.  With w, b the (m, 1 + ndirs) tables (column 0 the self
// term, column 1 + d agent j's weight on its direction-d message) and src
// the (ndirs, m) source table (receiver i of direction d hears agent
// src[d][i]), per column:
//     acc_i  = w_i0 x_i - b_i0 u_i
//     v_d,j  = w_j,1+d x_j - b_j,1+d u_j              (every agent j)
//     acc_i  = acc_i + v_d,src[d][i]                  (d = 0 .. ndirs - 1)
//     x'_i   = acc_i rounded to X's dtype
// and, for the obfuscating two, u_j = (2 lam_bar * U(bits)) * g_j in f32, with
// U(bits) = bitcast((bits >> 9) | 0x3F800000) - 1 (obfuscate.cu's rule).
//
// Exactness.  The TPU kernel shifts v_d by a 0/1 permutation matmul; here
// the permutation is the source table in shared memory and the shift a
// gather, which for finite v is the same value.  A matmul also spreads a
// non-finite v to every receiver of the column (0 * nan = nan, 0 * inf =
// nan), so each thread counts the non-finite v_d in its column and a
// receiver whose other senders include one gets nan.  Every product, sum and
// difference is __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA, and the order is the reference's (self first, then
// the directions in order): the kernels are bitwise with the plain PyTorch
// versions (kernels/ref.py) in f32 and bf16.
//
// What bounds them on an H100.  Per column they read m values of X and of U
// (or G, plus 4-byte bits for ring_obfuscate_gossip) and write m values of
// x': 6 B an element in bf16 (10 with bits), against about 4 (1 + ndirs)
// float operations an element — device memory bounds ring_gossip_update and
// ring_obfuscate_gossip.  ring_obfuscate_gossip_krng moves 6 B an element but
// runs the 20-round threefry2x32 (threefry.cuh) for each, about 100 integer
// operations: the integer units bound it, as they bound obfuscate_update_krng.
//
// Design of B7 and B8 (B9's is at ring_krng_kernel below).  One thread owns
// VEC consecutive columns across all m <= 32 rows:
// it loads every row of its columns (vector loads, neighbouring threads on
// neighbouring addresses), forms u, accumulates in f32 and stores x'.
// Because it reads all m rows before it writes any, x' may be written over X
// in place, as the PDSGD step does.  The gather of v_d[src] walks the m
// senders with compile-time indices and selects, so v_d stays in registers.
// The tables and the source table sit in shared memory.  With capture, v
// (ndirs, m, n) and u (m, n) are written out in f32.  The time goes with the
// registers a thread holds (the x, u, accumulator and v_d arrays): VEC is 2,
// 1, 1 for m <= 8, 16, 32, and for m <= 4 (the training path) 2 in
// ring_gossip_update and 4 in ring_obfuscate_gossip, with registers capped
// so three blocks fit an SM — the settings that measured fastest at the
// main path's shape on an H100.
//
// In-kernel randomness.  The TPU kernel seeds the TPU's own generator, a
// stream no other device reproduces.  Here, as in obfuscate_update_krng, row
// a, column c of leaf l (columns [off[l], off[l+1])) draws
//     x0 ^ x1 of threefry2x32(key[a, l], (hi(c - off[l]), lo(c - off[l])))
// from the per-(agent, leaf) key table: jax.random's counter stream, so Lambda
// equals the reference's per-agent bits bit for bit; padding columns past
// off[n_leaves] draw 0.  The bits may be exported for the parity check.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDirs = 4;
constexpr int kTab = 1 + kMaxDirs;  // table row stride in shared memory
constexpr int kMaxLeaves = 1024;

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

// Where u comes from in ring_kernel (B9 has a kernel of its own).
enum USource { kUGiven = 0, kUFromBits = 1 };

struct RingArgs {
  const float* w_tab;       // (m, 1 + ndirs)
  const float* b_tab;       // (m, 1 + ndirs)
  const int* src;           // (ndirs, m)
  int ndirs;
  const void* X;            // (m, n)
  const void* U;            // (m, n): u (kUGiven) or g
  const uint32_t* bits;     // (m, n), kUFromBits
  const uint32_t* keys;     // (m, n_leaves, 2), B9
  const int64_t* offsets;   // (n_leaves + 1,), B9
  int n_leaves;
  const float* lam_bar;     // (1,), device memory
  void* out;                // (m, n), may alias X
  float* v_out;             // (ndirs, m, n) or null
  float* u_out;             // (m, n) or null
  uint32_t* bits_out;       // (m, n) or null, B9
  int m;
  int64_t n;
  cudaStream_t stream;
};

__device__ __forceinline__ float u01(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

template <typename T, int M, int VEC, int USRC>
__global__ void __launch_bounds__(kThreads, M <= 4 ? 3 : 1)
    ring_kernel(RingArgs a) {
  __shared__ float w_s[M * kTab];
  __shared__ float b_s[M * kTab];
  __shared__ int src_s[kMaxDirs * M];
  const int m = a.m, nd = a.ndirs, nc = 1 + nd;
  for (int i = threadIdx.x; i < M * kTab; i += blockDim.x) {
    const int r = i / kTab, c = i % kTab;
    const bool in = r < m && c < nc;
    w_s[i] = in ? a.w_tab[r * nc + c] : 0.0f;
    b_s[i] = in ? a.b_tab[r * nc + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < kMaxDirs * M; i += blockDim.x) {
    const int d = i / M, r = i % M;
    src_s[i] = (d < nd && r < m) ? a.src[d * m + r] : 0;
  }
  __syncthreads();
  const float lam2 = USRC == kUGiven ? 0.0f : __fmul_rn(2.0f, a.lam_bar[0]);
  const T* X = (const T*)a.X;
  const T* U = (const T*)a.U;
  T* out = (T*)a.out;
  const int64_t n = a.n;
  const int64_t nv = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < nv;
       t += stride) {
    const int64_t c0 = t * VEC;
    float x[M][VEC], u[M][VEC];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < m) {
        const int64_t row = (int64_t)j * n + c0;
        const VecT<T, VEC> xv = *reinterpret_cast<const VecT<T, VEC>*>(X + row);
        const VecT<T, VEC> gv = *reinterpret_cast<const VecT<T, VEC>*>(U + row);
        uint32_t bits[VEC];
        if (USRC == kUFromBits) {
          const VecT<uint32_t, VEC> bv =
              *reinterpret_cast<const VecT<uint32_t, VEC>*>(a.bits + row);
#pragma unroll
          for (int v = 0; v < VEC; ++v) bits[v] = bv.v[v];
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          x[j][v] = to_f(xv.v[v]);
          u[j][v] = USRC == kUGiven
                        ? to_f(gv.v[v])
                        : __fmul_rn(__fmul_rn(lam2, u01(bits[v])),
                                    to_f(gv.v[v]));
        }
        if (USRC != kUGiven && a.u_out != nullptr) {
          VecT<float, VEC> uo;
#pragma unroll
          for (int v = 0; v < VEC; ++v) uo.v[v] = u[j][v];
          *reinterpret_cast<VecT<float, VEC>*>(a.u_out + row) = uo;
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[j][v] = u[j][v] = 0.0f;
      }
    }
    float acc[M][VEC];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[i][v] = __fsub_rn(__fmul_rn(w_s[i * kTab], x[i][v]),
                              __fmul_rn(b_s[i * kTab], u[i][v]));
      }
    }
    for (int d = 0; d < nd; ++d) {
      float vd[M][VEC];
      int bad[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) bad[v] = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float wj = w_s[j * kTab + 1 + d], bj = b_s[j * kTab + 1 + d];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          vd[j][v] = __fsub_rn(__fmul_rn(wj, x[j][v]), __fmul_rn(bj, u[j][v]));
          bad[v] += (j < m && !isfinite(vd[j][v])) ? 1 : 0;
        }
        if (a.v_out != nullptr && j < m) {
          VecT<float, VEC> vo;
#pragma unroll
          for (int v = 0; v < VEC; ++v) vo.v[v] = vd[j][v];
          *reinterpret_cast<VecT<float, VEC>*>(
              a.v_out + ((int64_t)d * m + j) * n + c0) = vo;
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < m) {
          const int s = src_s[d * M + i];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float g = vd[0][v];
#pragma unroll
            for (int j = 1; j < M; ++j) g = (s == j) ? vd[j][v] : g;
            // the matmul's rule: another sender's non-finite v makes nan
            const int others = bad[v] - (isfinite(g) ? 0 : 1);
            if (others > 0) g = __int_as_float(0x7fc00000);
            acc[i][v] = __fadd_rn(acc[i][v], g);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        VecT<T, VEC> ov;
#pragma unroll
        for (int v = 0; v < VEC; ++v) from_f(&ov.v[v], acc[i][v]);
        *reinterpret_cast<VecT<T, VEC>*>(out + (int64_t)i * n + c0) = ov;
      }
    }
  }
}

// B9, ring_obfuscate_gossip_krng.  Its work is instructions, not bytes:
// 73 integer operations of threefry a word (the bound), and the mixing's
// own (the unpacking of bf16, U(bits), the m x ndirs messages, the gather
// and the non-finite rule), which on the same card take about as long as
// the cipher when written plainly.  So the design cuts instructions:
// * one warp owns a tile of 32 VEC consecutive columns across all m rows
//   (a lane VEC of them) and walks tiles a grid apart, one wave of the
//   blocks that fit; it issues the tile's loads (the leaf's keys first,
//   then X and G, all rows) before it draws the tile's words, which do not
//   depend on them;
// * the tile's leaf is found once, by a binary search over the offsets in
//   shared memory that is the same for the whole warp; a tile inside one
//   leaf (all but the few that hold a leaf boundary, the padding's start or
//   a counter's 2^32 step) draws with the leaf's m keys in registers and a
//   32-bit counter, no per-column lookup; the other tiles walk the leaves
//   per column as B3 does;
// * the matmul's non-finite rule costs one sum a column and direction: the
//   sum of the m messages is finite exactly when none of them is
//   non-finite (or when they overflow together, which takes the exact
//   rule as well), and only a thread with a non-finite sum runs the rule;
// * on the ring the trainer builds (m = M agents, ndirs 2, agent i hearing
//   i - 1 and i + 1; `dist.collectives.source_table`), found once a block
//   from the source table, the gather is a compile-time register index:
//   no selects;
// * registers are not capped below what the arrays need.
// The arithmetic is ring_kernel's, in the same order: bitwise with B8 on
// the exported bits and with the plain version.
template <typename T, int M, int VEC, bool RING>
__device__ __forceinline__ void krng_tile(const RingArgs& a, const float* w_s,
                                          const float* b_s, const int* src_s,
                                          const int64_t* off_s, float lam2,
                                          int64_t t0, int lane) {
  constexpr int kTile = 32 * VEC;
  const int m = RING ? M : a.m, nd = RING ? 2 : a.ndirs, nl = a.n_leaves;
  const int64_t n = a.n, end = off_s[nl];
  const int64_t c0 = t0 + lane * VEC;
  const bool live = c0 < n;  // n % 8 == 0: a lane's VEC are all in or out
  // the tile's leaf, the same for the warp: largest l with off[l] <= t0
  int leaf = 0;
  bool one_leaf = false;
  uint32_t k0[M], k1[M], chi = 0, clo = 0;
  if (t0 < end) {
    int lo = 0, hi = nl;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off_s[mid] <= t0) lo = mid; else hi = mid;
    }
    leaf = lo;
    const int64_t ctr0 = t0 - off_s[lo];
    one_leaf = t0 + kTile <= off_s[lo + 1] &&
               (uint32_t)ctr0 <= 0xFFFFFFFFu - (uint32_t)kTile;
    if (one_leaf) {
      chi = (uint32_t)(ctr0 >> 32);
      clo = (uint32_t)ctr0 + (uint32_t)(lane * VEC);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (j < m) {
          const uint32_t* kp = a.keys + 2 * ((int64_t)j * nl + lo);
          k0[j] = kp[0];
          k1[j] = kp[1];
        }
      }
    }
  }
  VecT<T, VEC> xv[M], gv[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j < m && live) {
      const int64_t row = (int64_t)j * n + c0;
      xv[j] = *reinterpret_cast<const VecT<T, VEC>*>((const T*)a.X + row);
      gv[j] = *reinterpret_cast<const VecT<T, VEC>*>((const T*)a.U + row);
    }
  }
  uint32_t bits[M][VEC];
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) bits[j][v] = 0u;
  }
  if (one_leaf) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          bits[j][v] = threefry_bits(k0[j], k1[j], chi, clo + (uint32_t)v);
        }
      }
    }
  } else if (t0 < end) {
    // per column: walk the leaves from the tile's
    int lv[VEC];
    uint64_t ctr[VEC];
    int l = leaf;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int64_t c = c0 + v;
      lv[v] = -1;
      ctr[v] = 0;
      if (c < end) {
        while (c >= off_s[l + 1]) ++l;
        lv[v] = l;
        ctr[v] = (uint64_t)(c - off_s[l]);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if (lv[v] >= 0) {
            const uint32_t* kp = a.keys + 2 * ((int64_t)j * nl + lv[v]);
            bits[j][v] = threefry_bits(kp[0], kp[1], (uint32_t)(ctr[v] >> 32),
                                       (uint32_t)ctr[v]);
          }
        }
      }
    }
  }
  if (!live) return;
  float x[M][VEC], u[M][VEC];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j < m) {
      const int64_t row = (int64_t)j * n + c0;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        x[j][v] = to_f(xv[j].v[v]);
        u[j][v] = __fmul_rn(__fmul_rn(lam2, u01(bits[j][v])),
                            to_f(gv[j].v[v]));
      }
      if (a.bits_out != nullptr) {
        VecT<uint32_t, VEC> bo;
#pragma unroll
        for (int v = 0; v < VEC; ++v) bo.v[v] = bits[j][v];
        *reinterpret_cast<VecT<uint32_t, VEC>*>(a.bits_out + row) = bo;
      }
      if (a.u_out != nullptr) {
        VecT<float, VEC> uo;
#pragma unroll
        for (int v = 0; v < VEC; ++v) uo.v[v] = u[j][v];
        *reinterpret_cast<VecT<float, VEC>*>(a.u_out + row) = uo;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[j][v] = u[j][v] = 0.0f;
    }
  }
  float acc[M][VEC];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[i][v] = __fsub_rn(__fmul_rn(w_s[i * kTab], x[i][v]),
                            __fmul_rn(b_s[i * kTab], u[i][v]));
    }
  }
  // the ring's two directions unrolled for their compile-time gather; for
  // m > 8 the general loop is not (unrolled, it spilled kilobytes)
#pragma unroll (RING ? 2 : (M <= 8 ? kMaxDirs : 1))
  for (int d = 0; d < (RING ? 2 : kMaxDirs); ++d) {
    if (d >= nd) break;
    // rows past m hold w = b = x = u = 0: their v is 0
    float vd[M][VEC];
    bool clean = true;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float wj = w_s[j * kTab + 1 + d], bj = b_s[j * kTab + 1 + d];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        vd[j][v] = __fsub_rn(__fmul_rn(wj, x[j][v]), __fmul_rn(bj, u[j][v]));
      }
      if (a.v_out != nullptr && j < m) {
        VecT<float, VEC> vo;
#pragma unroll
        for (int v = 0; v < VEC; ++v) vo.v[v] = vd[j][v];
        *reinterpret_cast<VecT<float, VEC>*>(
            a.v_out + ((int64_t)d * m + j) * n + c0) = vo;
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float tot = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) tot += vd[j][v];
      clean = clean && isfinite(tot);
    }
    if (clean) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < m) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float g;
            if (RING) {
              g = vd[(i + (d == 0 ? M - 1 : 1)) % M][v];
            } else {
              const int s = src_s[d * M + i];
              g = vd[0][v];
#pragma unroll
              for (int j = 1; j < M; ++j) g = (s == j) ? vd[j][v] : g;
            }
            acc[i][v] = __fadd_rn(acc[i][v], g);
          }
        }
      }
    } else {
      // the matmul's rule: another sender's non-finite v makes nan
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        int bad = 0;
#pragma unroll
        for (int j = 0; j < M; ++j) bad += (j < m && !isfinite(vd[j][v]));
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i < m) {
            const int s = src_s[d * M + i];
            float g = vd[0][v];
#pragma unroll
            for (int j = 1; j < M; ++j) g = (s == j) ? vd[j][v] : g;
            if (bad - (isfinite(g) ? 0 : 1) > 0) {
              g = __int_as_float(0x7fc00000);
            }
            acc[i][v] = __fadd_rn(acc[i][v], g);
          }
        }
      }
    }
  }
  T* out = (T*)a.out;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < m) {
      VecT<T, VEC> ov;
#pragma unroll
      for (int v = 0; v < VEC; ++v) from_f(&ov.v[v], acc[i][v]);
      *reinterpret_cast<VecT<T, VEC>*>(out + (int64_t)i * n + c0) = ov;
    }
  }
}

template <typename T, int M, int VEC>
__global__ void __launch_bounds__(kThreads)
    ring_krng_kernel(RingArgs a) {
  constexpr int kWarps = kThreads / 32, kTile = 32 * VEC;
  __shared__ float w_s[M * kTab];
  __shared__ float b_s[M * kTab];
  __shared__ int src_s[kMaxDirs * M];
  __shared__ int64_t off_s[kMaxLeaves + 1];
  __shared__ int not_ring;
  const int m = a.m, nd = a.ndirs, nc = 1 + nd, nl = a.n_leaves;
  if (threadIdx.x == 0) not_ring = m != M || nd != 2;
  for (int i = threadIdx.x; i < M * kTab; i += blockDim.x) {
    const int r = i / kTab, c = i % kTab;
    const bool in = r < m && c < nc;
    w_s[i] = in ? a.w_tab[r * nc + c] : 0.0f;
    b_s[i] = in ? a.b_tab[r * nc + c] : 0.0f;
  }
  for (int i = threadIdx.x; i <= nl; i += blockDim.x) off_s[i] = a.offsets[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxDirs * M; i += blockDim.x) {
    const int d = i / M, r = i % M;
    const int s = (d < nd && r < m) ? a.src[d * m + r] : 0;
    src_s[i] = s;
    // the ring: direction 0 from r - 1, direction 1 from r + 1
    if (d < 2 && r < M && s != (r + (d == 0 ? M - 1 : 1)) % M) not_ring = 1;
  }
  __syncthreads();
  const float lam2 = __fmul_rn(2.0f, a.lam_bar[0]);
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (a.n + kTile - 1) / kTile;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  const int64_t first = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (!not_ring) {
    for (int64_t tile = first; tile < tiles; tile += step) {
      krng_tile<T, M, VEC, true>(a, w_s, b_s, src_s, off_s, lam2,
                                 tile * kTile, lane);
    }
  } else {
    for (int64_t tile = first; tile < tiles; tile += step) {
      krng_tile<T, M, VEC, false>(a, w_s, b_s, src_s, off_s, lam2,
                                  tile * kTile, lane);
    }
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename T, int M, int VEC, int USRC>
int launch(const RingArgs& a) {
  ring_kernel<T, M, VEC, USRC><<<grid_for(a.n / VEC), kThreads, 0, a.stream>>>(
      a);
  return (int)cudaGetLastError();
}

// Columns a thread owns: fewer as m grows, so the arrays stay in registers.
// For m <= 4 (the training path's m = 4) the gossip-only kernel takes 2 and
// the obfuscating one 4, and the register cap of three blocks an SM holds:
// the widths and the cap that measured fastest at the main path's shape.
template <typename T, int USRC>
int dispatch_m(const RingArgs& a) {
  if (a.m <= 4) return launch<T, 4, USRC == kUGiven ? 2 : 4, USRC>(a);
  if (a.m <= 8) return launch<T, 8, 2, USRC>(a);
  if (a.m <= 16) return launch<T, 16, 1, USRC>(a);
  return launch<T, 32, 1, USRC>(a);
}

// B9: one block of kThreads an SM per block that fits, the warps walking
// the tiles.
template <typename T, int M, int VEC>
int launch_krng(const RingArgs& a) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_krng_kernel<T, M, VEC>, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (a.n + 32 * VEC - 1) / (32 * VEC);
  int64_t blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  ring_krng_kernel<T, M, VEC><<<(int)blocks, kThreads, 0, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_krng_m(const RingArgs& a) {
  if (a.m <= 4) return launch_krng<T, 4, 2>(a);
  if (a.m <= 8) return launch_krng<T, 8, 2>(a);
  if (a.m <= 16) return launch_krng<T, 16, 1>(a);
  return launch_krng<T, 32, 1>(a);
}

bool valid(const RingArgs& a) {
  return a.m >= 1 && a.m <= 32 && a.ndirs >= 0 && a.ndirs <= kMaxDirs &&
         a.n % 8 == 0;
}

template <int USRC>
int dispatch(int dtype, const RingArgs& a) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_m<float, USRC>(a);
  if (dtype == 1) return dispatch_m<__nv_bfloat16, USRC>(a);
  return (int)cudaErrorInvalidValue;
}

int dispatch_krng(int dtype, const RingArgs& a) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_krng_m<float>(a);
  if (dtype == 1) return dispatch_krng_m<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common to every entry point: dtype 0 = float32, 1 = bfloat16 (X, U or G,
// and out share it).  w_tab, b_tab: (m, 1 + ndirs) float32; src: (ndirs, m)
// int32, each row a permutation of 0..m-1; 0 <= ndirs <= 4, 1 <= m <= 32.
// X, U, G, out: (m, n) row-major, out may alias X; n % 8 == 0 and every
// buffer's rows aligned to 8 elements (the wrappers check).  v_out (ndirs, m,
// n) and u_out (m, n) float32 may be null (no capture).

extern "C" int ring_gossip_update(int dtype, const void* w_tab,
                                  const void* b_tab, const void* src,
                                  int ndirs, const void* X, const void* U,
                                  void* out, void* v_out, int m, long long n,
                                  void* stream) {
  RingArgs a{};
  a.w_tab = (const float*)w_tab;
  a.b_tab = (const float*)b_tab;
  a.src = (const int*)src;
  a.ndirs = ndirs;
  a.X = X;
  a.U = U;
  a.out = out;
  a.v_out = (float*)v_out;
  a.m = m;
  a.n = n;
  a.stream = (cudaStream_t)stream;
  return dispatch<kUGiven>(dtype, a);
}

// bits: (m, n) uint32; lam_bar: (1,) float32 in device memory.
extern "C" int ring_obfuscate_gossip(int dtype, const void* w_tab,
                                     const void* b_tab, const void* src,
                                     int ndirs, const void* X, const void* G,
                                     const void* bits, const void* lam_bar,
                                     void* out, void* v_out, void* u_out,
                                     int m, long long n, void* stream) {
  RingArgs a{};
  a.w_tab = (const float*)w_tab;
  a.b_tab = (const float*)b_tab;
  a.src = (const int*)src;
  a.ndirs = ndirs;
  a.X = X;
  a.U = G;
  a.bits = (const uint32_t*)bits;
  a.lam_bar = (const float*)lam_bar;
  a.out = out;
  a.v_out = (float*)v_out;
  a.u_out = (float*)u_out;
  a.m = m;
  a.n = n;
  a.stream = (cudaStream_t)stream;
  return dispatch<kUFromBits>(dtype, a);
}

// keys: (m, n_leaves, 2) uint32; offsets: (n_leaves + 1,) int64 with
// offsets[0] == 0, 1 <= n_leaves <= 1024; bits_out (m, n) uint32 may be null.
extern "C" int ring_obfuscate_gossip_krng(
    int dtype, const void* w_tab, const void* b_tab, const void* src,
    int ndirs, const void* X, const void* G, const void* keys,
    const void* offsets, int n_leaves, const void* lam_bar, void* out,
    void* v_out, void* u_out, void* bits_out, int m, long long n,
    void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.w_tab = (const float*)w_tab;
  a.b_tab = (const float*)b_tab;
  a.src = (const int*)src;
  a.ndirs = ndirs;
  a.X = X;
  a.U = G;
  a.keys = (const uint32_t*)keys;
  a.offsets = (const int64_t*)offsets;
  a.n_leaves = n_leaves;
  a.lam_bar = (const float*)lam_bar;
  a.out = out;
  a.v_out = (float*)v_out;
  a.u_out = (float*)u_out;
  a.bits_out = (uint32_t*)bits_out;
  a.m = m;
  a.n = n;
  a.stream = (cudaStream_t)stream;
  return dispatch_krng(dtype, a);
}
