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
// computed to f32 accuracy; only y is rounded, as the TPU kernel does.
//
// What bounds it on an H100.  The f32 states, G H P N of them, are most of
// the bytes; the products are 2 Q N (scores) + 2 Q H P (y) a causal pair
// and 2 Q H P N (states) a chunk.  On tensor cores the bytes bound every
// shape the xLSTM paths give it (prefill memory call, G = 32, Q = 64,
// P = N = 384: 25 MB, 7.5 us; 0.71 GFLOP, 0.7 us at the bf16 rate).
//
// One launch a call, no scratch in device memory, two routes chosen here
// by Q:
//
// * chunk route, 16 <= Q <= 128 (Q padded to QP = 16, 32, 64 or 128): one
//   block of 8 warps per (g, h, 64 columns of P), 192 blocks at the prefill
//   shape, two an SM.  N is streamed in steps of 64 columns of B and C
//   through two shared-memory slots filled by cp.async, the next step in
//   flight while the block computes on this one (one barrier a step).
//   Each step (1) adds C B^T over its columns into the lower-triangular
//   16 x 8 tiles of the scores, held in registers across the steps (a
//   warp's 16 x 32 block shares one C fragment), and (2) writes that
//   step's 64 x 64 tile of the states, (x fac)^T B with
//   fac_j = dt_j exp(a_{Q-1} - a_j), so B is read once for both products.
//   Then the block forms the masked decay weights W (QP x QP, f32, over
//   the ring's slots) from its scores (the mask is taken before the exp:
//   anti-causal exponents are positive and overflow) and y = W x for its
//   64 columns.  The scores are recomputed by each of the
//   ceil(P / 64) blocks of a chunk; on tensor cores that costs less than a
//   pass through memory.
//   All three products are mma.sync m16n8k8 TF32 with a compensated split
//   (3xTF32): an f32 operand a is hi = a truncated to TF32 and lo = a - hi
//   (exact), and a b = a_hi b_lo + a_lo b_hi + a_hi b_hi (small terms
//   first), accurate to about 3 2^-20 |a| |b| (the dropped a_lo b_lo and
//   the tensor cores' reading of lo to 11 bits).  The split is two
//   instructions (a mask, a subtraction) on each fragment as it is loaded;
//   shared memory holds the operands once, as staged.  A bf16
//   operand is exact in TF32 and goes in as it is (lo = 0, its products
//   skipped): C B^T on bf16 inputs is one product, W x and (x fac)^T B
//   two.
// * decode route, Q < 16 (below the tensor cores' 16-row tile; the decode
//   step's Q = 1): one block per (g, h, 32 columns of P) writes its 32 x N
//   slab of the states with float4 stores, B read through L1; the
//   Q (Q + 1) / 2 scores are warp dot products.  f32 FMAs, few registers,
//   many blocks an SM: bound by writing the states.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 128;
constexpr int TC_Q = 16;  // the chunk route from here
// chunk route: P columns a block owns, N columns staged a step
constexpr int TP = 64;
constexpr int NC = 64;
// decode route: P columns a block owns
constexpr int TPD = 32;

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

// v = hi + lo, hi its leading 11 significant bits (TF32, truncated) and lo
// the exact remainder (|lo| < 2^-10 |v|), of which the tensor cores read
// the leading 11 bits: hi + lo as read is v to within 2^-20 |v|.  Two
// instructions.  An EXACT v (a bf16 value) is its own hi.
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = __float_as_uint(v) & 0xFFFFE000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k8 fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
// b1 (t + 4, g); D (16 x 8) d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ...).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// big[c] += a_hi b_hi[c], small[c] += a_hi b_lo[c] + a_lo b_hi[c]: 3xTF32
// over C tiles that share a, the products issued side by side into
// independent accumulators (the compiler keeps asm in program order, so
// this order is what lets their tensor-core latencies overlap); an exact
// operand's lo products are skipped.  The value is big + small.
template <bool AX, bool BX, int C>
__device__ __forceinline__ void mma3(float (&big)[C][4],
                                     float (&small)[C][4], const FragA& a,
                                     const FragB (&b)[C]) {
  if (!BX) {
#pragma unroll
    for (int c = 0; c < C; ++c) mma(small[c], a.hi, b[c].lo);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) mma(big[c], a.hi, b[c].hi);
  if (!AX) {
#pragma unroll
    for (int c = 0; c < C; ++c) mma(small[c], a.lo, b[c].hi);
  }
}

// A (i, k) = s[i * ld + k] (x's dtype), split as loaded
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a_rows(FragA& f, const T* s, int ld,
                                            int g, int t) {
  const float v[4] = {to_f(s[g * ld + t]), to_f(s[(g + 8) * ld + t]),
                      to_f(s[g * ld + t + 4]),
                      to_f(s[(g + 8) * ld + t + 4])};
#pragma unroll
  for (int e = 0; e < 4; ++e) split<EXACT>(v[e], f.hi[e], f.lo[e]);
}

// A (p, k) = s[k * ld + p] fac[k]: the states' (x fac)^T, split as loaded
template <typename T>
__device__ __forceinline__ void load_a_xfac(FragA& f, const T* s, int ld,
                                            const float* fac, int g, int t) {
  const float v[4] = {to_f(s[t * ld + g]) * fac[t],
                      to_f(s[t * ld + g + 8]) * fac[t],
                      to_f(s[(t + 4) * ld + g]) * fac[t + 4],
                      to_f(s[(t + 4) * ld + g + 8]) * fac[t + 4]};
#pragma unroll
  for (int e = 0; e < 4; ++e) split<false>(v[e], f.hi[e], f.lo[e]);
}

// B (k, n) = s[k * ld + n] (x's dtype or f32), split as loaded
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b_rows(FragB& f, const T* s, int ld,
                                            int g, int t) {
  split<EXACT>(to_f(s[t * ld + g]), f.hi[0], f.lo[0]);
  split<EXACT>(to_f(s[(t + 4) * ld + g]), f.hi[1], f.lo[1]);
}

// B (k, n) = s[n * ld + k] (x's dtype), split as loaded
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b_cols(FragB& f, const T* s, int ld,
                                            int g, int t) {
  split<EXACT>(to_f(s[g * ld + t]), f.hi[0], f.lo[0]);
  split<EXACT>(to_f(s[g * ld + t + 4]), f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// rows x cols of T from global (row stride gld) into shared memory (row
// stride sld); (r, c) past vr rows or vc columns is 0.  With vec, 16-byte
// cp.async (the caller has checked alignment, gld and vc a multiple of a
// vector); else element loads.
template <typename T>
__device__ __forceinline__ void stage(T* s, int sld, const T* src,
                                      long long gld, int rows, int cols,
                                      int vr, int vc, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cv = cols / V;
    for (int e = threadIdx.x; e < rows * cv; e += THREADS) {
      const int r = e / cv, c = (e - r * cv) * V;
      const bool in = r < vr && c < vc;
      cp16(s + r * sld + c, in ? src + r * gld + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e - r * cols;
      s[r * sld + c] =
          (r < vr && c < vc) ? src[r * gld + c] : from_f<T>(0.0f);
    }
  }
}

// Shared memory of the chunk route: a ring of STAGES steps of B and C as
// staged (x's dtype; B QP x LDB, then C QP x LDC), reused for W (f32,
// QP x LDW) after the last step; a, dt and fac (f32, QP each); x (x's
// dtype, QP x LDX).  Row strides padded so the fragment loads hit
// distinct banks (f32 B's transposed read in the scores two-way).
constexpr int STAGES = 2;
template <typename T, int QP>
struct ChunkSmem {
  static constexpr bool EX = sizeof(T) == 2;  // bf16: exact in tf32
  static constexpr int LDX = TP + 8, LDB = NC + 8, LDC = NC + (EX ? 8 : 4);
  static constexpr int LDW = QP + 4;
  static constexpr int STAGE = QP * (LDB + LDC);  // elements of T
  static constexpr size_t RING = STAGES * STAGE * sizeof(T);
  static constexpr size_t W = (size_t)QP * LDW * 4;
  static constexpr size_t REGION = RING > W ? RING : W;
  static constexpr size_t BYTES =
      REGION + 12 * (size_t)QP + sizeof(T) * (size_t)QP * LDX;
};

// chunk route: grid (G H, P tiles of TP), THREADS threads
template <typename T, int QP>
__global__ void __launch_bounds__(THREADS, QP <= 64 ? 2 : 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ states, int Q, int H, int P, int N,
                 int vec_x, int vec_bc) {
  using L = ChunkSmem<T, QP>;
  constexpr bool EX = L::EX;
  constexpr int LDX = L::LDX, LDB = L::LDB, LDC = L::LDC, LDW = L::LDW;
  constexpr int RT = QP / 16;  // 16-row tiles
  // score blocks of 16 rows x 32 columns (4 tiles of 16 x 8 sharing their
  // C fragment) over the lower triangle: row tile r has r / 2 + 1 blocks,
  // of which tiles c <= 2 r + 1 are computed
  constexpr int SC_BLOCKS = (RT / 2) * (RT / 2 + 1) + (RT & 1);
  constexpr int SC_PER_WARP = (SC_BLOCKS + WARPS - 1) / WARPS;
  extern __shared__ __align__(16) uint32_t smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* Ws = reinterpret_cast<float*>(smem);  // after the last step
  float* as = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem) + L::REGION);
  float* dts = as + QP;
  float* fac = dts + QP;
  T* Xs = reinterpret_cast<T*>(fac + QP);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long gh = blockIdx.x;
  const long long gi = gh / H;
  const int h = (int)(gh - gi * H);
  const int p0 = blockIdx.y * TP;
  const T* Bg = Bm + gi * Q * (long long)N;
  const T* Cg = Cm + gi * Q * (long long)N;
  const int steps = (N + NC - 1) / NC;
  auto issue = [&](int k) {  // step k's B and C into its ring slot
    if (k < steps) {
      T* st = ring + (k % STAGES) * L::STAGE;
      stage(st, LDB, Bg + k * NC, N, QP, NC, Q, N - k * NC, vec_bc);
      stage(st + QP * LDB, LDC, Cg + k * NC, N, QP, NC, Q, N - k * NC,
            vec_bc);
    }
    cp_commit();
  };

  stage(Xs, LDX, x + (gi * Q * H + h) * (long long)P + p0, (long long)H * P,
        QP, TP, Q, P - p0, vec_x);
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  const float a_end = a_cum[(gi * Q + Q - 1) * H + h];
  for (int j = threadIdx.x; j < QP; j += THREADS) {
    const long long o = (gi * Q + j) * H + h;
    const bool in = j < Q;
    const float aj = in ? a_cum[o] : 0.0f, dj = in ? dt[o] : 0.0f;
    as[j] = aj;
    dts[j] = dj;
    fac[j] = in ? dj * expf(a_end - aj) : 0.0f;
  }

  // score blocks, warp w takes w, w + 8, ..: row tile sr, first column
  // tile sc
  int sr[SC_PER_WARP], sc[SC_PER_WARP];
  constexpr int SCT = QP < 32 ? 2 : 4;  // tiles of a block computed
  float sacc[SC_PER_WARP][SCT][4], ssmall[SC_PER_WARP][SCT][4];
#pragma unroll
  for (int k = 0; k < SC_PER_WARP; ++k) {
    int b = warp + WARPS * k, r = 0;
    while (b >= r / 2 + 1) b -= r++ / 2 + 1;
    sr[k] = warp + WARPS * k < SC_BLOCKS ? r : -1;
    sc[k] = 4 * b;
#pragma unroll
    for (int c = 0; c < SCT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[k][c][e] = ssmall[k][c][e] = 0.0f;
    }
  }
  // states tiles (16 x 8) of a step: warp w takes 16-row tile w % 4 of the
  // P tile and column tiles 2 (w / 4), + 1 of each 32 columns
  const int smt = warp & 3, snt = 2 * (warp >> 2);
  const bool st_live = smt < min(4, (P - p0 + 15) / 16);
  cp_wait<STAGES - 2>();  // x and step 0
  __syncthreads();

  float* Sg = states + gh * (long long)P * N;
  for (int k = 0; k < steps; ++k) {
    const int n0 = k * NC;
    cp_wait<STAGES - 2>();  // step k has landed
    __syncthreads();        // and every warp is done with step k - 1
    issue(k + STAGES - 1);  // into step k - 1's slot
    const T* Bst = ring + (k % STAGES) * L::STAGE;
    const T* Cst = Bst + QP * LDB;
    // (1) scores += C B^T over this step's columns (zeros past N): the
    // whole 16 x 32 block, its tiles past the diagonal unused, so the loop
    // has no branch and its loads issue ahead (QP = 16: two tiles)
#pragma unroll
    for (int kk = 0; kk < NC / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < SC_PER_WARP; ++j) {
        if (sr[j] < 0) continue;
        FragA a;
        FragB b[SCT];
        load_a_rows<EX>(a, Cst + 16 * sr[j] * LDC + 8 * kk, LDC, g, t);
#pragma unroll
        for (int c = 0; c < SCT; ++c) {
          load_b_cols<EX>(b[c], Bst + 8 * (sc[j] + c) * LDB + 8 * kk, LDB, g,
                          t);
        }
        mma3<EX, EX, SCT>(sacc[j], ssmall[j], a, b);
      }
    }
    // (2) states[p0 + 16 mt.., n0 + 8 nt..] = (x fac)^T B: the warp's
    // four tiles of the step side by side
    if (st_live) {
      constexpr int ST = NC / 16;  // tiles of a warp
      float acc[ST][4], small[ST][4];
#pragma unroll
      for (int c = 0; c < ST; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = small[c][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < QP / 8; ++kk) {
        FragA a;
        FragB b[ST];
        load_a_xfac(a, Xs + 8 * kk * LDX + 16 * smt, LDX, fac + 8 * kk, g, t);
#pragma unroll
        for (int c = 0; c < ST; ++c) {
          const int nt = 4 * (c >> 1) + snt + (c & 1);
          load_b_rows<EX>(b[c], Bst + 8 * kk * LDB + 8 * nt, LDB, g, t);
        }
        mma3<false, EX, ST>(acc, small, a, b);
      }
#pragma unroll
      for (int c = 0; c < ST; ++c) {
        const int n = n0 + 8 * (4 * (c >> 1) + snt + (c & 1)) + 2 * t;
        if (n >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + 16 * smt + g + 8 * half;
          if (p >= P) continue;
          float* dst = Sg + (long long)p * N + n;
          const float v0 = acc[c][2 * half] + small[c][2 * half];
          const float v1 = acc[c][2 * half + 1] + small[c][2 * half + 1];
          if (n + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < N) dst[1] = v1;
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for W

  // W[i][j] = scores (j <= i < Q) exp(a_i - a_j) dt_j, else 0, over the
  // tiles y reads (j < 16 (r + 1) for row tile r)
#pragma unroll
  for (int k = 0; k < SC_PER_WARP; ++k) {
    if (sr[k] < 0) continue;
#pragma unroll
    for (int c = 0; c < SCT; ++c) {
      if (sc[k] + c > 2 * sr[k] + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * sr[k] + g + (e >= 2 ? 8 : 0);
        const int j = 8 * (sc[k] + c) + 2 * t + (e & 1);
        Ws[i * LDW + j] =
            (j <= i && i < Q)
                ? (sacc[k][c][e] + ssmall[k][c][e]) * expf(as[i] - as[j]) *
                      dts[j]
                : 0.0f;
      }
    }
  }
  __syncthreads();

  // y[i][p0 + p] = sum_{j <= i} W[i][j] x[j][p]: warp (r, yb) owns row tile
  // r and the RT column tiles yb.. (8 / RT warps a row tile)
  const int r = warp % RT, yb = (warp / RT) * RT;
  if (16 * r >= Q) return;
  float acc[RT][4] = {}, small[RT][4] = {};
  for (int kk = 0; kk <= 2 * r + 1; ++kk) {
    FragA a;
    FragB b[RT];
    load_a_rows<false>(a, Ws + 16 * r * LDW + 8 * kk, LDW, g, t);
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      load_b_rows<EX>(b[c], Xs + 8 * kk * LDX + 8 * (yb + c), LDX, g, t);
    }
    mma3<false, EX, RT>(acc, small, a, b);
  }
#pragma unroll
  for (int c = 0; c < RT; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * r + g + (e >= 2 ? 8 : 0);
      const int p = p0 + 8 * (yb + c) + 2 * t + (e & 1);
      if (i < Q && p < P) {
        y[((gi * Q + i) * H + h) * (long long)P + p] =
            from_f<T>(acc[c][e] + small[c][e]);
      }
    }
  }
}

// four consecutive B values from global memory (aligned to four when vec)
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xFFFF0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xFFFF0000u));
  }
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

// decode route (Q < TC_Q): grid (G H, P tiles of TPD), THREADS threads
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_cum, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y,
                  float* __restrict__ states, int Q, int H, int P, int N,
                  int vec) {
  constexpr int QD = TC_Q - 1;
  __shared__ float xs[QD][TPD], xf[QD][TPD], W[QD][QD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gh = blockIdx.x;
  const long long gi = gh / H;
  const int h = (int)(gh - gi * H);
  const int p0 = blockIdx.y * TPD;
  const int np = min(TPD, P - p0);
  const float a_end = a_cum[(gi * Q + Q - 1) * H + h];
  for (int e = threadIdx.x; e < Q * TPD; e += THREADS) {
    const int j = e / TPD, p = e - j * TPD;
    const long long o = (gi * Q + j) * H + h;
    const float v = p < np ? to_f(x[o * (long long)P + p0 + p]) : 0.0f;
    xs[j][p] = v;
    xf[j][p] = v * (dt[o] * expf(a_end - a_cum[o]));
  }
  const T* Bg = Bm + gi * Q * (long long)N;
  const T* Cg = Cm + gi * Q * (long long)N;
  // scores: one warp a causal pair (i, j), lanes along N
  const int pairs = Q * (Q + 1) / 2;
  for (int k = warp; k < pairs; k += WARPS) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= k) ++i;
    const int j = k - i * (i + 1) / 2;
    const T* ci = Cg + (long long)i * N;
    const T* bj = Bg + (long long)j * N;
    float s = 0.0f;
    for (int n = lane; n < N; n += 32) s = fmaf(to_f(ci[n]), to_f(bj[n]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const long long oi = (gi * Q + i) * H + h, oj = (gi * Q + j) * H + h;
      W[i][j] = s * expf(a_cum[oi] - a_cum[oj]) * dt[oj];
    }
  }
  __syncthreads();
  // states[p0 + p][n..n + 3] = sum_j xf[j][p] B[j][n..n + 3]
  float* Sg = states + (gh * P + p0) * (long long)N;
  const int nq = (N + 3) / 4;
  for (int e = threadIdx.x; e < np * nq; e += THREADS) {
    const int p = e / nq, n = 4 * (e - p * nq);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vec || n + 4 <= N) {
      for (int j = 0; j < Q; ++j) {
        const float w = xf[j][p];
        const float4 b = load4(Bg + (long long)j * N + n, vec);
        acc.x = fmaf(w, b.x, acc.x);
        acc.y = fmaf(w, b.y, acc.y);
        acc.z = fmaf(w, b.z, acc.z);
        acc.w = fmaf(w, b.w, acc.w);
      }
    } else {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < Q; ++j) {
        for (int q = 0; n + q < N; ++q) {
          v[q] = fmaf(xf[j][p], to_f(Bg[(long long)j * N + n + q]), v[q]);
        }
      }
      acc = make_float4(v[0], v[1], v[2], v[3]);
    }
    float* dst = Sg + (long long)p * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int q = 0; q < 4 && n + q < N; ++q) dst[q] = v[q];
    }
  }
  for (int e = threadIdx.x; e < Q * np; e += THREADS) {
    const int i = e / np, p = e - i * np;
    float acc = 0.0f;
    for (int j = 0; j <= i; ++j) acc = fmaf(W[i][j], xs[j][p], acc);
    y[((gi * Q + i) * H + h) * (long long)P + p0 + p] = from_f<T>(acc);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int QP>
int launch_chunk(const T* x, const float* dt, const float* a_cum,
                 const T* Bm, const T* Cm, T* y, float* states, long long G,
                 int Q, int H, int P, int N, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr size_t smem = ChunkSmem<T, QP>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_x = P % V == 0 && aligned16(x);
  const int vec_bc = N % V == 0 && aligned16(Bm) && aligned16(Cm);
  const dim3 grid((unsigned)(G * H), (unsigned)((P + TP - 1) / TP));
  ssd_chunk_kernel<T, QP><<<grid, THREADS, smem, s>>>(
      x, dt, a_cum, Bm, Cm, y, states, Q, H, P, N, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_cum, const void* Bm,
           const void* Cm, void* y, void* states, long long G, int Q, int H,
           int P, int N, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_cum);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  T* yt = static_cast<T*>(y);
  float* st = static_cast<float*>(states);
  if (Q < TC_Q) {
    const dim3 grid((unsigned)(G * H), (unsigned)((P + TPD - 1) / TPD));
    const int vec = N % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(Bm) % (4 * sizeof(T)) == 0 &&
                    aligned16(states);
    ssd_decode_kernel<T><<<grid, THREADS, 0, s>>>(xt, dtf, af, Bt, Ct, yt,
                                                  st, Q, H, P, N, vec);
    return (int)cudaGetLastError();
  }
  if (Q <= 16)
    return launch_chunk<T, 16>(xt, dtf, af, Bt, Ct, yt, st, G, Q, H, P, N, s);
  if (Q <= 32)
    return launch_chunk<T, 32>(xt, dtf, af, Bt, Ct, yt, st, G, Q, H, P, N, s);
  if (Q <= 64)
    return launch_chunk<T, 64>(xt, dtf, af, Bt, Ct, yt, st, G, Q, H, P, N, s);
  return launch_chunk<T, 128>(xt, dtf, af, Bt, Ct, yt, st, G, Q, H, P, N, s);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, Bm, Cm, y).  1 <= Q <= 128; G H < 2^31; P tiles
// < 65536.  One kernel launch on `stream`.
extern "C" int ssd_intra_chunk_fwd(int dtype, const void* x, const void* dt,
                                   const void* a_cum, const void* Bm,
                                   const void* Cm, void* y, void* states,
                                   long long G, int Q, int H, int P, int N,
                                   void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_cum, Bm, Cm, y, states, G, Q, H, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_cum, Bm, Cm, y, states, G, Q, H, P,
                                 N, s);
  return (int)cudaErrorInvalidValue;
}
