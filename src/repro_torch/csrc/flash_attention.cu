// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// softmax(q k^T / sqrt(hd)) v over (B, S, H, hd) with equal head counts,
// online softmax over key tiles, f32 scores, running max, running sum and
// accumulator, output acc / max(l, 1e-30) in the input dtype.
//
// Replaces:
//   flash_attention_fwd  <- repro/kernels/flash_attention.py::flash_attention
//                           (_flash_kernel, pallas_call at :100)
//
// Layout.  q, k, v and o are contiguous (B, S, H, hd), the layout the
// model's q/k/v projections produce, so nothing is transposed outside the
// kernel: row s of head h starts at ((b S + s) H + h) hd.
//
// Work split (both paths).  One block per (q tile of 64 rows, batch x
// head); blocks with the longest causal span are issued first.  The block
// walks the key tiles of 64 its rows can see: with `causal`, tiles wholly
// above the diagonal are skipped; with `window`, tiles wholly behind the
// window (as the TPU kernel skips them at flash_attention.py:60-66).  Any
// hd that is a multiple of 8 up to 128 is taken (stablelm-3b's 80 among
// them); any S >= 1: query rows and keys past S are zero-filled in shared
// memory, keys past S are masked, rows past S are not written.
//
// Masking.  A masked score is -1e30 (the TPU kernel's NEG_INF) and its
// probability is exactly 0, so a row whose keys in a tile are all masked
// keeps a finite running max and adds nothing.  With causal masking every
// row sees its diagonal; without it, a window still leaves the diagonal,
// so no row ends empty.
//
// What bounds it on an H100.  At the serve path's prefill shape (1, 2000,
// 32, 80) bf16 the kernel reads q, k, v once (41 MB with o written) and
// does 4 hd H S (S + 1) / 2 = 20.5 GFLOP: matmul-shaped work, bound by
// arithmetic.  Two code paths:
//   * float32 (flash_fwd_kernel): f32 FMAs on the CUDA cores (67 TFLOP/s
//     peak), everything in f32.  256 threads; Q, K and V tiles in shared
//     memory as f32 (Q and K transposed, so a thread reads four rows or
//     four keys as one float4).  Thread t owns query rows 4 (t / 16) .. +3
//     against keys 4 (t % 16) .. +3; the sixteen threads of a row group
//     reduce the row max and sum with shuffles; the probabilities go
//     through shared memory to P V, where the thread accumulates its rows
//     at head columns t % 16 + 16 j (j < NJ = ceil(hd / 16)).
//   * bfloat16 (flash_fwd_tc_kernel): the tensor cores through mma.sync
//     m16n8k16 (bf16 in, f32 accumulate).  4 warps, 16 query rows each;
//     Q's fragments stay in registers for the whole key loop; the scores'
//     accumulator fragments become the P operand of P V once rounded to
//     bf16 (as the plain version rounds its probabilities), the running
//     sum l is kept from the f32 probabilities.  hd is padded to a
//     multiple of 16 with zeros in shared memory.  wgmma/TMA tiles are
//     later work.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLDT = kBQ + 4;  // row stride (floats) of the transposed tiles
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

// max / sum over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

size_t smem_bytes(int hd) {
  // qT, kT: [hd][kLDT]; vs: [kBK][hd]; pT: [kBK][kLDT]
  return sizeof(float) * ((size_t)2 * hd * kLDT + (size_t)kBK * hd +
                          (size_t)kBK * kLDT);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S,
                     int H, int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + hd * kLDT;
  float* vs = kT + hd * kLDT;
  float* pT = vs + kBK * hd;

  const int nq = (S + kBQ - 1) / kBQ;
  const int BH = gridDim.x / nq;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // longest span first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - b * H;
  const int64_t rs = (int64_t)H * hd;  // stride of one sequence position
  const int64_t base = (int64_t)b * S * rs + (int64_t)h * hd;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;  // this thread's 4 query rows
  const int cg = tid & 15;        // its key group / head-column lane

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    qT[d * kLDT + r] = s < S ? q[base + s * rs + d] : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (S + kBK - 1) / kBK;
  const int q_end = min(q0 + kBQ, S);  // one past this tile's last row
  const int hi = causal ? min(nk, (q_end + kBK - 1) / kBK) : nk;
  const int first_key = window > 0 ? q0 - window + 1 : 0;
  const int lo = first_key > 0 ? first_key / kBK : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's kT, vs and pT are read
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int s = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (s < S) {
        kx = k[base + s * rs + d];
        vx = v[base + s * rs + d];
      }
      kT[d * kLDT + r] = kx;
      vs[r * hd + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * kLDT + r0);
      const float4 ka =
          *reinterpret_cast<const float4*>(kT + d * kLDT + cg * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg * 4 + j;
        ok[j] = kpos < S && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        rsum += p[i][j];
      }
      l[i] = alpha * l[i] + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (cg * 4 + j) * kLDT + r0) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + c * kLDT + r0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < hd) {
          const float vx = vs[c * hd + d];
          acc[0][j] = fmaf(pa.x, vx, acc[0][j]);
          acc[1][j] = fmaf(pa.y, vx, acc[1][j]);
          acc[2][j] = fmaf(pa.z, vx, acc[2][j]);
          acc[3][j] = fmaf(pa.w, vx, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < hd) o[base + s * rs + d] = acc[i][j] / denom;
    }
  }
}

// ---- bfloat16 on the tensor cores --------------------------------------

constexpr int kWarpsTC = 4;              // 16 query rows a warp
constexpr int kThreadsTC = 32 * kWarpsTC;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int NK>  // NK = hd padded to 16, over 16
size_t smem_bytes_tc() {
  constexpr int HDP = 16 * NK, LDK = HDP + 8, LDV = kBK + 8;
  return sizeof(__nv_bfloat16) * ((size_t)2 * kBQ * LDK + (size_t)HDP * LDV);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                a3 = (g+8, 2t+8..);
//   B (16 x 8):  b0 = (2t..2t+1, g), b1 = (2t+8.., g);
//   C (16 x 8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// For S = Q K^T, B[d][key] = K[key][d]: K row-major in shared memory gives
// each b register as one 32-bit load.  For O = P V, B[key][d] = V[key][d]:
// V is staged transposed (vt[d][key]) for the same reason.
template <int NK>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int S, int H, int hd,
                        int causal, int window, float scale) {
  constexpr int HDP = 16 * NK;
  constexpr int LDK = HDP + 8;  // bf16 row stride of the Q and K tiles
  constexpr int LDV = kBK + 8;  // bf16 row stride of the transposed V tile
  constexpr int NT = kBK / 8;   // key n-tiles of the score block
  constexpr int CH = HDP / 8;   // 16-byte chunks of a padded row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + kBQ * LDK;
  __nv_bfloat16* vt = ks + kBK * LDK;

  const int nq = (S + kBQ - 1) / kBQ;
  const int BH = gridDim.x / nq;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // longest span first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - b * H;
  const int64_t rs = (int64_t)H * hd;
  const int64_t base = (int64_t)b * S * rs + (int64_t)h * hd;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // Q tile, rows past S and columns past hd zero (16-byte chunks: hd, the
  // head offset and the row stride are multiples of 8 elements)
  for (int i = tid; i < kBQ * CH; i += kThreadsTC) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int s = q0 + r;
    *reinterpret_cast<uint4*>(qs + r * LDK + c) =
        (s < S && c < hd)
            ? *reinterpret_cast<const uint4*>(q + base + s * rs + c)
            : zero4;
  }
  __syncthreads();
  const int qr = warp * 16 + g;  // this thread's rows qr and qr + 8
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = lds32(qs + qr * LDK + c);
    qf[kk][1] = lds32(qs + (qr + 8) * LDK + c);
    qf[kk][2] = lds32(qs + qr * LDK + c + 8);
    qf[kk][3] = lds32(qs + (qr + 8) * LDK + c + 8);
  }

  float oacc[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  const int nk = (S + kBK - 1) / kBK;
  const int q_end = min(q0 + kBQ, S);
  const int hi = causal ? min(nk, (q_end + kBK - 1) / kBK) : nk;
  const int first_key = window > 0 ? q0 - window + 1 : 0;
  const int lo = first_key > 0 ? first_key / kBK : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's ks and vt are read
    for (int i = tid; i < kBK * CH; i += kThreadsTC) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const int s = k0 + r;
      uint4 kx = zero4, vx = zero4;
      if (s < S && c < hd) {
        kx = *reinterpret_cast<const uint4*>(k + base + s * rs + c);
        vx = *reinterpret_cast<const uint4*>(v + base + s * rs + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LDK + c) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q0 + qr + 8 * half;
      uint32_t ok = 0;  // bit 2 nt + j: key nt * 8 + 2 t + j is seen
      float tmax = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + nt * 8 + 2 * t + j;
          const bool seen = kpos < S && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          float& x = sc[nt][2 * half + j];
          x = seen ? x * scale : kNegInf;
          ok |= (uint32_t)seen << (2 * nt + j);
          tmax = fmaxf(tmax, x);
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);
      const float alpha = expf(m[half] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sc[nt][2 * half + j];
          x = (ok >> (2 * nt + j)) & 1u ? expf(x - m_new) : 0.0f;
          rsum += x;
        }
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[half] = alpha * l[half] + rsum;
      m[half] = m_new;
#pragma unroll
      for (int dt = 0; dt < 2 * NK; ++dt) {
        oacc[dt][2 * half] *= alpha;
        oacc[dt][2 * half + 1] *= alpha;
      }
    }

#pragma unroll
    for (int ks16 = 0; ks16 < kBK / 16; ++ks16) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * ks16][0], sc[2 * ks16][1]),
          pack_bf16(sc[2 * ks16][2], sc[2 * ks16][3]),
          pack_bf16(sc[2 * ks16 + 1][0], sc[2 * ks16 + 1][1]),
          pack_bf16(sc[2 * ks16 + 1][2], sc[2 * ks16 + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 2 * NK; ++dt) {
        if (dt * 8 < hd) {
          const __nv_bfloat16* vr = vt + (dt * 8 + g) * LDV + ks16 * 16 + 2 * t;
          mma_bf16(oacc[dt], pa, lds32(vr), lds32(vr + 8));
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + qr + 8 * half;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < 2 * NK; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (d < hd) {
        *reinterpret_cast<__nv_bfloat162*>(o + base + s * rs + d) =
            __floats2bfloat162_rn(oacc[dt][2 * half] * inv,
                                  oacc[dt][2 * half + 1] * inv);
      }
    }
  }
}

template <int NK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int hd, int causal, int window,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes_tc<NK>();
  auto kernel = flash_fwd_tc_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)((int64_t)nq * B * H));
  kernel<<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, hd, causal, window, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int hd, int causal, int window,
                        cudaStream_t stream) {
  switch ((hd + 15) / 16) {
    case 1: return launch_tc<1>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 2: return launch_tc<2>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 3: return launch_tc<3>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 4: return launch_tc<4>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 5: return launch_tc<5>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 6: return launch_tc<6>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 7: return launch_tc<7>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 8: return launch_tc<8>(q, k, v, o, B, S, H, hd, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- float32 on the CUDA cores ------------------------------------------

template <int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int hd, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_fwd_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)((int64_t)nq * B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, hd, causal,
      window, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int hd, int causal, int window,
                         cudaStream_t stream) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 2: return launch<2>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 3: return launch<3>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 4: return launch<4>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 5: return launch<5>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 6: return launch<6>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 7: return launch<7>(q, k, v, o, B, S, H, hd, causal, window, stream);
    case 8: return launch<8>(q, k, v, o, B, S, H, hd, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int hd, int causal, int window,
                                   void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 8 || hd > kMaxHd || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch_f32(q, k, v, o, B, S, H, hd, causal, window, s)
      : dtype == 1
          ? dispatch_tc(q, k, v, o, B, S, H, hd, causal, window, s)
          : cudaErrorInvalidValue;
  return (int)err;
}
