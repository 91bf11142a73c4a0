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
// Work split.  f32: one block per (q tile of 64 rows, batch x head),
// blocks with the longest causal span issued first.  bf16: a persistent
// grid (one block an SM) walks the (q tile of 128 rows, batch x head)
// items longest span first, in rounds that alternate direction.  Either
// walks the key tiles its rows can see: with `causal`, tiles wholly above
// the diagonal are skipped; with `window`, tiles wholly behind the window
// (as the TPU kernel skips them at flash_attention.py:60-66).  Any hd that
// is a multiple of 8 up to 128 is taken (stablelm-3b's 80 among them); any
// S >= 1: query rows and keys past S read as zeros, keys past S are
// masked, rows past S are not written.
//
// Masking.  A masked score is -1e30 (the TPU kernel's NEG_INF) and its
// probability is exactly 0, so a row whose keys in a tile are all masked
// keeps a finite running max and adds nothing.  With causal masking every
// row sees its diagonal; without it, a window still leaves the diagonal,
// so no row ends empty.  bf16 masks only the tiles that cross the
// diagonal, the window's edge or S.
//
// What bounds it on an H100.  At the serve path's prefill shape (1, 2000,
// 32, 80) bf16 the kernel reads q, k, v once (41 MB with o written) and
// does 4 hd per unmasked (query, key) pair, 20.49 GFLOP: at the bf16
// tensor cores' 989 TFLOP/s that is 0.0207 ms, above the bytes' 0.0122 ms,
// so it is bound by operations on the tensor cores.  Beside the products,
// each score costs an exp2 on the special-function units (16 a clock an
// SM, about as long as the products at hd = 80) and K and V cross from L2
// into every block that uses them (131 FLOP a byte at 128 query rows a
// block).  Two code paths:
//   * float32 (flash_fwd_kernel): f32 FMAs on the CUDA cores (67 TFLOP/s
//     peak), everything in f32, 64 query rows and 64 keys a tile.  256
//     threads; Q, K and V tiles in shared memory as f32 (Q and K
//     transposed, so a thread reads four rows or four keys as one float4).
//     Thread t owns query rows 4 (t / 16) .. +3 against keys 4 (t % 16) ..
//     +3; the sixteen threads of a row group reduce the row max and sum
//     with shuffles; the probabilities go through shared memory to P V,
//     where the thread accumulates its rows at head columns t % 16 + 16 j
//     (j < NJ = ceil(hd / 16)).
//   * bfloat16 (flash_fwd_wgmma_kernel), built so the tensor cores, the
//     exp2s and the copies overlap:
//       - 384 threads: warpgroup 0 is the producer (setmaxnreg 24);
//         warpgroups 1 and 2 are consumers of 64 query rows each
//         (setmaxnreg 240).  One producer thread issues every copy with
//         the Tensor Memory Accelerator (TMA): an item's Q tile once, K and
//         V tiles of 128 keys into a ring of kStages stages, each guarded
//         by a "full" mbarrier (the copies' transaction bytes) and an
//         "empty" one (one arrival a consumer warp); it runs ahead into the
//         next item while the consumers finish the last.
//       - TMA layout: CUtensorMaps built on the host for every call, 4-D
//         over (hd, H, S, B), so rows past S and columns past hd read as
//         zeros (the ragged tail of S = 2000 and the padding of hd need no
//         code).  Q and K: 64-column boxes with the 128-byte swizzle, then
//         16-column boxes with the 32-byte swizzle for the rest (hd = 80:
//         one of each, two copies a row); V: 16-column boxes only (see
//         tile_bytes).  Each tile is a canonical wgmma layout.
//       - S = Q K^T: wgmma m64n128k16, Q and K K-major from shared memory,
//         ceil(hd / 16) k-steps (5 at hd = 80), scores in f32 registers.
//       - Softmax in registers: the row max of the raw scores, exp2 of
//         (s - max) log2(e) / sqrt(hd) by one FFMA and ex2.approx; the
//         running sum l kept per thread from the f32 probabilities and
//         summed over the row's four threads at the end.  The
//         probabilities are rounded to bf16 in place: the m64n128
//         accumulator's layout is the register A-fragment layout of the
//         next product.
//       - O += P V: one wgmma m64nNk16 a k-step of 16 keys, N = 16
//         ceil(hd / 16) (n80 at hd = 80), P from registers and V MN-major
//         from shared memory (the transpose flag), so no transposed copy of
//         V is made.
//       - Overlap: in each warpgroup Q K^T of tile t is issued with P V of
//         tile t - 1, whose product runs during the softmax of t; the two
//         warpgroups take turns to issue (named barriers 1 and 2), so one's
//         softmax runs while the other's products are on the tensor cores.
//       - Causal and window inside a 128-row item: the producer loads the
//         union of the two warpgroups' tiles; a warpgroup skips a tile it
//         cannot see (it waits for it and releases it).
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() so a refused launch reaches the Python wrapper.

#include <cuda.h>
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

// ---- bfloat16: TMA, an mbarrier ring and wgmma ---------------------------

constexpr int kBQW = 128;        // query rows an item: two warpgroups of 64
constexpr int kBKW = 128;        // keys a tile
constexpr int kStages = 3;       // K and V tiles in flight
constexpr int kThreadsW = 384;   // producer warpgroup + two consumers
// arrivals that free a stage or the Q tile: one a consumer warp
constexpr int kReleases = 8;
constexpr int kWide = 64;        // head columns of a wide box (128 bytes)
constexpr int kNarrow = 16;      // head columns of a narrow box (32 bytes)
constexpr int kWideBox = 128 * 128;   // bytes of a 128-row wide box
constexpr int kNarrowBox = 128 * 32;  // bytes of a 128-row narrow box
constexpr uint32_t kSwizzle128 = 1, kSwizzle32 = 3;  // descriptor modes

static_assert(kBQW == 128 && kBKW == 128, "one 128-row box for Q, K and V");

// two floats as one bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (a result below 2^-126 flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// named barriers 1 and 2 between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait of seconds means a broken ring: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if ((spin & 1023u) == 0 && clock64() - start > (8LL << 30)) {
      __trap();
    }
  }
}

// one box of a (hd, H, S, B) tensor map into shared memory, completion
// reported to `bar` as transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(h),
      "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes at this point
// of the program, so the compiler neither reads an accumulator before the
// wait nor reuses an operand's register while the product runs.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

// S (+)= Q K^T: m64n128k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V: m64nNk16 with N = 16 NK, A (P) from registers, B (V)
// MN-major in shared memory (transposed)
template <int NK>
__device__ __forceinline__ void wgmma_pv(float (&d)[8 * NK],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<1>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<2>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<3>(float (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<4>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<5>(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<6>(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<7>(float (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<8>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online softmax of one 64 x 128 score tile, in place: sc holds this
// thread's raw scores (rows row[0], row[1], keys k0 + 8 j + 2 t + e at
// sc[4 j + 2 half + e]) and leaves their f32 probabilities, exp2((s - m)
// log2(e) / sqrt(hd)); m and l are the rows' running max (raw) and this
// thread's part of the running sum; alpha is the factor by which the
// accumulator is to be rescaled.  MASK: the tile crosses the diagonal, the
// window's edge or S.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const int (&row)[2], int k0,
                                             int t, int S, int causal,
                                             int window, float scale_log2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * half + e];
        if (MASK) {
          const int kpos = k0 + 8 * j + 2 * t + e;
          const bool seen = kpos < S && (!causal || kpos <= row[half]) &&
                            (window <= 0 || kpos > row[half] - window);
          x = seen ? x : kNegInf;
        }
        tmax = fmaxf(tmax, x);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[half], tmax);
    alpha[half] = fast_exp2((m[half] - m_new) * scale_log2);
    // a row with every key so far masked: its masked scores give exactly 0
    const float shift = m_new == kNegInf ? 0.0f : -m_new * scale_log2;
    float rsum = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * half + e];
        x = fast_exp2(fmaf(x, scale_log2, shift));
        rsum += x;
      }
    }
    l[half] = alpha[half] * l[half] + rsum;
    m[half] = m_new;
  }
}

// The key tiles [lo, hi) that rows r0 .. r0 + 63 (those below S) can see;
// lo = hi when none of the rows is below S.
__device__ __forceinline__ void tile_range(int r0, int S, int causal,
                                           int window, int& lo, int& hi) {
  if (r0 >= S) {
    lo = hi = 0;
    return;
  }
  const int nk = (S + kBKW - 1) / kBKW;
  const int last = min(r0 + 63, S - 1);
  hi = causal ? min(nk, last / kBKW + 1) : nk;
  lo = window > 0 ? max(0, r0 - window + 1) / kBKW : 0;
}

// The tensor maps of a call, all with 128-row boxes: q and k through wide
// boxes (64 columns, 128-byte swizzle); q, k and v through narrow boxes
// (16 columns, 32-byte swizzle).
struct TensorMaps {
  CUtensorMap wide[2], narrow[3];
};

// A 128-row tile in shared memory.  Q and K: NF = hd / 64 wide boxes (head
// columns 64 f .. 64 f + 63), then NT = ceil((hd - 64 NF) / 16) narrow
// ones (columns 64 NF + 16 c ..): hd = 80 is one wide and one narrow box,
// two copies a row, and each k16 step of Q K^T lies in one box.  V: 4 NF +
// NT narrow boxes, the same bytes, so that P V is one m64nNk16 with N = 16
// (4 NF + NT) (n80 at hd = 80) over one canonical MN-major layout.
template <int NF, int NT>
__host__ __device__ constexpr int tile_bytes() {
  return NF * kWideBox + NT * kNarrowBox;
}

// Shared memory from a 1024-byte aligned base: the Q tile, kStages K tiles,
// kStages V tiles, then the barriers full[kStages], empty[kStages], q_full,
// q_empty.
template <int NF, int NT>
constexpr size_t smem_bytes_wgmma() {
  return 1024 + (size_t)(1 + 2 * kStages) * tile_bytes<NF, NT>() +
         16 * kStages + 16;
}

// One block of 128 query rows of one (batch, head): which, and the key
// tiles [lo, hi) its two warpgroups' rows see together (wlo/whi: each
// warpgroup's own).
struct WorkItem {
  int b, h, q0, lo, hi, wlo[2], whi[2];
};

// Work item k of this block: a persistent grid walks the (q tile, batch x
// head) items longest causal span first, round k of gridDim.x items in
// one direction, the next round back (so no block gets every round's
// longest), which balances the causal spans as well as a greedy schedule.
__device__ __forceinline__ bool work_item(int k, int S, int H, int BH,
                                          int causal, int window,
                                          WorkItem& it) {
  const int nq = (S + kBQW - 1) / kBQW;
  const int G = gridDim.x;
  const int w = k * G + ((k & 1) ? G - 1 - (int)blockIdx.x
                                 : (int)blockIdx.x);
  if (w >= nq * BH) return false;
  const int qt = nq - 1 - w / BH;
  const int bh = w % BH;
  it.b = bh / H;
  it.h = bh - it.b * H;
  it.q0 = qt * kBQW;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    tile_range(it.q0 + 64 * c, S, causal, window, it.wlo[c], it.whi[c]);
  }
  it.lo = it.wlo[0];
  it.hi = max(it.whi[0], it.whi[1]);
  return true;
}

template <int NF, int NT>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ TensorMaps maps,
                           __nv_bfloat16* __restrict__ o, int B, int S,
                           int H, int hd, int causal, int window,
                           float scale_log2) {
  constexpr int TB = tile_bytes<NF, NT>();
  constexpr int NV = 4 * NF + NT;  // V's narrow boxes; O is 16 NV wide
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t qs = base;
  const uint32_t ks = qs + TB;                 // stage s at + s TB
  const uint32_t vs = ks + kStages * TB;       // likewise
  const uint32_t full = vs + kStages * TB;     // + 8 s
  const uint32_t empty = full + 8 * kStages;   // + 8 s
  const uint32_t q_full = empty + 8 * kStages;
  const uint32_t q_empty = q_full + 8;
  const int BH = B * H;
  const int rounds = ((S + kBQW - 1) / kBQW * BH + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kReleases);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kReleases);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy, running ahead into the next
    // item's tiles while the consumers finish the last one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      WorkItem it;
      // operand x (0 q, 1 k, 2 v), 128 rows from `row`, into `dst`
      auto load_tile = [&](int x, uint32_t dst, uint32_t bar, int row) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          tma_load(dst + f * kWideBox, &maps.wide[x], bar, f * kWide, it.h,
                   row, it.b);
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          tma_load(dst + NF * kWideBox + c * kNarrowBox, &maps.narrow[x], bar,
                   NF * kWide + c * kNarrow, it.h, row, it.b);
        }
      };
      int i = 0, n = 0;  // ring position, items begun
      for (int k = 0; k < rounds; ++k) {
        if (!work_item(k, S, H, BH, causal, window, it)) continue;
        for (int t = it.lo; t < it.hi; ++t, ++i) {
          const int s = i % kStages;
          mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, 2 * TB);
          load_tile(1, ks + s * TB, full + 8 * s, t * kBKW);
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            tma_load(vs + s * TB + c * kNarrowBox, &maps.narrow[2],
                     full + 8 * s, c * kNarrow, it.h, t * kBKW, it.b);
          }
          if (t == it.lo) {
            // Q once the consumers are done with the last item's
            mbar_wait(q_empty, (n & 1) ^ 1);
            mbar_expect_tx(q_full, TB);
            load_tile(0, qs, q_full, it.q0);
          }
        }
        ++n;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // consumer 0 or 1
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    float oacc[8 * NV];  // O, the m64nNk16 accumulator of N = 16 NV
    float m[2], l[2];
    float sc[64];       // the newest tile's scores, then probabilities
    uint32_t pa[8][4];  // bf16 P of the tile whose P V is in flight
    WorkItem it;
    int r0 = 0;

    // S = Q K^T of the tile in stage s, issued.  Both K-major: in a wide
    // box this warpgroup's 64 rows start 8 KB in, 8-row groups 1024 bytes
    // apart (SBO) and the k16 step is 32 bytes along the swizzled row; in
    // a narrow box they start 2 KB in, groups 256 bytes apart, one k16 step
    // a box.
    auto issue_qk = [&](int s) {
      const uint32_t kb = ks + s * TB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NF; ++kk) {
        const uint32_t off = (kk / 4) * kWideBox + (kk % 4) * 32;
        wgmma_qk(sc,
                 smem_desc(qs + off + cw * 64 * 128, 16, 1024, kSwizzle128),
                 smem_desc(kb + off, 16, 1024, kSwizzle128), kk > 0);
      }
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const uint32_t off = NF * kWideBox + c * kNarrowBox;
        wgmma_qk(sc, smem_desc(qs + off + cw * 64 * 32, 16, 256, kSwizzle32),
                 smem_desc(kb + off, 16, 256, kSwizzle32), NF > 0 || c > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s, issued.  V MN-major: 16-column
    // boxes kNarrowBox apart (LBO), 8-key groups 256 bytes apart (SBO), 16
    // keys (512 bytes) a k-step.
    auto issue_pv = [&](int s) {
      const uint32_t vb = vs + s * TB;
      pin(oacc);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        wgmma_pv<NV>(oacc, pa[kq],
                     smem_desc(vb + kq * 512, kNarrowBox, 256, kSwizzle32));
      }
      wgmma_commit();
    };
    // the softmax of tile t in sc; alpha: the rescale of O it asks for
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int k0 = t * kBKW;
      const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
      const bool mask = k0 + kBKW > S || (causal && k0 + kBKW - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 63 - window);
      if (mask) {
        softmax_tile<true>(sc, m, l, alpha, row, k0, t4, S, causal, window,
                           scale_log2);
      } else {
        softmax_tile<false>(sc, m, l, alpha, row, k0, t4, S, causal, window,
                            scale_log2);
      }
    };
    // O *= alpha, then P in bf16 as the A fragments of m64nNk16: k-step kq
    // covers keys 16 kq .. 16 kq + 15, the accumulator's n8 blocks 2 kq and
    // 2 kq + 1
    auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < 2 * NV; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        pa[kq][0] = pack_bf16(sc[8 * kq + 0], sc[8 * kq + 1]);
        pa[kq][1] = pack_bf16(sc[8 * kq + 2], sc[8 * kq + 3]);
        pa[kq][2] = pack_bf16(sc[8 * kq + 4], sc[8 * kq + 5]);
        pa[kq][3] = pack_bf16(sc[8 * kq + 6], sc[8 * kq + 7]);
      }
    };
    auto wait_full = [&](int i) {
      mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    };
    // a stage (or the Q tile) is free once every consumer warp is done
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Ping-pong: the two warpgroups take turns to issue their products, so
    // one's softmax runs while the other's products are on the tensor
    // cores.  Each waits for its turn on barrier 1 + cw and hands the turn
    // on; every item is hi - lo + 1 turns for both (a skipped tile a turn,
    // the last P V one more), so the turns stay matched.
    auto turn = [&]() { bar_sync(1 + cw); };
    auto pass = [&]() { bar_arrive(2 - cw); };
    if (cw == 1) pass();  // warpgroup 0 goes first

    int i = 0, n = 0;  // ring position, items begun
    for (int k = 0; k < rounds; ++k) {
      if (!work_item(k, S, H, BH, causal, window, it)) continue;
      r0 = it.q0 + 64 * cw;
      const int my_lo = it.wlo[cw], my_hi = it.whi[cw];
#pragma unroll
      for (int e = 0; e < 8 * NV; ++e) oacc[e] = 0.0f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full, n & 1);
      // The item's tiles, ring positions from i.  Those outside [my_lo,
      // my_hi) are waited for and released untouched.  Inside, the
      // products are pipelined: Q K^T of tile t and P V of tile t - 1 are
      // issued together, and the softmax of t runs while P V of t - 1 is on
      // the tensor cores.
      const bool any = my_lo < my_hi;
      for (int t = it.lo; t < (any ? my_lo : it.hi); ++t, ++i) {
        wait_full(i);
        turn();
        pass();
        release(empty + 8 * (i % kStages));
      }
      if (any) {
        float alpha[2];
        wait_full(i);
        turn();
        issue_qk(i % kStages);
        pass();
        wgmma_wait<0>();
        pin(sc);
        softmax(my_lo, alpha);
        rescale_and_pack(alpha);
        for (int t = my_lo + 1; t < my_hi; ++t, ++i) {
          wait_full(i + 1);
          turn();
          issue_qk((i + 1) % kStages);
          issue_pv(i % kStages);
          pass();
          wgmma_wait<1>();  // Q K^T of tile t
          pin(sc);
          softmax(t, alpha);
          wgmma_wait<0>();  // P V of tile t - 1
          pin(oacc);
          pin(pa);
          release(empty + 8 * (i % kStages));
          rescale_and_pack(alpha);
        }
        turn();
        issue_pv(i % kStages);
        pass();
        wgmma_wait<0>();
        pin(oacc);
        pin(pa);
        release(empty + 8 * (i % kStages));
        ++i;
      } else {
        turn();  // the turn of the last P V
        pass();
      }
      release(q_empty);
      for (int t = any ? my_hi : it.hi; t < it.hi; ++t, ++i) {
        wait_full(i);
        turn();
        pass();
        release(empty + 8 * (i % kStages));
      }

      const int64_t rs = (int64_t)H * hd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float lt = l[half];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int sr = r0 + 16 * warp + g + 8 * half;
        if (sr >= S) continue;
        const float inv = 1.0f / fmaxf(lt, 1e-30f);
        __nv_bfloat16* orow =
            o + ((int64_t)it.b * S + sr) * rs + (int64_t)it.h * hd;
#pragma unroll
        for (int j = 0; j < 2 * NV; ++j) {
          const int d = 8 * j + 2 * t4;
          if (d < hd) {
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(oacc[4 * j + 2 * half] * inv,
                                      oacc[4 * j + 2 * half + 1] * inv);
          }
        }
      }
      ++n;
    }
    // warpgroup 1's last hand-over is still pending on barrier 1
    if (cw == 0) turn();
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (B, S, H, hd) bf16 as a 4-D map over (hd, H, S, B); boxes of `cols`
// columns by 128 rows; reads out of bounds give zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
              int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NF, int NT>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int hd, int causal,
                         int window, cudaStream_t stream) {
  TensorMaps maps = {};
  const void* ops[3] = {q, k, v};
  for (int x = 0; x < 3; ++x) {
    if ((x < 2 && NF > 0 &&
         !make_map(&maps.wide[x], ops[x], B, S, H, hd, kWide,
                   CU_TENSOR_MAP_SWIZZLE_128B)) ||
        ((x == 2 || NT > 0) &&
         !make_map(&maps.narrow[x], ops[x], B, S, H, hd, kNarrow,
                   CU_TENSOR_MAP_SWIZZLE_32B))) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = smem_bytes_wgmma<NF, NT>();
  auto kernel = flash_fwd_wgmma_kernel<NF, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: one block an SM, or one an item where fewer
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t items = (int64_t)((S + kBQW - 1) / kBQW) * B * H;
  const dim3 grid((unsigned)(items < sms ? items : sms));
  kernel<<<grid, kThreadsW, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), B, S, H, hd, causal, window,
      1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

// hd = 64 NF + 16 NT (the last narrow box part-filled where hd % 16 == 8)
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int hd, int causal,
                          int window, cudaStream_t stream) {
#define FA_LAUNCH(NF, NT) \
  launch_wgmma<NF, NT>(q, k, v, o, B, S, H, hd, causal, window, stream)
  const int nf = hd / kWide, nt = (hd - nf * kWide + kNarrow - 1) / kNarrow;
  switch (nf * 8 + nt) {
    case 1: return FA_LAUNCH(0, 1);
    case 2: return FA_LAUNCH(0, 2);
    case 3: return FA_LAUNCH(0, 3);
    case 4: return FA_LAUNCH(0, 4);
    case 8: return FA_LAUNCH(1, 0);
    case 9: return FA_LAUNCH(1, 1);
    case 10: return FA_LAUNCH(1, 2);
    case 11: return FA_LAUNCH(1, 3);
    case 12: return FA_LAUNCH(1, 4);
    case 16: return FA_LAUNCH(2, 0);
    default: return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
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
          ? dispatch_bf16(q, k, v, o, B, S, H, hd, causal, window, s)
          : cudaErrorInvalidValue;
  return (int)err;
}
