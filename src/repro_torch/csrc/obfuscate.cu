// Gradient-obfuscation kernels for Hopper (sm_90a): the self term of the
// paper's Eq. (3),
//
//     v = w_self * x - b_self * (lambda o g),
//     lambda = 2 lam_bar * (bitcast((bits >> 9) | 0x3F800000) - 1)   in f32,
//
// cast to x's dtype.  The PDSGD step calls it with w_self = 0, b_self = -1,
// which gives u = Lambda o g.
//
// Replaces:
//   obfuscate_update       <- repro/kernels/obfuscate.py::obfuscate_update
//                             (_obfuscate_kernel, pallas_call at :85);
//                             the bits are an input.
//   obfuscate_update_krng  <- repro/kernels/obfuscate.py::obfuscate_update_krng
//                             (_obfuscate_krng_kernel, pallas_call at :153);
//                             the bits are drawn in the kernel.
//
// What bounds them on an H100.  obfuscate_update is an elementwise pass that
// moves 10 B per bf16 element (x, g, bits in; v out) and does 5 float
// operations on it: device memory bounds it.  Each thread takes 8
// consecutive elements with 16-byte vector loads when the pointers allow it.
// obfuscate_update_krng moves 6 B per bf16 element but runs the 20-round
// Threefry-2x32 cipher (about 100 integer operations) for each one, so the
// integer units bound it rather than memory.  The rotations use the funnel
// shifter (one instruction each).
//
// In-kernel randomness.  The TPU kernel re-seeds the TPU's own generator per
// tile, a stream no other device reproduces.  Here the kernel runs
// threefry2x32 (threefry.cuh) exactly as jax.random.bits does under
// jax_threefry_partitionable: row a, column c of leaf l (columns
// [off[l], off[l+1]) of every row) is
//     x0 ^ x1 of threefry2x32(key[a, l], (hi(c - off[l]), lo(c - off[l]))),
// with key[a, l] the per-(agent, leaf) key the caller derives from the step's
// Lambda key.  Columns past off[n_leaves] (padding) get bits 0.  The realized
// Lambda is therefore bit-identical to the reference's counter stream, and
// the main path needs no bits buffer at all (the optional bits output is for
// the parity check only).  With original != 0 the words follow jax's earlier
// stream instead (jax_threefry_partitionable=False, threefry_bits_original
// over the leaf's n = off[l+1] - off[l] words), a second instantiation of
// the kernel.
//
// Bitwise parity with the plain PyTorch version.  The math is written with
// __fmul_rn / __fsub_rn, which nvcc never contracts into FMAs, so every
// product and difference is rounded once, as PyTorch's eager ops round them.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kMaxLeaves = 1024;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 elements of T as one aligned vector (two 16-byte words for f32, one for
// bf16).
template <typename T>
struct alignas(sizeof(T) * kVec) Vec8 {
  T v[kVec];
};

struct alignas(32) Bits8 {
  uint32_t v[kVec];
};

__device__ __forceinline__ float obf_math(float x, float g, uint32_t bits,
                                          float lam2, float w_self,
                                          float b_self) {
  float u01 = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  float lam = __fmul_rn(lam2, u01);
  return __fsub_rn(__fmul_rn(w_self, x), __fmul_rn(b_self, __fmul_rn(lam, g)));
}

// scal = [lam_bar, w_self, b_self] in device memory: the step never has to
// bring lam_bar to the host.  x and g carry no __restrict__: the step writes
// u over g in place (each thread reads its 8 elements before it writes them).
// Row blockIdx.y of n columns, rows ld elements apart (one leaf's columns of
// the flat buffers in the leafwise layout); columns [head, head + 8 body)
// go 8 at a time with vector loads, the rest one at a time.
template <typename T>
__global__ void obfuscate_kernel(const T* x, const T* g,
                                 const uint32_t* __restrict__ bits,
                                 const float* __restrict__ scal,
                                 T* out, int64_t n, int64_t ld,
                                 int64_t head) {
  const int64_t r = (int64_t)blockIdx.y * ld;
  x += r;
  g += r;
  bits += r;
  out += r;
  const float lam2 = __fmul_rn(2.0f, scal[0]);
  const float w_self = scal[1], b_self = scal[2];
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t body = (n - head) / kVec;
  for (int64_t i = tid; i < body; i += stride) {
    const int64_t c = head + i * kVec;
    Vec8<T> xv = *reinterpret_cast<const Vec8<T>*>(x + c);
    Vec8<T> gv = *reinterpret_cast<const Vec8<T>*>(g + c);
    Bits8 bv = *reinterpret_cast<const Bits8*>(bits + c);
    Vec8<T> ov;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      store_f(&ov.v[k], obf_math(load_f(&xv.v[k]), load_f(&gv.v[k]),
                                 bv.v[k], lam2, w_self, b_self));
    }
    *reinterpret_cast<Vec8<T>*>(out + c) = ov;
  }
  const int64_t tail0 = head + body * kVec;
  for (int64_t t = tid; t < head + n - tail0; t += stride) {
    const int64_t i = t < head ? t : tail0 + (t - head);
    store_f(&out[i], obf_math(load_f(&x[i]), load_f(&g[i]), bits[i], lam2,
                              w_self, b_self));
  }
}

// One thread per 8 consecutive columns of one row (cols % 8 == 0, so the 8
// never straddle rows).  Leaf offsets live in shared memory; a thread finds
// the leaf of its first column by binary search and walks forward across a
// boundary inside its 8.
template <typename T, bool kOriginal>
__global__ void obfuscate_krng_kernel(const T* x, const T* g,
                                      const uint32_t* __restrict__ keys,
                                      const int64_t* __restrict__ offsets,
                                      int n_leaves, int64_t rows,
                                      int64_t cols,
                                      const float* __restrict__ scal,
                                      T* out, uint32_t* bits_out) {
  __shared__ int64_t off[kMaxLeaves + 1];
  for (int i = threadIdx.x; i <= n_leaves; i += blockDim.x) off[i] = offsets[i];
  __syncthreads();
  const float lam2 = __fmul_rn(2.0f, scal[0]);
  const float w_self = scal[1], b_self = scal[2];
  const int64_t end = off[n_leaves];
  const int64_t nv = rows * cols / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const int64_t e0 = i * kVec;
    const int64_t row = e0 / cols;
    const int64_t col0 = e0 - row * cols;
    // largest l with off[l] <= col0 (off[0] == 0)
    int lo = 0, hi = n_leaves;
    while (hi - lo > 1) {
      int mid = (lo + hi) >> 1;
      if (off[mid] <= col0) lo = mid; else hi = mid;
    }
    int l = lo;
    Vec8<T> xv = reinterpret_cast<const Vec8<T>*>(x)[i];
    Vec8<T> gv = reinterpret_cast<const Vec8<T>*>(g)[i];
    Vec8<T> ov;
    Bits8 bv;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t c = col0 + k;
      uint32_t b = 0u;
      if (c < end) {
        while (c >= off[l + 1]) ++l;
        const uint64_t ctr = (uint64_t)(c - off[l]);
        const uint32_t* kp = keys + 2 * (row * n_leaves + l);
        if constexpr (kOriginal) {
          b = threefry_bits_original(kp[0], kp[1], ctr,
                                     (uint64_t)(off[l + 1] - off[l]));
        } else {
          b = threefry_bits(kp[0], kp[1], (uint32_t)(ctr >> 32),
                            (uint32_t)ctr);
        }
      }
      bv.v[k] = b;
      store_f(&ov.v[k], obf_math(load_f(&xv.v[k]), load_f(&gv.v[k]), b, lam2,
                                 w_self, b_self));
    }
    reinterpret_cast<Vec8<T>*>(out)[i] = ov;
    if (bits_out != nullptr) reinterpret_cast<Bits8*>(bits_out)[i] = bv;
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

}  // namespace

// Elements from p to the next 8-element boundary of its buffer.
static int64_t misalign(const void* p, int64_t elem) {
  return (int64_t)(((uintptr_t)p / elem) % kVec);
}

// dtype: 0 = float32, 1 = bfloat16 (x, g and out share it).  rows of n
// columns, ld elements apart in every buffer (ld = n: contiguous); out may
// alias g.
extern "C" int obfuscate_update(int dtype, const void* x, const void* g,
                                const void* bits, const void* scal, void* out,
                                long long rows, long long n, long long ld,
                                void* stream) {
  if (rows < 1 || ld < n) return (int)cudaErrorInvalidValue;
  if (ld == n) {  // contiguous: one row of every element
    n *= rows;
    ld = n;
    rows = 1;
  }
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  const int64_t es = dtype == 0 ? 4 : 2;
  const int64_t m0 = misalign(x, es);
  const bool same = (rows == 1 || ld % kVec == 0) && misalign(g, es) == m0 &&
                    misalign(out, es) == m0 && misalign(bits, 4) == m0;
  int64_t head = same ? (kVec - m0) % kVec : n;
  if (head > n) head = n;
  cudaStream_t s = (cudaStream_t)stream;
  int64_t blocks = grid_for(n / kVec + kVec) / rows;
  const dim3 grid((unsigned)(blocks < 1 ? 1 : blocks), (unsigned)rows);
  if (dtype == 0) {
    obfuscate_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)g, (const uint32_t*)bits,
        (const float*)scal, (float*)out, n, ld, head);
  } else if (dtype == 1) {
    obfuscate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
        (const uint32_t*)bits, (const float*)scal, (__nv_bfloat16*)out, n,
        ld, head);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kOriginal>
void launch_krng(int grid, cudaStream_t s, const void* x, const void* g,
                 const void* keys, const void* offsets, int n_leaves,
                 long long rows, long long cols, const void* scal, void* out,
                 void* bits_out) {
  obfuscate_krng_kernel<T, kOriginal><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)g, (const uint32_t*)keys,
      (const int64_t*)offsets, n_leaves, rows, cols, (const float*)scal,
      (T*)out, (uint32_t*)bits_out);
}

// keys: (rows, n_leaves, 2) uint32; offsets: (n_leaves + 1,) int64 with
// offsets[0] == 0.  cols % 8 == 0 and 16-byte aligned x/g/out/bits_out are
// the caller's checks; with original, a leaf has fewer than 2^32 columns
// (the original stream's counters are 32-bit).  bits_out may be null.
extern "C" int obfuscate_update_krng(int dtype, const void* x, const void* g,
                                     const void* keys, const void* offsets,
                                     int n_leaves, long long rows,
                                     long long cols, const void* scal,
                                     void* out, void* bits_out, int original,
                                     void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || cols % kVec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(rows * cols / kVec);
  if (dtype == 0 && !original) {
    launch_krng<float, false>(grid, s, x, g, keys, offsets, n_leaves, rows,
                              cols, scal, out, bits_out);
  } else if (dtype == 0) {
    launch_krng<float, true>(grid, s, x, g, keys, offsets, n_leaves, rows,
                             cols, scal, out, bits_out);
  } else if (dtype == 1 && !original) {
    launch_krng<__nv_bfloat16, false>(grid, s, x, g, keys, offsets,
                                      n_leaves, rows, cols, scal, out,
                                      bits_out);
  } else if (dtype == 1) {
    launch_krng<__nv_bfloat16, true>(grid, s, x, g, keys, offsets, n_leaves,
                                     rows, cols, scal, out, bits_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
