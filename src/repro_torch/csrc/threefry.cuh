// Threefry-2x32 on the device, bit for bit with jax.random's counter stream
// (jax's _threefry2x32_lowering, 20 rounds, unrolled form).  Shared by the
// obfuscate kernel (per-(agent, leaf) Lambda bits) and the gossip kernel
// that draws its edge mask in-kernel.
//
// jax.random.bits(key, shape) is, for row-major flat index i of shape,
//     threefry_bits(key[0], key[1], hi(i), lo(i))   (x0 ^ x1 of the block).
#pragma once

#include <stdint.h>

static __device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;

static __device__ __forceinline__ uint32_t threefry_bits(uint32_t k0,
                                                         uint32_t k1,
                                                         uint32_t x0,
                                                         uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// Both output words of the block (x0, x1): jax's original (not
// partitionable) stream keeps them apart.
static __device__ __forceinline__ void threefry_pair(uint32_t k0, uint32_t k1,
                                                     uint32_t x0, uint32_t x1,
                                                     uint32_t* y0,
                                                     uint32_t* y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  *y0 = x0;
  *y1 = x1;
}

// Word i of jax.random.bits(key, (n,)) in jax's original stream
// (jax_threefry_partitionable=False): the counters 0..n-1 (padded with one
// 0 when n is odd) are split into halves of h = ceil(n / 2) and ciphered
// pairwise, (i, i + h); word i < h is the first output of pair i, word
// i >= h the second output of pair i - h.  n < 2^32.
static __device__ __forceinline__ uint32_t threefry_bits_original(
    uint32_t k0, uint32_t k1, uint64_t i, uint64_t n) {
  const uint64_t h = (n + 1) >> 1;
  uint32_t y0, y1;
  if (i < h) {
    threefry_pair(k0, k1, (uint32_t)i, i + h < n ? (uint32_t)(i + h) : 0u,
                  &y0, &y1);
    return y0;
  }
  threefry_pair(k0, k1, (uint32_t)(i - h), (uint32_t)i, &y0, &y1);
  return y1;
}

#undef TF_ROUND
