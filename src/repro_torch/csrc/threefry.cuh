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

#undef TF_ROUND
