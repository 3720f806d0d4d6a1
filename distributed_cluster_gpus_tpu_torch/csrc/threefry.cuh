// Device threefry-2x32 with jax.random's partitionable semantics, shared by
// the arrival-table kernel (B2) and the event-scan kernel (B1).  Bit for bit
// what ops/prng.py computes (and what jax computes):
//   * fold_in(k, d) and split(k)[d] are one block on counter (0, d);
//   * 32 random bits of a scalar draw are the xor of the two output words of
//     the block on counter (0, 0);
//   * randint(k, 0, span) is jax `_randint`: two such draws from split(k)
//     reduced modulo the span (ops/prng.py::_randint_reduce).
#pragma once

#include <stdint.h>

namespace tf {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

// threefry-2x32 block (20 rounds) on counter (c0, c1) under key (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t c0,
                                         uint32_t c1, uint32_t& o0,
                                         uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
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
  o0 = x0;
  o1 = x1;
}

#undef TF_ROUND

// fold_in(k, d) and split(k)[d]: the block on counter (0, d)
__device__ __forceinline__ void child(uint32_t k0, uint32_t k1, uint32_t d,
                                      uint32_t& o0, uint32_t& o1) {
  threefry(k0, k1, 0u, d, o0, o1);
}

// 32 random bits for a scalar draw from key (k0, k1)
__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1) {
  uint32_t o0, o1;
  threefry(k0, k1, 0u, 0u, o0, o1);
  return o0 ^ o1;
}

// the 64 bits of a scalar draw from key (k0, k1) under jax_enable_x64: the
// block on counter (0, 0) as (hi, lo), whose 32-bit draw is hi ^ lo
__device__ __forceinline__ void bits64(uint32_t k0, uint32_t k1, uint32_t& hi,
                                       uint32_t& lo) {
  threefry(k0, k1, 0u, 0u, hi, lo);
}

// jax `_uniform`'s mantissa trick: a float32 in [0, 1)
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// ... in float64 (jax under jax_enable_x64): the 64 bits of a scalar draw
// are (o0 << 32) | o1 of the block whose 32 bits are o0 ^ o1; the top 52
// under the exponent of 1.0, less 1 (ops/prng.py words_to_unit_double)
__device__ __forceinline__ double unit_double(uint32_t o0, uint32_t o1) {
  const unsigned long long m =
      ((unsigned long long)o0 << 20) | (unsigned long long)(o1 >> 12);
  return __longlong_as_double((long long)(m | 0x3FF0000000000000ull)) - 1.0;
}

// jax.random.randint(k, (), 0, maxval, int32) for a small positive span:
// (hi % span) * ((2^16 % span)^2 % span) + lo % span, modulo the span, with
// hi/lo the bits of split(k)[0] and split(k)[1]; exact in 64-bit integers
// as ops/prng.py's Python ints are
__device__ __forceinline__ int randint(uint32_t k0, uint32_t k1, int maxval) {
  uint32_t a0, a1, b0, b1;
  child(k0, k1, 0u, a0, a1);
  child(k0, k1, 1u, b0, b1);
  const uint64_t hi = bits32(a0, a1);
  const uint64_t lo = bits32(b0, b1);
  const uint64_t span = maxval > 1 ? (uint64_t)maxval : 1ull;
  const uint64_t m16 = 65536ull % span;
  const uint64_t mult = (m16 * m16) % span;
  return (int)((((hi % span) * mult) + lo % span) % span);
}

}  // namespace tf
