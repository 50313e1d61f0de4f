// Device helpers of the mega path: Philox4x32-10, the 24-bit uniform, and
// the murmur3-mixed PT scalar draws.  Each is bitwise its plain torch
// version (ops/rng.py, ops/tempering.py); the tests and chip_smoke.py hold
// them against each other.
#pragma once

#include <cstdint>

namespace peapods {

constexpr int kThreads = 256;        // threads per colour-pass block
constexpr int kSitesPerThread = 4;   // one Philox block of 4 words
constexpr float kKeep = 0.9375f;     // 1 - METROPOLIS_LAZINESS (1/16)
constexpr float kInv24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1,
                                               uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return static_cast<float>(w >> 8) * kInv24;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float scalar_uniform(uint32_t w0, uint32_t w1,
                                                uint32_t salt) {
  const uint32_t h = mix32(w0 ^ mix32(w1 + salt * 0x9E3779B9u));
  return static_cast<float>(h >> 8) * kInv24;
}

__device__ __forceinline__ int scalar_randint(uint32_t w0, uint32_t w1,
                                              uint32_t salt, int n) {
  const uint32_t h = mix32(w1 ^ mix32(w0 + salt * 0x9E3779B9u));
  return static_cast<int>((h >> 4) % static_cast<uint32_t>(n));
}

}  // namespace peapods
