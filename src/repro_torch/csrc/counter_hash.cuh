// The counter hash of the descent kernels, shared by
// quilt_prng_descent_lookup.cu and quadrant_descent_prng.cu.
//
// A candidate's level-k uniform is a pure function of the round key's two
// seed words, the global graph id and the word slot * kChannels + k:
// lowbias32 on the word, xor of the graph stream, lowbias32 again.  Native
// uint32 arithmetic, bit-identical to counter_hash / counter_u01 in
// repro_torch/kernels/quadrant_descent.py (and to the reference's).
#pragma once

#include <cstdint>

namespace qkg {

constexpr uint32_t kChannels = 64;  // PRNG_CHANNELS
constexpr uint32_t kMixA = 0x7FEB352Du;
constexpr uint32_t kMixB = 0x846CA68Bu;
constexpr uint32_t kWordC = 0x9E3779B9u;
constexpr uint32_t kGidC = 0x85EBCA6Bu;
constexpr int kMaxLevels = 31;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixA;
  x ^= x >> 15;
  x *= kMixB;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_hash(uint32_t s0, uint32_t s1,
                                                 uint32_t gid, uint32_t word) {
  uint32_t x = mix32(word * kWordC + s0);
  x ^= gid * kGidC + s1;
  return mix32(x);
}

// float32 uniform in [0, 1) from the hash's top 24 bits; the conversion and
// the scaling by 2^-24 are exact, so no compiler flag can change the value
__device__ __forceinline__ float counter_u01(uint32_t s0, uint32_t s1,
                                             uint32_t gid, uint32_t word) {
  return static_cast<float>(counter_hash(s0, s1, gid, word) >> 8) *
         5.9604644775390625e-08f;
}

// Quadrant descent of one level: the quadrant is the number of cumulative
// thresholds at or below u (IEEE float32 compares), its high bit extends
// the source config and its low bit the destination config.
__device__ __forceinline__ void descend_level(float u, const float* cum4,
                                              int32_t* src, int32_t* dst) {
  const int quad = (u >= cum4[0]) + (u >= cum4[1]) + (u >= cum4[2]);
  *src = (*src << 1) | (quad >> 1);
  *dst = (*dst << 1) | (quad & 1);
}

}  // namespace qkg
