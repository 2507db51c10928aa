// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011), written out for the device-native descent kernel
// (quadrant_descent_native.cu).  A counter of four uint32 words and a key of
// two go through ten rounds; each round multiplies two counter words by the
// round constants, takes the high and low halves of the 64-bit products
// (__umulhi and a plain multiply) and mixes them into the other two words
// with that round's key.  The round keys (the key bumped by the Weyl
// constants between rounds) depend on the key alone, so a kernel computes
// them outside its calls (philox_keys) and reuses them for every counter.
//
// Bit-identical to philox4x32 in repro_torch/kernels/quadrant_descent.py,
// which checks the known-answer vectors of the Random123 distribution.
#pragma once

#include <cstdint>

namespace qkg {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kPhiloxRounds = 10;

struct Philox4 {
  uint32_t w[4];
};

struct PhiloxKeys {
  uint32_t k0[kPhiloxRounds], k1[kPhiloxRounds];
};

__device__ __forceinline__ PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return keys;
}

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 const PhiloxKeys& keys) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ keys.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ keys.k1[r];
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

}  // namespace qkg
