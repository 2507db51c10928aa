// Device-native PRNG quadrant descent: plain KPGM Algorithm 1 for a batch of
// candidate edges, its uniforms drawn inside the kernel by Philox4x32-10.
//
// Replaces the Pallas TPU kernel _prng_native_kernel
// (src/repro/kernels/quadrant_descent.py:369), the tpu_native=True body of
// quadrant_descent_prng (:390), which seeds the TPU's hardware PRNG per
// 512-row tile.  The H100 has no such generator, so this kernel writes one
// out (csrc/philox.cuh): slot s calls Philox with key (s0, s1), the two seed
// words, and counter (s, j, 0, 0) for j = 0 .. ceil(d/4) - 1; level k takes
// word k % 4 of call k / 4 as its bits and u = (bits >> 8) * 2^-24, as the
// TPU kernel does.  A slot's stream depends on the slot alone, so a shorter
// batch is a prefix of a longer one.  The bits are not the TPU's, and not
// the counter hash's (quadrant_descent_prng.cu): the law is held by the
// 3-sigma suite.  Bit-identical to quadrant_descent_native_plain in
// repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: 32-bit integer operations.  A Philox call is 10 rounds
// of 4 multiplies (the high and low halves of two products) and 4 XORs (80
// ops); the round keys depend on the seed alone, so they are computed
// outside the calls (philox_keys), not in each.  A level takes ~21 more
// (the uniform, three compares, the bit updates, the loop) and a slot ~10
// (the index and the stores): at 2^25 slots and d = 15 (4 calls), ~645 ops
// a slot, 2.2e10 ops, 0.65 ms at 128 lanes x 132 SMs x 1.98 GHz, against 8
// B of output per slot (0.08 ms at 3.35 TB/s).  The design keeps the bytes
// at that floor: the only input is the (d, 4) table, held in shared memory,
// the generator state lives in registers, and neighbouring threads write
// neighbouring slots, so the stores coalesce.  Blocks stride over the slots
// (grid = SMs x occupancy), so each block loads the table once.
//
// Build WITHOUT --use_fast_math: the compares must be IEEE float32 compares.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    quadrant_descent_native_kernel(uint32_t s0, uint32_t s1,
                                   const float* __restrict__ cum, int d,
                                   int32_t* __restrict__ src,
                                   int32_t* __restrict__ dst, int n) {
  __shared__ float s_cum[4 * qkg::kMaxLevels];
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  __syncthreads();

  const qkg::PhiloxKeys keys = qkg::philox_keys(s0, s1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    int32_t sc = 0, dc = 0;
    for (int j = 0; 4 * j < d; ++j) {
      const qkg::Philox4 bits = qkg::philox4x32_10(
          static_cast<uint32_t>(r), static_cast<uint32_t>(j), 0u, 0u, keys);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int k = 4 * j + w;
        if (k < d) {
          const float u = static_cast<float>(bits.w[w] >> 8) * 5.9604644775390625e-08f;
          qkg::descend_level(u, s_cum + 4 * k, &sc, &dc);
        }
      }
    }
    src[r] = sc;
    dst[r] = dc;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` for slots [0, n).  Returns the CUDA error code of the
// launch (0 = launched); the caller raises on any other value.
int qkg_quadrant_descent_native(int device, uint32_t s0, uint32_t s1,
                                const void* cum, int d, int n, void* src,
                                void* dst, void* stream) {
  if (d < 1 || d > qkg::kMaxLevels || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quadrant_descent_native_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  quadrant_descent_native_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      s0, s1, static_cast<const float*>(cum), d, static_cast<int32_t*>(src),
      static_cast<int32_t*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
