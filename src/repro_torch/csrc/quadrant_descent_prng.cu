// Counter-PRNG quadrant descent: plain KPGM Algorithm 1 for a batch of
// candidate edges.
//
// Replaces the Pallas TPU kernel quadrant_descent_prng
// (src/repro/kernels/quadrant_descent.py:390, body _prng_kernel :354), its
// counter-hash variant.  One thread per slot s: d uniforms
// u_k = (hash(s0, s1, gid = 0, s*64 + k) >> 8) * 2^-24 (word arithmetic
// wraps in uint32, as the reference's does), quadrant descent against the
// (d, 4) cumulative table -> int32 (src, dst).  Bit-identical to
// quadrant_descent_prng_plain in repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: 32-bit integer operations.  ~35 per level (the hash,
// the uniform, three compares, the bit updates, the loop) and ~10 per slot
// for the index and the stores: at 2^25 slots and d = 15, 1.8e10 ops, 0.54
// ms at 128 lanes x 132 SMs x 1.98 GHz, against 8 B of output per slot
// (0.27 GB, 0.08 ms at 3.35 TB/s).  The design keeps the bytes at that
// floor: the only input is the (d, 4) table, held in shared memory, and
// nothing but the two outputs goes to device memory; neighbouring threads
// write neighbouring slots, so the stores coalesce.  Blocks stride over the
// slots (grid = SMs x occupancy), so each block loads the table once.
//
// Build WITHOUT --use_fast_math: the compares must be IEEE float32 compares.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    quadrant_descent_prng_kernel(uint32_t s0, uint32_t s1,
                                 const float* __restrict__ cum, int d,
                                 int32_t* __restrict__ src,
                                 int32_t* __restrict__ dst, int n) {
  __shared__ float s_cum[4 * qkg::kMaxLevels];
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const uint32_t base = static_cast<uint32_t>(r) * qkg::kChannels;
    int32_t sc = 0, dc = 0;
    for (int k = 0; k < d; ++k) {
      const float u = qkg::counter_u01(s0, s1, 0u, base + static_cast<uint32_t>(k));
      qkg::descend_level(u, s_cum + 4 * k, &sc, &dc);
    }
    src[r] = sc;
    dst[r] = dc;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` for slots [0, n).  Returns the CUDA error code of the
// launch (0 = launched); the caller raises on any other value.
int qkg_quadrant_descent_prng(int device, uint32_t s0, uint32_t s1,
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
      &per_sm, quadrant_descent_prng_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  quadrant_descent_prng_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      s0, s1, static_cast<const float*>(cum), d, static_cast<int32_t*>(src),
      static_cast<int32_t*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
