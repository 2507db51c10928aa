// The MAGM log edge-probability tile: (M, d), (N, d) float32 attributes ->
// (M, N) float32 log Q = c0 + F_s u 1^T + 1 (F_t v)^T + F_s diag(w) F_t^T.
//
// Replaces the Pallas TPU kernel magm_logprob
// (src/repro/kernels/magm_logprob.py:46, body _kernel :27), reached from
// ops.magm_logprob (the reference's magm_logprob_pallas) and MAGFIT's dense
// scoring (fit/magfit.py dense_expected_logprob(use_kernel=True)).
//
// Bound on an H100: bytes.  It writes 4 B per output (a 2048 x 2048 tile:
// 16.8 MB, 5.0 us at 3.35 TB/s) and does d FMAs per output (d <= 31: at
// most 8 FMAs per byte written, below the card's ~20).  The design
// (bilinear_tile.cuh) keeps the bytes at that floor: the operands are read
// once per 64-row or 64-column strip and stay in L2, the products live in
// registers, and each output is written once, in runs of 16 consecutive
// floats.  The tolerance against the plain version is float32 sums taken
// in another order (atol 2e-4, the reference's own).

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_tile.cuh"

namespace {

struct StoreLogQ {
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int i, int j, float logq) const {
    out[static_cast<int64_t>(i) * N + j] = logq;
  }
};

__global__ void __launch_bounds__(qkg::kTileThreads)
    magm_logprob_kernel(const float* __restrict__ fs,
                        const float* __restrict__ ft, int M, int N, int d,
                        const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ c0,
                        float* __restrict__ out) {
  qkg::bilinear_tile(fs, ft, M, N, d, u, v, w, c0, StoreLogQ{out, N});
}

}  // namespace

extern "C" {

// Launch on `stream`.  Returns the CUDA error code of the launch (0 =
// launched); the caller raises on any other value.
int qkg_magm_logprob(int device, const void* fs, const void* ft, int M, int N,
                     int d, const void* u, const void* v, const void* w,
                     const void* c0, void* out, void* stream) {
  if (!qkg::tile_shape_ok(M, N, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  magm_logprob_kernel<<<qkg::tile_grid(M, N), qkg::kTileThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fs), static_cast<const float*>(ft), M, N, d,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(c0),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
