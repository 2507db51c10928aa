// The naive sampler's fused tile: the MAGM log-Q tile compared against a
// tile of log-uniforms -> (M, N) int8 adjacency, A[i, j] = [log u < log Q].
//
// Replaces the Pallas TPU kernel bernoulli_tile
// (src/repro/kernels/bernoulli_tile.py:44, body _kernel :28), reached from
// ops.bernoulli_sample (the reference's bernoulli_sample_pallas) and the
// naive baseline (core/naive.py sample_tile / naive_sample).
//
// Bound on an H100: bytes.  It reads 4 B of log u and writes 1 B of mask
// per cell (a 2048 x 2048 tile: 21 MB, 6.3 us at 3.35 TB/s) against d
// FMAs per cell.  The design (bilinear_tile.cuh) keeps log Q in registers,
// so it never goes to device memory (the fusion the TPU kernel made): per
// cell 5 B move instead of 4 + 4 + 4 + 1.  log u is read through a row
// stride, so a view into a larger draw (ops.bernoulli_sample draws over the
// shape padded to 256, as the reference does) needs no copy.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_tile.cuh"

namespace {

struct StoreMask {
  const float* logu;
  int64_t ld;
  int8_t* out;
  int N;
  __device__ __forceinline__ void operator()(int i, int j, float logq) const {
    const float lu = __ldg(logu + static_cast<int64_t>(i) * ld + j);
    out[static_cast<int64_t>(i) * N + j] = lu < logq ? 1 : 0;
  }
};

__global__ void __launch_bounds__(qkg::kTileThreads)
    bernoulli_tile_kernel(const float* __restrict__ fs,
                          const float* __restrict__ ft, int M, int N, int d,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ c0,
                          const float* __restrict__ logu, int64_t ld,
                          int8_t* __restrict__ out) {
  qkg::bilinear_tile(fs, ft, M, N, d, u, v, w, c0, StoreMask{logu, ld, out, N});
}

}  // namespace

extern "C" {

// Launch on `stream`; `ld` is the row stride of logu in elements.  Returns
// the CUDA error code of the launch (0 = launched); the caller raises on
// any other value.
int qkg_bernoulli_tile(int device, const void* fs, const void* ft, int M,
                       int N, int d, const void* u, const void* v,
                       const void* w, const void* c0, const void* logu,
                       int64_t ld, void* out, void* stream) {
  if (!qkg::tile_shape_ok(M, N, d) || ld < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bernoulli_tile_kernel<<<qkg::tile_grid(M, N), qkg::kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fs), static_cast<const float*>(ft), M, N, d,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(c0),
      static_cast<const float*>(logu), ld, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
