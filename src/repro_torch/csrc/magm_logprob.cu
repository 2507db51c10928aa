// The MAGM log edge-probability tile: (M, d), (N, d) float32 attributes ->
// (M, N) float32 log Q = c0 + F_s u 1^T + 1 (F_t v)^T + F_s diag(w) F_t^T.
//
// Replaces the Pallas TPU kernel magm_logprob
// (src/repro/kernels/magm_logprob.py:46, body _kernel :27), reached from
// ops.magm_logprob (the reference's magm_logprob_pallas) and MAGFIT's dense
// scoring (fit/magfit.py dense_expected_logprob(use_kernel=True): one
// (n, n) launch per call).
//
// Bound on an H100: bytes.  It writes 4 B per output (a 2048 x 2048 tile:
// 16.8 MB, 5.0 us at 3.35 TB/s; 8192 x 8192: 268 MB, 80 us) against d
// FMAs per output (d = 15: ~4 FMAs per byte, below the card's ~10).  The
// design (bilinear_tile.cuh) writes each output once, from registers, as
// float4 stores (a warp instruction: 4 rows x 128 B; scalar stores where
// N % 4 != 0), and overlaps the stores with the FMAs: persistent CTAs walk
// 128 x 128 tiles with the next stage's operands in flight, and a launch
// of one wave (2048^2) stores each tile in two halves of its rows.  The
// tolerance against the plain version is float32 sums taken in another
// order (atol 2e-4, the reference's own).

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_tile.cuh"

namespace {

struct LogQOut {
  float* out;
  int N;
  bool vec;  // rows start 16 B aligned: float4 stores

  static constexpr bool kRowHalves = true;  // nothing to wait for before the stores

  __device__ __forceinline__ void load(int, int, int) {}
  __device__ __forceinline__ float4 cells(int, float4 q) const { return q; }
  __device__ __forceinline__ void store(int i, int j, float4 q) const {
    float* p = out + static_cast<int64_t>(i) * N + j;
    if (vec && j + 3 < N) {
      *reinterpret_cast<float4*>(p) = q;
    } else {
      if (j < N) p[0] = q.x;
      if (j + 1 < N) p[1] = q.y;
      if (j + 2 < N) p[2] = q.z;
      if (j + 3 < N) p[3] = q.w;
    }
  }
};

__global__ void __launch_bounds__(qkg::kTileThreads, 2)
    magm_logprob_kernel(const float* __restrict__ fs,
                        const float* __restrict__ ft, int M, int N, int d,
                        const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ c0,
                        float* __restrict__ out, bool vec) {
  LogQOut store{out, N, vec};
  qkg::bilinear_tiles(fs, ft, M, N, d, u, v, w, c0, store);
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
  int ctas = 0;
  if (err == cudaSuccess) err = qkg::persistent_ctas(magm_logprob_kernel, 0, device, M, N, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  magm_logprob_kernel<<<ctas, qkg::kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fs), static_cast<const float*>(ft), M, N, d,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(c0),
      static_cast<float*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
