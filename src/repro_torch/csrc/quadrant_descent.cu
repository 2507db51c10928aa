// Quadrant descent of an (N, d) float32 uniforms operand: KPGM Algorithm 1
// for a batch of candidate edges whose uniforms were drawn beforehand.
//
// Replaces the Pallas TPU kernel quadrant_descent
// (src/repro/kernels/quadrant_descent.py:188, body _kernel :45).  Row i
// descends d levels: at level k its quadrant is the number of the level's
// cumulative thresholds cum[k][0..2] at or below u[i][k] (IEEE float32
// compares), the quadrant's high bit extends the source id and its low bit
// the destination id.  Outputs are int32 (src, dst), bit-identical to
// quadrant_descent_plain in repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: bytes.  Each row reads 4 d bytes and writes 8, so
// 2^24 rows at d = 16 move 1.21 GB, 0.36 ms at 3.35 TB/s; the ~21 32-bit
// operations per level (8 to stage a uniform, 13 for the compares and the
// bit updates) and ~10 per row are 0.17 ms at 33.5 T ops/s.  The design reads every byte once and coalesced:
// a block stages its tile of kRows rows through shared memory
// (csrc/uniform_tile.cuh), then thread t descends row t of the tile and
// writes its two ids; blocks stride over the tiles.
//
// Build WITHOUT --use_fast_math: the compares must be IEEE float32 compares.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "uniform_tile.cuh"

namespace {

constexpr int kRows = 256;  // rows per tile = threads per block
constexpr int kCumFloats = 4 * 32;

__global__ void __launch_bounds__(kRows)
    quadrant_descent_kernel(const float* __restrict__ u,
                            const float* __restrict__ cum, int d, int n,
                            int32_t* __restrict__ src,
                            int32_t* __restrict__ dst) {
  extern __shared__ __align__(16) float smem[];
  float* s_cum = smem;
  float* tile = smem + kCumFloats;
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  const int stride = qkg::tile_stride(d);
  for (int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRows; tile0 < n;
       tile0 += static_cast<int64_t>(gridDim.x) * kRows) {
    const int rows = static_cast<int>(n - tile0 < kRows ? n - tile0 : kRows);
    __syncthreads();  // the previous tile has been read
    qkg::load_tile<kRows>(tile, u, tile0, rows, d);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < rows) {
      int32_t sc, dc;
      qkg::descend_row(tile + threadIdx.x * stride, s_cum, d, &sc, &dc);
      src[tile0 + threadIdx.x] = sc;
      dst[tile0 + threadIdx.x] = dc;
    }
  }
}

size_t shared_bytes(int d) {
  return (kCumFloats + static_cast<size_t>(kRows) * qkg::tile_stride(d)) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Launch on `stream` for rows [0, n) of the row-major (n, d) operand u.
// Returns the CUDA error code of the launch (0 = launched); the caller
// raises on any other value.
int qkg_quadrant_descent(int device, const void* u, const void* cum, int d,
                         int n, void* src, void* dst, void* stream) {
  if (d < 1 || d > qkg::kMaxLevels || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem = shared_bytes(d);
  err = cudaFuncSetAttribute(quadrant_descent_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quadrant_descent_kernel, kRows, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  quadrant_descent_kernel<<<static_cast<unsigned>(grid), kRows, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(cum), d, n,
      static_cast<int32_t*>(src), static_cast<int32_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
