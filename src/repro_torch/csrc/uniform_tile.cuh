// Staging of an (N, d) float32 uniforms operand through shared memory,
// shared by quadrant_descent.cu and quilt_descent_lookup.cu.
//
// A row is 4 d bytes (64 B at d = 16), so a warp whose threads each read
// their own row would touch 32 strided rows per load.  Instead the block
// copies its tile of kRows rows (kRows * d consecutive floats) with
// consecutive threads reading consecutive floats, and each thread then
// descends its row from shared memory.  Rows are stored with an odd stride
// (d | 1) so the 32 rows a warp reads at one level fall in 32 banks.
#pragma once

#include <cstdint>

#include "counter_hash.cuh"

namespace qkg {

__host__ __device__ __forceinline__ int tile_stride(int d) { return d | 1; }

// Copies rows [tile0, tile0 + rows) of u into `tile` (row stride
// tile_stride(d)); blockDim.x must be kRows.  The caller synchronises.
template <int kRows>
__device__ __forceinline__ void load_tile(float* tile, const float* u,
                                          int64_t tile0, int rows, int d) {
  const int stride = tile_stride(d);
  const int q = kRows / d, rem = kRows - q * d;  // one pass of kRows floats
  int r = threadIdx.x / d, k = threadIdx.x - (threadIdx.x / d) * d;
  const float* g = u + tile0 * d;
  const int total = rows * d;
  for (int i = threadIdx.x; i < total; i += kRows) {
    tile[r * stride + k] = g[i];
    r += q;
    k += rem;
    if (k >= d) {
      k -= d;
      ++r;
    }
  }
}

// Quadrant descent of one staged row: d IEEE float32 compares per level
// against the (d, 4) cumulative table in shared memory.
__device__ __forceinline__ void descend_row(const float* row,
                                            const float* s_cum, int d,
                                            int32_t* src, int32_t* dst) {
  int32_t sc = 0, dc = 0;
  for (int k = 0; k < d; ++k) descend_level(row[k], s_cum + 4 * k, &sc, &dc);
  *src = sc;
  *dst = dc;
}

}  // namespace qkg
