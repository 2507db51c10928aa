// The MAGM log edge-probability tile, shared by magm_logprob.cu and
// bernoulli_tile.cu:
//
//   log Q[i, j] = c0 + (F_s u)[i] + (F_t v)[j] + sum_k (F_s[i, k] w[k]) F_t[j, k]
//
// One block of 256 threads owns a 64 x 64 output tile.  It stages its 64
// rows of F_s * w and its 64 rows of F_t in shared memory, 32 attributes at
// a time and at the real depth d (no padding of d: the TPU kernel padded d
// to 128 lanes for its matrix unit, which at d = 15 would be 8x the work),
// computes the tile's row and column terms once, and each thread
// accumulates 4 x 4 outputs with a sequential fmaf loop over k.  The
// epilogue adds c0, the row term and the column term in the reference's
// order ((c0 + row) + col) + inter and hands each in-range value to the
// caller's store; the ragged M and N edges are masked here.
//
// At the depths of this model (d <= 31) the tile does ~d FMAs per output
// against 4 or 5 bytes of device memory per output, far below the card's
// 20 FMAs per byte, so it is bound by bytes; the operands F_s, F_t are read
// once per tile row / column strip (L2-resident).  Thread (ty, tx) holds
// rows ty + 16a and columns tx + 16b, so a warp's stores cover two runs of
// 16 consecutive outputs.
//
// Build WITHOUT --use_fast_math.
#pragma once

#include <cstdint>

namespace qkg {

constexpr int kTile = 64;       // output rows and columns per block
constexpr int kTileK = 32;      // attributes staged per step
constexpr int kTileThreads = 256;
constexpr int kSub = 4;         // outputs per thread along each axis
constexpr int kPad = kTile + 1; // shared-memory row length (no bank conflicts)

// Computes the block's tile and calls store(i, j, logq) for every output in
// range.  Launch with grid (ceil(N / 64), ceil(M / 64)), 256 threads.
template <class Store>
__device__ __forceinline__ void bilinear_tile(
    const float* __restrict__ fs, const float* __restrict__ ft, int M, int N,
    int d, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ c0p, Store store) {
  __shared__ float s_a[kTileK][kPad];  // (F_s * w)^T of the block's rows
  __shared__ float s_b[kTileK][kPad];  // F_t^T of the block's columns
  __shared__ float s_row[kTile];
  __shared__ float s_col[kTile];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  // row terms (threads 0..63) and column terms (threads 64..127)
  if (tid < 2 * kTile) {
    const bool is_row = tid < kTile;
    const int t = is_row ? tid : tid - kTile;
    const int g = (is_row ? i0 : j0) + t;
    const int lim = is_row ? M : N;
    const float* f = is_row ? fs : ft;
    const float* coef = is_row ? u : v;
    float s = 0.0f;
    if (g < lim) {
      const float* fr = f + static_cast<int64_t>(g) * d;
      for (int k = 0; k < d; ++k) s = fmaf(fr[k], coef[k], s);
    }
    (is_row ? s_row : s_col)[t] = s;
  }

  float acc[kSub][kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) acc[a][b] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    const int kc = min(kTileK, d - k0);
    for (int e = tid; e < kTile * kTileK; e += kTileThreads) {
      const int t = e / kTileK, k = e - t * kTileK;
      float a = 0.0f, b = 0.0f;
      if (k < kc) {
        if (i0 + t < M) a = fs[static_cast<int64_t>(i0 + t) * d + k0 + k] * w[k0 + k];
        if (j0 + t < N) b = ft[static_cast<int64_t>(j0 + t) * d + k0 + k];
      }
      s_a[k][t] = a;
      s_b[k][t] = b;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float ra[kSub], rb[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) ra[a] = s_a[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < kSub; ++b) rb[b] = s_b[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int b = 0; b < kSub; ++b) acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
    }
    __syncthreads();
  }
  if (d == 0) __syncthreads();  // the row and column terms are ready

  const float c0 = *c0p;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= M) continue;
    const float base = c0 + s_row[ty + 16 * a];
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j < N) store(i, j, (base + s_col[tx + 16 * b]) + acc[a][b]);
    }
  }
}

inline dim3 tile_grid(int M, int N) {
  return dim3(static_cast<unsigned>((N + kTile - 1) / kTile),
              static_cast<unsigned>((M + kTile - 1) / kTile));
}

// Shape limits of a launch: a grid's y extent is at most 65535 tiles.
inline bool tile_shape_ok(int M, int N, int d) {
  return M >= 1 && N >= 1 && d >= 0 && (M + kTile - 1) / kTile <= 65535;
}

}  // namespace qkg
