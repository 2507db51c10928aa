// The MAGM log edge-probability tile, shared by magm_logprob.cu (kernel 3)
// and bernoulli_tile.cu (kernel 4):
//
//   log Q[i, j] = ((c0 + (F_s u)[i]) + (F_t v)[j]) + sum_k (F_s[i, k] w[k]) F_t[j, k]
//
// It replaces the body the two Pallas TPU kernels share
// (src/repro/kernels/magm_logprob.py:27 and bernoulli_tile.py:28: the
// bilinear product on the matrix unit, d padded to 128 lanes).
//
// Bound on an H100: bytes.  An output cell costs d FMAs (d = 15 on the
// model's paths) against 4 B written (log Q) or 4 B read and 1 B written
// (the mask): ~4 FMAs per byte, below the card's ~10 float32 FMAs per byte
// of HBM.  The FMAs still take about half the store time, so the design
// keeps them at the FMA rate and overlaps them with the stores:
//
// - Persistent CTAs.  The launch holds as many 256-thread CTAs as are
//   resident on the card at once (persistent_ctas: SMs x CTAs per SM, at
//   most one per tile); each walks the 128 x 128 output tiles in a
//   grid-stride loop, so one tile's stores drain while the next tile's
//   operands land and its products run.  There is no grid-extent limit.
// - Operands one stage ahead.  A stage is one tile and a chunk of up to 16
//   attributes (d <= 16: one stage a tile; d = 33: three).  Its 128 rows of
//   F_s and of F_t and 16 values of u, v, w come in by 4 B cp.async,
//   transposed on the way into shared memory ([k][row]); the 16 threads of
//   a half warp read one row's contiguous attributes.  Four-byte copies
//   take any base (F[1:] at d = 15 starts 60 B past a 16 B boundary) and
//   any d, so alignment needs no second path.  The next stage's copies
//   are issued before this stage's work (two buffers).
// - Row and column terms in parallel from shared memory: 128 threads take
//   the row terms (and scale their row of F_s by w in place), 128 the
//   column terms, each a sequential fmaf over k.  Attributes past the
//   chunk's end are set to 0, so the products run without a branch.
// - 8 x 8 outputs a thread (ThreadCells), 32 x 64 a warp.  Each step of k
//   is four float4 reads from shared memory (conflict-free, broadcast
//   across the lanes that share rows or columns) and 64 FMAs, sequential
//   over k; d = 15 runs 15 steps, not 16.  FP32 FMAs, not tensor cores:
//   TF32 would round w to 10 bits and leave the 2e-4 band.
// - The epilogue adds ((c0 + row) + col) + product, the reference's order,
//   and hands each group of four consecutive cells of a row to the
//   caller: a warp instruction covers 4 rows x 128 B of log Q (float4) or
//   4 rows x 32 B of mask (char4), each run contiguous.  Where the rows are
//   not aligned (N % 4 != 0) the caller stores by scalar, in the same
//   kernel; the ragged M and N edges are masked here and in the caller.
// - When the launch is one wave with one stage a tile (2048^2 at d = 15:
//   256 tiles on 264 CTAs), a CTA has no next tile to overlap, so log Q
//   leaves in two halves of the rows: the first half's stores drain while
//   the second half's products run.  The mask does not split: its compare
//   waits for log u, which is still in flight halfway through.
//
// Build WITHOUT --use_fast_math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace qkg {

constexpr int kWarpsM = 4;                      // warps along the tile's rows
constexpr int kWarpsN = 2;                      // and along its columns
constexpr int kTileM = 32 * kWarpsM;            // output rows per tile
constexpr int kTileN = 64 * kWarpsN;            // output columns per tile
constexpr int kTileThreads = 32 * kWarpsM * kWarpsN;
constexpr int kChunk = 16;                      // attributes per stage
constexpr int kCells = 16;                      // quads (4 cells of a row) a thread
constexpr int kPitchA = kTileM + 4;             // shared row lengths, multiples of 4
constexpr int kPitchB = kTileN + 4;             // for the float4 reads
constexpr int kCopyRows = kTileThreads / kChunk;  // rows copied per pass

struct TileSmem {
  float a[2][kChunk][kPitchA];  // F_s^T of the tile's rows (x w after the terms)
  float b[2][kChunk][kPitchB];  // F_t^T of the tile's columns
  float u[2][kChunk], v[2][kChunk], w[2][kChunk];
  float row[kTileM];            // (F_s u)[i], accumulated over the chunks
  float col[kTileN];            // (F_t v)[j]
};

// Issues the copies of one stage into buffer `buf`: attributes k0..k0+kc-1
// of the rows i0.. of F_s and j0.. of F_t, and of u, v, w.
__device__ __forceinline__ void stage_copy(
    TileSmem& sm, int buf, const float* __restrict__ fs,
    const float* __restrict__ ft, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ w, int M, int N,
    int d, int i0, int j0, int k0, int kc) {
  const int k = threadIdx.x % kChunk, r = threadIdx.x / kChunk;
  if (k >= kc) return;
  const int rows_a = min(kTileM, M - i0), rows_b = min(kTileN, N - j0);
  const float* pa = fs + static_cast<int64_t>(i0) * d + k0 + k;
  for (int t = r; t < rows_a; t += kCopyRows) {
    cp_async4(&sm.a[buf][k][t], pa + static_cast<int64_t>(t) * d);
  }
  const float* pb = ft + static_cast<int64_t>(j0) * d + k0 + k;
  for (int t = r; t < rows_b; t += kCopyRows) {
    cp_async4(&sm.b[buf][k][t], pb + static_cast<int64_t>(t) * d);
  }
  if (r == 0) {
    cp_async4(&sm.u[buf][k], u + k0 + k);
    cp_async4(&sm.v[buf][k], v + k0 + k);
    cp_async4(&sm.w[buf][k], w + k0 + k);
  }
}

// A thread's cells: quad c (0..15) is row row(c / 2) and columns
// col(c % 2) .. + 3 of the tile.  A warp holds 32 rows x 64 columns: its
// lane (rg, cg) = (lane / 8, lane % 8) the rows {4 rg .. + 3} and
// {16 + 4 rg .. + 3}, the columns {4 cg .. + 3} and {32 + 4 cg .. + 3}, so
// a warp instruction over one quad index covers 4 rows x 128 B (log Q)
// or 4 rows x 32 B (mask), each run contiguous.
struct ThreadCells {
  int rw, cw;  // the thread's first row and column in the tile
  __device__ __forceinline__ ThreadCells() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    rw = (warp / kWarpsN) * 32 + 4 * (lane >> 3);
    cw = (warp % kWarpsN) * 64 + 4 * (lane & 7);
  }
  __device__ __forceinline__ int row(int r) const { return rw + (r & 3) + (r >> 2) * 16; }
  __device__ __forceinline__ int col(int h) const { return cw + h * 32; }
};

// acc[r][q] += (F_s w)[row(r), k] F_t[col(q), k] for rows r = R0 .. R1 - 1
// and k = 0 .. K - 1 of the staged chunk, sequentially over k.
template <int K, int R0, int R1>
__device__ __forceinline__ void chunk_products(const TileSmem& sm, int buf, const ThreadCells& me,
                                               float (&acc)[8][8]) {
  // unrolled by 4, not 16: fully unrolled, the six copies of this loop
  // are ~80 KB of code, fetched from HBM when a launch finds L2 cold
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float ra[8], rb[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= R0 / 4 && h < (R1 + 3) / 4) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.a[buf][k][me.rw + 16 * h]);
        ra[4 * h] = a.x, ra[4 * h + 1] = a.y, ra[4 * h + 2] = a.z, ra[4 * h + 3] = a.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[buf][k][me.col(h)]);
      rb[4 * h] = b.x, rb[4 * h + 1] = b.y, rb[4 * h + 2] = b.z, rb[4 * h + 3] = b.w;
    }
#pragma unroll
    for (int r = R0; r < R1; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(ra[r], rb[q], acc[r][q]);
  }
}

// The chunk's products for rows R0 .. R1 - 1: 15 steps at d = 15, else 16
// (the steps past the chunk's end add zeros).
template <int R0, int R1>
__device__ __forceinline__ void products(const TileSmem& sm, int buf, const ThreadCells& me,
                                         float (&acc)[8][8], int kc) {
  if (kc == kChunk - 1) {
    chunk_products<kChunk - 1, R0, R1>(sm, buf, me, acc);
  } else {
    chunk_products<kChunk, R0, R1>(sm, buf, me, acc);
  }
}

// Rows R0 .. R1 - 1 of the thread's cells, ((c0 + row) + col) + product,
// through the caller's cells() and store().
template <int R0, int R1, class Out>
__device__ __forceinline__ void epilogue(const TileSmem& sm, const ThreadCells& me, const float (&acc)[8][8],
                                         float c0, int i0, int j0, int M, Out& out) {
  float cv[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 x = *reinterpret_cast<const float4*>(&sm.col[me.col(h)]);
    cv[4 * h] = x.x, cv[4 * h + 1] = x.y, cv[4 * h + 2] = x.z, cv[4 * h + 3] = x.w;
  }
#pragma unroll
  for (int r = R0; r < R1; ++r) {
    const int i = i0 + me.row(r);
    if (i >= M) continue;
    const float base = c0 + sm.row[me.row(r)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q = make_float4(
          (base + cv[4 * h]) + acc[r][4 * h], (base + cv[4 * h + 1]) + acc[r][4 * h + 1],
          (base + cv[4 * h + 2]) + acc[r][4 * h + 2], (base + cv[4 * h + 3]) + acc[r][4 * h + 3]);
      out.store(i, j0 + me.col(h), out.cells(2 * r + h, q));
    }
  }
}

// Computes every tile of the (M, N) output this CTA owns.  Per thread and
// tile, `out.load(c, i, j)` is called for each of its quads c in range
// (row i < M) before the tile's products; it may issue cp.async copies,
// which are waited for before `out.cells(c, q)` turns q = log Q[i, j .. j
// + 3] into the quad's four output cells and `out.store(i, j, cells)`
// writes them (masking the columns past N).  Out::kRowHalves allows the
// two-halves epilogue.  Launch with persistent_ctas(...) CTAs of
// kTileThreads threads.
template <class Out>
__device__ __forceinline__ void bilinear_tiles(
    const float* __restrict__ fs, const float* __restrict__ ft, int M, int N,
    int d, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ c0p, Out& out) {
  __shared__ __align__(16) TileSmem sm;

  const int tiles_n = (N + kTileN - 1) / kTileN;
  const int tiles = (M + kTileM - 1) / kTileM * tiles_n;
  const int chunks = d > 0 ? (d + kChunk - 1) / kChunk : 1;
  int t = blockIdx.x;
  if (t >= tiles) return;

  const int tid = threadIdx.x;
  const ThreadCells me;
  const float c0 = __ldg(c0p);

  stage_copy(sm, 0, fs, ft, u, v, w, M, N, d, t / tiles_n * kTileM, t % tiles_n * kTileN, 0,
             min(kChunk, d));
  cp_async_commit();

  float acc[8][8];
  int c = 0, buf = 0;
  for (;;) {
    int tn = t, cn = c + 1;
    if (cn == chunks) {
      cn = 0;
      tn += gridDim.x;
    }
    const bool first = c == 0, last = c == chunks - 1;
    const int i0 = t / tiles_n * kTileM, j0 = t % tiles_n * kTileN;
    // this stage has landed, and every thread is done with the other buffer
    cp_async_wait_all();
    __syncthreads();
    if (last) {
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        const int i = i0 + me.row(q >> 1);
        if (i < M) out.load(q, i, j0 + me.col(q & 1));
      }
    }
    cp_async_commit();
    if (tn < tiles) {
      stage_copy(sm, buf ^ 1, fs, ft, u, v, w, M, N, d, tn / tiles_n * kTileM,
                 tn % tiles_n * kTileN, cn * kChunk, min(kChunk, d - cn * kChunk));
    }
    cp_async_commit();

    const int kc = min(kChunk, d - c * kChunk);
    if (first) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    }

    // row terms (scaling the row of F_s by w) and column terms; the
    // attributes past the chunk's kc are set to 0, so the products below
    // run all 16 steps without a branch (adding exact zeros)
    for (int x = tid; x < kTileM + kTileN; x += kTileThreads) {
      if (x < kTileM) {
        float s = first ? 0.0f : sm.row[x];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float f = 0.0f;
          if (k < kc) {
            f = sm.a[buf][k][x];
            s = fmaf(f, sm.u[buf][k], s);
            f *= sm.w[buf][k];
          }
          sm.a[buf][k][x] = f;
        }
        sm.row[x] = s;
      } else {
        const int y = x - kTileM;
        float s = first ? 0.0f : sm.col[y];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < kc) {
            s = fmaf(sm.b[buf][k][y], sm.v[buf][k], s);
          } else {
            sm.b[buf][k][y] = 0.0f;
          }
        }
        sm.col[y] = s;
      }
    }
    __syncthreads();

    if (Out::kRowHalves && chunks == 1 && tiles <= static_cast<int>(gridDim.x)) {
      // one tile per CTA, one stage per tile: the tile leaves in two halves
      // of its rows, the first half's stores draining while the second
      // half's products run
      products<0, 4>(sm, buf, me, acc, kc);
      cp_async_wait_one();
      epilogue<0, 4>(sm, me, acc, c0, i0, j0, M, out);
      products<4, 8>(sm, buf, me, acc, kc);
      epilogue<4, 8>(sm, me, acc, c0, i0, j0, M, out);
    } else {
      products<0, 8>(sm, buf, me, acc, kc);
      if (last) {
        cp_async_wait_one();  // the quads' loads (the next stage may be in flight)
        epilogue<0, 8>(sm, me, acc, c0, i0, j0, M, out);
      }
    }
    if (tn >= tiles) break;
    t = tn;
    c = cn;
    buf ^= 1;
  }
}

// Shape limits of a launch: the tile loop has no grid-extent limit; tile
// indices are int (an output of 2^31 tiles would not fit in memory).
inline bool tile_shape_ok(int M, int N, int d) {
  return M >= 1 && N >= 1 && d >= 0 &&
         static_cast<int64_t>((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN) <= INT32_MAX;
}

// CTAs of a persistent launch of `kernel` with `smem_bytes` of dynamic
// shared memory: as many as are resident on the card at once (SMs x CTAs
// per SM, computed once per device, after allowing the kernel that much
// dynamic shared memory), at most one per tile of an (M, N) output.
template <class Kernel>
static cudaError_t persistent_ctas(Kernel kernel, int smem_bytes, int device, int M, int N, int* ctas) {
  static int resident[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, smem_bytes);
    }
    if (err != cudaSuccess) return err;
    resident[device] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int tiles = (M + kTileM - 1) / kTileM * ((N + kTileN - 1) / kTileN);
  *ctas = tiles < resident[device] ? tiles : resident[device];
  return cudaSuccess;
}

}  // namespace qkg
