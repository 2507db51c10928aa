// Quadrant descent of an (N, d) float32 uniforms operand + per-block
// config lookup: the host-path step of the quilting sampler and the
// proposal step of the ball-dropping host loop.
//
// Replaces the Pallas TPU kernel quilt_descent_lookup
// (src/repro/kernels/quadrant_descent.py:131, body _quilt_kernel :64).
// Row i descends its d uniforms against the (d, 4) cumulative table to a
// (src_cfg, dst_cfg) pair, exactly as quadrant_descent.cu does, then looks
// src_cfg up in block kb[i] and dst_cfg in block lb[i]: node id on a hit,
// -1 on a miss or for a block outside [0, B).  Outputs are four int32
// arrays of N rows, bit-identical to quilt_descent_lookup_plain in
// repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: bytes.  Per row 4 d bytes of uniforms and 8 of block
// ids are read and 16 written (88 B at d = 16: 4,194,304 rows move 369 MB,
// 0.110 ms at 3.35 TB/s); chip_smoke.py reckons the operations too.  Two
// things stand between a plain tile-by-tile kernel and that bound:
//
// - The lookup.  A lower-bound search of the sorted (B, L) tables is
//   search_steps(L) dependent loads a side (17 at n = 2^16, L = 41,432),
//   and with random block ids nearly every warp holds a row of the widest
//   block, so every warp runs all of them.  Where the plan has its dense
//   inverse ((B, 2^d) int32, config -> node or -1; built while
//   B 2^d <= 2^24, 2 MB and L2-resident at n = 2^16) each side is one
//   independent gather at inv[block * 2^d + cfg] instead (the kInv arm).
//   Without it the search arm runs sorted_lookup.cuh's search (shared with
//   kernel quilt_prng_descent_lookup), with the tables in shared memory
//   when they fit (n = 2^12) and read through __ldg from L2 otherwise; its
//   bottom probes are L2 accesses of their own, which no staging hides.
// - The staging.  The uniforms (and the rows' block ids) come in by 4 B
//   cp.async, and a tile's buffer is refilled with the next tile's rows as
//   soon as this tile's descent has read it: the HBM read of one tile
//   overlaps the lookups of the one before, which is where the time goes.
//   One buffer a CTA, not two: a double buffer halves the rows an SM keeps
//   in flight for the same shared memory, and both arms, the search most
//   (its probes run through L1, which shared memory shrinks), measured
//   slower with it.  CTAs are persistent (as many as are resident, 8 an SM at
//   d = 16) and walk the tiles in a grid-stride loop.  Rows keep the odd
//   stride d | 1 of csrc/uniform_tile.cuh, so the 32 rows a warp descends
//   at one level fall in 32 banks; the copy order is that of load_tile
//   (consecutive threads, consecutive floats: coalesced).
//
// Outputs are written with streaming stores (__stcs): they are read next by
// the copy to the host, and should not push the inverse out of L2.
//
// Build WITHOUT --use_fast_math: the compares must be IEEE float32 compares.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "cp_async.cuh"
#include "sorted_lookup.cuh"
#include "uniform_tile.cuh"

namespace {

constexpr int kRows = 256;  // rows per tile = threads per block
constexpr int kCumFloats = 4 * 32;

// A CTA's buffer: a tile of kRows rows of uniforms (row stride
// tile_stride(d)), then the rows' kb and lb block ids.
__host__ __device__ __forceinline__ int stage_words(int d) {
  return kRows * (qkg::tile_stride(d) + 2);
}

// Issues the cp.async copies of rows [tile0, tile0 + rows) of u, kb and lb
// into `stage` as one group.  The uniforms go in load_tile's order.
__device__ __forceinline__ void issue_stage(float* stage, const float* u,
                                            const int32_t* kb,
                                            const int32_t* lb, int64_t tile0,
                                            int rows, int d) {
  const int stride = qkg::tile_stride(d);
  const int q = kRows / d, rem = kRows - q * d;  // one pass of kRows floats
  int r = threadIdx.x / d, k = threadIdx.x - (threadIdx.x / d) * d;
  const float* g = u + tile0 * d;
  const int total = rows * d;
  for (int i = threadIdx.x; i < total; i += kRows) {
    qkg::cp_async4(stage + r * stride + k, g + i);
    r += q;
    k += rem;
    if (k >= d) {
      k -= d;
      ++r;
    }
  }
  if (static_cast<int>(threadIdx.x) < rows) {
    float* ids = stage + kRows * stride;
    qkg::cp_async4(ids + threadIdx.x, kb + tile0 + threadIdx.x);
    qkg::cp_async4(ids + kRows + threadIdx.x, lb + tile0 + threadIdx.x);
  }
  qkg::cp_async_commit();
}

// Node id of config `cfg` in block `row` through the dense inverse; -1 for
// a block outside [0, B).
__device__ __forceinline__ int32_t inverse_lookup(const int32_t* inv, int row,
                                                  int B, int d, int32_t cfg) {
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(B)) return -1;
  return __ldg(inv + ((static_cast<size_t>(row) << d) | static_cast<uint32_t>(cfg)));
}

template <bool kSmem, bool kInv>
__global__ void __launch_bounds__(kRows)
    quilt_descent_lookup_kernel(const float* __restrict__ u,
                                const float* __restrict__ cum, int d,
                                const int32_t* __restrict__ kb,
                                const int32_t* __restrict__ lb,
                                const int32_t* __restrict__ tcfg,
                                const int32_t* __restrict__ tnode,
                                const int32_t* __restrict__ inv, int B,
                                int L, int steps, int n,
                                int32_t* __restrict__ scfg_out,
                                int32_t* __restrict__ dcfg_out,
                                int32_t* __restrict__ snode_out,
                                int32_t* __restrict__ dnode_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_cum = reinterpret_cast<float*>(smem);
  float* stage = s_cum + kCumFloats;
  const int32_t* ids = reinterpret_cast<const int32_t*>(stage + kRows * qkg::tile_stride(d));
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRows;
  int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRows;
  auto rows_at = [n](int64_t t0) {
    return static_cast<int>(n - t0 < kRows ? n - t0 : kRows);
  };
  // the first tile's copies fly while the table and the lookup tables load
  if (tile0 < n) issue_stage(stage, u, kb, lb, tile0, rows_at(tile0), d);
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  const int32_t* cfg = tcfg;
  const int32_t* node = tnode;
  if (kSmem) {
    cfg = qkg::stage_tables(
        reinterpret_cast<unsigned char*>(stage + stage_words(d)), tcfg, tnode, B, L);
    node = cfg + static_cast<size_t>(B) * L;
  }
  for (; tile0 < n; tile0 += step) {
    qkg::cp_async_wait_all();
    __syncthreads();  // every thread's copies (and the tables) are visible
    const bool live = static_cast<int>(threadIdx.x) < rows_at(tile0);
    int32_t sc = 0, dc = 0;
    int krow = 0, lrow = 0;
    if (live) {
      qkg::descend_row(stage + threadIdx.x * qkg::tile_stride(d), s_cum, d, &sc, &dc);
      krow = ids[threadIdx.x];
      lrow = ids[kRows + threadIdx.x];
    }
    __syncthreads();  // the buffer is read: refill it while the lookups run
    const int64_t next = tile0 + step;
    if (next < n) issue_stage(stage, u, kb, lb, next, rows_at(next), d);
    if (live) {
      int32_t sn, dn;
      if (kInv) {
        sn = inverse_lookup(inv, krow, B, d, sc);
        dn = inverse_lookup(inv, lrow, B, d, dc);
      } else {
        sn = qkg::lookup<kSmem>(cfg, node, krow, B, sc, L, steps);
        dn = qkg::lookup<kSmem>(cfg, node, lrow, B, dc, L, steps);
      }
      const int64_t r = tile0 + threadIdx.x;
      __stcs(scfg_out + r, sc);
      __stcs(dcfg_out + r, dc);
      __stcs(snode_out + r, sn);
      __stcs(dnode_out + r, dn);
    }
  }
}

size_t tile_bytes(int d) {
  return (kCumFloats + static_cast<size_t>(stage_words(d))) * sizeof(float);
}

template <bool kSmem, bool kInv>
cudaError_t launch(int sms, size_t shmem, cudaStream_t stream, const float* u,
                   const float* cum, int d, const int32_t* kb,
                   const int32_t* lb, const int32_t* tcfg,
                   const int32_t* tnode, const int32_t* inv, int B, int L,
                   int n, int32_t* scfg, int32_t* dcfg, int32_t* snode,
                   int32_t* dnode) {
  auto* kernel = quilt_descent_lookup_kernel<kSmem, kInv>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRows,
                                                      shmem);
  if (err != cudaSuccess) return err;
  const int64_t needed = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  kernel<<<static_cast<unsigned>(grid), kRows, shmem, stream>>>(
      u, cum, d, kb, lb, tcfg, tnode, inv, B, L, qkg::search_steps(L), n,
      scfg, dcfg, snode, dnode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` for rows [0, n).  With `inv` (the (B, 2^d) int32 dense
// inverse, non-null) each lookup is one gather there; with a null `inv`
// the lookups search the (B, L) tables.  Returns the CUDA error code of the
// launch (0 = launched); the caller raises on any other value.
int qkg_quilt_descent_lookup(int device, const void* u, const void* cum,
                             int d, const void* kb, const void* lb,
                             const void* tcfg, const void* tnode,
                             const void* inv, int B, int L, int n,
                             void* scfg, void* dcfg, void* snode, void* dnode,
                             void* stream) {
  if (d < 1 || d > qkg::kMaxLevels || B < 1 || L < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* uu = static_cast<const float*>(u);
  const auto* c = static_cast<const float*>(cum);
  const auto* k = static_cast<const int32_t*>(kb);
  const auto* l = static_cast<const int32_t*>(lb);
  const auto* tc = static_cast<const int32_t*>(tcfg);
  const auto* tn = static_cast<const int32_t*>(tnode);
  const auto* iv = static_cast<const int32_t*>(inv);
  auto* o0 = static_cast<int32_t*>(scfg);
  auto* o1 = static_cast<int32_t*>(dcfg);
  auto* o2 = static_cast<int32_t*>(snode);
  auto* o3 = static_cast<int32_t*>(dnode);
  if (iv != nullptr) {
    err = launch<false, true>(sms, tile_bytes(d), st, uu, c, d, k, l, tc, tn,
                              iv, B, L, n, o0, o1, o2, o3);
    return static_cast<int>(err);
  }
  bool use_smem = false;
  const size_t shmem = qkg::table_shared_bytes(device, B, L, tile_bytes(d), &use_smem);
  if (shmem == 0) return static_cast<int>(cudaErrorInvalidDevice);
  err = use_smem ? launch<true, false>(sms, shmem, st, uu, c, d, k, l, tc, tn,
                                       iv, B, L, n, o0, o1, o2, o3)
                 : launch<false, false>(sms, shmem, st, uu, c, d, k, l, tc,
                                        tn, iv, B, L, n, o0, o1, o2, o3);
  return static_cast<int>(err);
}

// 1 when a call with these tables at this d and no inverse keeps them in
// shared memory.
int qkg_descent_tables_in_smem(int device, int d, int B, int L) {
  bool in_smem = false;
  if (qkg::table_shared_bytes(device, B, L, tile_bytes(d), &in_smem) == 0) {
    return -1;
  }
  return in_smem ? 1 : 0;
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
