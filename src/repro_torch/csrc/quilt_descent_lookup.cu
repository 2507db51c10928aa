// Quadrant descent of an (N, d) float32 uniforms operand + per-block
// sorted-config lookup: the host-path step of the quilting sampler.
//
// Replaces the Pallas TPU kernel quilt_descent_lookup
// (src/repro/kernels/quadrant_descent.py:131, body _quilt_kernel :64).
// Row i descends its d uniforms against the (d, 4) cumulative table to a
// (src_cfg, dst_cfg) pair, exactly as quadrant_descent.cu does, then looks
// src_cfg up in row kb[i] and dst_cfg in row lb[i] of the sentinel-padded
// (B, L) tables (csrc/sorted_lookup.cuh, the search of
// quilt_prng_descent_lookup.cu): node id on a hit, -1 on a miss.  Outputs
// are four int32 arrays of N rows, bit-identical to quilt_descent_lookup_plain
// in repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: per row 4 d bytes of uniforms and 8 of block ids read,
// 16 written (88 B at d = 16), against ~21 32-bit operations per level and
// ~10 per step of two fixed-length searches; chip_smoke.py reckons both.
// The uniforms are staged through shared memory as in quadrant_descent.cu
// (csrc/uniform_tile.cuh); the (B, L) tables sit in shared memory when they
// fit beside the tile (n = 2^12), else they are read through __ldg from L2
// (n = 2^16: 2.65 MB).
//
// Build WITHOUT --use_fast_math: the compares must be IEEE float32 compares.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "sorted_lookup.cuh"
#include "uniform_tile.cuh"

namespace {

constexpr int kRows = 512;  // rows per tile = threads per block
constexpr int kCumFloats = 4 * 32;

template <bool kSmem>
__global__ void __launch_bounds__(kRows)
    quilt_descent_lookup_kernel(const float* __restrict__ u,
                                const float* __restrict__ cum, int d,
                                const int32_t* __restrict__ kb,
                                const int32_t* __restrict__ lb,
                                const int32_t* __restrict__ tcfg,
                                const int32_t* __restrict__ tnode, int B,
                                int L, int steps, int n,
                                int32_t* __restrict__ scfg_out,
                                int32_t* __restrict__ dcfg_out,
                                int32_t* __restrict__ snode_out,
                                int32_t* __restrict__ dnode_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_cum = reinterpret_cast<float*>(smem);
  float* tile = s_cum + kCumFloats;
  const int stride = qkg::tile_stride(d);
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  const int32_t* cfg = tcfg;
  const int32_t* node = tnode;
  if (kSmem) {
    cfg = qkg::stage_tables(
        reinterpret_cast<unsigned char*>(tile + static_cast<size_t>(kRows) * stride),
        tcfg, tnode, B, L);
    node = cfg + static_cast<size_t>(B) * L;
  }
  for (int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRows; tile0 < n;
       tile0 += static_cast<int64_t>(gridDim.x) * kRows) {
    const int rows = static_cast<int>(n - tile0 < kRows ? n - tile0 : kRows);
    __syncthreads();  // the previous tile has been read (and the tables staged)
    qkg::load_tile<kRows>(tile, u, tile0, rows, d);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < rows) {
      const int64_t r = tile0 + threadIdx.x;
      int32_t sc, dc;
      qkg::descend_row(tile + threadIdx.x * stride, s_cum, d, &sc, &dc);
      scfg_out[r] = sc;
      dcfg_out[r] = dc;
      snode_out[r] = qkg::lookup<kSmem>(cfg, node, __ldg(kb + r), B, sc, L, steps);
      dnode_out[r] = qkg::lookup<kSmem>(cfg, node, __ldg(lb + r), B, dc, L, steps);
    }
  }
}

size_t tile_bytes(int d) {
  return (kCumFloats + static_cast<size_t>(kRows) * qkg::tile_stride(d)) *
         sizeof(float);
}

template <bool kSmem>
cudaError_t launch(int sms, size_t shmem, cudaStream_t stream, const float* u,
                   const float* cum, int d, const int32_t* kb,
                   const int32_t* lb, const int32_t* tcfg,
                   const int32_t* tnode, int B, int L, int n, int32_t* scfg,
                   int32_t* dcfg, int32_t* snode, int32_t* dnode) {
  cudaError_t err = cudaFuncSetAttribute(
      quilt_descent_lookup_kernel<kSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quilt_descent_lookup_kernel<kSmem>, kRows, shmem);
  if (err != cudaSuccess) return err;
  const int64_t needed = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  quilt_descent_lookup_kernel<kSmem>
      <<<static_cast<unsigned>(grid), kRows, shmem, stream>>>(
          u, cum, d, kb, lb, tcfg, tnode, B, L, qkg::search_steps(L), n, scfg,
          dcfg, snode, dnode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` for rows [0, n).  Returns the CUDA error code of the
// launch (0 = launched); the caller raises on any other value.
int qkg_quilt_descent_lookup(int device, const void* u, const void* cum,
                             int d, const void* kb, const void* lb,
                             const void* tcfg, const void* tnode, int B,
                             int L, int n, void* scfg, void* dcfg,
                             void* snode, void* dnode, void* stream) {
  if (d < 1 || d > qkg::kMaxLevels || B < 1 || L < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool use_smem = false;
  const size_t shmem = qkg::table_shared_bytes(device, B, L, tile_bytes(d), &use_smem);
  if (shmem == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* uu = static_cast<const float*>(u);
  const auto* c = static_cast<const float*>(cum);
  const auto* k = static_cast<const int32_t*>(kb);
  const auto* l = static_cast<const int32_t*>(lb);
  const auto* tc = static_cast<const int32_t*>(tcfg);
  const auto* tn = static_cast<const int32_t*>(tnode);
  auto* o0 = static_cast<int32_t*>(scfg);
  auto* o1 = static_cast<int32_t*>(dcfg);
  auto* o2 = static_cast<int32_t*>(snode);
  auto* o3 = static_cast<int32_t*>(dnode);
  err = use_smem ? launch<true>(sms, shmem, st, uu, c, d, k, l, tc, tn, B, L, n,
                                o0, o1, o2, o3)
                 : launch<false>(sms, shmem, st, uu, c, d, k, l, tc, tn, B, L,
                                 n, o0, o1, o2, o3);
  return static_cast<int>(err);
}

// 1 when a call with these tables at this d keeps them in shared memory.
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
