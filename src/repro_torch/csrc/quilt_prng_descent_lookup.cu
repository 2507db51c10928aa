// Fused counter-PRNG quadrant descent + per-block sorted-config lookup.
//
// Replaces the Pallas TPU kernel quilt_prng_descent_lookup
// (src/repro/kernels/quadrant_descent.py, body _prng_quilt_kernel).  One
// thread per candidate row:
//   row -> (local graph, slot) -> global graph id gid = gids[local];
//   d counter-hash uniforms u_k = (hash(s0, s1, gid, slot*64 + k) >> 8) * 2^-24;
//   quadrant descent against the (d, 4) cumulative table -> (src_cfg, dst_cfg);
//   block pair (kb, lb) = (gid mod B^2) split in base B, or two rank channels
//   (ranks != 0, ball dropping);
//   lower-bound search of each config in its block's row of the
//   sentinel-padded (B, L) tables -> node id, -1 on a miss.
// Outputs are four int32 arrays of gc * a_tot rows, bit-identical to the
// plain PyTorch version in repro_torch/kernels/quadrant_descent.py.
//
// Bound on an H100: 32-bit integer operations.  Per row, ~35 per level (the
// counter hash, the uniform, the compares, the bit updates) and ~10 per step
// of two fixed-length searches; at n = 2^15 (d = 15, 16 steps, 25.9 M rows)
// that is ~2.4e10 ops, 0.72 ms at 128 lanes x 132 SMs x 1.98 GHz, against
// 16 B of output per row (0.41 GB, 0.12 ms at 3.35 TB/s).  The
// design keeps the bytes at that floor: nothing but the outputs goes to
// device memory; the (d, 4) table always sits in shared memory, and the
// (B, L) tables do too when 2*B*L*4 bytes fit the opt-in limit (n = 2^12:
// 145 KB), else they are read from global memory through the read-only path
// (n = 2^15: 1.16 MB, L2-resident); the search is csrc/sorted_lookup.cuh,
// shared with quilt_descent_lookup.cu.  Blocks stride over rows so each
// block loads the tables once.
//
// All hash arithmetic is native uint32; the uniform's conversion is exact
// (24 bits), so build WITHOUT --use_fast_math: the compares must be the
// IEEE float32 compares of the reference.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "sorted_lookup.cuh"

namespace {

using qkg::counter_hash;
using qkg::counter_u01;
using qkg::kChannels;
using qkg::kMaxLevels;

constexpr uint32_t kRank0 = kChannels - 2;
constexpr int kThreads = 512;
constexpr size_t kCumBytes = 4 * 32 * sizeof(float);  // (d <= 31, 4) f32, 16 B aligned

template <bool kSmem, bool kRanks>
__global__ void __launch_bounds__(kThreads)
    quilt_prng_kernel(uint32_t s0, uint32_t s1,
                      const int32_t* __restrict__ gids,
                      const float* __restrict__ cum, int d,
                      const int32_t* __restrict__ tcfg,
                      const int32_t* __restrict__ tnode, int B, int L,
                      int steps, int a_tot, int num_blocks,
                      int32_t* __restrict__ scfg_out,
                      int32_t* __restrict__ dcfg_out,
                      int32_t* __restrict__ snode_out,
                      int32_t* __restrict__ dnode_out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_cum = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_cum[i] = cum[i];
  const int32_t* cfg = tcfg;
  const int32_t* node = tnode;
  if (kSmem) {
    cfg = qkg::stage_tables(smem + kCumBytes, tcfg, tnode, B, L);
    node = cfg + static_cast<size_t>(B) * L;
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int row = static_cast<int>(r);
    const int local = row / a_tot;
    const int slot = row - local * a_tot;
    const int32_t gid = __ldg(gids + local);
    const uint32_t base = static_cast<uint32_t>(slot) * kChannels;
    int32_t sc = 0, dc = 0;
    for (int k = 0; k < d; ++k) {
      const float u = counter_u01(s0, s1, static_cast<uint32_t>(gid),
                                  base + static_cast<uint32_t>(k));
      qkg::descend_level(u, s_cum + 4 * k, &sc, &dc);
    }
    int kb, lb;
    if (kRanks) {
      const uint32_t nb = static_cast<uint32_t>(num_blocks);
      kb = static_cast<int>(
          (counter_hash(s0, s1, gid, base + kRank0) >> 1) % nb);
      lb = static_cast<int>(
          (counter_hash(s0, s1, gid, base + kRank0 + 1) >> 1) % nb);
    } else {
      const int blk = gid % (num_blocks * num_blocks);
      kb = blk / num_blocks;
      lb = blk - kb * num_blocks;
    }
    scfg_out[row] = sc;
    dcfg_out[row] = dc;
    snode_out[row] = qkg::lookup<kSmem>(cfg, node, kb, B, sc, L, steps);
    dnode_out[row] = qkg::lookup<kSmem>(cfg, node, lb, B, dc, L, steps);
  }
}

template <bool kSmem, bool kRanks>
cudaError_t launch(int sms, size_t shmem, cudaStream_t stream, uint32_t s0,
                   uint32_t s1, const int32_t* gids, const float* cum, int d,
                   const int32_t* tcfg, const int32_t* tnode, int B, int L,
                   int steps, int a_tot, int num_blocks, int32_t* scfg,
                   int32_t* dcfg, int32_t* snode, int32_t* dnode, int n) {
  cudaError_t err = cudaFuncSetAttribute(
      quilt_prng_kernel<kSmem, kRanks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quilt_prng_kernel<kSmem, kRanks>, kThreads, shmem);
  if (err != cudaSuccess) return err;
  const int64_t needed = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  quilt_prng_kernel<kSmem, kRanks>
      <<<static_cast<unsigned>(grid), kThreads, shmem, stream>>>(
          s0, s1, gids, cum, d, tcfg, tnode, B, L, steps, a_tot, num_blocks,
          scfg, dcfg, snode, dnode, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` for the rows gc * a_tot.  Returns the CUDA error code
// of the launch (0 = launched); the caller raises on any other value.
int qkg_quilt_prng_descent_lookup(int device, uint32_t s0, uint32_t s1,
                                  const void* gids, int gc, const void* cum,
                                  int d, const void* tcfg, const void* tnode,
                                  int B, int L, int a_tot, int num_blocks,
                                  int ranks, void* scfg, void* dcfg,
                                  void* snode, void* dnode, void* stream) {
  if (d < 1 || d > kMaxLevels || B < 1 || L < 1 || gc < 1 || a_tot < 1 ||
      num_blocks < 1 || num_blocks > B ||
      static_cast<int64_t>(gc) * a_tot > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = gc * a_tot;
  const int steps = qkg::search_steps(L);

  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool use_smem = false;
  const size_t shmem = qkg::table_shared_bytes(device, B, L, kCumBytes, &use_smem);
  if (shmem == 0) return static_cast<int>(cudaErrorInvalidDevice);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int32_t*>(gids);
  const auto* c = static_cast<const float*>(cum);
  const auto* tc = static_cast<const int32_t*>(tcfg);
  const auto* tn = static_cast<const int32_t*>(tnode);
  auto* o0 = static_cast<int32_t*>(scfg);
  auto* o1 = static_cast<int32_t*>(dcfg);
  auto* o2 = static_cast<int32_t*>(snode);
  auto* o3 = static_cast<int32_t*>(dnode);
  if (use_smem && ranks) {
    err = launch<true, true>(sms, shmem, st, s0, s1, g, c, d, tc, tn, B, L,
                             steps, a_tot, num_blocks, o0, o1, o2, o3, n);
  } else if (use_smem) {
    err = launch<true, false>(sms, shmem, st, s0, s1, g, c, d, tc, tn, B, L,
                              steps, a_tot, num_blocks, o0, o1, o2, o3, n);
  } else if (ranks) {
    err = launch<false, true>(sms, shmem, st, s0, s1, g, c, d, tc, tn, B, L,
                              steps, a_tot, num_blocks, o0, o1, o2, o3, n);
  } else {
    err = launch<false, false>(sms, shmem, st, s0, s1, g, c, d, tc, tn, B, L,
                               steps, a_tot, num_blocks, o0, o1, o2, o3, n);
  }
  return static_cast<int>(err);
}

// 1 when a call with these tables keeps them in shared memory.
int qkg_tables_in_smem(int device, int B, int L) {
  bool in_smem = false;
  if (qkg::table_shared_bytes(device, B, L, kCumBytes, &in_smem) == 0) return -1;
  return in_smem ? 1 : 0;
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
