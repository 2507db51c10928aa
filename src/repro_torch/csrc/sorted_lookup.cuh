// The sorted-table block lookup of the descent kernels, shared by
// quilt_prng_descent_lookup.cu and quilt_descent_lookup.cu.
//
// Row b of the (B, L) tables holds block b's configs ascending (INT32_MAX
// padding) and the node ids aligned with them (-1 padding).  A candidate's
// config is found by a lower-bound search of fixed length `steps` (as the
// reference's kernels search), its node id read on an exact hit, else -1.
//
// The tables sit in shared memory when both fit the device's opt-in limit
// beside the kernel's other shared bytes (n = 2^12: 145 KB), else they are
// read from global memory through the read-only path (__ldg; L2-resident at
// the sizes the samplers give them).  Host code picks the branch with
// table_shared_bytes and launches the kernel template with kSmem set.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qkg {

template <bool kSmem>
__device__ __forceinline__ int32_t table_load(const int32_t* p) {
  if (kSmem) return *p;
  return __ldg(p);
}

// First position in row `row` whose config is >= target, by `steps`
// iterations with the probe index clamped to L - 1; the node id there on
// an exact hit, else -1.  A row outside [0, B) is a miss.
template <bool kSmem>
__device__ __forceinline__ int32_t lookup(const int32_t* cfg,
                                          const int32_t* node, int row,
                                          int B, int32_t target, int L,
                                          int steps) {
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(B)) return -1;
  const int32_t* c = cfg + static_cast<size_t>(row) * L;
  int lo = 0, hi = L;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const int32_t probe = table_load<kSmem>(c + min(mid, L - 1));
    const bool active = lo < hi;
    const bool right = active && probe < target;
    lo = right ? mid + 1 : lo;
    hi = (active && !right) ? mid : hi;
  }
  const int pos = min(lo, L - 1);
  return table_load<kSmem>(c + pos) == target
             ? table_load<kSmem>(node + static_cast<size_t>(row) * L + pos)
             : -1;
}

// Copies the (B, L) tables into `smem` (configs, then nodes) with the whole
// block; the caller synchronises.  Returns the shared config table; the node
// table follows it.
__device__ __forceinline__ int32_t* stage_tables(unsigned char* smem,
                                                 const int32_t* tcfg,
                                                 const int32_t* tnode, int B,
                                                 int L) {
  int32_t* s_cfg = reinterpret_cast<int32_t*>(smem);
  int32_t* s_node = s_cfg + static_cast<size_t>(B) * L;
  for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
    s_cfg[i] = tcfg[i];
    s_node[i] = tnode[i];
  }
  return s_cfg;
}

// Search length for a row of width L: enough halvings to close any window.
inline int search_steps(int L) {
  int x = L - 1 > 1 ? L - 1 : 1, b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b + 1;
}

// Dynamic shared memory of a launch: `other` bytes of the kernel's own,
// plus the (B, L) tables when they fit the device's opt-in limit beside
// them.  Returns 0 on failure.
inline size_t table_shared_bytes(int device, int B, int L, size_t other,
                                 bool* tables_in_smem) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  const size_t table_bytes = 2 * static_cast<size_t>(B) * L * sizeof(int32_t);
  *tables_in_smem = other + table_bytes <= static_cast<size_t>(optin);
  return other + (*tables_in_smem ? table_bytes : 0);
}

}  // namespace qkg
