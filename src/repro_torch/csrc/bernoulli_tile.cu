// The naive sampler's fused tile: the MAGM log-Q tile compared against a
// tile of log-uniforms -> (M, N) int8 adjacency, A[i, j] = [log u < log Q].
//
// Replaces the Pallas TPU kernel bernoulli_tile
// (src/repro/kernels/bernoulli_tile.py:44, body _kernel :28), reached from
// ops.bernoulli_sample (the reference's bernoulli_sample_pallas) and the
// naive baseline (core/naive.py sample_tile / naive_sample: 256 launches of
// 2048 x 2048 at n = 2^15).
//
// Bound on an H100: bytes.  It reads 4 B of log u and writes 1 B of mask
// per cell (a 2048 x 2048 tile: 21 MB, 6.3 us at 3.35 TB/s; 8192 x 8192:
// 336 MB, 100 us) against d FMAs per cell.  The design (bilinear_tile.cuh)
// keeps log Q in registers, so it never goes to device memory (the fusion
// the TPU kernel made): per cell 5 B move instead of 4 + 4 + 4 + 1.  Each
// thread's 16 quads of log u (4 consecutive cells of a row) come by 16 B
// cp.async into its own slots of shared memory, issued before the tile's
// products and waited for after them, so the bytes are in flight while
// the FMAs run and hold no registers; a warp's copy covers 4 rows x 128 B.
// The mask leaves as char4 stores, a warp instruction writing 4 rows x
// 32 B, each run a full sector.  log u is read through a row stride, so a
// view into a larger draw (ops.bernoulli_sample draws over the shape
// padded to 256, as the reference does) needs no copy; an unaligned
// stride or base takes 4 B copies, and N % 4 != 0 scalar stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_tile.cuh"

namespace {

struct MaskOut {
  const float* logu;
  int64_t ld;
  int8_t* out;
  int N;
  bool vec_in;   // log u rows start 16 B aligned: 16 B copies
  bool vec_out;  // mask rows start 4 B aligned: char4 stores
  float4* lu;    // the thread's quads of log u in shared memory: lu[c * kTileThreads + tid]

  static constexpr bool kRowHalves = false;  // the compare waits for log u

  __device__ __forceinline__ void load(int c, int i, int j) const {
    float4* slot = lu + c * qkg::kTileThreads + threadIdx.x;
    const float* p = logu + static_cast<int64_t>(i) * ld + j;
    if (vec_in && j + 3 < N) {
      qkg::cp_async16(slot, p);
    } else {
      float* s = reinterpret_cast<float*>(slot);
      for (int x = 0; x < 4 && j + x < N; ++x) qkg::cp_async4(s + x, p + x);
    }
  }
  __device__ __forceinline__ char4 cells(int c, float4 q) const {
    const float4 l = lu[c * qkg::kTileThreads + threadIdx.x];
    return make_char4(l.x < q.x, l.y < q.y, l.z < q.z, l.w < q.w);
  }
  __device__ __forceinline__ void store(int i, int j, char4 m) const {
    int8_t* p = out + static_cast<int64_t>(i) * N + j;
    if (vec_out && j + 3 < N) {
      *reinterpret_cast<char4*>(p) = m;
    } else {
      if (j < N) p[0] = m.x;
      if (j + 1 < N) p[1] = m.y;
      if (j + 2 < N) p[2] = m.z;
      if (j + 3 < N) p[3] = m.w;
    }
  }
};

constexpr int kSmemBytes = qkg::kCells * qkg::kTileThreads * static_cast<int>(sizeof(float4));

__global__ void __launch_bounds__(qkg::kTileThreads, 2)
    bernoulli_tile_kernel(const float* __restrict__ fs,
                          const float* __restrict__ ft, int M, int N, int d,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ c0,
                          const float* __restrict__ logu, int64_t ld,
                          int8_t* __restrict__ out, bool vec_in, bool vec_out) {
  extern __shared__ float4 lu_smem[];
  MaskOut mask{logu, ld, out, N, vec_in, vec_out, lu_smem};
  qkg::bilinear_tiles(fs, ft, M, N, d, u, v, w, c0, mask);
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
  int ctas = 0;
  if (err == cudaSuccess) {
    err = qkg::persistent_ctas(bernoulli_tile_kernel, kSmemBytes, device, M, N, &ctas);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_in = ld % 4 == 0 && reinterpret_cast<uintptr_t>(logu) % 16 == 0;
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  bernoulli_tile_kernel<<<ctas, qkg::kTileThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fs), static_cast<const float*>(ft), M, N, d,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(c0),
      static_cast<const float*>(logu), ld, static_cast<int8_t*>(out), vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
