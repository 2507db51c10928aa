// The exact round's acceptance: each candidate's final keep byte.
//
// Replaces no Pallas kernel.  The reference computes this in jnp inside
// src/repro/core/quilt.py::_exact_cell_valid.  In plain PyTorch (the CPU
// path, kernels/exact_accept.py) it is some 2,000 elementwise passes over
// the round, since core/f32math.py emulates each float32 fused multiply-add
// with about ten float64 and int64 passes; here it is one.
// One thread per candidate row of gc graphs x a_tot slots:
//   valid = snode >= 0 && dnode >= 0 && u01(salt, gid, cell) < alpha(scfg, dcfg)
// with gid = gids[row / a_tot], cell = scfg * 2^bits + dcfg (quilting,
// bits = d) or snode * 2^bits + dnode (ball dropping's node pair), and
//   logp   = sum over levels k (from 0, the most significant bit) of
//            logt[4k + 2 a_k + b_k], one float32 add at a time;
//   logpi  = (logp - log_level_sum) - log_extra;
//   pi     = exp(logpi);  q = -expm1(G * log1p(-pi));
//   alpha  = min(exp(logp - log q), 1);
//   u01    = splitmix64(salt ^ gid * G64 ^ cell * C64) >> 40, times 2^-24.
// The output is one bool byte a row, bit-identical to the plain version in
// repro_torch/kernels/exact_accept.py (and so to the reference).
//
// Exactness.  The transcendentals are core/f32math.py's polynomials, step
// for step: each f32math.fma is __fmaf_rn and every other float operation
// an unfused __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, because the
// shared build flags keep nvcc's default -fmad=true, which would contract a
// plain a * b + c.  The flushes are f32math's explicit ones (its _f32 on
// inputs, _ftz on exp's result) and no others: build WITHOUT
// --use_fast_math or -ftz=true.  Clamps are comparisons that pass NaN, as
// torch.clamp does.  Where f32math computes two arms and picks one (log1p,
// expm1's tanh arm), the kernel computes only the one it picks.
//
// Bound on an H100 at the exact cell (n = 2^15, d = 15, 25,885,867 rows, of
// which 539,984, 2.1%, hit both lookups): every row reads snode and dnode
// and writes one byte (9 B), a hit also reads scfg and dcfg (8 B): 0.24 GB,
// 0.071 ms at 3.35 TB/s.  Every row runs ~10 lane operations (loads,
// compares, the store) and a hit ~370 more (8 a level for the table sum,
// ~45 for the 64-bit hash, ~25 for the row decode, ~180 for the five
// transcendentals): 4.6e8, 0.014 ms at 128 lanes x 132 SMs x 1.98 GHz.
// Bytes bound (analysis/roofline.py::accept_bound_ms).
// Design: a miss row reads nothing past its two node ids and writes 0, so
// the bytes stay at that floor.  The per-level table (4d floats) comes by
// value, as a kernel argument (no device buffer, no copy), and is read by a
// data-dependent index d times a hit: registers cannot serve that (they are
// not indexable) and the argument space serializes lanes that read
// different words, so each block stages it in shared memory once and
// strides over rows.  The polynomial coefficients sit in constant memory,
// read as operands; the salt is one 8-byte read a thread.  Divergence costs
// the rest: about half the warps hold a hit and run the ~370 operations for
// it while their other lanes wait.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 31;

// the per-level log table, passed by value
struct LevelLogs {
  float v[4 * kMaxLevels];
};

// core/f32math.py's float32 constants, as exact hex literals (the
// polynomials' in constant memory: a uniform index reads them as operands)
constexpr float kMinNormal = 0x1p-126f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kExpLo = -0x1.5f3334p+6f;
constexpr float kExpHi = 0x1.633334p+6f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLog1pSmall = 0x1.a8279ap-2f;
constexpr float kTanhTiny = 0x1.a36e2ep-12f;
constexpr float kTanhClamp = 0x1.ffec88p+2f;
__constant__ float kExpP[5] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.11121p-7f,
                               0x1.555382p-5f, 0x1.555554p-3f};
__constant__ float kLogP[9] = {0x1.204376p-4f, -0x1.d7a37p-4f,  0x1.de4a34p-4f,
                               -0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555cap-3f,
                               0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
__constant__ float kLog1pDen[6] = {0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                                   0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
__constant__ float kLog1pNum[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                                   0x1.de9738p+4f,  0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                                   0x1.40a202p+4f};
__constant__ float kTanhA[7] = {-0x1.3e4b8p-52f, 0x1.c266fcp-43f, -0x1.7a6ffep-34f,
                                0x1.b80082p-25f, 0x1.f28694p-17f, 0x1.4e1bdap-11f,
                                0x1.40b3b8p-8f};
__constant__ float kTanhB[4] = {0x1.41a7bp-20f, 0x1.f12bacp-14f, 0x1.29540ap-9f,
                                0x1.40b3bap-8f};

// _accept_u01's splitmix64 constants (core/quilt.py)
constexpr uint64_t kAccG = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kAccC = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kAccM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kAccM2 = 0x94D049BB133111EBull;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// f32math._ftz: |x| below the smallest normal becomes a zero of x's sign
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kMinNormal ? __fmul_rn(x, 0.0f) : x;
}

// f32math.exp
__device__ float f32_exp(float x) {
  x = clamp(ftz(x), kExpLo, kExpHi);
  const float fx = clamp(floorf(fma_(x, kLog2e, 0.5f)), -127.0f, 127.0f);
  const float r = fma_(fx, -kLn2Lo, fma_(fx, -kLn2Hi, x));
  float p = fma_(r, kExpP[0], kExpP[1]);
  p = fma_(p, r, kExpP[2]);
  p = fma_(p, r, kExpP[3]);
  p = fma_(p, r, kExpP[4]);
  p = fma_(p, r, 0.5f);
  const float y = __fadd_rn(fma_(p, __fmul_rn(r, r), r), 1.0f);
  const float pow2 = __int_as_float((static_cast<int>(fx) + 127) << 23);
  return ftz(__fmul_rn(y, pow2));
}

// f32math._log_core: log of a positive normal float
__device__ float log_core(float x) {
  const int bits = __float_as_int(x < kMinNormal ? kMinNormal : x);
  const float m = __int_as_float((bits & -0x7F800001) | 0x3F000000);
  const bool low = m < kSqrtHalf;
  const float e = __fsub_rn(__fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f),
                            low ? 1.0f : 0.0f);
  const float x1 = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(x1, x1);
  const float x3 = __fmul_rn(x2, x1);
  float y = fma_(fma_(x1, kLogP[0], kLogP[1]), x1, kLogP[2]);
  const float y1 = fma_(fma_(x1, kLogP[3], kLogP[4]), x1, kLogP[5]);
  const float y2 = fma_(fma_(x1, kLogP[6], kLogP[7]), x1, kLogP[8]);
  y = fma_(fma_(y, x3, y1), x3, y2);
  y = fma_(y, x3, __fmul_rn(e, kLn2Lo));
  return fma_(e, kLn2Hi, __fadd_rn(fma_(x2, -0.5f, x1), y));
}

// f32math._log_special
__device__ __forceinline__ float log_of(float x) {
  if (x == __int_as_float(0x7f800000)) return x;             // +inf
  if (x == 0.0f) return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  return x > 0.0f ? log_core(x) : __int_as_float(0x7fc00000);  // NaN
}

// f32math.log
__device__ __forceinline__ float f32_log(float x) { return log_of(ftz(x)); }

// f32math.log1p, the arm it picks
__device__ float f32_log1p(float x) {
  x = ftz(x);
  if (!(fabsf(x) < kLog1pSmall)) return log_of(__fadd_rn(x, 1.0f));
  float den = __fadd_rn(x, kLog1pDen[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) den = fma_(den, x, kLog1pDen[i]);
  float num = fma_(x, kLog1pNum[0], kLog1pNum[1]);
#pragma unroll
  for (int i = 2; i < 7; ++i) num = fma_(num, x, kLog1pNum[i]);
  const float x2 = __fmul_rn(x, x);
  return __fadd_rn(x, fma_(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
}

// f32math._tanh
__device__ float f32_tanh(float h) {
  const float hc = clamp(h, -kTanhClamp, kTanhClamp);
  const float h2 = __fmul_rn(hc, hc);
  float p = fma_(h2, kTanhA[0], kTanhA[1]);
#pragma unroll
  for (int i = 2; i < 7; ++i) p = fma_(h2, p, kTanhA[i]);
  float q = fma_(h2, kTanhB[0], kTanhB[1]);
#pragma unroll
  for (int i = 2; i < 4; ++i) q = fma_(h2, q, kTanhB[i]);
  const float t = fabsf(h) < kTanhTiny ? h : __fdiv_rn(__fmul_rn(hc, p), q);
  return fabsf(h) >= 20.0f ? copysignf(1.0f, h) : t;
}

// f32math.expm1, the arm it picks
__device__ float f32_expm1(float raw) {
  const float x = ftz(raw);
  const float h = __fmul_rn(x, 0.5f);
  if (h == 0.0f) return raw;  // tiny inputs pass through as given
  const float e = f32_exp(x);
  if (fabsf(x) > 0.5f) return __fsub_rn(e, 1.0f);
  return __fmul_rn(f32_tanh(h), __fadd_rn(e, 1.0f));
}

// quilt._exact_alpha of one candidate
__device__ float exact_alpha(const float* logt, int d, int sc, int dc,
                             float log_level_sum, float log_extra, float g) {
  float logp = 0.0f;
  for (int k = 0; k < d; ++k) {
    const int shift = d - 1 - k;
    const float v = logt[4 * k + (((sc >> shift) & 1) << 1) + ((dc >> shift) & 1)];
    logp = k == 0 ? v : __fadd_rn(logp, v);
  }
  const float logpi = __fsub_rn(__fsub_rn(logp, log_level_sum), log_extra);
  const float pi = f32_exp(logpi);
  const float q = -f32_expm1(__fmul_rn(g, f32_log1p(-pi)));
  const float a = f32_exp(__fsub_rn(logp, f32_log(q)));
  return a > 1.0f ? 1.0f : a;  // torch.clamp_max: NaN passes through
}

// quilt._accept_u01 of one candidate
__device__ __forceinline__ float accept_u01(uint64_t salt, uint64_t gid, uint64_t cell) {
  uint64_t x = salt ^ (gid * kAccG) ^ (cell * kAccC);
  x = (x ^ (x >> 30)) * kAccM1;
  x = (x ^ (x >> 27)) * kAccM2;
  x ^= x >> 31;
  return __fmul_rn(__ull2float_rn(x >> 40), 0x1p-24f);
}

template <bool kNodePair>
__global__ void __launch_bounds__(kThreads)
    exact_accept_kernel(const int64_t* __restrict__ salt_ptr,
                        const int32_t* __restrict__ gids, int a_tot,
                        const LevelLogs logt, int d,
                        float log_level_sum, float log_extra, float g, int bits,
                        const int32_t* __restrict__ scfg,
                        const int32_t* __restrict__ dcfg,
                        const int32_t* __restrict__ snode,
                        const int32_t* __restrict__ dnode,
                        uint8_t* __restrict__ valid, int n) {
  __shared__ float s_logt[4 * kMaxLevels];
  for (int i = threadIdx.x; i < 4 * d; i += blockDim.x) s_logt[i] = logt.v[i];
  __syncthreads();
  const uint64_t salt = static_cast<uint64_t>(*salt_ptr);

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int row = static_cast<int>(r);
    const int32_t sn = snode[row], dn = dnode[row];
    uint8_t ok = 0;
    if (sn >= 0 && dn >= 0) {
      const int32_t sc = scfg[row], dc = dcfg[row];
      const int64_t gid = __ldg(gids + row / a_tot);
      // int64 arithmetic that wraps mod 2^64, as the plain version's
      const int64_t hi = kNodePair ? sn : sc, lo = kNodePair ? dn : dc;
      const uint64_t cell = (static_cast<uint64_t>(hi) << bits) + static_cast<uint64_t>(lo);
      const float u = accept_u01(salt, static_cast<uint64_t>(gid), cell);
      ok = u < exact_alpha(s_logt, d, sc, dc, log_level_sum, log_extra, g);
    }
    valid[row] = ok;
  }
}

template <bool kNodePair>
cudaError_t launch(int sms, cudaStream_t stream, const int64_t* salt,
                   const int32_t* gids, int a_tot, const LevelLogs& logt, int d,
                   float lls, float log_extra, float g, int bits,
                   const int32_t* scfg, const int32_t* dcfg,
                   const int32_t* snode, const int32_t* dnode, uint8_t* valid,
                   int n) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, exact_accept_kernel<kNodePair>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t needed = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  exact_accept_kernel<kNodePair><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      salt, gids, a_tot, logt, d, lls, log_extra, g, bits, scfg, dcfg, snode,
      dnode, valid, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` for the rows gc * a_tot (= n).  `salt` points at one
// int64 on the device, `logt` at the 4d floats of the table in host memory
// (copied into the launch's arguments); `node_pair` != 0 hashes the node
// pair (ball dropping), else the config pair.  Returns the CUDA error code of the
// launch (0 = launched); the caller raises on any other value.
int qkg_exact_accept(int device, const void* salt, const void* gids, int gc,
                     int a_tot, const void* logt, int d, float log_level_sum,
                     float log_extra, float g, int node_pair, int bits,
                     const void* scfg, const void* dcfg, const void* snode,
                     const void* dnode, void* valid, void* stream) {
  if (d < 1 || d > kMaxLevels || gc < 1 || a_tot < 1 || bits < 0 || bits > 62 ||
      static_cast<int64_t>(gc) * a_tot > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = gc * a_tot;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int64_t*>(salt);
  const auto* gi = static_cast<const int32_t*>(gids);
  LevelLogs lt{};
  for (int i = 0; i < 4 * d; ++i) lt.v[i] = static_cast<const float*>(logt)[i];
  const auto* sc = static_cast<const int32_t*>(scfg);
  const auto* dc = static_cast<const int32_t*>(dcfg);
  const auto* sn = static_cast<const int32_t*>(snode);
  const auto* dn = static_cast<const int32_t*>(dnode);
  auto* out = static_cast<uint8_t*>(valid);
  err = node_pair
            ? launch<true>(sms, st, s, gi, a_tot, lt, d, log_level_sum, log_extra, g,
                           bits, sc, dc, sn, dn, out, n)
            : launch<false>(sms, st, s, gi, a_tot, lt, d, log_level_sum, log_extra, g,
                            bits, sc, dc, sn, dn, out, n);
  return static_cast<int>(err);
}

const char* qkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
