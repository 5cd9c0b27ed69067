// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/rmsnorm.py::_fwd_kernel (driven by
// _rms_norm_fwd_impl): y = x * rsqrt(mean(x^2) + eps) * scale per row of an
// [N, E] tensor, statistics in f32, y in x's dtype.
//
// What bounds it on the H100.  At many rows, memory: ~3 operations per
// element against 4 bytes moved (bf16 in and out), far below the card's
// ~295 operations per byte, so the least time is the bytes over 3.35 TB/s.
// At decode (1 to 8 rows, at most 12 KB) no rate of the card counts: a
// call takes the launch plus the chain of dependent memory round trips that
// a row waits on, so the design makes that chain one round trip long.
//
// Two forms, chosen by shape in the one entry point:
//
// * the register form, for rows of at most kRegRowBytes (2 KB) whose width
//   is a multiple of the 16-byte vector (8 values in bf16, 4 in f32), with
//   x, y and scale 16-byte aligned: the bf16 E = 768 of every path.  One
//   warp per row, neighbouring lanes on neighbouring 16-byte vectors.  A
//   lane issues all of its loads before its first add -- its vectors of x
//   and its columns of f32 scale, at E = 768 in bf16 three vectors of x and
//   six of scale -- so a row costs one memory round trip, not one for x and
//   another for scale.  Then the f32 sum of squares by shuffles, rsqrtf,
//   the products, one rounding to x's dtype, 16-byte stores.  Where N is
//   more rows than the grid has warps (it is capped at kBlocksPerSm blocks
//   an SM), a warp takes every (grid)-th row and keeps scale's columns in
//   registers across them;
// * the loop form, for every other width, dtype layout or alignment: two
//   passes over the row in 2- or 4-byte loads, the second served from L1;
//   scale is prefetched into L1 during the first pass, so the second does
//   not wait on a round trip to L2 for it.
//
// Registers (ptxas -v, sm_90a): the register form in bf16 takes 64 at
// three vectors a lane (E = 768) and 80 at four (E = 1024), none spilled.
//
// Rows do not depend on N: the form and the order of every sum follow from
// the width, the dtype and the alignment alone, so a token's row has the
// same bits in a decode of 8 rows, a prefill of 1024 and a training step.
// The grid, which does follow N (see launch_form), only decides which warp
// takes a row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "rmsnorm.cuh"

namespace {

using namespace hvd_rms;

constexpr int kMaxWarps = 8;     // rows a block takes at once, at most
constexpr int kMaxVecs = 4;      // register form: 16-byte vectors per lane
constexpr int kRegRowBytes = 32 * kMaxVecs * 16;
// The grid's cap, in blocks an SM: one wave of blocks of kMaxWarps warps
// for the bf16 E = 768 form (64 registers a thread: four such blocks fit
// an SM's 64K) and the loop form; the 80-register E = 1024 form fits
// three, so it runs the fourth in a second wave.
constexpr int kBlocksPerSm = 4;

// The register form: V 16-byte vectors of each row per lane.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_fwd_regs_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale, T* __restrict__ y,
                        int N, int E, float eps) {
  constexpr int kN = Vec<T>::kN;
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int nvec = E / kN;
  int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= N) return;
  const float4* s4 = reinterpret_cast<const float4*>(scale);

  // The first row's vectors of x and the lane's columns of scale, all
  // loaded before the first add.
  uint4 xv[V];
  float sc[V][kN];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int vi = lane + 32 * j;
    xv[j] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < kN; ++e) sc[j][e] = 0.f;
    if (vi < nvec) {
      xv[j] = reinterpret_cast<const uint4*>(x + (long)row * E)[vi];
#pragma unroll
      for (int k = 0; k < kN / 4; ++k) {
        const float4 s = s4[vi * (kN / 4) + k];
        sc[j][4 * k] = s.x; sc[j][4 * k + 1] = s.y;
        sc[j][4 * k + 2] = s.z; sc[j][4 * k + 3] = s.w;
      }
    }
  }

  for (;;) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f[kN];
      Vec<T>::unpack(xv[j], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)E + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (long)row * E);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= nvec) continue;
      float f[kN], o[kN];
      Vec<T>::unpack(xv[j], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) o[e] = f[e] * inv * sc[j][e];
      yr[vi] = Vec<T>::pack(o);
    }
    row += gridDim.x * warps;
    if (row >= N) return;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long)row * E);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (lane + 32 * j < nvec) xv[j] = xr[lane + 32 * j];
  }
}

// The loop form, for any width and alignment.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int N, int E, float eps) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  for (int row = blockIdx.x * warps + threadIdx.x / 32; row < N;
       row += gridDim.x * warps) {
    const T* xr = x + (long)row * E;
    T* yr = y + (long)row * E;
    float ss = 0.f;
    for (int i = lane; i < E; i += 32) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(scale + i));
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)E + eps);
    for (int i = lane; i < E; i += 32)
      yr[i] = from_f<T>(to_f(xr[i]) * inv * scale[i]);
  }
}

// One row per warp, in blocks of as few warps as spread the N rows over
// every SM, one block each, up to kMaxWarps: a decode's rows then land on
// separate SMs, each row's loads through its own L1.  The grid is capped
// at kBlocksPerSm blocks an SM, past which a warp takes several rows.
template <typename T, int V>
int launch_form(const void* x, const void* scale, void* y, int N, int E,
                float eps, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int warps = std::min(kMaxWarps, (N + sms - 1) / sms);
  const int blocks = std::min((N + warps - 1) / warps, kBlocksPerSm * sms);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  if constexpr (V == 0)
    rmsnorm_fwd_kernel<T><<<blocks, warps * 32, 0, stream>>>(xp, sp, yp, N,
                                                             E, eps);
  else
    rmsnorm_fwd_regs_kernel<T, V><<<blocks, warps * 32, 0, stream>>>(
        xp, sp, yp, N, E, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int N, int E,
           float eps, cudaStream_t stream) {
  const int row_bytes = E * (int)sizeof(T);
  if (E % Vec<T>::kN == 0 && row_bytes <= kRegRowBytes && aligned16(x) &&
      aligned16(y) && aligned16(scale)) {
    switch ((row_bytes / 16 + 31) / 32) {   // vectors per lane
      case 1: return launch_form<T, 1>(x, scale, y, N, E, eps, stream);
      case 2: return launch_form<T, 2>(x, scale, y, N, E, eps, stream);
      case 3: return launch_form<T, 3>(x, scale, y, N, E, eps, stream);
      default:
        return launch_form<T, kMaxVecs>(x, scale, y, N, E, eps, stream);
    }
  }
  return launch_form<T, 0>(x, scale, y, N, E, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x and y; scale is float32 [E].
// Returns a cudaError_t, or -1 for a dtype this kernel was not built for.
extern "C" int hvd_rmsnorm_fwd(const void* x, const void* scale, void* y,
                               int dtype, int N, int E, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, y, N, E, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, y, N, E, eps, s);
  return -1;
}
