// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/rmsnorm.py::_fwd_kernel (driven by
// _rms_norm_fwd_impl): y = x * rsqrt(mean(x^2) + eps) * scale per row of an
// [N, E] tensor, statistics in f32, y in x's dtype.
//
// What bounds it on the H100: memory.  It does ~3 operations per element
// against 4 bytes moved (bf16 in and out), far below the card's ~295
// operations per byte, so the least time is the bytes over 3.35 TB/s.  The
// design reads each row once from device memory: one warp per row,
// neighbouring lanes on neighbouring elements (coalesced), the sum of
// squares reduced with shuffles, and the second pass over the row served
// from L1.  At the serving shapes (N <= 2048, E = 768) a call moves at most
// ~6 MB, so launch latency, not bandwidth, is what it pays.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;   // rows per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int N, int E, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const T* xr = x + (long)row * E;
  T* yr = y + (long)row * E;
  float ss = 0.f;
  for (int i = lane; i < E; i += 32) {
    const float f = to_f(xr[i]);
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)E + eps);
  for (int i = lane; i < E; i += 32) yr[i] = from_f<T>(to_f(xr[i]) * inv * scale[i]);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int N, int E, float eps,
           cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  rmsnorm_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), N, E, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; scale is float32.  Returns a
// cudaError_t, or -1 for a dtype this kernel was not built for.
extern "C" int hvd_rmsnorm_fwd(const void* x, const void* scale, void* y,
                               int dtype, int N, int E, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, y, N, E, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, y, N, E, eps, s);
  return -1;
}
