// RMSNorm backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/rmsnorm.py::_bwd_kernel (driven by
// _rms_norm_bwd_impl): per row of an [N, E] tensor it recomputes
// r = rsqrt(mean(x^2) + eps) from x, emits
//
//   dx = r * (g - x^ * mean(g * x^)),   g = dy * scale,   x^ = x * r,
//
// in x's dtype, and writes per-block f32 partials of dscale = sum dy * x^
// that the caller sums, as the TPU kernel's caller sums its per-block
// partials (rmsnorm.py:139).  Statistics are f32.
//
// What bounds it on the H100: memory.  It does ~11 operations per element
// against 6 bytes moved (bf16 x and dy in, dx out), far below the card's
// ~295 operations per byte, so the least time is the bytes over 3.35 TB/s.
// The design reads each row from device memory once: one warp per row,
// neighbouring lanes on neighbouring elements (coalesced), both row sums
// reduced with shuffles, the later passes over the row served from L1.
// The dscale partials stay out of device memory until the end: each warp
// adds its rows' dy * x^ into its own shared-memory row (no atomics, so
// the sum is deterministic), and each block writes one [E] row of f32
// partials.  The caller caps the grid (ops/rmsnorm.py), so the partials
// stay small next to x, and sets it from N alone, so the order of every
// sum, and the result, does not depend on the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;   // rows in flight per block

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ dscale_part, int N, int E, float eps) {
  extern __shared__ float sacc[];   // [kWarps][E] dscale partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* acc = sacc + (long)warp * E;
  for (int i = lane; i < E; i += 32) acc[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < N;
       row += gridDim.x * kWarps) {
    const T* xr = x + (long)row * E;
    const T* dyr = dy + (long)row * E;
    T* dxr = dx + (long)row * E;
    float ss = 0.f;
    for (int i = lane; i < E; i += 32) {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)E + eps);
    float gx = 0.f;
    for (int i = lane; i < E; i += 32)
      gx = fmaf(to_f(dyr[i]) * scale[i], to_f(xr[i]) * inv, gx);
    const float mean_gx = warp_sum(gx) / (float)E;
    for (int i = lane; i < E; i += 32) {
      const float d = to_f(dyr[i]);
      const float xh = to_f(xr[i]) * inv;
      dxr[i] = from_f<T>(inv * (d * scale[i] - xh * mean_gx));
      acc[i] = fmaf(d, xh, acc[i]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < E; i += kWarps * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sacc[(long)w * E + i];
    dscale_part[(long)blockIdx.x * E + i] = t;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const void* scale, void* dx,
           void* dscale_part, int N, int E, float eps, int blocks,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * E;
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(scale), static_cast<T*>(dx),
      static_cast<float*>(dscale_part), N, E, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, dy and dx; scale is float32 [E];
// dscale_part is float32 [blocks, E], one row per block, every row
// written.  Returns a cudaError_t, or -1 for a dtype this kernel was not
// built for.
extern "C" int hvd_rmsnorm_bwd(const void* x, const void* dy,
                               const void* scale, void* dx, void* dscale_part,
                               int dtype, int N, int E, float eps, int blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dy, scale, dx, dscale_part, N, E, eps, blocks, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, scale, dx, dscale_part, N, E, eps, blocks, s);
  return -1;
}
