// RMSNorm backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/rmsnorm.py::_bwd_kernel (driven by
// _rms_norm_bwd_impl): per row of an [N, E] tensor it recomputes
// r = rsqrt(mean(x^2) + eps) from x, emits
//
//   dx = r * (g - x^ * mean(g * x^)),   g = dy * scale,   x^ = x * r,
//
// in x's dtype, and dscale = sum over rows of dy * x^ in f32.  The TPU
// kernel writes per-block partials of dscale that its caller sums
// (rmsnorm.py:139); here the sum of the partials happens in the same
// launch, so one call is one kernel.  Statistics are f32.
//
// What bounds it on the H100: memory.  It does ~11 operations per element
// against 6 bytes moved (bf16 x and dy in, dx out), far below the card's
// ~295 operations per byte, so the least time is the bytes over 3.35 TB/s.
// The design reads each row from device memory once and keeps everything
// else out of it:
//
// * rows in registers (the register form): one warp per row, neighbouring
//   lanes on neighbouring 16-byte vectors; a lane loads its vectors of x
//   and dy once (at E = 768 bf16, three of 8 values each), reduces sum x^2
//   and sum g * x^ with shuffles and writes dx with 16-byte stores.  The
//   lane's columns of scale and its dscale partial stay in registers for
//   every row the warp takes, since they are the same columns;
// * the block's sum: at the end each warp puts its dscale partial in its
//   own shared-memory row and the block adds the rows once, in warp order,
//   into its row of the partials scratch [blocks, E];
// * the sum across blocks, in the same launch: blocks are grouped by index
//   in groups of kGroup.  Each block takes a ticket from its group's
//   counter after writing its row; the group's last block sums the group's
//   rows in block order, then takes a ticket from the top counter, whose
//   last block sums the group sums in group order into dscale.  Every sum
//   runs in an order fixed by block index, not arrival, so dscale is
//   deterministic; the last block of each counter resets it to 0, so the
//   counters (a small workspace the caller allocates once per device and
//   stream, zeroed) are zero again after every launch.  Two levels keep
//   the serial tail short: the last block reads kGroup + blocks/kGroup
//   rows, not all of them, and each thread issues a level's loads before
//   its first add, so a level costs one L2 round trip, not one per row.
//   (A level still puts a fence, an atomic and that round trip on the
//   critical path.  Thread-block clusters of 8 summing through
//   distributed shared memory in place of the first level measured slower
//   on the H100 at every shape of the training step, so the levels are
//   tickets.)
//
// Registers: the register form runs two blocks per SM (128 registers a
// thread); at four vectors a lane (E = 1024 in bf16) ptxas spills 40
// bytes to stay there, at three (E = 768) nothing.
//
// The caller caps the grid (ops/rmsnorm.py) and sets it from N and E
// alone, so the order of every sum, and the result, does not depend on the
// card.
//
// Widths the register form does not take -- E not a multiple of 8, rows
// of more than kRegRowBytes (E > 1024 in bf16, E > 512 in f32), or an
// input not 16-byte aligned -- take the loop form, chosen by shape in the
// same entry point: three passes over the row in 2- or 4-byte loads (the
// later ones served from L1), the dscale partials accumulated per warp in
// shared memory.  Both forms end in the same two-level sum.
//
// Rows past kMaxWarpRowsE (7168) take the wide form: the loop form's eight
// rows of f32 partials would pass the 227 KB of shared memory a block may
// use.  The whole block takes one row at a time, each thread the columns
// threadIdx.x + k * kThreads, so each column's dscale partial has one
// owner and the block keeps one row of them: in shared memory while E
// floats fit there (E <= 57856), else in the block's own row of the
// partials scratch in device memory.  A row's two sums run over the block
// (the warps' sums added in warp order), so dx is the same for a row alone
// or among any N, and the form ends in the same two-level sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "rmsnorm.cuh"

namespace {

using namespace hvd_rms;

constexpr int kWarps = 8;        // rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;       // blocks per group of the cross-block sum
constexpr int kMaxVecs = 4;      // register form: 16-byte vectors per lane
constexpr int kRegRowBytes = 32 * kMaxVecs * 16;
// The loop form's kWarps rows of f32 partials fit a block's shared memory
// up to this width; wider rows take the wide form.
constexpr int kMaxWarpRowsE = 7168;
// The wide form keeps its one row of partials in shared memory up to this
// many bytes (the 227 KB a block may use, less room for its static arrays).
constexpr size_t kMaxSmemRowBytes = 232448 - 1024;

// Called by every thread of the block once the block's data is written:
// true in the block that arrives last of n at *counter, which also resets
// the counter to 0 for the next launch.  The fences order the writes of
// the blocks before the ticket against the reads of the last one after it.
__device__ __forceinline__ bool last_arrival(unsigned* counter, unsigned n) {
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// out = the sum, in row order, of the n <= kGroup rows first, first +
// stride, ... of part ([*, E] f32, written by other blocks: read past L1).
// Each thread issues all its loads before the first add, so the reads
// overlap instead of paying one L2 round trip per row; 16-byte vectors
// where E and the pointers allow.
template <typename V>
__device__ __forceinline__ void sum_rows_as(const float* part, int first,
                                           int stride, int n, int E,
                                           float* out) {
  const V* src = reinterpret_cast<const V*>(part);
  const long row = E / (sizeof(V) / sizeof(float));
  for (int i = threadIdx.x; i < row; i += kThreads) {
    V v[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r < n) v[r] = __ldcg(src + (first + (long)r * stride) * row + i);
    V t = v[0];
#pragma unroll
    for (int r = 1; r < kGroup; ++r)
      if (r < n) add_to(t, v[r]);
    reinterpret_cast<V*>(out)[i] = t;
  }
}

__device__ __forceinline__ void sum_rows(const float* part, int first,
                                         int stride, int n, int E,
                                         float* out) {
  if (E % 4 == 0 && ((reinterpret_cast<uintptr_t>(part) |
                      reinterpret_cast<uintptr_t>(out)) % 16) == 0)
    sum_rows_as<float4>(part, first, stride, n, E, out);
  else
    sum_rows_as<float>(part, first, stride, n, E, out);
}

// The block's kRows shared-memory rows of dscale partials into its row of
// part (kRows = 0: the block accumulated into that row itself), then the
// two-level sum across blocks into dscale (see the top).
template <int kRows>
__device__ void finish_dscale(const float* sacc, int E, float* part,
                              float* dscale, unsigned* counters) {
  __syncthreads();
  const int blocks = gridDim.x, b = blockIdx.x;
  if constexpr (kRows > 0) {
    for (int i = threadIdx.x; i < E; i += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kRows; ++w) t += sacc[(long)w * E + i];
      part[(long)b * E + i] = t;
    }
  }
  const int groups = (blocks + kGroup - 1) / kGroup;
  const int g = b / kGroup, g0 = g * kGroup;
  const int gn = min(kGroup, blocks - g0);
  if (!last_arrival(counters + 1 + g, gn)) return;
  // The group's sum goes into its first row, or straight to dscale.
  sum_rows(part, g0, 1, gn, E, groups == 1 ? dscale : part + (long)g0 * E);
  if (groups == 1 || !last_arrival(counters, groups)) return;
  sum_rows(part, 0, kGroup, groups, E, dscale);
}

// The register form: V 16-byte vectors of each row per lane.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_bwd_regs_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        float* __restrict__ part, float* __restrict__ dscale,
                        unsigned* __restrict__ counters, int N, int E,
                        float eps) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ float sacc[];   // [kWarps][E] dscale partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = E / kN;

  float sc[V][kN], acc[V][kN];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int vi = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      sc[j][e] = vi < nvec ? scale[vi * kN + e] : 0.f;
      acc[j][e] = 0.f;
    }
  }

  for (int row = blockIdx.x * kWarps + warp; row < N;
       row += gridDim.x * kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long)row * E);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + (long)row * E);
    uint4* dxr = reinterpret_cast<uint4*>(dx + (long)row * E);
    uint4 xv[V], gv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int vi = lane + 32 * j;
      xv[j] = gv[j] = make_uint4(0u, 0u, 0u, 0u);
      if (vi < nvec) {
        xv[j] = xr[vi];
        gv[j] = dyr[vi];
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f[kN];
      Vec<T>::unpack(xv[j], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)E + eps);
    float gx = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f[kN], d[kN];
      Vec<T>::unpack(xv[j], f);
      Vec<T>::unpack(gv[j], d);
#pragma unroll
      for (int e = 0; e < kN; ++e) gx = fmaf(d[e] * sc[j][e], f[e] * inv, gx);
    }
    const float mean_gx = warp_sum(gx) / (float)E;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= nvec) continue;
      float f[kN], d[kN], o[kN];
      Vec<T>::unpack(xv[j], f);
      Vec<T>::unpack(gv[j], d);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xh = f[e] * inv;
        o[e] = inv * (d[e] * sc[j][e] - xh * mean_gx);
        acc[j][e] = fmaf(d[e], xh, acc[j][e]);
      }
      dxr[vi] = Vec<T>::pack(o);
    }
  }

#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int vi = lane + 32 * j;
    if (vi >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) sacc[(long)warp * E + vi * kN + e] = acc[j][e];
  }
  finish_dscale<kWarps>(sacc, E, part, dscale, counters);
}

// The loop form, for any width up to kMaxWarpRowsE.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ part, float* __restrict__ dscale,
                   unsigned* __restrict__ counters, int N, int E, float eps) {
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
  finish_dscale<kWarps>(sacc, E, part, dscale, counters);
}

// The sum of v over the block, the same bits in every thread: the warps'
// sums added in warp order.  red holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += red[w];
  __syncthreads();   // red is written again by the next call
  return t;
}

// The wide form, for rows past kMaxWarpRowsE: a block per row (see the
// top); the row of partials in shared memory (kInSmem) or in part.
template <typename T, bool kInSmem>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        float* __restrict__ part, float* __restrict__ dscale,
                        unsigned* __restrict__ counters, int N, int E,
                        float eps) {
  extern __shared__ float sacc[];   // [E] dscale partials, if kInSmem
  __shared__ float red[kWarps];
  float* acc = kInSmem ? sacc : part + (long)blockIdx.x * E;
  for (int i = threadIdx.x; i < E; i += kThreads) acc[i] = 0.f;

  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const T* xr = x + (long)row * E;
    const T* dyr = dy + (long)row * E;
    T* dxr = dx + (long)row * E;
    float ss = 0.f;
    for (int i = threadIdx.x; i < E; i += kThreads) {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)E + eps);
    float gx = 0.f;
    for (int i = threadIdx.x; i < E; i += kThreads)
      gx = fmaf(to_f(dyr[i]) * scale[i], to_f(xr[i]) * inv, gx);
    const float mean_gx = block_sum(gx, red) / (float)E;
    for (int i = threadIdx.x; i < E; i += kThreads) {
      const float d = to_f(dyr[i]);
      const float xh = to_f(xr[i]) * inv;
      dxr[i] = from_f<T>(inv * (d * scale[i] - xh * mean_gx));
      acc[i] = fmaf(d, xh, acc[i]);
    }
  }
  finish_dscale<kInSmem ? 1 : 0>(sacc, E, part, dscale, counters);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const float*, T*, float*,
                          float*, unsigned*, int, int, float);

template <typename T>
int launch_form(KernelFn<T> kernel, size_t smem, const void* x,
                const void* dy, const void* scale, void* dx, void* part,
                void* dscale, void* counters, int N, int E, float eps,
                int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(scale), static_cast<T*>(dx),
      static_cast<float*>(part), static_cast<float*>(dscale),
      static_cast<unsigned*>(counters), N, E, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dy, const void* scale, void* dx,
           void* part, void* dscale, void* counters, int N, int E, float eps,
           int blocks, cudaStream_t stream) {
  if (E > kMaxWarpRowsE) {
    const size_t row = sizeof(float) * (size_t)E;
    if (row <= kMaxSmemRowBytes)
      return launch_form<T>(rmsnorm_bwd_wide_kernel<T, true>, row, x, dy,
                            scale, dx, part, dscale, counters, N, E, eps,
                            blocks, stream);
    return launch_form<T>(rmsnorm_bwd_wide_kernel<T, false>, 0, x, dy, scale,
                          dx, part, dscale, counters, N, E, eps, blocks,
                          stream);
  }
  const int row_bytes = E * (int)sizeof(T);
  KernelFn<T> kernel = rmsnorm_bwd_kernel<T>;
  if (E % 8 == 0 && row_bytes <= kRegRowBytes && aligned16(x) &&
      aligned16(dy) && aligned16(dx) && aligned16(scale)) {
    switch ((row_bytes / 16 + 31) / 32) {   // vectors per lane
      case 1: kernel = rmsnorm_bwd_regs_kernel<T, 1>; break;
      case 2: kernel = rmsnorm_bwd_regs_kernel<T, 2>; break;
      case 3: kernel = rmsnorm_bwd_regs_kernel<T, 3>; break;
      default: kernel = rmsnorm_bwd_regs_kernel<T, kMaxVecs>; break;
    }
  }
  return launch_form<T>(kernel, sizeof(float) * (size_t)kWarps * E, x, dy,
                        scale, dx, part, dscale, counters, N, E, eps, blocks,
                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, dy and dx; scale is float32 [E];
// dscale is float32 [E]; part is float32 [blocks, E] scratch; counters is
// n_counters zeroed unsigned ints that the kernel leaves zeroed, at least
// 1 + ceil(blocks / 16) of them.  Returns a cudaError_t, or -1 for a dtype
// this kernel was not built for.
extern "C" int hvd_rmsnorm_bwd(const void* x, const void* dy,
                               const void* scale, void* dx, void* part,
                               void* dscale, void* counters, int n_counters,
                               int dtype, int N, int E, float eps, int blocks,
                               void* stream) {
  if (blocks < 1 || blocks > kGroup * kGroup ||
      1 + (blocks + kGroup - 1) / kGroup > n_counters)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, scale, dx, part, dscale, counters, N, E, eps, blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, scale, dx, part, dscale, counters, N, E, eps, blocks, s);
  return -1;
}
