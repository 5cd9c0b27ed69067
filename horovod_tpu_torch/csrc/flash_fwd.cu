// Forward flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/flash_attention.py::_flash_kernel (driven by
// _flash_forward): online-softmax attention over [B, S, H, D] with the
// scale * log2(e) fold into q, exp2-domain scores, an f32 accumulator cast
// to the input dtype, and a natural-log lse that is NEG_INF for rows that
// attended to nothing.
//
// What bounds it on the H100: causal attention does ~2*S*S*D operations
// (the visible half of QK^T and PV) against ~4*S*D*2 bytes of bf16 q, k, v
// and out per head, so at D = 128 it sits near the card's ridge of ~295
// operations per byte: the bytes bound it up to S ~ 1200, the tensor cores
// above.  This first version does its products on the CUDA cores in f32
// (67 TFLOP/s peak, not the tensor cores' 989), so its own issue rate, not
// either bound, is what it pays; it is written to be right and simple, and
// its design only keeps the traffic low:
//
// * one block per (64-row q tile, batch*head); a loop inside the block over
//   64-key K/V tiles takes the place of the TPU's sequential K grid axis,
//   so m, l and the accumulator never leave registers;
// * K and V tiles go through shared memory once per block, read in place
//   from the [B, S, H, D] layout (no transposes on the host);
// * tiles entirely above the causal diagonal are skipped;
// * each warp owns 8 q rows and updates them 4 at a time, so one shared
//   load of K or V feeds 4 rows' FMAs.
//
// Masking follows the TPU kernel: a key at global position k_offset + j is
// visible to the query at q_offset + i iff j < Sk and (not causal or
// q_offset + i >= k_offset + j).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;   // 8
constexpr int kR = 4;                        // rows updated together
constexpr int kGroups = kRowsPerWarp / kR;   // 2

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
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t smem_bytes(int d) {
  // q tile [BQ][D], K tile [BK][D+1] (padded: lane j reads row j, so the
  // pad puts neighbouring lanes on neighbouring banks), V tile [BK][D],
  // per-warp probabilities [warps][R][BK].
  return sizeof(float) *
         (size_t)(kBQ * d + kBK * (d + 1) + kBK * d + kWarps * kR * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 int q_offset, int k_offset, float qscale) {
  constexpr int DL = D / 32;   // output dims per lane
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * D;
  float* sv = sk + kBK * (D + 1);
  float* sp = sv + kBK * D;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;   // elements between consecutive positions
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

  // q tile, pre-scaled by scale*log2(e) and rounded to the input dtype
  // once, exactly as the TPU kernel folds it.
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f(from_f<T>(to_f(qb[(long)(q0 + r) * rs + d]) * qscale));
    sq[i] = x;
  }

  float m[kGroups][kR], l[kGroups][kR], acc[kGroups][kR][DL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[g][r] = kNegInf;
      l[g][r] = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[g][r][i] = 0.f;
    }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    // The first key of tile t sits at k_offset + t*BK; tiles whose first
    // key lies past this block's last query are masked out entirely.
    const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
    const int span = q_last - k_offset;
    n_tiles = span < 0 ? 0 : min(n_tiles, span / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile is fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        kx = to_f(kb[(long)(k0 + c) * rs + d]);
        vx = to_f(vb[(long)(k0 + c) * rs + d]);
      }
      sk[c * (D + 1) + d] = kx;
      sv[c * D + d] = vx;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int rb = warp * kRowsPerWarp + g * kR;   // first local row
      float s[kR][2];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float ka = sk[lane * (D + 1) + d];
        const float kc = sk[(lane + 32) * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float qv = sq[(rb + r) * D + d];
          s[r][0] = fmaf(qv, ka, s[r][0]);
          s[r][1] = fmaf(qv, kc, s[r][1]);
        }
      }
      float* pw = sp + warp * kR * kBK;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int qpos = q_offset + q0 + rb + r;
        float p[2];
        bool ok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = k0 + lane + 32 * j;
          ok[j] = c < Sk && (!causal || qpos >= k_offset + c);
          if (!ok[j]) s[r][j] = kNegInf;
        }
        const float m_new = fmaxf(m[g][r], warp_max(fmaxf(s[r][0], s[r][1])));
#pragma unroll
        for (int j = 0; j < 2; ++j) p[j] = ok[j] ? exp2f(s[r][j] - m_new) : 0.f;
        const float corr = exp2f(m[g][r] - m_new);
        l[g][r] = l[g][r] * corr + warp_sum(p[0] + p[1]);
        m[g][r] = m_new;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][r][i] *= corr;
        pw[r * kBK + lane] = p[0];
        pw[r * kBK + lane + 32] = p[1];
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float vv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i) vv[i] = sv[c * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pw[r * kBK + c];
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[g][r][i] = fmaf(p, vv[i], acc[g][r][i]);
        }
      }
      __syncwarp();   // pw is rewritten by the next group
    }
  }

  T* ob = out + ((long)b * Sq * H + h) * D;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + g * kR + r;
      if (qi >= Sq) continue;
      const float denom = fmaxf(l[g][r], 1e-30f);
#pragma unroll
      for (int i = 0; i < DL; ++i)
        ob[(long)qi * rs + lane + 32 * i] = from_f<T>(acc[g][r][i] / denom);
      if (lane == 0)
        lse[((long)b * Sq + qi) * H + h] =
            l[g][r] > 0.f ? m[g][r] * kLn2 + logf(denom) : kNegInf;
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Sq, int Sk, int causal, int q_offset,
           int k_offset, float qscale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Sq, Sk, causal, q_offset, k_offset, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qscale is D**-0.5 * log2(e), rounded
// to float by the caller.  Returns a cudaError_t, or -1 for a dtype/head_dim
// combination this kernel was not built for.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int dtype, int B, int H,
                             int Sq, int Sk, int D, int causal, int q_offset,
                             int k_offset, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  return -1;
}
