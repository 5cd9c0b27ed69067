// Flash-attention backward, dq pass, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces horovod_tpu/ops/flash_attention.py::_bwd_dq_kernel (driven by
// flash_attention_backward):
//
//   dq = scale * sum_k ds * K,   ds = p * (dp - delta),   dp = dO . V^T,
//   p  = exp2(s - lse * log2(e)), s = q~ . K^T,
//
// where q~ is q folded with scale * log2(e) and rounded to the input dtype
// exactly as the forward folds it, so p recomputes the forward's
// probabilities from the saved natural-log lse.  ds is rounded to the
// input dtype before its product with K (the TPU kernel's MXU operand
// dtype); dq accumulates in f32, is multiplied by scale once at the end
// and cast to the input dtype.  Rows whose lse is NEG_INF attended to
// nothing and get p = 0 (exp2 would overflow there).
//
// What bounds it on the H100: per visible (q, k) pair it does three
// products of 2*D operations (s, dp, and ds into dq) against ~D*2 bytes of
// bf16 q, k, v, dO and dq per position, so at S = 1024 and D = 128 it
// sits above the card's ridge of ~295 operations per byte: the tensor
// cores bound it.  This first version does its products on the CUDA cores
// in f32 (67 TFLOP/s peak), so its own issue rate, not either bound, is
// what it pays; it is written to be right and simple:
//
// * one block per (64-row q tile, batch*head); a loop inside the block over
//   64-key K/V tiles takes the place of the TPU's sequential K grid axis,
//   and the dq tile stays in registers until it is written once: no
//   atomics, so the result is deterministic;
// * K and V tiles go through shared memory once per block, read in place
//   from the [B, S, H, D] layout; K tiles entirely above the causal
//   diagonal are skipped;
// * each warp owns 8 q rows and updates them 4 at a time, so one shared
//   load of K or V feeds 4 rows' FMAs.
//
// Masking follows the TPU kernel: a key at global position k_offset + j is
// visible to the query at q_offset + i iff j < Sk and (not causal or
// q_offset + i >= k_offset + j).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
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

// Rounds an f32 value to T and back: the TPU kernel's operand cast.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

constexpr size_t smem_bytes(int d) {
  // q~ tile and dO tile [BQ][D] (read by broadcast), K and V tiles
  // [BK][D+1] (padded: lane j reads row j, so the pad puts neighbouring
  // lanes on neighbouring banks), per-warp ds [warps][R][BK], and per-row
  // lse*log2e, delta and "attended to something" flags [BQ].
  return sizeof(float) * (size_t)(2 * kBQ * d + 2 * kBK * (d + 1) +
                                  kWarps * kR * kBK + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, int q_offset,
                    int k_offset, float qscale, float scale) {
  constexpr int DL = D / 32;   // dq dims per lane
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBQ * D;
  float* sk = sdo + kBQ * D;
  float* sv = sk + kBK * (D + 1);
  float* sds = sv + kBK * (D + 1);
  float* slse2 = sds + kWarps * kR * kBK;
  float* sdelta = slse2 + kBQ;
  float* sok = sdelta + kBQ;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;   // elements between consecutive positions
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* dob = dout + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f, g = 0.f;
    if (q0 + r < Sq) {
      x = round_to<T>(to_f(qb[(long)(q0 + r) * rs + d]) * qscale);
      g = to_f(dob[(long)(q0 + r) * rs + d]);
    }
    sq[i] = x;
    sdo[i] = g;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    float l = kNegInf, dl = 0.f;
    if (q0 + r < Sq) {
      const long at = ((long)b * Sq + q0 + r) * H + h;
      l = lse[at];
      dl = delta[at];
    }
    slse2[r] = l * kLog2e;
    sdelta[r] = dl;
    sok[r] = (q0 + r < Sq && l > kNegInf / 2) ? 1.f : 0.f;
  }

  float acc[kGroups][kR][DL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[g][r][i] = 0.f;

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
    __syncthreads();   // the previous tile is consumed; stats are written
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        kx = to_f(kb[(long)(k0 + c) * rs + d]);
        vx = to_f(vb[(long)(k0 + c) * rs + d]);
      }
      sk[c * (D + 1) + d] = kx;
      sv[c * (D + 1) + d] = vx;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int rb = warp * kRowsPerWarp + g * kR;   // first local row
      float s[kR][2], dp[kR][2];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float ka = sk[lane * (D + 1) + d];
        const float kc = sk[(lane + 32) * (D + 1) + d];
        const float va = sv[lane * (D + 1) + d];
        const float vc = sv[(lane + 32) * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float qv = sq[(rb + r) * D + d];
          const float gv = sdo[(rb + r) * D + d];
          s[r][0] = fmaf(qv, ka, s[r][0]);
          s[r][1] = fmaf(qv, kc, s[r][1]);
          dp[r][0] = fmaf(gv, va, dp[r][0]);
          dp[r][1] = fmaf(gv, vc, dp[r][1]);
        }
      }
      float* dsw = sds + warp * kR * kBK;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int lr = rb + r;
        const int qpos = q_offset + q0 + lr;
        const bool row_ok = sok[lr] != 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = k0 + lane + 32 * j;
          const bool ok = row_ok && c < Sk && (!causal || qpos >= k_offset + c);
          const float p = ok ? exp2f(s[r][j] - slse2[lr]) : 0.f;
          dsw[r * kBK + lane + 32 * j] = round_to<T>(p * (dp[r][j] - sdelta[lr]));
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float kv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i) kv[i] = sk[c * (D + 1) + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float ds = dsw[r * kBK + c];
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[g][r][i] = fmaf(ds, kv[i], acc[g][r][i]);
        }
      }
      __syncwarp();   // dsw is rewritten by the next group
    }
  }

  T* dqb = dq + ((long)b * Sq * H + h) * D;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + g * kR + r;
      if (qi >= Sq) continue;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        dqb[(long)qi * rs + lane + 32 * i] = from_f<T>(acc[g][r][i] * scale);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H, int Sq,
           int Sk, int causal, int q_offset, int k_offset, float qscale,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, causal, q_offset, k_offset, qscale,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout and dq of that dtype,
// [B, S, H, D] contiguous; lse and delta float32 [B, Sq, H].  qscale is
// D**-0.5 * log2(e) and scale is D**-0.5, rounded to float by the caller.
// Returns a cudaError_t, or -1 for a dtype/head_dim combination this kernel
// was not built for.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int H, int Sq, int Sk, int D, int causal,
                                int q_offset, int k_offset, float qscale,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  return -1;
}
