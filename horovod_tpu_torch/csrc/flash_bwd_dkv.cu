// Flash-attention backward, dk/dv pass, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces horovod_tpu/ops/flash_attention.py::_bwd_dkv_kernel (driven by
// flash_attention_backward):
//
//   dv = sum_q p^T . dO,   dk = ln(2) * sum_q ds^T . q~,
//   ds = p * (dp - delta), dp = dO . V^T, p = exp2(s - lse * log2(e)),
//
// where q~ is q folded with scale * log2(e) and rounded to the input dtype
// exactly as the forward folds it; the log2(e) the fold puts into dk is
// repaid by the ln(2) applied once at the end.  As in the TPU kernel, p
// stays f32 in the dv product (dO is widened to f32), ds is rounded to the
// input dtype before its product with q~, both sums accumulate in f32, and
// the results are cast to the input dtype.  Rows whose lse is NEG_INF
// attended to nothing and get p = 0 (exp2 would overflow there).
//
// What bounds it on the H100: per visible (q, k) pair it does four
// products of 2*D operations (s, dp, dv and dk) against ~D*2 bytes per
// position of bf16 q, k, v, dO, dk and dv, so at S = 1024 and D = 128 the
// tensor cores bound it.  This first version does its products on the CUDA
// cores in f32 (67 TFLOP/s peak), so its own issue rate, not either bound,
// is what it pays; it is written to be right and simple:
//
// * one block per (64-key tile, batch*head); a loop inside the block over
//   64-row Q/dO tiles (lse and delta alongside) takes the place of the
//   TPU's sequential Q grid axis, and the dk and dv tiles stay in
//   registers until they are written once: no atomics, so the result is
//   deterministic.  Splitting dq from dk/dv into two passes is what keeps
//   either pass free of reductions across blocks;
// * the block's K and V tile is loaded once; Q and dO tiles go through
//   shared memory once per block, read in place from the [B, S, H, D]
//   layout; q tiles entirely above the causal diagonal are skipped;
// * each warp owns 8 keys and updates them 4 at a time, so one shared load
//   of q~ or dO feeds 4 keys' FMAs.
//
// Masking follows the TPU kernel: a key at global position k_offset + j is
// visible to the query at q_offset + i iff j < Sk and (not causal or
// q_offset + i >= k_offset + j).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBK = 64;       // keys per block
constexpr int kBQ = 64;       // q rows per Q/dO tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerWarp = kBK / kWarps;   // 8
constexpr int kR = 4;                        // keys updated together
constexpr int kGroups = kKeysPerWarp / kR;   // 2

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
  // K and V tiles [BK][D] (read by broadcast), q~ and dO tiles [BQ][D+1]
  // (padded: lane j reads row j, so the pad puts neighbouring lanes on
  // neighbouring banks), per-warp p and ds [warps][R][BQ] each, and
  // per-row lse*log2e, delta and "attended to something" flags [BQ].
  return sizeof(float) * (size_t)(2 * kBK * d + 2 * kBQ * (d + 1) +
                                  2 * kWarps * kR * kBQ + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     int q_offset, int k_offset, float qscale) {
  constexpr int DL = D / 32;   // dk/dv dims per lane
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBK * D;
  float* sq = sv + kBK * D;
  float* sdo = sq + kBQ * (D + 1);
  float* sp = sdo + kBQ * (D + 1);
  float* sds = sp + kWarps * kR * kBQ;
  float* slse2 = sds + kWarps * kR * kBQ;
  float* sdelta = slse2 + kBQ;
  float* sok = sdelta + kBQ;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;   // elements between consecutive positions
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* dob = dout + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int c = i / D, d = i % D;
    float kx = 0.f, vx = 0.f;
    if (k0 + c < Sk) {
      kx = to_f(kb[(long)(k0 + c) * rs + d]);
      vx = to_f(vb[(long)(k0 + c) * rs + d]);
    }
    sk[i] = kx;
    sv[i] = vx;
  }

  float dka[kGroups][kR][DL], dva[kGroups][kR][DL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < DL; ++i) dka[g][r][i] = dva[g][r][i] = 0.f;

  // q tile t holds positions q_offset + t*BQ .. + BQ-1; under the causal
  // mask the ones whose last row lies before this block's first key see
  // none of its keys and are skipped.
  const int n_q_tiles = (Sq + kBQ - 1) / kBQ;
  int t_start = 0;
  if (causal) {
    const int lead = k_offset + k0 - q_offset;
    t_start = lead > 0 ? min(lead / kBQ, n_q_tiles) : 0;
  }

  for (int t = t_start; t < n_q_tiles; ++t) {
    const int q0 = t * kBQ;
    __syncthreads();   // the previous tile is consumed; K and V are written
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float x = 0.f, g = 0.f;
      if (q0 + r < Sq) {
        x = round_to<T>(to_f(qb[(long)(q0 + r) * rs + d]) * qscale);
        g = to_f(dob[(long)(q0 + r) * rs + d]);
      }
      sq[r * (D + 1) + d] = x;
      sdo[r * (D + 1) + d] = g;
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
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int kbase = warp * kKeysPerWarp + g * kR;   // first local key
      float s[kR][2], dp[kR][2];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = sq[lane * (D + 1) + d];
        const float qc = sq[(lane + 32) * (D + 1) + d];
        const float ga = sdo[lane * (D + 1) + d];
        const float gc = sdo[(lane + 32) * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float kv = sk[(kbase + r) * D + d];
          const float vv = sv[(kbase + r) * D + d];
          s[r][0] = fmaf(qa, kv, s[r][0]);
          s[r][1] = fmaf(qc, kv, s[r][1]);
          dp[r][0] = fmaf(ga, vv, dp[r][0]);
          dp[r][1] = fmaf(gc, vv, dp[r][1]);
        }
      }
      float* pw = sp + warp * kR * kBQ;
      float* dsw = sds + warp * kR * kBQ;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int key = k0 + kbase + r;
        const int kpos = k_offset + key;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int lr = lane + 32 * j;
          const bool ok = sok[lr] != 0.f && key < Sk &&
                          (!causal || q_offset + q0 + lr >= kpos);
          const float p = ok ? exp2f(s[r][j] - slse2[lr]) : 0.f;
          pw[r * kBQ + lr] = p;
          dsw[r * kBQ + lr] = round_to<T>(p * (dp[r][j] - sdelta[lr]));
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float gv[DL], qv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          gv[i] = sdo[c * (D + 1) + lane + 32 * i];
          qv[i] = sq[c * (D + 1) + lane + 32 * i];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pw[r * kBQ + c];
          const float ds = dsw[r * kBQ + c];
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            dva[g][r][i] = fmaf(p, gv[i], dva[g][r][i]);
            dka[g][r][i] = fmaf(ds, qv[i], dka[g][r][i]);
          }
        }
      }
      __syncwarp();   // pw and dsw are rewritten by the next group
    }
  }

  T* dkb = dk + ((long)b * Sk * H + h) * D;
  T* dvb = dv + ((long)b * Sk * H + h) * D;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int key = k0 + warp * kKeysPerWarp + g * kR + r;
      if (key >= Sk) continue;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        dkb[(long)key * rs + lane + 32 * i] = from_f<T>(dka[g][r][i] * kLn2);
        dvb[(long)key * rs + lane + 32 * i] = from_f<T>(dva[g][r][i]);
      }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Sq, int Sk, int causal, int q_offset, int k_offset,
           float qscale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + kBK - 1) / kBK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, causal, q_offset,
      k_offset, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dk and dv of that
// dtype, [B, S, H, D] contiguous; lse and delta float32 [B, Sq, H].  qscale
// is D**-0.5 * log2(e), rounded to float by the caller.  Returns a
// cudaError_t, or -1 for a dtype/head_dim combination this kernel was not
// built for.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int Sq, int Sk,
                                 int D, int causal, int q_offset,
                                 int k_offset, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  return -1;
}
