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
// repaid by the ln(2) applied once at the end.  As in the TPU kernel, ds is
// rounded to the input dtype before its product with q~, both sums
// accumulate in f32, and the results are cast to the input dtype.  Rows
// whose lse is NEG_INF attended to nothing and get p = 0 (exp2 would
// overflow there).  Masking follows the TPU kernel: a key at global
// position k_offset + j is visible to the query at q_offset + i iff j < Sk
// and (not causal or q_offset + i >= k_offset + j).
//
// What bounds it on the H100: per visible (q, k) pair it does four
// products of 2*D operations (s, dp, dv and dk) against ~D*2 bytes per
// position of bf16 q, k, v, dO, dk and dv, so at S = 1024 and D = 128 the
// tensor cores (989 TFLOP/s in bf16) bound it; products on the CUDA cores
// (67 TFLOP/s in f32) cannot come near.
//
// bf16, the tensor-core route (namespace tc):
//
// * one block per (64-key tile, batch*head), the first key tiles (which
//   see the most causal queries) issued first; the block's K and V tiles
//   stay resident in shared memory, and dk and dv accumulate in registers
//   and are written once: no atomics, so the result is deterministic.
//   Splitting dq from dk/dv into two passes keeps either pass free of
//   reductions across blocks;
// * a producer warp streams 64-row q and dO tiles through a two-stage TMA /
//   mbarrier ring, with lse * log2(e) (+inf on rows that attended to
//   nothing or lie past S_q, so that p = exp2(-inf) = 0 there) and delta
//   beside them; one consumer warpgroup folds each q tile in shared memory
//   (multiply, round to bf16) before its products;
// * the scores come out transposed, keys as wgmma's M dimension:
//   S^T = K.q~^T and dP^T = V.dO^T, both from shared memory (K-major as the
//   tiles lie), so P^T and dS^T are born in registers in the layout of
//   wgmma's A operand: dV += P^T.dO and dK += dS^T.q~ take them from
//   registers, with dO and q~ from shared memory through the transpose bit.
//   P never goes through shared memory;
// * q tiles wholly above the causal diagonal are skipped; only tiles that
//   straddle it, or the ragged end of the keys, are masked.
//
// Where p is rounded: p stays f32 in ds (as in the plain version), and is
// rounded to bf16 once, as the A operand of dV += P^T.dO: the single bf16
// MXU pass the TPU kernel's f32 p . dO product takes
// (horovod_tpu/ops/flash_attention.py:142-146, :560-564).
//
// The CUDA-core route (chosen by dtype and head dim, never on failure):
// float32 at D = 64, 128 and 256, since f32 inputs cannot meet the f32
// checks' 1e-4 through bf16 tensor-core products, and both dtypes at
// D = 256, where the tensor-core kernel's tiles are not instantiated.  It
// keeps the first version's design: one block per (batch*head, 64-key
// tile) looping over 64-row Q/dO tiles staged through shared memory in f32;
// each warp owns 8 keys and updates them 4 at a time.  At D = 256 the key
// tile is 32 keys (4 a warp), so that the tiles fit the 227 KB a block may
// use (209 KB).  bf16 inputs are widened on load, dk and dv rounded once,
// and p stays f32 for dv, as in the plain version.
//
// Head dims past 256 (namespace wide; both dtypes; the caller zero-pads D
// to a multiple of 64): each block owns one 64-column slice of dk and dv on
// the grid's z axis and sums S^T and dP^T over D in 64-wide chunks; every
// slice recomputes the same p and ds.  Right, not fast.
//
// Every route puts batch*head on the grid's x axis, and every offset is
// formed in 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

// ---- float32: CUDA cores -------------------------------------------------

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;       // q rows per Q/dO tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kR = 4;                        // keys updated together

// Keys per block: 64, or 32 at D = 256, where 64 keys of K and V beside
// the q~ and dO tiles, all in f32, would pass the 227 KB a block may use.
template <int D>
struct Keys {
  static constexpr int kBK = D > 128 ? 32 : 64;
  static constexpr int kPerWarp = kBK / kWarps;   // 8, or 4
  static constexpr int kGroups = kPerWarp / kR;   // 2, or 1
};

// This route takes float32, and bfloat16 at D = 256.
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

// Rounds an f32 value to T and back: the TPU kernel's operand cast.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
constexpr size_t smem_bytes() {
  // K and V tiles [BK][D] (read by broadcast), q~ and dO tiles [BQ][D+1]
  // (padded: lane j reads row j, so the pad puts neighbouring lanes on
  // neighbouring banks), per-warp p and ds [warps][R][BQ] each, and
  // per-row lse*log2e, delta and "attended to something" flags [BQ].
  constexpr int kBK = Keys<D>::kBK;
  return sizeof(float) * (size_t)(2 * kBK * D + 2 * kBQ * (D + 1) +
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
  constexpr int kBK = Keys<D>::kBK, kKeysPerWarp = Keys<D>::kPerWarp,
                kGroups = Keys<D>::kGroups;
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

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK;
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
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "the tiles pass a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sk + Keys<D>::kBK - 1) / Keys<D>::kBK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, causal, q_offset,
      k_offset, qscale);
  return (int)cudaGetLastError();
}


// ---- head dims past 256: CUDA cores, a slice of the columns a block -------

namespace wide {

constexpr int kBK = 64;        // keys per block
constexpr int kPerWarp = kBK / kWarps, kGroups = kPerWarp / kR;   // 8, 2
constexpr int kC = 64;         // columns of a chunk of the D sums, and of a slice
constexpr int kDL = kC / 32;   // dk/dv columns per lane

constexpr size_t smem_bytes() {
  // K and V chunks [BK][C] (read by broadcast), q~ and dO chunks [BQ][C+1]
  // (padded as above), the q~ and dO slices [BQ][C], per-warp p and ds
  // [warps][R][BQ] each, and per-row lse*log2e, delta and "attended to
  // something" flags [BQ].
  return sizeof(float) * (size_t)(2 * kBK * kC + 2 * kBQ * (kC + 1) +
                                  2 * kBQ * kC + 2 * kWarps * kR * kBQ +
                                  3 * kBQ);
}

// One block per (batch*head, 64-key tile, 64-column slice of dk and dv).
// S^T and dP^T sum over D in 64-wide chunks staged through shared memory,
// in the order d = 0 .. D-1 of the route above, so every slice forms the
// same p and ds; each block keeps only its slices of q~ and dO for
// dv += p^T.dO and dk += ds^T.q~.  D is a multiple of 64.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Sq, int Sk, int D,
                          int causal, int q_offset, int k_offset,
                          float qscale) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBK * kC;
  float* sq = sv + kBK * kC;
  float* sdo = sq + kBQ * (kC + 1);
  float* sqs = sdo + kBQ * (kC + 1);
  float* sdos = sqs + kBQ * kC;
  float* sp = sdos + kBQ * kC;
  float* sds = sp + kWarps * kR * kBQ;
  float* slse2 = sds + kWarps * kR * kBQ;
  float* sdelta = slse2 + kBQ;
  float* sok = sdelta + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK;
  const int c0 = blockIdx.z * kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* dob = dout + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

  float dka[kGroups][kR][kDL], dva[kGroups][kR][kDL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < kDL; ++i) dka[g][r][i] = dva[g][r][i] = 0.f;

  const int n_q_tiles = (Sq + kBQ - 1) / kBQ;
  int t_start = 0;
  if (causal) {
    const int lead = k_offset + k0 - q_offset;
    t_start = lead > 0 ? min(lead / kBQ, n_q_tiles) : 0;
  }

  for (int t = t_start; t < n_q_tiles; ++t) {
    const int q0 = t * kBQ;
    float s[kGroups][kR][2], dp[kGroups][kR][2];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        s[g][r][0] = s[g][r][1] = dp[g][r][0] = dp[g][r][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kC) {
      __syncthreads();   // the previous chunk (and tile) is consumed
      for (int i = tid; i < kBK * kC; i += kThreads) {
        const int c = i / kC, d = i % kC;
        const bool in = k0 + c < Sk;
        const long at = (long)(k0 + c) * rs + d0 + d;
        sk[i] = in ? to_f(kb[at]) : 0.f;
        sv[i] = in ? to_f(vb[at]) : 0.f;
      }
      for (int i = tid; i < kBQ * kC; i += kThreads) {
        const int r = i / kC, d = i % kC;
        const bool in = q0 + r < Sq;
        const long at = (long)(q0 + r) * rs;
        sq[r * (kC + 1) + d] =
            in ? round_to<T>(to_f(qb[at + d0 + d]) * qscale) : 0.f;
        sdo[r * (kC + 1) + d] = in ? to_f(dob[at + d0 + d]) : 0.f;
        if (d0 == 0) {
          sqs[i] = in ? round_to<T>(to_f(qb[at + c0 + d]) * qscale) : 0.f;
          sdos[i] = in ? to_f(dob[at + c0 + d]) : 0.f;
        }
      }
      if (d0 == 0) {
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
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int kbase = warp * kPerWarp + g * kR;
#pragma unroll 4
        for (int d = 0; d < kC; ++d) {
          const float qa = sq[lane * (kC + 1) + d];
          const float qc = sq[(lane + 32) * (kC + 1) + d];
          const float ga = sdo[lane * (kC + 1) + d];
          const float gc = sdo[(lane + 32) * (kC + 1) + d];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float kv = sk[(kbase + r) * kC + d];
            const float vv = sv[(kbase + r) * kC + d];
            s[g][r][0] = fmaf(qa, kv, s[g][r][0]);
            s[g][r][1] = fmaf(qc, kv, s[g][r][1]);
            dp[g][r][0] = fmaf(ga, vv, dp[g][r][0]);
            dp[g][r][1] = fmaf(gc, vv, dp[g][r][1]);
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int kbase = warp * kPerWarp + g * kR;
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
          const float p = ok ? exp2f(s[g][r][j] - slse2[lr]) : 0.f;
          pw[r * kBQ + lr] = p;
          dsw[r * kBQ + lr] = round_to<T>(p * (dp[g][r][j] - sdelta[lr]));
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float gv[kDL], qv[kDL];
#pragma unroll
        for (int i = 0; i < kDL; ++i) {
          gv[i] = sdos[c * kC + lane + 32 * i];
          qv[i] = sqs[c * kC + lane + 32 * i];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pw[r * kBQ + c];
          const float ds = dsw[r * kBQ + c];
#pragma unroll
          for (int i = 0; i < kDL; ++i) {
            dva[g][r][i] = fmaf(p, gv[i], dva[g][r][i]);
            dka[g][r][i] = fmaf(ds, qv[i], dka[g][r][i]);
          }
        }
      }
      __syncwarp();
    }
  }

  T* dkb = dk + ((long)b * Sk * H + h) * D + c0;
  T* dvb = dv + ((long)b * Sk * H + h) * D + c0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int key = k0 + warp * kPerWarp + g * kR + r;
      if (key >= Sk) continue;
#pragma unroll
      for (int i = 0; i < kDL; ++i) {
        dkb[(long)key * rs + lane + 32 * i] = from_f<T>(dka[g][r][i] * kLn2);
        dvb[(long)key * rs + lane + 32 * i] = from_f<T>(dva[g][r][i]);
      }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Sq, int Sk, int D, int causal, int q_offset,
           int k_offset, float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sk + kBK - 1) / kBK, D / kC);
  flash_bwd_dkv_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, causal,
      q_offset, k_offset, qscale);
  return (int)cudaGetLastError();
}

}  // namespace wide


// ---- bf16: tensor cores --------------------------------------------------

namespace tc {

using namespace hvd_sm90;

constexpr int kStages = 2;   // q / dO ring depth

template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kTile = kChunks * kChunkBytes;   // 64 rows
  static constexpr uint32_t kK = 0, kV = kTile;              // resident
  static constexpr uint32_t kStage0 = 2 * kTile;             // q~, dO
  static constexpr uint32_t kStats = kStage0 + kStages * 2 * kTile;
  static constexpr uint32_t kBars = kStats + kStages * 2 * 64 * 4;
  // kv_full, full[kStages], empty[kStages]; 1024 bytes of alignment slack.
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(160, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap omap,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int H, int Sq, int Sk, int causal, int q_offset, int k_offset,
           float qscale) {
  using L = Smem<D>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };
  auto q_tile = [&](int s) { return L::kStage0 + 2 * s * L::kTile; };
  auto stats = [&](int s) {   // lse * log2(e) [64], then delta [64]
    return reinterpret_cast<float*>(smem + L::kStats + s * 2 * 64 * 4);
  };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // q tile t holds positions q_offset + 64t .. + 63; under the causal mask
  // the ones whose last row lies before this block's first key see none of
  // its keys and are skipped.
  const int n_q_tiles = (Sq + 63) / 64;
  int t_start = 0;
  if (causal) {
    const int lead = k_offset + k0 - q_offset;
    t_start = lead > 0 ? min(lead / 64, n_q_tiles) : 0;
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);   // every producer lane writes stats
      mbar_init(empty(s), 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kTile);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + L::kK + c * kChunkBytes, &kmap, kv_full, 64 * c, h,
                 k0, b);
        tma_load(base + L::kV + c * kChunkBytes, &vmap, kv_full, 64 * c, h,
                 k0, b);
      }
    }
    for (int t = t_start, it = 0; t < n_q_tiles; ++t, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
      float* st = stats(s);
      for (int r = lane; r < 64; r += 32) {
        const int qi = 64 * t + r;
        float l2 = __int_as_float(0x7f800000), dl = 0.f;   // +inf, 0
        if (qi < Sq) {
          const long at = ((long)b * Sq + qi) * H + h;
          const float lv = lse[at];
          if (lv > kNegInf / 2) l2 = lv * kLog2e;
          dl = delta[at];
        }
        st[r] = l2;
        st[64 + r] = dl;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(base + q_tile(s) + c * kChunkBytes, &qmap, full(s),
                   64 * c, h, 64 * t, b);
          tma_load(base + q_tile(s) + L::kTile + c * kChunkBytes, &omap,
                   full(s), 64 * c, h, 64 * t, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds keys kr and kr + 8.
  const int kr = k0 + 16 * warp + lane / 4;
  float dka[D / 2], dva[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = t_start, it = 0; t < n_q_tiles; ++t, ++it) {
    const int st = it % kStages;
    mbar_wait(full(st), (it / kStages) & 1);
    const uint32_t qt = base + q_tile(st), ot = qt + L::kTile;
    fold_tile(smem + q_tile(st), L::kTile, threadIdx.x, 128, qscale);
    fence_proxy_async();
    named_bar_sync<1>(128);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss_m64n64k16(s, desc_k_major(base + L::kK + off),
                         desc_k_major(qt + off), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss_m64n64k16(dp, desc_k_major(base + L::kV + off),
                         desc_k_major(ot + off), kk > 0);
    }
    wgmma_commit();

    // P^T while dP^T is still in flight.
    wgmma_wait<1>();
    fence_regs(s);
    const int q0 = 64 * t;
    const float* sts = stats(st);
    const bool masked =
        k0 + 64 > Sk || (causal && q_offset + q0 < k_offset + k0 + 63);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i, lane);
      float p = exp2f(s[i] - sts[c]);
      if (masked) {
        const int key = kr + 8 * acc_half(i);
        if (!(key < Sk && (!causal || q_offset + q0 + c >= k_offset + key)))
          p = 0.f;
      }
      s[i] = p;
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - sts[64 + acc_col(i, lane)]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dsa[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d_o = desc_mn_major(ot + kk * 16 * 128);
      const uint64_t d_q = desc_mn_major(qt + kk * 16 * 128);
      if constexpr (D == 128) {
        wgmma_rs_m64n128k16_tb(dva, pa[kk], d_o);
        wgmma_rs_m64n128k16_tb(dka, dsa[kk], d_q);
      } else {
        wgmma_rs_m64n64k16_tb(dva, pa[kk], d_o);
        wgmma_rs_m64n64k16_tb(dka, dsa[kk], d_q);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(empty(st));   // this warp is done with st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (key >= Sk) continue;
    const long at = (((long)b * Sk + key) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = acc_col(4 * j, lane);
      *reinterpret_cast<uint32_t*>(dk + at + c) = pack_bf16(
          dka[4 * j + 2 * r] * kLn2, dka[4 * j + 2 * r + 1] * kLn2);
      *reinterpret_cast<uint32_t*>(dv + at + c) =
          pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Sq, int Sk, int causal, int q_offset, int k_offset,
           float qscale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  // With no queries, the q and dO maps are never read: describe k instead.
  const bool no_q = Sq == 0;
  int rc = make_bshd_map(&km, k, B, Sk, H, D);
  if (!rc) rc = make_bshd_map(&vm, v, B, Sk, H, D);
  if (!rc) rc = make_bshd_map(&qm, no_q ? k : q, B, no_q ? Sk : Sq, H, D);
  if (!rc) rc = make_bshd_map(&om, no_q ? k : dout, B, no_q ? Sk : Sq, H, D);
  if (rc) return rc;
  constexpr uint32_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sk + 63) / 64);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 160, smem, stream>>>(
      qm, km, vm, om, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, causal, q_offset, k_offset,
      qscale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores at D = 64
// and 128, CUDA cores at D = 256 and past it, D a multiple of 64); q, k, v, dout, dk and dv of that dtype,
// [B, S, H, D] contiguous; lse and delta float32 [B, Sq, H].  qscale is
// D**-0.5 * log2(e) of the caller's head dim, rounded to float by the
// caller (which zero-pads other head dims to these).  Returns a cudaError_t, or -1 for a dtype/head_dim combination
// this kernel was not built for.
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
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (D > 256 && D % 64 == 0)
    return dtype == 0
        ? wide::launch<float>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, s)
        : wide::launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, s);
  return -1;
}

// The tiles a call of hvd_flash_bwd_dkv at this shape launches, as the
// launchers above choose them: tiles[0] q rows and tiles[1] keys of a
// block's tile, tiles[2] its dynamic shared memory in bytes.  Launches
// nothing; returns -1 where hvd_flash_bwd_dkv would.
extern "C" int hvd_flash_bwd_dkv_tiles(int dtype, int B, int H, int Sq, int D,
                                       int* tiles) {
  auto put = [tiles](int bq, int bk, size_t smem) {
    tiles[0] = bq, tiles[1] = bk, tiles[2] = (int)smem;
    return 0;
  };
  if (dtype == 1 && D == 64) return put(64, 64, tc::Smem<64>::kBytes);
  if (dtype == 1 && D == 128) return put(64, 64, tc::Smem<128>::kBytes);
  if (dtype == 0 && D == 64) return put(kBQ, Keys<64>::kBK, smem_bytes<64>());
  if (dtype == 0 && D == 128)
    return put(kBQ, Keys<128>::kBK, smem_bytes<128>());
  if ((dtype == 0 || dtype == 1) && D == 256)
    return put(kBQ, Keys<256>::kBK, smem_bytes<256>());
  if ((dtype == 0 || dtype == 1) && D > 256 && D % 64 == 0)
    return put(kBQ, wide::kBK, wide::smem_bytes());
  return -1;
}
