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
// nothing and get p = 0 (exp2 would overflow there).  Masking follows the
// TPU kernel: a key at global position k_offset + j is visible to the
// query at q_offset + i iff j < Sk and (not causal or q_offset + i >=
// k_offset + j).
//
// What bounds it on the H100: per visible (q, k) pair it does three
// products of 2*D operations (s, dp, and ds into dq) against ~D*2 bytes of
// bf16 q, k, v, dO and dq per position, so at S = 1024 and D = 128 it
// sits above the card's ridge of ~295 operations per byte: the tensor
// cores (989 TFLOP/s in bf16) bound it; products on the CUDA cores
// (67 TFLOP/s in f32) cannot come near.
//
// bf16, the tensor-core route (namespace tc), the mirror image of the
// dk/dv kernel's:
//
// * one block per (q tile, batch*head), the last causal q tiles (which see
//   the most keys) issued first; the q tile is 128 rows (two consumer
//   warpgroups of 64 rows) when that gives at least one block per SM, else
//   64 rows (one warpgroup), the forward's rule.  The block's q~ and dO
//   tiles are loaded once by TMA and stay resident; each warpgroup folds
//   its q rows in shared memory (multiply, round to bf16) before its first
//   product.  dq accumulates in registers and is written once: no atomics,
//   so the result is deterministic;
// * each consumer thread keeps its two rows' lse * log2(e) and delta in
//   registers, +inf for a row that attended to nothing or lies past S_q,
//   so that p = exp2(-inf) = 0 there;
// * a producer warp streams 64-key K and V tiles through a two-stage TMA /
//   mbarrier ring; under the causal mask tiles past the block's last query
//   are not loaded;
// * S = q~.K^T and dP = dO.V^T are wgmma products from shared memory (both
//   operands K-major, as the tiles lie); P and dS = P * (dP - delta),
//   rounded to bf16, are formed on the accumulator fragment in registers,
//   which is exactly the layout of wgmma's A operand, so dQ += dS.K takes
//   dS from registers and K from shared memory through the transpose bit
//   (its contracted dim is the key).  Neither P nor dS goes through shared
//   memory;
// * only tiles that straddle the causal diagonal or the ragged end of the
//   keys are masked.
//
// The CUDA-core route (chosen by dtype and head dim, never on failure):
// float32 at D = 64, 128 and 256, since f32 inputs cannot meet the f32
// checks' 1e-4 through bf16 tensor-core products, and both dtypes at
// D = 256, where the tensor-core kernel's tiles are not instantiated.  It
// keeps the first version's design: one block per (batch*head, 64-row q
// tile) looping over 64-key K/V tiles staged through shared memory in f32;
// each warp owns 8 q rows and updates them 4 at a time.  At D = 256 the q
// tile is 32 rows (4 a warp), so that the tiles fit the 227 KB a block may
// use (201 KB).  bf16 inputs are widened on load and dq rounded once.
//
// Head dims past 256 (namespace wide; both dtypes; the caller zero-pads D
// to a multiple of 64): each block owns one 64-column slice of dq on the
// grid's z axis and sums S and dP over D in 64-wide chunks; every slice
// recomputes the same ds.  Right, not fast.
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
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kR = 4;                        // rows updated together

// q rows per block: 64, or 32 at D = 256, where 64 rows of q~ and dO beside
// the K and V tiles, all in f32, would pass the 227 KB a block may use.
template <int D>
struct Rows {
  static constexpr int kBQ = D > 128 ? 32 : 64;
  static constexpr int kPerWarp = kBQ / kWarps;   // 8, or 4
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
  // q~ tile and dO tile [BQ][D] (read by broadcast), K and V tiles
  // [BK][D+1] (padded: lane j reads row j, so the pad puts neighbouring
  // lanes on neighbouring banks), per-warp ds [warps][R][BK], and per-row
  // lse*log2e, delta and "attended to something" flags [BQ].
  constexpr int kBQ = Rows<D>::kBQ;
  return sizeof(float) * (size_t)(2 * kBQ * D + 2 * kBK * (D + 1) +
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
  constexpr int kBQ = Rows<D>::kBQ, kRowsPerWarp = Rows<D>::kPerWarp,
                kGroups = Rows<D>::kGroups;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBQ * D;
  float* sk = sdo + kBQ * D;
  float* sv = sk + kBK * (D + 1);
  float* sds = sv + kBK * (D + 1);
  float* slse2 = sds + kWarps * kR * kBK;
  float* sdelta = slse2 + kBQ;
  float* sok = sdelta + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
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
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "the tiles pass a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + Rows<D>::kBQ - 1) / Rows<D>::kBQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, causal, q_offset, k_offset, qscale,
      scale);
  return (int)cudaGetLastError();
}


// ---- head dims past 256: CUDA cores, a slice of the columns a block -------

namespace wide {

constexpr int kBQ = 64;        // q rows per block
constexpr int kPerWarp = kBQ / kWarps, kGroups = kPerWarp / kR;   // 8, 2
constexpr int kC = 64;         // columns of a chunk of the D sums, and of a slice
constexpr int kDL = kC / 32;   // dq columns per lane

constexpr size_t smem_bytes() {
  // q~ and dO chunks [BQ][C] (read by broadcast), K and V chunks [BK][C+1]
  // (padded as above), the K slice [BK][C], per-warp ds [warps][R][BK], and
  // per-row lse*log2e, delta and "attended to something" flags [BQ].
  return sizeof(float) * (size_t)(2 * kBQ * kC + 2 * kBK * (kC + 1) +
                                  kBK * kC + kWarps * kR * kBK + 3 * kBQ);
}

// One block per (batch*head, 64-row q tile, 64-column slice of dq).  S and
// dP sum over D in 64-wide chunks staged through shared memory, in the
// order d = 0 .. D-1 of the route above, so every slice forms the same ds;
// each block keeps only its slice of K for dq += ds.K.  D is a multiple of
// 64.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int H, int Sq, int Sk, int D, int causal,
                         int q_offset, int k_offset, float qscale,
                         float scale) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBQ * kC;
  float* sk = sdo + kBQ * kC;
  float* sv = sk + kBK * (kC + 1);
  float* sks = sv + kBK * (kC + 1);
  float* sds = sks + kBK * kC;
  float* slse2 = sds + kWarps * kR * kBK;
  float* sdelta = slse2 + kBQ;
  float* sok = sdelta + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int c0 = blockIdx.z * kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* dob = dout + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

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

  float acc[kGroups][kR][kDL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[g][r][i] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
    const int span = q_last - k_offset;
    n_tiles = span < 0 ? 0 : min(n_tiles, span / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    float s[kGroups][kR][2], dp[kGroups][kR][2];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        s[g][r][0] = s[g][r][1] = dp[g][r][0] = dp[g][r][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kC) {
      __syncthreads();   // the previous chunk (and tile) is consumed
      for (int i = tid; i < kBQ * kC; i += kThreads) {
        const int r = i / kC, d = i % kC;
        float x = 0.f, g = 0.f;
        if (q0 + r < Sq) {
          x = round_to<T>(to_f(qb[(long)(q0 + r) * rs + d0 + d]) * qscale);
          g = to_f(dob[(long)(q0 + r) * rs + d0 + d]);
        }
        sq[i] = x;
        sdo[i] = g;
      }
      for (int i = tid; i < kBK * kC; i += kThreads) {
        const int c = i / kC, d = i % kC;
        const bool in = k0 + c < Sk;
        const long at = (long)(k0 + c) * rs + d0 + d;
        sk[c * (kC + 1) + d] = in ? to_f(kb[at]) : 0.f;
        sv[c * (kC + 1) + d] = in ? to_f(vb[at]) : 0.f;
        if (d0 == 0)
          sks[c * kC + d] = in ? to_f(kb[(long)(k0 + c) * rs + c0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int rb = warp * kPerWarp + g * kR;
#pragma unroll 4
        for (int d = 0; d < kC; ++d) {
          const float ka = sk[lane * (kC + 1) + d];
          const float kc = sk[(lane + 32) * (kC + 1) + d];
          const float va = sv[lane * (kC + 1) + d];
          const float vc = sv[(lane + 32) * (kC + 1) + d];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float qv = sq[(rb + r) * kC + d];
            const float gv = sdo[(rb + r) * kC + d];
            s[g][r][0] = fmaf(qv, ka, s[g][r][0]);
            s[g][r][1] = fmaf(qv, kc, s[g][r][1]);
            dp[g][r][0] = fmaf(gv, va, dp[g][r][0]);
            dp[g][r][1] = fmaf(gv, vc, dp[g][r][1]);
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int rb = warp * kPerWarp + g * kR;
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
          const float p = ok ? exp2f(s[g][r][j] - slse2[lr]) : 0.f;
          dsw[r * kBK + lane + 32 * j] =
              round_to<T>(p * (dp[g][r][j] - sdelta[lr]));
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float kv[kDL];
#pragma unroll
        for (int i = 0; i < kDL; ++i) kv[i] = sks[c * kC + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float ds = dsw[r * kBK + c];
#pragma unroll
          for (int i = 0; i < kDL; ++i) acc[g][r][i] = fmaf(ds, kv[i], acc[g][r][i]);
        }
      }
      __syncwarp();
    }
  }

  T* dqb = dq + ((long)b * Sq * H + h) * D + c0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + warp * kPerWarp + g * kR + r;
      if (qi >= Sq) continue;
#pragma unroll
      for (int i = 0; i < kDL; ++i)
        dqb[(long)qi * rs + lane + 32 * i] = from_f<T>(acc[g][r][i] * scale);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H, int Sq,
           int Sk, int D, int causal, int q_offset, int k_offset,
           float qscale, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, D / kC);
  flash_bwd_dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, D, causal, q_offset, k_offset, qscale,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace wide


// ---- bf16: tensor cores --------------------------------------------------

namespace tc {

using namespace hvd_sm90;

constexpr int kStages = 2;   // K/V ring depth

template <int D, int NWG>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kTile = kChunks * kChunkBytes;   // 64 rows
  static constexpr uint32_t kQ = 0;                          // NWG tiles
  static constexpr uint32_t kO = NWG * kTile;                // dO, NWG tiles
  static constexpr uint32_t kStage0 = 2 * NWG * kTile;       // K, V per stage
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kTile;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of alignment slack.
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap omap,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, int causal,
           int q_offset, int k_offset, float qscale, float scale) {
  using L = Smem<D, NWG>;
  constexpr int kChunks = L::kChunks;
  constexpr int kBQ = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBars;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s) { return base + L::kStage0 + 2 * s * L::kTile; };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // K tiles this block needs: under the causal mask, none whose first key
  // lies past the block's last query.
  int n_tiles = (Sk + 63) / 64;
  if (causal) {
    const int span = q_offset + min(q0 + kBQ, Sq) - 1 - k_offset;
    n_tiles = span < 0 ? 0 : min(n_tiles, span / 64 + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {   // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * NWG * L::kTile);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = (w * kChunks + c) * kChunkBytes;
          tma_load(base + L::kQ + off, &qmap, q_full, 64 * c, h, q0 + 64 * w, b);
          tma_load(base + L::kO + off, &omap, q_full, 64 * c, h, q0 + 64 * w, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(k_tile(s) + c * kChunkBytes, &kmap, full(s), 64 * c, h,
                   64 * t, b);
          tma_load(k_tile(s) + L::kTile + c * kChunkBytes, &vmap, full(s),
                   64 * c, h, 64 * t, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 q rows; this thread holds rows r0 and r0 + 8.
  const int wg = warp / 4, w4 = warp % 4;
  const int row0 = q0 + 64 * wg;
  const int r0 = row0 + 16 * w4 + lane / 4;
  const uint32_t q_tile = base + L::kQ + wg * L::kTile;
  const uint32_t o_tile = base + L::kO + wg * L::kTile;

  // The rows' lse * log2(e) (+inf where p must be 0) and delta, read while
  // the tiles are in flight.
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    l2[r] = __int_as_float(0x7f800000);   // +inf
    dl[r] = 0.f;
    if (qi < Sq) {
      const long at = ((long)b * Sq + qi) * H + h;
      const float lv = lse[at];
      if (lv > kNegInf / 2) l2[r] = lv * kLog2e;
      dl[r] = delta[at];
    }
  }

  mbar_wait(q_full, 0);
  fold_tile(smem + L::kQ + wg * L::kTile, L::kTile, threadIdx.x % 128, 128,
            qscale);
  fence_proxy_async();
  if (wg == 0) named_bar_sync<1>(128);
  else named_bar_sync<2>(128);

  // This warpgroup's own reach: the block's last tiles may lie past it.
  int n_mine = row0 < Sq ? n_tiles : 0;
  if (causal && row0 < Sq) {
    const int span = q_offset + min(row0 + 64, Sq) - 1 - k_offset;
    n_mine = span < 0 ? 0 : min(n_tiles, span / 64 + 1);
  }

  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(full(st), (t / kStages) & 1);
    if (t < n_mine) {
      const uint32_t kt = k_tile(st), vt = kt + L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss_m64n64k16(s, desc_k_major(q_tile + off),
                           desc_k_major(kt + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss_m64n64k16(dp, desc_k_major(o_tile + off),
                           desc_k_major(vt + off), kk > 0);
      }
      wgmma_commit();

      // P while dP is still in flight.
      wgmma_wait<1>();
      fence_regs(s);
      const int k0 = 64 * t;
      const bool masked =
          k0 + 64 > Sk || (causal && k_offset + k0 + 63 > q_offset + row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = exp2f(s[i] - l2[acc_half(i)]);
        if (masked) {
          const int c = k0 + acc_col(i, lane);
          const int r = r0 + 8 * acc_half(i);
          if (!(c < Sk && (!causal || q_offset + r >= k_offset + c))) p = 0.f;
        }
        s[i] = p;
      }

      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          dsa[kk][j] = pack_bf16(s[i] * (dp[i] - dl[acc_half(i)]),
                                 s[i + 1] * (dp[i + 1] - dl[acc_half(i + 1)]));
        }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t kd = desc_mn_major(kt + kk * 16 * 128);
        if constexpr (D == 128) wgmma_rs_m64n128k16_tb(acc, dsa[kk], kd);
        else wgmma_rs_m64n64k16_tb(acc, dsa[kk], kd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsa);
    }
    if (lane == 0) mbar_arrive(empty(st));   // this warp is done with st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + acc_col(4 * j, lane)) = pack_bf16(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int D, int NWG>
int launch_rows(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int H,
                int Sq, int Sk, int causal, int q_offset, int k_offset,
                float qscale, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  // With no keys, the K and V maps are never read: describe q instead.
  const bool no_keys = Sk == 0;
  int rc = make_bshd_map(&qm, q, B, Sq, H, D);
  if (!rc) rc = make_bshd_map(&om, dout, B, Sq, H, D);
  if (!rc) rc = make_bshd_map(&km, no_keys ? q : k, B, no_keys ? Sq : Sk, H, D);
  if (!rc) rc = make_bshd_map(&vm, no_keys ? q : v, B, no_keys ? Sq : Sk, H, D);
  if (rc) return rc;
  constexpr uint32_t smem = Smem<D, NWG>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + 64 * NWG - 1) / (64 * NWG));
  flash_bwd_dq_wgmma_kernel<D, NWG><<<grid, NWG * 128 + 32, smem, stream>>>(
      qm, km, vm, om, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      Sq, Sk, causal, q_offset, k_offset, qscale, scale);
  return (int)cudaGetLastError();
}

// 128-row q tiles when they give every SM a block, else 64-row ones.
inline bool two_row_tiles(int B, int H, int Sq) {
  return (long)((Sq + 127) / 128) * B * H >= num_sms();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H, int Sq,
           int Sk, int causal, int q_offset, int k_offset, float qscale,
           float scale, cudaStream_t stream) {
  if (two_row_tiles(B, H, Sq))
    return launch_rows<D, 2>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                             causal, q_offset, k_offset, qscale, scale, stream);
  return launch_rows<D, 1>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                           causal, q_offset, k_offset, qscale, scale, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores at D = 64
// and 128, CUDA cores at D = 256 and past it, D a multiple of 64); q, k, v, dout and dq of that dtype,
// [B, S, H, D] contiguous; lse and delta float32 [B, Sq, H].  qscale is
// D**-0.5 * log2(e) and scale is D**-0.5 of the caller's head dim, rounded
// to float by the caller (which zero-pads other head dims to these).  Returns a cudaError_t, or -1 for a
// dtype/head_dim combination this kernel was not built for.
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
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, scale, s);
  if (D > 256 && D % 64 == 0)
    return dtype == 0
        ? wide::launch<float>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, scale, s)
        : wide::launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, scale, s);
  return -1;
}

// The tiles a call of hvd_flash_bwd_dq at this shape launches, as the
// launchers above choose them: tiles[0] q rows and tiles[1] keys of a
// block's tile, tiles[2] its dynamic shared memory in bytes.  Launches
// nothing; returns -1 where hvd_flash_bwd_dq would.
extern "C" int hvd_flash_bwd_dq_tiles(int dtype, int B, int H, int Sq, int D,
                                      int* tiles) {
  auto put = [tiles](int bq, int bk, size_t smem) {
    tiles[0] = bq, tiles[1] = bk, tiles[2] = (int)smem;
    return 0;
  };
  const bool two = tc::two_row_tiles(B, H, Sq);
  if (dtype == 1 && D == 64)
    return two ? put(128, 64, tc::Smem<64, 2>::kBytes)
               : put(64, 64, tc::Smem<64, 1>::kBytes);
  if (dtype == 1 && D == 128)
    return two ? put(128, 64, tc::Smem<128, 2>::kBytes)
               : put(64, 64, tc::Smem<128, 1>::kBytes);
  if (dtype == 0 && D == 64) return put(Rows<64>::kBQ, kBK, smem_bytes<64>());
  if (dtype == 0 && D == 128)
    return put(Rows<128>::kBQ, kBK, smem_bytes<128>());
  if ((dtype == 0 || dtype == 1) && D == 256)
    return put(Rows<256>::kBQ, kBK, smem_bytes<256>());
  if ((dtype == 0 || dtype == 1) && D > 256 && D % 64 == 0)
    return put(wide::kBQ, kBK, wide::smem_bytes());
  return -1;
}
