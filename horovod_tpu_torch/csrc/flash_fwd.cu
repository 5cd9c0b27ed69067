// Forward flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces horovod_tpu/ops/flash_attention.py::_flash_kernel (driven by
// _flash_forward): online-softmax attention over [B, S, H, D] with the
// scale * log2(e) fold into q, exp2-domain scores, an f32 accumulator cast
// to the input dtype, and a natural-log lse that is NEG_INF for rows that
// attended to nothing.  Masking follows the TPU kernel: a key at global
// position k_offset + j is visible to the query at q_offset + i iff j < Sk
// and (not causal or q_offset + i >= k_offset + j).
//
// What bounds it on the H100: causal attention does ~2*S*S*D operations
// (the visible half of QK^T and PV) against ~4*S*D*2 bytes of bf16 q, k, v
// and out per head, so at D = 128 it sits near the card's ridge of ~295
// operations per byte: the bytes bound it up to S ~ 1200, the tensor cores
// (989 TFLOP/s in bf16) above.  Products on the CUDA cores (67 TFLOP/s in
// f32) cannot come near either bound.
//
// bf16, the tensor-core route (namespace tc):
//
// * one block per (q tile, batch*head), the heaviest causal q tiles issued
//   first, since the longest block sets the time; the q tile is 128 rows
//   (two consumer warpgroups of 64 rows) when that gives at least one block
//   per SM, else 64 rows (one warpgroup), so that a serving prefill
//   ([1, S <= 1024, 6, 128]: 48 blocks of 128 rows) spreads over more SMs;
// * a producer warp keeps TMA loads of 64-key K and V tiles in flight in a
//   two-stage shared-memory ring, completed through mbarriers; the q tile
//   is loaded once, and each warpgroup folds scale * log2(e) into its rows
//   in shared memory (multiply, round to bf16) before its first product;
// * S = q~.K^T is a wgmma from shared memory (K is K-major as it lies,
//   [key][d]); the online softmax runs on the accumulator fragment in
//   registers; O += P.V takes P from registers as wgmma's A operand and V
//   from shared memory with the transpose bit (its contracted dim is the
//   key);
// * only tiles that straddle the causal diagonal or the ragged end of the
//   keys are masked; tiles wholly above the diagonal are skipped, tiles
//   below run mask-free, as the TPU kernel's interior/boundary split does.
//
// Where p is rounded: wgmma multiplies bf16 operands, so p enters P.V as
// two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products
// into one f32 accumulator: p keeps ~16 significant bits, l sums the f32 p,
// and the output agrees with the plain version's f32-p product to f32
// rounding.  (One bf16 term, as the TPU's single bf16 MXU pass takes it --
// horovod_tpu/ops/flash_attention.py:142-146 -- errs by up to 2^-9 of each
// p, and on rows that see only a few keys that breaks the 1e-3 absolute
// agreement the card tests and chip_smoke.py hold the kernel to.)
//
// The CUDA-core route (chosen by dtype and head dim, never on failure):
// float32 at D = 64, 128 and 256, since f32 inputs cannot meet the f32
// checks' 1e-5 through bf16 tensor-core products, and both dtypes at
// D = 256, where the tensor-core kernel's tiles are not instantiated.  It
// keeps the first version's design: one block per (batch*head, 64-row q
// tile) looping over 64-key K/V tiles staged through shared memory in f32
// (200 KB at D = 256, within the 227 KB a block may use); each warp owns 8
// q rows and updates them 4 at a time.  bf16 inputs are widened on load and
// the output rounded once, so that route keeps p in f32, as the plain
// version does.
//
// Head dims past 256 (namespace wide; both dtypes; the caller zero-pads D
// to a multiple of 64): whole-D tiles no longer fit shared memory, so each
// block owns one 64-column slice of the output on the grid's z axis and
// sums q~.K^T over D in 64-wide chunks; every slice recomputes the same
// scores and row statistics, so the scores cost D/64 times over.  No
// configuration of the repository has such a head dim: right, not fast.
//
// Every route puts batch*head on the grid's x axis (up to 2^31 - 1 blocks;
// y and z are capped at 65535), and every offset into q, k, v, out and lse
// is formed in 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

// ---- float32: CUDA cores -------------------------------------------------

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;   // 8
constexpr int kR = 4;                        // rows updated together
constexpr int kGroups = kRowsPerWarp / kR;   // 2

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

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
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
  constexpr size_t smem = smem_bytes(D);
  static_assert(smem <= 232448, "the tiles pass a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Sq, Sk, causal, q_offset, k_offset, qscale);
  return (int)cudaGetLastError();
}


// ---- head dims past 256: CUDA cores, a slice of the columns a block -------

namespace wide {

constexpr int kC = 64;         // columns of a chunk of q.K^T, and of a slice
constexpr int kDL = kC / 32;   // output columns per lane

constexpr size_t smem_bytes() {
  // q chunk [BQ][C], K chunk [BK][C+1] (padded as above), V slice [BK][C],
  // per-warp probabilities [warps][R][BK].
  return sizeof(float) *
         (size_t)(kBQ * kC + kBK * (kC + 1) + kBK * kC + kWarps * kR * kBK);
}

// One block per (batch*head, 64-row q tile, 64-column slice of the output).
// S = q~.K^T sums over D in 64-wide chunks staged through shared memory, in
// the same order (d = 0 .. D-1) as the route above, so every slice of a row
// computes the same scores, m and l; each block keeps only its slice of V
// and of the accumulator, and slice 0 writes lse.  D is a multiple of 64.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D,
                      int causal, int q_offset, int k_offset, float qscale) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * kC;
  float* sv = sk + kBK * (kC + 1);
  float* sp = sv + kBK * kC;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int c0 = blockIdx.z * kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;

  float m[kGroups][kR], l[kGroups][kR], acc[kGroups][kR][kDL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[g][r] = kNegInf;
      l[g][r] = 0.f;
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[g][r][i] = 0.f;
    }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
    const int span = q_last - k_offset;
    n_tiles = span < 0 ? 0 : min(n_tiles, span / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    float s[kGroups][kR][2];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) s[g][r][0] = s[g][r][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kC) {
      __syncthreads();   // the previous chunk (and tile) is consumed
      for (int i = tid; i < kBQ * kC; i += kThreads) {
        const int r = i / kC, d = i % kC;
        float x = 0.f;
        if (q0 + r < Sq)
          x = to_f(from_f<T>(to_f(qb[(long)(q0 + r) * rs + d0 + d]) * qscale));
        sq[i] = x;
      }
      for (int i = tid; i < kBK * kC; i += kThreads) {
        const int c = i / kC, d = i % kC;
        const bool in = k0 + c < Sk;
        sk[c * (kC + 1) + d] = in ? to_f(kb[(long)(k0 + c) * rs + d0 + d]) : 0.f;
        if (d0 == 0)
          sv[c * kC + d] = in ? to_f(vb[(long)(k0 + c) * rs + c0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int rb = warp * kRowsPerWarp + g * kR;
#pragma unroll 8
        for (int d = 0; d < kC; ++d) {
          const float ka = sk[lane * (kC + 1) + d];
          const float kc = sk[(lane + 32) * (kC + 1) + d];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float qv = sq[(rb + r) * kC + d];
            s[g][r][0] = fmaf(qv, ka, s[g][r][0]);
            s[g][r][1] = fmaf(qv, kc, s[g][r][1]);
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int rb = warp * kRowsPerWarp + g * kR;
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
          if (!ok[j]) s[g][r][j] = kNegInf;
        }
        const float m_new =
            fmaxf(m[g][r], warp_max(fmaxf(s[g][r][0], s[g][r][1])));
#pragma unroll
        for (int j = 0; j < 2; ++j) p[j] = ok[j] ? exp2f(s[g][r][j] - m_new) : 0.f;
        const float corr = exp2f(m[g][r] - m_new);
        l[g][r] = l[g][r] * corr + warp_sum(p[0] + p[1]);
        m[g][r] = m_new;
#pragma unroll
        for (int i = 0; i < kDL; ++i) acc[g][r][i] *= corr;
        pw[r * kBK + lane] = p[0];
        pw[r * kBK + lane + 32] = p[1];
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float vv[kDL];
#pragma unroll
        for (int i = 0; i < kDL; ++i) vv[i] = sv[c * kC + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pw[r * kBK + c];
#pragma unroll
          for (int i = 0; i < kDL; ++i) acc[g][r][i] = fmaf(p, vv[i], acc[g][r][i]);
        }
      }
      __syncwarp();
    }
  }

  T* ob = out + ((long)b * Sq * H + h) * D + c0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + g * kR + r;
      if (qi >= Sq) continue;
      const float denom = fmaxf(l[g][r], 1e-30f);
#pragma unroll
      for (int i = 0; i < kDL; ++i)
        ob[(long)qi * rs + lane + 32 * i] = from_f<T>(acc[g][r][i] / denom);
      if (lane == 0 && blockIdx.z == 0)
        lse[((long)b * Sq + qi) * H + h] =
            l[g][r] > 0.f ? m[g][r] * kLn2 + logf(denom) : kNegInf;
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Sq, int Sk, int D, int causal, int q_offset,
           int k_offset, float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, D / kC);
  flash_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Sq, Sk, D, causal, q_offset, k_offset,
      qscale);
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
  static constexpr uint32_t kStage0 = NWG * kTile;           // K, V per stage
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kTile;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of alignment slack.
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H,
           int Sq, int Sk, int causal, int q_offset, int k_offset,
           float qscale) {
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
      mbar_arrive_expect_tx(q_full, NWG * L::kTile);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < kChunks; ++c)
          tma_load(base + L::kQ + (w * kChunks + c) * kChunkBytes, &qmap,
                   q_full, 64 * c, h, q0 + 64 * w, b);
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

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

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
      wgmma_wait<0>();
      fence_regs(s);

      const int k0 = 64 * t;
      const bool masked =
          k0 + 64 > Sk || (causal && k_offset + k0 + 63 > q_offset + row0);
      uint32_t ok = 0xffffffffu;
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = k0 + acc_col(i, lane);
          const int r = r0 + 8 * acc_half(i);
          if (!(c < Sk && (!causal || q_offset + r >= k_offset + c))) {
            ok &= ~(1u << i);
            s[i] = kNegInf;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = (ok >> i & 1u) ? exp2f(s[i] - m[acc_half(i)]) : 0.f;
        rsum[acc_half(i)] += s[i];
      }
      // l is this thread's share of its rows' sums; the four threads of a
      // row add theirs at the end (corr is the same across them).
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[acc_half(i)];

      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = s[8 * kk + 2 * j], c = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][j] = pack_bf16(a - __low2float(hi), c - __high2float(hi));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_mn_major(vt + kk * 16 * 128);
        if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb(o, p_hi[kk], dv);
          wgmma_rs_m64n128k16_tb(o, p_lo[kk], dv);
        } else {
          wgmma_rs_m64n64k16_tb(o, p_hi[kk], dv);
          wgmma_rs_m64n64k16_tb(o, p_lo[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }
    if (lane == 0) mbar_arrive(empty(st));   // this warp is done with st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + acc_col(4 * j, lane)) =
          pack_bf16(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0)
      lse[((long)b * Sq + qi) * H + h] =
          l[r] > 0.f ? m[r] * kLn2 + logf(denom) : kNegInf;
  }
}

template <int D, int NWG>
int launch_rows(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int H, int Sq, int Sk, int causal, int q_offset,
           int k_offset, float qscale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  // With no keys, the K and V maps are never read: describe q instead.
  const bool no_keys = Sk == 0;
  int rc = make_bshd_map(&qm, q, B, Sq, H, D);
  if (!rc) rc = make_bshd_map(&km, no_keys ? q : k, B, no_keys ? Sq : Sk, H, D);
  if (!rc) rc = make_bshd_map(&vm, no_keys ? q : v, B, no_keys ? Sq : Sk, H, D);
  if (rc) return rc;
  constexpr uint32_t smem = Smem<D, NWG>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + 64 * NWG - 1) / (64 * NWG));
  flash_fwd_wgmma_kernel<D, NWG><<<grid, NWG * 128 + 32, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, causal, q_offset, k_offset, qscale);
  return (int)cudaGetLastError();
}

// 128-row q tiles when they give every SM a block, else 64-row ones.
inline bool two_row_tiles(int B, int H, int Sq) {
  return (long)((Sq + 127) / 128) * B * H >= num_sms();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int H, int Sq, int Sk, int causal, int q_offset,
           int k_offset, float qscale, cudaStream_t stream) {
  if (two_row_tiles(B, H, Sq))
    return launch_rows<D, 2>(q, k, v, out, lse, B, H, Sq, Sk, causal,
                             q_offset, k_offset, qscale, stream);
  return launch_rows<D, 1>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset,
                           k_offset, qscale, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores at D = 64
// and 128, CUDA cores at D = 256 and past it, D a multiple of 64).  qscale is the caller's head dim's
// D**-0.5 * log2(e), rounded to float (the caller zero-pads other head dims
// up to one of these).  Returns a cudaError_t, or -1 for a dtype/head_dim
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
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, out, lse, B, H, Sq, Sk, causal, q_offset, k_offset, qscale, s);
  if (D > 256 && D % 64 == 0)
    return dtype == 0
        ? wide::launch<float>(q, k, v, out, lse, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, s)
        : wide::launch<__nv_bfloat16>(q, k, v, out, lse, B, H, Sq, Sk, D, causal, q_offset, k_offset, qscale, s);
  return -1;
}

// The tiles a call of hvd_flash_fwd at this shape launches, as the
// launchers above choose them: tiles[0] q rows and tiles[1] keys of a
// block's tile, tiles[2] its dynamic shared memory in bytes.  Launches
// nothing; returns -1 where hvd_flash_fwd would.
extern "C" int hvd_flash_fwd_tiles(int dtype, int B, int H, int Sq, int D,
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
  if ((dtype == 0 && (D == 64 || D == 128 || D == 256)) ||
      (dtype == 1 && D == 256))
    return put(kBQ, kBK, smem_bytes(D));
  if ((dtype == 0 || dtype == 1) && D > 256 && D % 64 == 0)
    return put(kBQ, kBK, wide::smem_bytes());
  return -1;
}
