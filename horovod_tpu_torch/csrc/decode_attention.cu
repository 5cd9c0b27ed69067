// Decode attention over a per-slot KV cache for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces no TPU kernel.  The JAX package computes this step with two XLA
// einsums and a masked softmax (horovod_tpu/models/transformer.py:132,
// cached_decode_attention); XLA fuses them on the TPU.  Eager PyTorch does
// not: its einsums copy every slot's whole [B, S, H, D] cache into another
// layout before each batched GEMV, every layer of every decode.
//
// What it computes: for slot b, query row i (at position lengths[b] + i)
// and head h, softmax(q . K^T * D^-1/2) . V over the cache positions
// p <= lengths[b] + i, f32 throughout, the output rounded once to the
// input's dtype.  q: [B, S_q, H, D]; K, V: [B, S, H, D], contiguous.
//
// What bounds it on the H100: the bytes of the live cache.  A decode row
// does 2 operations per K or V element against 2 bytes (bf16) read, far
// below the card's ~295 operations per byte, so the least time is the
// live K and V bytes, sum over b of (lengths[b] + S_q) * H * D * 2 * 2,
// over 3.35 TB/s.
//
// The design streams those bytes once:
//
// * phase 1 (split): a block per (chunk of `chunk` positions, 256 from
//   the wrapper; group of G heads; slot).  It reads lengths[b] itself and returns before loading
//   anything if its chunk starts past the slot's last visible position,
//   so the grid is sized by the capacity S with no host sync.  The block
//   streams its chunk's K and V, kTile positions a stage, through a
//   kStages-deep cp.async ring in shared memory (16 bytes a thread,
//   neighbouring threads on neighbouring addresses; a position's G heads
//   are one contiguous row of at most kRowBytes), computes the scores
//   from shared memory, updates an f32 online softmax per (query row,
//   head) with the scale and log2(e) folded into q, and accumulates P.V
//   from the same stage: each K and V byte is read from HBM once.  It
//   writes its chunk's (max, sum, f32 accumulator) to scratch.
// * phase 2 (merge): a block per (query row, head, slot) merges the
//   slot's live chunks by log-sum-exp, in chunk order, into the output.
//   No atomics.
//
// A slot's partition follows from its own length, S and the chunk alone, and
// every sum runs in a fixed order, so slot b's output has the same bits
// whatever the other slots hold and whatever B is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // phase 1: four warps a block
constexpr int kTile = 16;       // positions a stage of the ring holds
constexpr int kStages = 3;      // stages of the ring; kStages - 1 in flight
constexpr int kRowBytes = 1024; // a head group's K (or V) at one position
constexpr int kPad = 16;        // bytes after each row in shared memory
constexpr int kMaxRows = 16;    // query rows S_q
constexpr int kMaxPairs = 16;   // (row, head) pairs a thread accumulates
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four consecutive elements of T at p as floats (8 bytes of bf16, 16 of
// f32).
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x);
  f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
}

// The dot of one 16-byte vector of T with the matching floats of q.
__device__ __forceinline__ float dot16(const float* k, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(q);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* k,
                                       const float* q) {
  const uint4 a = *reinterpret_cast<const uint4*>(k);
  const float4 b0 = *reinterpret_cast<const float4*>(q);
  const float4 b1 = *reinterpret_cast<const float4*>(q + 4);
  return bf16_lo(a.x) * b0.x + bf16_hi(a.x) * b0.y + bf16_lo(a.y) * b0.z +
         bf16_hi(a.y) * b0.w + bf16_lo(a.z) * b1.x + bf16_hi(a.z) * b1.y +
         bf16_lo(a.w) * b1.z + bf16_hi(a.w) * b1.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A fixed xor tree: every lane gets the same bits.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes from global to shared memory, bypassing L1; n = 0 fills zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of phase 1, in bytes, for G heads of D elements of
// elem_bytes and S_q query rows: the K/V ring (rows padded by kPad, so
// that the score loop's 16-byte reads of eight neighbouring rows fall in
// distinct banks), q (f32, pre-scaled), the tile's scores and the (max,
// sum, rescale) of each (row, head) pair.
inline int split_smem_bytes(int S_q, int G, int D, int elem_bytes) {
  const int pairs = S_q * G;
  return kStages * 2 * kTile * (G * D * elem_bytes + kPad) +
         pairs * D * 4 + pairs * kTile * 4 + 3 * pairs * 4;
}

__host__ __device__ inline int64_t visible_end(int64_t len, int S_q, int S) {
  len = len < 0 ? 0 : len;
  return len + S_q < S ? len + S_q : S;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int64_t* __restrict__ lengths,
                              float* __restrict__ part_acc,
                              float* __restrict__ part_ml, int S_q, int S,
                              int H, int G, int chunk, float qscale) {
  constexpr int kVecElems = 16 / sizeof(T);        // elements a 16-byte vector
  constexpr int kHeadVecs = D / kVecElems;         // vectors of one head row
  constexpr int kTpp = D / 4;                      // threads a pair in P.V
  constexpr int kPairsPerPass = kThreads / kTpp;
  const int c = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t len = lengths[b] < 0 ? 0 : lengths[b];
  const int64_t end = visible_end(lengths[b], S_q, S);
  const int64_t c0 = static_cast<int64_t>(c) * chunk;
  if (c0 >= end) return;
  const int n = static_cast<int>(end - c0 < chunk ? end - c0 : chunk);
  const int ntiles = (n + kTile - 1) / kTile;
  const int pairs = S_q * G;
  const int row_bytes = G * D * static_cast<int>(sizeof(T));
  const int pitch = row_bytes + kPad;
  const int row_vecs = row_bytes / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + kStages * 2 * kTile * pitch);
  float* s_s = q_s + pairs * D;       // [pairs][kTile]
  float* m_s = s_s + pairs * kTile;   // [pairs]
  float* l_s = m_s + pairs;
  float* a_s = l_s + pairs;

  // Position p's row of the head group: G * D elements from here.
  const int64_t slot0 = static_cast<int64_t>(b) * S;
  const int64_t head0 = static_cast<int64_t>(hg) * G * D;
  auto load_tile = [&](int j) {
    unsigned char* kd = ring + (j % kStages) * 2 * kTile * pitch;
    unsigned char* vd = kd + kTile * pitch;
    for (int x = tid; x < kTile * row_vecs; x += kThreads) {
      const int t = x / row_vecs, vv = x % row_vecs;
      const int pos = j * kTile + t;
      const bool live = pos < n;
      const int64_t off =
          ((slot0 + c0 + (live ? pos : 0)) * H) * D + head0 +
          static_cast<int64_t>(vv) * kVecElems;
      cp_async16(kd + t * pitch + vv * 16, k + off, live ? 16 : 0);
      cp_async16(vd + t * pitch + vv * 16, v + off, live ? 16 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < ntiles) load_tile(j);
    cp_async_commit();
  }

  // q of this slot's rows and the group's heads, scaled by D^-1/2 log2(e)
  // so that the softmax runs on exp2.
  for (int x = tid; x < pairs * D; x += kThreads) {
    const int r = x / D, d = x % D, i = r / G, g = r % G;
    q_s[x] = to_f(q[((static_cast<int64_t>(b) * S_q + i) * H) * D + head0 +
                    g * D + d]) * qscale;
  }
  for (int r = tid; r < pairs; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // P.V: thread tid owns elements 4*dq .. 4*dq + 3 of pairs r0, r0 +
  // kPairsPerPass, ...
  const int dq = tid % kTpp, r0 = tid / kTpp;
  float acc[kMaxPairs][4];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j landed; tile j - 1's stage is free
    if (j + kStages - 1 < ntiles) load_tile(j + kStages - 1);
    cp_async_commit();
    const unsigned char* kt = ring + (j % kStages) * 2 * kTile * pitch;
    const unsigned char* vt = kt + kTile * pitch;
    const int64_t tile0 = c0 + static_cast<int64_t>(j) * kTile;

    // Scores: a thread per (pair, position); masked ones are -inf.
    for (int x = tid; x < pairs * kTile; x += kThreads) {
      const int r = x / kTile, t = x % kTile, i = r / G, g = r % G;
      float s = -INFINITY;
      if (j * kTile + t < n && tile0 + t <= len + i) {
        const T* kr = reinterpret_cast<const T*>(kt + t * pitch) + g * D;
        const float* qr = q_s + r * D;
        s = 0.f;
#pragma unroll
        for (int u = 0; u < kHeadVecs; ++u)
          s += dot16(kr + u * kVecElems, qr + u * kVecElems);
      }
      s_s[x] = s;
    }
    __syncthreads();

    // Online softmax: a warp per pair, a lane per position.
    for (int r = warp; r < pairs; r += kThreads / 32) {
      const float s = lane < kTile ? s_s[r * kTile + lane] : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s == -INFINITY ? 0.f : exp2f(s - m_new);
      const float psum = warp_sum(p);
      if (lane < kTile) s_s[r * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V over the tile's positions.
    const int tn = n - j * kTile < kTile ? n - j * kTile : kTile;
#pragma unroll
    for (int jj = 0; jj < kMaxPairs; ++jj) {
      const int r = r0 + jj * kPairsPerPass;
      if (r < pairs) {
        const int g = r % G;
        const float alpha = a_s[r];
        float o[4] = {acc[jj][0] * alpha, acc[jj][1] * alpha,
                      acc[jj][2] * alpha, acc[jj][3] * alpha};
        const float* pr = s_s + r * kTile;
        for (int t = 0; t < tn; ++t) {
          float vf[4];
          load4(reinterpret_cast<const T*>(vt + t * pitch) + g * D + 4 * dq,
                vf);
          const float p = pr[t];
          o[0] += p * vf[0]; o[1] += p * vf[1];
          o[2] += p * vf[2]; o[3] += p * vf[3];
        }
        acc[jj][0] = o[0]; acc[jj][1] = o[1];
        acc[jj][2] = o[2]; acc[jj][3] = o[3];
      }
    }
  }
  cp_async_wait<0>();

  // The chunk's partials: part_*[b][c][i][h].
  const int nc = gridDim.x;
  auto index = [&](int r) {
    const int i = r / G, g = r % G;
    return ((static_cast<int64_t>(b) * nc + c) * S_q + i) * H +
           hg * G + g;
  };
#pragma unroll
  for (int jj = 0; jj < kMaxPairs; ++jj) {
    const int r = r0 + jj * kPairsPerPass;
    if (r < pairs)
      *reinterpret_cast<float4*>(part_acc + index(r) * D + 4 * dq) =
          make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
  }
  for (int r = tid; r < pairs; r += kThreads) {
    part_ml[2 * index(r)] = m_s[r];
    part_ml[2 * index(r) + 1] = l_s[r];
  }
}

// Phase 2: block (i * H + h, b), D / 4 threads, each 4 elements of the
// output row; the slot's live chunks merged in chunk order.
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
decode_attention_merge_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              const int64_t* __restrict__ lengths,
                              T* __restrict__ out, int S_q, int S, int H,
                              int nc, int chunk) {
  const int ih = blockIdx.x, b = blockIdx.y, dq = threadIdx.x;
  const int i = ih / H, h = ih % H;
  const int64_t end = visible_end(lengths[b], S_q, S);
  const int live = static_cast<int>((end + chunk - 1) / chunk);
  auto index = [&](int c) {
    return ((static_cast<int64_t>(b) * nc + c) * S_q + i) * H + h;
  };
  float m = -INFINITY;
  for (int c = 0; c < live; ++c) m = fmaxf(m, part_ml[2 * index(c)]);
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < live; ++c) {
    const float mc = part_ml[2 * index(c)];
    const float w = mc == -INFINITY ? 0.f : exp2f(mc - m);
    l += w * part_ml[2 * index(c) + 1];
    const float4 a =
        *reinterpret_cast<const float4*>(part_acc + index(c) * D + 4 * dq);
    o[0] += w * a.x; o[1] += w * a.y; o[2] += w * a.z; o[3] += w * a.w;
  }
  T* dst = out + ((static_cast<int64_t>(b) * S_q + i) * H + h) * D + 4 * dq;
#pragma unroll
  for (int e = 0; e < 4; ++e) store_f(dst + e, o[e] / l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* part_acc, void* part_ml, int B, int S_q, int S,
           int H, int G, int chunk, cudaStream_t stream) {
  const int smem = split_smem_bytes(S_q, G, D, sizeof(T));
  auto split = decode_attention_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (S + chunk - 1) / chunk;
  const float qscale = kLog2e / sqrtf(static_cast<float>(D));
  const int64_t* lens = static_cast<const int64_t*>(lengths);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  split<<<dim3(nc, H / G, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, acc, ml, S_q, S, H, G, chunk, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_merge_kernel<T, D><<<dim3(S_q * H, B), D / 4, 0, stream>>>(
      acc, ml, lens, static_cast<T*>(out), S_q, S, H, nc, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* out, void* part_acc, void* part_ml,
             int B, int S_q, int S, int H, int G, int chunk,
             cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, B, S_q,
                         S, H, G, chunk, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, B, S_q,
                          S, H, G, chunk, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and out; lengths int64 [B];
// part_acc f32 [B, ceil(S / chunk), S_q, H, D] and part_ml f32 [..., 2],
// scratch.  Returns a cudaError_t, or -1 for a dtype or shape this kernel
// does not take: D other than 64 or 128, S_q outside 1 .. 16, G heads a
// block that do not divide H or pass kRowBytes, a chunk that is not a
// positive multiple of kTile, or B or H / G past a grid dimension.
extern "C" int hvd_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_acc,
                                    void* part_ml, int dtype, int B, int S_q,
                                    int S, int H, int D, int G, int chunk,
                                    void* stream) {
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (elem == 0 || B < 1 || B > 65535 || S < 1 || S_q < 1 ||
      S_q > kMaxRows || H < 1 || G < 1 || H % G || H / G > 65535 ||
      G * D * elem > kRowBytes || S_q * G * D > 4 * kThreads * kMaxPairs ||
      chunk < kTile || chunk % kTile)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, lengths, out, part_acc, part_ml, B,
                           S_q, S, H, G, chunk, s);
  return launch_d<__nv_bfloat16>(D, q, k, v, lengths, out, part_acc,
                                 part_ml, B, S_q, S, H, G, chunk, s);
}
