#include "half.h"

#include <cstring>

#if defined(__F16C__)
#include <immintrin.h>
#endif

namespace hvd {

namespace {

// Scalar fp16 → fp32 (reference HalfBits2Float, half.h:38-92 algorithm
// family; bit manipulation re-derived from the IEEE 754 layouts).
inline float HalfBitsToFloat(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // zero
    } else {
      // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Scalar fp32 → fp16 with round-to-nearest-even (reference Float2HalfBits).
inline uint16_t FloatToHalfBits(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFFu) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFFu;
  if (exp >= 0x1F) {
    // overflow → inf; preserve nan payload bit
    uint32_t nan = ((bits & 0x7F800000u) == 0x7F800000u && mant) ? 0x200u : 0;
    return static_cast<uint16_t>(sign | 0x7C00u | nan);
  }
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);  // underflow → 0
    // subnormal
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half_mant = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_mant & 1))) ++half_mant;
    return static_cast<uint16_t>(sign | half_mant);
  }
  uint32_t half = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) ++half;
  return static_cast<uint16_t>(half);
}

}  // namespace

void HalfToFloat(const uint16_t* src, float* dst, size_t n) {
  size_t i = 0;
#if defined(__F16C__)
  for (; i + 8 <= n; i += 8) {
    __m128i h = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    _mm256_storeu_ps(dst + i, _mm256_cvtph_ps(h));
  }
#endif
  for (; i < n; ++i) dst[i] = HalfBitsToFloat(src[i]);
}

void FloatToHalf(const float* src, uint16_t* dst, size_t n) {
  size_t i = 0;
#if defined(__F16C__)
  for (; i + 8 <= n; i += 8) {
    __m256 f = _mm256_loadu_ps(src + i);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm256_cvtps_ph(f, _MM_FROUND_TO_NEAREST_INT));
  }
#endif
  for (; i < n; ++i) dst[i] = FloatToHalfBits(src[i]);
}

void BFloat16ToFloat(const uint16_t* src, float* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
    std::memcpy(dst + i, &bits, 4);
  }
}

void FloatToBFloat16(const float* src, uint16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, src + i, 4);
    // round-to-nearest-even on the dropped 16 bits (skip for nan to keep it nan)
    if ((bits & 0x7F800000u) != 0x7F800000u) {
      uint32_t rem = bits & 0xFFFFu;
      uint32_t upper = bits >> 16;
      if (rem > 0x8000u || (rem == 0x8000u && (upper & 1))) ++upper;
      dst[i] = static_cast<uint16_t>(upper);
    } else {
      dst[i] = static_cast<uint16_t>((bits >> 16) | (bits & 0xFFFFu ? 1 : 0));
    }
  }
}

void HalfSumInto(uint16_t* dst, const uint16_t* src, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    dst[i] = FloatToHalfBits(HalfBitsToFloat(dst[i]) + HalfBitsToFloat(src[i]));
  }
}

void BFloat16SumInto(uint16_t* dst, const uint16_t* src, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float a, b;
    BFloat16ToFloat(dst + i, &a, 1);
    BFloat16ToFloat(src + i, &b, 1);
    float s = a + b;
    FloatToBFloat16(&s, dst + i, 1);
  }
}

}  // namespace hvd
