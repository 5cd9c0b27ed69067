// float16 / bfloat16 ↔ float32 conversion.
//
// Rebuild of the reference's half support (reference horovod/common/half.{h,cc}:
// software converters + F16C fast path, used for its custom MPI fp16 sum op).
// Here the converters serve the host staging paths: the torch binding moves
// float16/bfloat16 torch tensors through numpy (which lacks bfloat16), and
// the engine's fused eager buffers can be widened/narrowed on the host.
// F16C vectorizes the fp16 side when the CPU supports it; bf16 is a cheap
// shift (round-to-nearest-even on narrowing).
#pragma once

#include <cstdint>
#include <cstddef>

namespace hvd {

void HalfToFloat(const uint16_t* src, float* dst, size_t n);
void FloatToHalf(const float* src, uint16_t* dst, size_t n);
void BFloat16ToFloat(const uint16_t* src, float* dst, size_t n);
void FloatToBFloat16(const float* src, uint16_t* dst, size_t n);

// Elementwise sum dst += src over n half/bf16 values (the reference's
// float16_sum MPI op, half.cc:43-76, for host-side reductions).
void HalfSumInto(uint16_t* dst, const uint16_t* src, size_t n);
void BFloat16SumInto(uint16_t* dst, const uint16_t* src, size_t n);

}  // namespace hvd
