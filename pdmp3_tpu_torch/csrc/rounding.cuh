// The reference decoder's three float64 rounding points, as device
// functions: the exact granule kernel (fused_granule.cu) calls them, and
// the 2^32-input sweep (rounding_sweep.cu) proves them against their
// plain PyTorch versions, pdmp3_tpu_torch/ops/rounding.py ms_f64 / uq_f64
// / qz_f64.  Written with the _rn intrinsics, so no step is contracted
// into an FMA or reassociated; the kernels are built without
// flush-to-zero, so subnormal inputs and results are kept.
#pragma once

#include <cuda_runtime.h>

namespace pdmp3 {

constexpr double kInvSqrt2 = 0.70710678118654752440;  // C_INV_SQRT_2

// MS butterfly (pdmp3.c:1923-1925): fl32(f64(m) * C_INV_SQRT_2), where
// the caller has rounded m = l +- r to f32, as C does
__device__ __forceinline__ float ms_f64(float m) {
  return __double2float_rn(__dmul_rn((double)m, kInvSqrt2));
}

// short-block intensity quirk (pdmp3.c:2212-2213): (float)(uint32_t)
// (int64_t)l, i.e. fl32(floor_mod(trunc(f64(l)), 2^32)).  Every step is
// exact in f64 for an f32 l; the final + 0.0 turns -0.0 into +0.0, as
// the integer round trip does
__device__ __forceinline__ float uq_f64(float l) {
  const double t = trunc((double)l);
  const double k = floor(__dmul_rn(t, 0x1p-32));
  const double r = __dsub_rn(t, __dmul_rn(k, 4294967296.0));
  return __double2float_rn(__dadd_rn(r, 0.0));
}

// final quantize (pdmp3.c:2028-2031): trunc(f64(s) * 32767), where
// cvttsd2si turns NaN and values outside int32 into INT32_MIN and the
// clip turns that into -32767.  The range test runs in f64 against
// 2^31 - 1 (in f32 that bound rounds to 2^31).  Returns the clipped
// value as a float; a zero keeps the truncation's sign
__device__ __forceinline__ float qz_f64(float s) {
  const double scaled = __dmul_rn((double)s, 32767.0);
  const double t = trunc(scaled);
  if (isnan(scaled) || t < -2147483648.0 || t > 2147483647.0)
    return -32767.0f;
  return __double2float_rn(fmin(fmax(t, -32767.0), 32767.0));
}

}  // namespace pdmp3
