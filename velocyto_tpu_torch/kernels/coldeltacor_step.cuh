// The per-(pair, gene) step shared by the two colDeltaCor kernels
// (coldeltacor_dense.cu, coldeltacor_partial.cu).
//
// One step takes a = transform(e_i - e_c) and adds a to S1, its square to
// S2, a*b to S3 and, for the dual form, a*b2 to S4.  Both kernels are bound
// by instruction issue and the special-function unit (SFU) once their bytes
// are served, so the step is written for the fewest issued instructions:
//
//   sqrt:   x = |delta| + psc;  a = +-sqrt.approx(x)      (one MUFU.SQRT)
//           S2 += x, since a*a == |delta| + psc
//   log10:  a = +-lg2.approx(|delta| + psc)               (one MUFU.LG2)
//           log10 = log10(2) * lg2, and a Pearson correlation does not
//           change when every a is scaled by the same positive factor, so
//           the factor is never applied
//   sign:   one LOP3 that XORs the sign bit into the magnitude, taken from
//           -delta (full: delta == +0 goes negative, the `delta > 0` test)
//           or from delta (partial log10: delta == +0 stays positive, the
//           `delta >= 0` test)
//   partial sqrt: |delta| < 1e-16 maps to exactly 0, by one select on x
//
// sqrt.approx.ftz and lg2.approx.ftz have a relative error near 2^-22 and
// flush subnormal inputs to 0; the correlation's f32 moment cancellation
// (S2 - S1^2/G) dominates that by orders of magnitude, so the kernels stay
// within rtol 2e-3 / atol 2e-4 of the plain PyTorch versions (IEEE sqrt and
// log10, a*a).  A -0.0 in the inputs can flip the sign of a zero delta's
// +-sqrt(psc) against the plain version; expression data holds none.
//
// Every accumulation is an explicit __fadd_rn / __fmaf_rn, so the single and
// the dual instantiation of a kernel perform the same operations on S1..S3
// in the same order and their outputs are bitwise equal.
#pragma once

namespace vtt {

constexpr int kLinear = 0, kSqrt = 1, kLog10 = 2;
constexpr unsigned kSignBit = 0x80000000u;

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// m with its sign bit XORed by the sign bit of `mask` (a single LOP3)
__device__ __forceinline__ float flip(float m, unsigned mask) {
  return __uint_as_float(__float_as_uint(m) ^ (mask & kSignBit));
}

template <int TF, bool PARTIAL, bool DUAL>
__device__ __forceinline__ void moment_step(float e_i, float e_c, float b,
                                            float b2, float psc, float& s1,
                                            float& s2, float& s3,
                                            float& s4) {
  float a;
  if (TF == kLinear) {
    a = __fsub_rn(e_i, e_c);
    s2 = __fmaf_rn(a, a, s2);
  } else if (TF == kSqrt) {
    const float nd = __fsub_rn(e_c, e_i);           // -delta
    float x = __fadd_rn(fabsf(nd), psc);
    if (PARTIAL) x = fabsf(nd) < 1e-16f ? 0.0f : x;
    // full: delta > 0 <=> nd < 0 (sign bit set) keeps +; delta == 0 gives
    // nd == +0 and goes negative.  partial: delta == 0 has x == 0 already.
    a = flip(sqrt_approx(x), ~__float_as_uint(nd));
    s2 = __fadd_rn(s2, x);
  } else {
    // full: the `delta > 0` test, from -delta as above; partial: the
    // `delta >= 0` test, the sign bit of delta itself
    const float dl = PARTIAL ? __fsub_rn(e_i, e_c) : __fsub_rn(e_c, e_i);
    const float m = lg2_approx(__fadd_rn(fabsf(dl), psc));
    a = flip(m, PARTIAL ? __float_as_uint(dl) : ~__float_as_uint(dl));
    s2 = __fmaf_rn(a, a, s2);
  }
  s1 = __fadd_rn(s1, a);
  s3 = __fmaf_rn(a, b, s3);
  if (DUAL) s4 = __fmaf_rn(a, b2, s4);
}

// Pearson correlation from the five moments over G genes (the formula of
// _corr_from_moments in ops/coldeltacor.py), IEEE sqrt and division
__device__ __forceinline__ float corr_from_moments(float s1, float s2,
                                                   float s3, float sb1,
                                                   float sb2, float gf) {
  const float num = s3 - s1 * (sb1 / gf);
  const float var_a = s2 - s1 * s1 / gf;
  const float var_b = sb2 - sb1 * sb1 / gf;
  return num / (sqrtf(var_a) * sqrtf(var_b));
}

}  // namespace vtt
