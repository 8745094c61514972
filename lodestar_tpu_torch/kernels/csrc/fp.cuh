// GF(p) Montgomery arithmetic, 12 x 32-bit limbs, R = 2^384.
// The CUDA twin of lodestar_tpu_torch/kernels/core.py.
//
// Every function takes canonical operands (integers in [0, p)) and returns
// canonical results, so a value leaving a kernel equals the plain torch
// engine's bit for bit.  p < 2^381 leaves three spare bits in the top limb:
// the CIOS accumulator never needs a fourteenth word and a sum of two
// canonical values never carries out of limb 11.
#pragma once

#include "common.cuh"

struct fp {
  uint32_t w[LT_NL];
};

#ifndef __CUDACC__
// Fp products done by the host build: the check of the cost model that
// bounds each kernel (kernels/verify.py FP_MULS_PER_LANE)
static uint64_t lt_fp_muls;
extern "C" uint64_t lt_host_fp_muls(void) {
  const uint64_t c = lt_fp_muls;
  lt_fp_muls = 0;
  return c;
}
#endif

// planes are int32 [12, n]: limb i of lane j at plane[i * n + j]
LT_DEV void fp_load(fp &r, const int32_t *plane, int n, int lane) {
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = (uint32_t)plane[i * n + lane];
}

LT_DEV void fp_store(int32_t *plane, int n, int lane, const fp &a) {
#pragma unroll
  for (int i = 0; i < LT_NL; i++) plane[i * n + lane] = (int32_t)a.w[i];
}

LT_DEV void fp_const(fp &r, const uint32_t *c) {
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = c[i];
}

LT_DEV void fp_zero(fp &r) {
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = 0;
}

LT_DEV void fp_one(fp &r) { fp_const(r, LT_ONE); }

LT_DEV bool fp_is_zero(const fp &a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) acc |= a.w[i];
  return acc == 0;
}

LT_DEV bool fp_eq(const fp &a, const fp &b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

LT_DEV bool fp_is_one(const fp &a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) acc |= a.w[i] ^ LT_ONE[i];
  return acc == 0;
}

// r = cond ? a : b
LT_DEV void fp_select(fp &r, bool cond, const fp &a, const fp &b) {
  uint32_t m = cond ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
}

// r = t - p if t >= p else t, for t < 2p
LT_DEV void fp_reduce_once(fp &r, const uint32_t *t) {
  uint32_t s[LT_NL];
  s[0] = sub_cc(t[0], LT_P[0]);
#pragma unroll
  for (int i = 1; i < LT_NL; i++) s[i] = subc_cc(t[i], LT_P[i]);
  uint32_t keep = subc(0, 0);  // all ones iff t < p
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = (t[i] & keep) | (s[i] & ~keep);
}

LT_DEV void fp_add(fp &r, const fp &a, const fp &b) {
  uint32_t t[LT_NL];
  t[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < LT_NL - 1; i++) t[i] = addc_cc(a.w[i], b.w[i]);
  t[LT_NL - 1] = addc(a.w[LT_NL - 1], b.w[LT_NL - 1]);
  fp_reduce_once(r, t);
}

LT_DEV void fp_sub(fp &r, const fp &a, const fp &b) {
  uint32_t t[LT_NL];
  t[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < LT_NL; i++) t[i] = subc_cc(a.w[i], b.w[i]);
  uint32_t m = subc(0, 0);  // all ones iff a < b: add p back
  r.w[0] = add_cc(t[0], LT_P[0] & m);
#pragma unroll
  for (int i = 1; i < LT_NL - 1; i++) r.w[i] = addc_cc(t[i], LT_P[i] & m);
  r.w[LT_NL - 1] = addc(t[LT_NL - 1], LT_P[LT_NL - 1] & m);
}

LT_DEV void fp_neg(fp &r, const fp &a) {
  fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

LT_DEV void fp_dbl(fp &r, const fp &a) { fp_add(r, a, a); }

// Montgomery product a * b / R mod p (CIOS, one limb of b per row).
// a must be canonical; b may be any integer below 2^384 (the row bound
// t < 2p only needs a < p), which is what mont_convert relies on.
LT_NOINL void fp_mul(fp &r, const fp &a, const fp &b) {
#ifndef __CUDACC__
  lt_fp_muls++;
#endif
  uint32_t t[LT_NL + 1];
#pragma unroll
  for (int i = 0; i <= LT_NL; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    const uint32_t bi = b.w[i];
    // t += a * bi: low halves into t[0..11], high halves into t[1..12]
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < LT_NL; j++) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[LT_NL] = addc(t[LT_NL], 0);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < LT_NL - 1; j++) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[LT_NL] = madc_hi(a.w[LT_NL - 1], bi, t[LT_NL]);
    // t += m * p with m chosen so that t[0] becomes 0, then t /= 2^32
    const uint32_t m = t[0] * LT_N0;
    t[0] = mad_lo_cc(m, LT_P[0], t[0]);
#pragma unroll
    for (int j = 1; j < LT_NL; j++) t[j] = madc_lo_cc(m, LT_P[j], t[j]);
    t[LT_NL] = addc(t[LT_NL], 0);
    t[1] = mad_hi_cc(m, LT_P[0], t[1]);
#pragma unroll
    for (int j = 1; j < LT_NL - 1; j++) t[j + 1] = madc_hi_cc(m, LT_P[j], t[j + 1]);
    t[LT_NL] = madc_hi(m, LT_P[LT_NL - 1], t[LT_NL]);
#pragma unroll
    for (int j = 0; j < LT_NL; j++) t[j] = t[j + 1];
    t[LT_NL] = 0;
  }
  fp_reduce_once(r, t);
}

LT_DEV void fp_sqr(fp &r, const fp &a) { fp_mul(r, a, a); }

// x -> x * R mod p for any plain integer x below 2^384 (REDC of x * R^2)
LT_DEV void fp_mont_convert(fp &r, const fp &x) {
  fp r2;
  fp_const(r2, LT_R2);
  fp_mul(r, r2, x);
}

// a^e for the static exponent e given as 12 little-endian words, top bit
// at position `top` (square-and-multiply, MSB first)
LT_NOINL void fp_pow_words(fp &r, const fp &a, const uint32_t *e, int top) {
  fp acc = a;
  for (int bit = top - 1; bit >= 0; bit--) {
    fp_sqr(acc, acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) fp_mul(acc, acc, a);
  }
  r = acc;
}

// a^(p - 2) = a^-1 (0 for a = 0); p - 2 has its top bit at position 380
LT_DEV void fp_inv(fp &r, const fp &a) { fp_pow_words(r, a, LT_P_MINUS_2, 380); }

// the candidate square root a^((p + 1) / 4) (p = 3 mod 4): a root of a
// iff its square is a (lodestar_tpu/kernels/sqrt.py fp_sqrt_cand)
LT_DEV void fp_sqrt_cand(fp &r, const fp &a) { fp_pow_words(r, a, LT_SQRT_EXP, LT_SQRT_TOP); }
