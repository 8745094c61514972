// Signs of field values: the CUDA twin of lodestar_tpu_torch/kernels/canonical.py.
//
// The engine's values are canonical Montgomery residues x R mod p, so a
// sign is one REDC out of Montgomery form (a product with the plain
// integer 1) and then a compare with (p - 1) / 2 or a parity bit.  The
// definitions are those of lodestar_tpu/kernels/canonical.py:
//   fp_sgn    x > (p - 1) / 2 (the ZCash sort flag; 0 for x = 0)
//   fp_sgn0   x mod 2 (RFC 9380 sgn0, m = 1)
//   fp2_sgn   fp_sgn of the imaginary part, of the real part if that is 0
//   fp2_sgn0  sgn0(x0) | (x0 == 0 & sgn0(x1)) (RFC 9380, m = 2)
#pragma once

#include "fp2.cuh"

// x R mod p -> x
LT_DEV void fp_from_mont(fp &r, const fp &a) {
  fp one;
  fp_zero(one);
  one.w[0] = 1;
  fp_mul(r, a, one);
}

// a > c for a canonical a and a constant c: the borrow of c - a
LT_DEV bool fp_gt_words(const fp &a, const uint32_t *c) {
  sub_cc(c[0], a.w[0]);
#pragma unroll
  for (int i = 1; i < LT_NL; i++) subc_cc(c[i], a.w[i]);
  return subc(0, 0) != 0;  // all ones iff the chain borrowed
}

LT_DEV bool fp_sgn(const fp &a) {
  fp v;
  fp_from_mont(v, a);
  return fp_gt_words(v, LT_HALF_P);
}

LT_DEV bool fp_sgn0(const fp &a) {
  fp v;
  fp_from_mont(v, a);
  return (v.w[0] & 1u) != 0;
}

LT_DEV bool fp2_sgn(const fp2 &a) {
  fp v0, v1;
  fp_from_mont(v1, a.c1);
  fp_from_mont(v0, a.c0);
  const bool s1 = fp_gt_words(v1, LT_HALF_P);
  const bool s0 = fp_gt_words(v0, LT_HALF_P);
  return fp_is_zero(v1) ? s0 : s1;
}

LT_DEV bool fp2_sgn0(const fp2 &a) {
  fp v0, v1;
  fp_from_mont(v0, a.c0);
  fp_from_mont(v1, a.c1);
  return ((v0.w[0] & 1u) != 0) || (fp_is_zero(v0) && (v1.w[0] & 1u) != 0);
}
