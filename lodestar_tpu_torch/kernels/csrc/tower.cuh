// Fp6 = Fp2[v] / (v^3 - xi), Fp12 = Fp6[w] / (w^2 - v).
// The CUDA twin of lodestar_tpu_torch/kernels/tower.py; formulas as in
// lodestar_tpu/kernels/tower.py.
#pragma once

#include "fp2.cuh"

struct fp6 {
  fp2 c0, c1, c2;
};

struct fp12 {
  fp6 c0, c1;
};

// twelve planes, leaf k = 6 h + 2 i + j (half h, coefficient i, component j)
LT_DEV void fp12_load(fp12 &r, const int32_t *base, int n, int lane) {
  fp2 *parts[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2, &r.c1.c0, &r.c1.c1, &r.c1.c2};
  for (int k = 0; k < 6; k++) fp2_load(*parts[k], base + 2 * k * LT_NL * n, n, lane);
}

LT_DEV void fp12_store(int32_t *base, int n, int lane, const fp12 &a) {
  const fp2 *parts[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int k = 0; k < 6; k++) fp2_store(base + 2 * k * LT_NL * n, n, lane, *parts[k]);
}

// ---------------------------------------------------------------------------
// Fp6
// ---------------------------------------------------------------------------

LT_DEV void fp6_add(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

LT_DEV void fp6_sub(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

LT_DEV void fp6_neg(fp6 &r, const fp6 &a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// (c0, c1, c2) * v = (xi c2, c0, c1)
LT_DEV void fp6_mul_by_v(fp6 &r, const fp6 &a) {
  fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// Karatsuba: six Fp2 products
LT_NOINL void fp6_mul(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2 t0, t1, t2, x, y, m12, m01, m02;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  fp2_add(x, a.c1, a.c2);
  fp2_add(y, b.c1, b.c2);
  fp2_mul(m12, x, y);
  fp2_add(x, a.c0, a.c1);
  fp2_add(y, b.c0, b.c1);
  fp2_mul(m01, x, y);
  fp2_add(x, a.c0, a.c2);
  fp2_add(y, b.c0, b.c2);
  fp2_mul(m02, x, y);
  // c0 = t0 + xi (m12 - t1 - t2)
  fp2_sub(m12, m12, t1);
  fp2_sub(m12, m12, t2);
  fp2_mul_xi(m12, m12);
  fp2_add(r.c0, t0, m12);
  // c1 = m01 - t0 - t1 + xi t2
  fp2_sub(m01, m01, t0);
  fp2_sub(m01, m01, t1);
  fp2_mul_xi(x, t2);
  fp2_add(r.c1, m01, x);
  // c2 = m02 - t0 - t2 + t1
  fp2_sub(m02, m02, t0);
  fp2_sub(m02, m02, t2);
  fp2_add(r.c2, m02, t1);
}

// CH-SQR2: three Fp2 squarings and two products
LT_NOINL void fp6_sqr(fp6 &r, const fp6 &a) {
  fp2 s0, s1, s2, s3, s4, t;
  fp2_sqr(s0, a.c0);
  fp2_mul(s1, a.c0, a.c1);
  fp2_dbl(s1, s1);
  fp2_sub(t, a.c0, a.c1);
  fp2_add(t, t, a.c2);
  fp2_sqr(s2, t);
  fp2_mul(s3, a.c1, a.c2);
  fp2_dbl(s3, s3);
  fp2_sqr(s4, a.c2);
  fp2_mul_xi(t, s3);
  fp2_add(r.c0, s0, t);
  fp2_mul_xi(t, s4);
  fp2_add(r.c1, s1, t);
  fp2_add(t, s1, s2);
  fp2_add(t, t, s3);
  fp2_sub(t, t, s0);
  fp2_sub(r.c2, t, s4);
}

// ---------------------------------------------------------------------------
// Fp12
// ---------------------------------------------------------------------------

LT_DEV void fp12_one(fp12 &r) {
  fp2_one(r.c0.c0);
  fp2_zero(r.c0.c1);
  fp2_zero(r.c0.c2);
  fp2_zero(r.c1.c0);
  fp2_zero(r.c1.c1);
  fp2_zero(r.c1.c2);
}

LT_DEV bool fp12_is_one(const fp12 &a) {
  return fp_is_one(a.c0.c0.c0) && fp_is_zero(a.c0.c0.c1) && fp2_is_zero(a.c0.c1) &&
         fp2_is_zero(a.c0.c2) && fp2_is_zero(a.c1.c0) && fp2_is_zero(a.c1.c1) &&
         fp2_is_zero(a.c1.c2);
}

LT_DEV void fp12_select(fp12 &r, bool cond, const fp12 &a, const fp12 &b) {
  fp2_select(r.c0.c0, cond, a.c0.c0, b.c0.c0);
  fp2_select(r.c0.c1, cond, a.c0.c1, b.c0.c1);
  fp2_select(r.c0.c2, cond, a.c0.c2, b.c0.c2);
  fp2_select(r.c1.c0, cond, a.c1.c0, b.c1.c0);
  fp2_select(r.c1.c1, cond, a.c1.c1, b.c1.c1);
  fp2_select(r.c1.c2, cond, a.c1.c2, b.c1.c2);
}

// the p^6 Frobenius; the inverse of a cyclotomic element
LT_DEV void fp12_conj(fp12 &r, const fp12 &a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

// Karatsuba: three Fp6 products
LT_NOINL void fp12_mul(fp12 &r, const fp12 &a, const fp12 &b) {
  fp6 t0, t1, x, y;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t0);
  fp6_sub(r.c1, x, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(r.c0, t0, t1);
}

// two Fp6 products
LT_NOINL void fp12_sqr(fp12 &r, const fp12 &a) {
  fp6 t, x, y;
  fp6_mul(t, a.c0, a.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_mul_by_v(y, a.c1);
  fp6_add(y, a.c0, y);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t);
  fp6_mul_by_v(y, t);
  fp6_sub(r.c0, x, y);
  fp6_add(r.c1, t, t);
}

// x -> x^(p^power), power in {1, 2, 3}: conjugate for odd powers, then
// multiply the coefficient of v^i w^j by gamma[2 i + j]
LT_NOINL void fp12_frob(fp12 &r, const fp12 &a, int power) {
  const uint32_t(*gam)[2][LT_NL] = power == 1 ? LT_FROB1 : (power == 2 ? LT_FROB2 : LT_FROB3);
  fp2 *out[6] = {&r.c0.c0, &r.c1.c0, &r.c0.c1, &r.c1.c1, &r.c0.c2, &r.c1.c2};
  const fp2 *in[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1, &a.c1.c1, &a.c0.c2, &a.c1.c2};
  for (int k = 0; k < 6; k++) {
    fp2 c, g;
    if (power & 1) {
      fp2_conj(c, *in[k]);
    } else {
      c = *in[k];
    }
    fp2_const(g, gam[k]);
    fp2_mul(*out[k], c, g);
  }
}

// ---------------------------------------------------------------------------
// Cyclotomic squaring (Granger-Scott) and the power by x
// ---------------------------------------------------------------------------

// (z0 + z1 s)^2 with s^2 = v: (z0^2 + xi z1^2, 2 z0 z1)
LT_DEV void fp4_sqr(fp2 &r0, fp2 &r1, const fp2 &z0, const fp2 &z1) {
  fp2 t0, t1, tm;
  fp2_sqr(t0, z0);
  fp2_sqr(t1, z1);
  fp2_add(tm, z0, z1);
  fp2_sqr(tm, tm);
  fp2_sub(tm, tm, t0);
  fp2_sub(r1, tm, t1);
  fp2_mul_xi(t1, t1);
  fp2_add(r0, t0, t1);
}

// 3 t - 2 x and 3 t + 2 x
LT_DEV void fp2_triple_sub_double(fp2 &r, const fp2 &t, const fp2 &x) {
  fp2 d;
  fp2_sub(d, t, x);
  fp2_dbl(d, d);
  fp2_add(r, d, t);
}

LT_DEV void fp2_triple_add_double(fp2 &r, const fp2 &t, const fp2 &x) {
  fp2 d;
  fp2_add(d, t, x);
  fp2_dbl(d, d);
  fp2_add(r, d, t);
}

// a^2 for a in the cyclotomic subgroup: nine Fp2 squarings
LT_NOINL void fp12_cyclo_sqr(fp12 &r, const fp12 &a) {
  fp2 r00, c00, r01, c01, r02, c02;
  fp4_sqr(r00, c00, a.c0.c0, a.c1.c1);
  fp4_sqr(r01, c01, a.c1.c0, a.c0.c2);
  fp4_sqr(r02, c02, a.c0.c1, a.c1.c2);
  fp12 o;
  fp2_triple_sub_double(o.c0.c0, r00, a.c0.c0);
  fp2_triple_sub_double(o.c0.c1, r01, a.c0.c1);
  fp2_triple_sub_double(o.c0.c2, r02, a.c0.c2);
  fp2_mul_xi(c02, c02);
  fp2_triple_add_double(o.c1.c0, c02, a.c1.c0);
  fp2_triple_add_double(o.c1.c1, c00, a.c1.c1);
  fp2_triple_add_double(o.c1.c2, c01, a.c1.c2);
  r = o;
}

// a^x for the negative BLS parameter x: a^|x| by cyclotomic squarings,
// then the conjugate
LT_NOINL void fp12_cyclo_pow_x_neg(fp12 &r, const fp12 &a) {
  const uint64_t e = LT_X_ABS;
  fp12 acc = a;
  for (int bit = 62; bit >= 0; bit--) {  // |x| has its top bit at 63
    fp12_cyclo_sqr(acc, acc);
    if ((e >> bit) & 1u) fp12_mul(acc, acc, a);
  }
  fp12_conj(r, acc);
}

// ---------------------------------------------------------------------------
// Inversion chain: Fp -> Fp2 -> Fp6 -> Fp12 (one Fp exponentiation)
// ---------------------------------------------------------------------------

LT_NOINL void fp2_inv(fp2 &r, const fp2 &a) {
  fp t0, t1;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(t0, t0, t1);
  fp_inv(t1, t0);
  fp_mul(r.c0, a.c0, t1);
  fp_mul(t0, a.c1, t1);
  fp_neg(r.c1, t0);
}

LT_NOINL void fp6_inv(fp6 &r, const fp6 &a) {
  fp2 c0, c1, c2, t, u;
  fp2_sqr(c0, a.c0);
  fp2_mul(t, a.c1, a.c2);
  fp2_mul_xi(t, t);
  fp2_sub(c0, c0, t);
  fp2_sqr(c1, a.c2);
  fp2_mul_xi(c1, c1);
  fp2_mul(t, a.c0, a.c1);
  fp2_sub(c1, c1, t);
  fp2_sqr(c2, a.c1);
  fp2_mul(t, a.c0, a.c2);
  fp2_sub(c2, c2, t);
  // norm = a0 c0 + xi (a2 c1 + a1 c2)
  fp2_mul(t, a.c2, c1);
  fp2_mul(u, a.c1, c2);
  fp2_add(t, t, u);
  fp2_mul_xi(t, t);
  fp2_mul(u, a.c0, c0);
  fp2_add(t, u, t);
  fp2_inv(t, t);
  fp2_mul(r.c0, c0, t);
  fp2_mul(r.c1, c1, t);
  fp2_mul(r.c2, c2, t);
}

LT_NOINL void fp12_inv(fp12 &r, const fp12 &a) {
  fp6 t0, t1;
  fp6_sqr(t0, a.c0);
  fp6_sqr(t1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(t0, t0, t1);
  fp6_inv(t0, t0);
  fp6_mul(t1, a.c1, t0);
  fp6_mul(r.c0, a.c0, t0);
  fp6_neg(r.c1, t1);
}
