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

LT_DEV void fp12_select(fp12 &r, bool cond, const fp12 &a, const fp12 &b) {
  fp2_select(r.c0.c0, cond, a.c0.c0, b.c0.c0);
  fp2_select(r.c0.c1, cond, a.c0.c1, b.c0.c1);
  fp2_select(r.c0.c2, cond, a.c0.c2, b.c0.c2);
  fp2_select(r.c1.c0, cond, a.c1.c0, b.c1.c0);
  fp2_select(r.c1.c1, cond, a.c1.c1, b.c1.c1);
  fp2_select(r.c1.c2, cond, a.c1.c2, b.c1.c2);
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

// ---------------------------------------------------------------------------
// Fp2 inversion (one Fp exponentiation)
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

