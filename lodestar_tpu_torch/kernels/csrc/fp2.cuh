// Fp2 = Fp[u] / (u^2 + 1).  The CUDA twin of lodestar_tpu_torch/kernels/fp2.py.
#pragma once

#include "fp.cuh"

struct fp2 {
  fp c0, c1;
};

// planes of one Fp2 value: component k at base + k * 12 * n
LT_DEV void fp2_load(fp2 &r, const int32_t *base, int n, int lane) {
  fp_load(r.c0, base, n, lane);
  fp_load(r.c1, base + LT_NL * n, n, lane);
}

LT_DEV void fp2_store(int32_t *base, int n, int lane, const fp2 &a) {
  fp_store(base, n, lane, a.c0);
  fp_store(base + LT_NL * n, n, lane, a.c1);
}

LT_DEV void fp2_const(fp2 &r, const uint32_t (*c)[LT_NL]) {
  fp_const(r.c0, c[0]);
  fp_const(r.c1, c[1]);
}

LT_DEV void fp2_zero(fp2 &r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

LT_DEV void fp2_one(fp2 &r) {
  fp_one(r.c0);
  fp_zero(r.c1);
}

LT_DEV bool fp2_is_zero(const fp2 &a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }

LT_DEV bool fp2_eq(const fp2 &a, const fp2 &b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }

LT_DEV void fp2_select(fp2 &r, bool cond, const fp2 &a, const fp2 &b) {
  fp_select(r.c0, cond, a.c0, b.c0);
  fp_select(r.c1, cond, a.c1, b.c1);
}

LT_DEV void fp2_add(fp2 &r, const fp2 &a, const fp2 &b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

LT_DEV void fp2_sub(fp2 &r, const fp2 &a, const fp2 &b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

LT_DEV void fp2_neg(fp2 &r, const fp2 &a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

LT_DEV void fp2_dbl(fp2 &r, const fp2 &a) { fp2_add(r, a, a); }

// a0 - a1 u == a^p
LT_DEV void fp2_conj(fp2 &r, const fp2 &a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

// a * xi, xi = 1 + u: (a0 - a1) + (a0 + a1) u
LT_DEV void fp2_mul_xi(fp2 &r, const fp2 &a) {
  fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

// a * k for a small static k (3, 4 or 8 in the curve formulas)
LT_DEV void fp2_mul_small(fp2 &r, const fp2 &a, int k) {
  fp2 acc = a;
  if (k == 3) {
    fp2_dbl(acc, a);
    fp2_add(acc, acc, a);
  } else {
    for (int s = k; s > 1; s >>= 1) fp2_dbl(acc, acc);  // k a power of two
  }
  r = acc;
}

// Karatsuba: three Montgomery products
LT_NOINL void fp2_mul(fp2 &r, const fp2 &a, const fp2 &b) {
  fp t0, t1, sa, sb, t2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u: two Montgomery products
LT_NOINL void fp2_sqr(fp2 &r, const fp2 &a) {
  fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_dbl(r.c1, m);
}

// a times an Fp element
LT_DEV void fp2_mul_fp(fp2 &r, const fp2 &a, const fp &k) {
  fp_mul(r.c0, a.c0, k);
  fp_mul(r.c1, a.c1, k);
}
