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

// A square root of a by the norm method, branch-free; returns whether r
// is one (r*r == a), the one final check that decides every path.  The
// steps and selects of lodestar_tpu/kernels/sqrt.py fp2_sqrt, so the root
// is the JAX kernel's: d = sqrt(a0^2 + a1^2), x0 = sqrt((a0 +- d) / 2),
// x1 = a1 / (2 x0), and for a1 == 0 the real or imaginary root of a0.
// Five exponentiations by (p + 1) / 4 and one by p - 2, each a loop in
// fp_pow_words (not inlined).
LT_NOINL bool fp2_sqrt(fp2 &r, const fp2 &a) {
  fp n, t, d, half, xp, xm, rp, rm, x0, x1, sp, sm, zero, re, im;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_sqrt_cand(d, n);
  fp_const(half, LT_INV2);
  fp_add(t, a.c0, d);
  fp_mul(xp, t, half);
  fp_sub(t, a.c0, d);
  fp_mul(xm, t, half);
  fp_sqrt_cand(rp, xp);
  fp_sqr(t, rp);
  const bool p_ok = fp_eq(t, xp);
  fp_sqrt_cand(rm, xm);
  fp_select(x0, p_ok, rp, rm);
  fp_dbl(t, x0);
  fp_inv(t, t);  // 0 for x0 = 0, as pow(p - 2) gives
  fp_mul(x1, a.c1, t);
  // a1 == 0: the root is (sqrt(a0), 0) or (0, sqrt(-a0))
  fp_sqrt_cand(sp, a.c0);
  fp_sqr(t, sp);
  const bool sp_ok = fp_eq(t, a.c0);
  fp_neg(t, a.c0);
  fp_sqrt_cand(sm, t);
  fp_zero(zero);
  fp_select(re, sp_ok, sp, zero);
  fp_select(im, sp_ok, zero, sm);
  const bool a1z = fp_is_zero(a.c1);
  fp_select(r.c0, a1z, re, x0);
  fp_select(r.c1, a1z, im, x1);
  fp2 s;
  fp2_sqr(s, r);
  return fp2_eq(s, a);
}
