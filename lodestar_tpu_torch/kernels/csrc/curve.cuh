// Jacobian arithmetic on a = 0 short Weierstrass curves, generic over the
// base field (G1 over Fp, G2 over Fp2).  The CUDA twin of
// lodestar_tpu_torch/kernels/curve.py; formulas and infinity-mask semantics
// as in lodestar_tpu/kernels/curve.py.
#pragma once

#include "fp2.cuh"

// field-generic spellings of the Fp and Fp2 operations
LT_DEV void f_add(fp &r, const fp &a, const fp &b) { fp_add(r, a, b); }
LT_DEV void f_add(fp2 &r, const fp2 &a, const fp2 &b) { fp2_add(r, a, b); }
LT_DEV void f_sub(fp &r, const fp &a, const fp &b) { fp_sub(r, a, b); }
LT_DEV void f_sub(fp2 &r, const fp2 &a, const fp2 &b) { fp2_sub(r, a, b); }
LT_DEV void f_neg(fp &r, const fp &a) { fp_neg(r, a); }
LT_DEV void f_neg(fp2 &r, const fp2 &a) { fp2_neg(r, a); }
LT_DEV void f_dbl(fp &r, const fp &a) { fp_dbl(r, a); }
LT_DEV void f_dbl(fp2 &r, const fp2 &a) { fp2_dbl(r, a); }
LT_DEV void f_mul(fp &r, const fp &a, const fp &b) { fp_mul(r, a, b); }
LT_DEV void f_mul(fp2 &r, const fp2 &a, const fp2 &b) { fp2_mul(r, a, b); }
LT_DEV void f_sqr(fp &r, const fp &a) { fp_sqr(r, a); }
LT_DEV void f_sqr(fp2 &r, const fp2 &a) { fp2_sqr(r, a); }
LT_DEV bool f_is_zero(const fp &a) { return fp_is_zero(a); }
LT_DEV bool f_is_zero(const fp2 &a) { return fp2_is_zero(a); }
LT_DEV bool f_eq(const fp &a, const fp &b) { return fp_eq(a, b); }
LT_DEV bool f_eq(const fp2 &a, const fp2 &b) { return fp2_eq(a, b); }
LT_DEV void f_select(fp &r, bool c, const fp &a, const fp &b) { fp_select(r, c, a, b); }
LT_DEV void f_select(fp2 &r, bool c, const fp2 &a, const fp2 &b) { fp2_select(r, c, a, b); }
LT_DEV void f_one(fp &r) { fp_one(r); }
LT_DEV void f_one(fp2 &r) { fp2_one(r); }

// a * k for k in {3, 4, 8}
template <typename F>
LT_DEV void f_mul_small(F &r, const F &a, int k) {
  F acc = a;
  if (k == 3) {
    f_dbl(acc, a);
    f_add(acc, acc, a);
  } else {
    for (int s = k; s > 1; s >>= 1) f_dbl(acc, acc);
  }
  r = acc;
}

template <typename F>
struct jac {
  F x, y, z;
};

template <typename F>
struct aff {
  F x, y;
};

template <typename F>
LT_DEV void jac_select(jac<F> &r, bool c, const jac<F> &a, const jac<F> &b) {
  f_select(r.x, c, a.x, b.x);
  f_select(r.y, c, a.y, b.y);
  f_select(r.z, c, a.z, b.z);
}

// 2P, 2M + 5S; maps infinity (Z = 0) to infinity
template <typename F>
LT_NOINL void jac_dbl(jac<F> &r, const jac<F> &p) {
  F A, B, CC, D, E, Fq, t;
  f_sqr(A, p.x);
  f_sqr(B, p.y);
  f_sqr(CC, B);
  f_add(t, p.x, B);
  f_sqr(t, t);
  f_sub(t, t, A);
  f_sub(t, t, CC);
  f_dbl(D, t);
  f_mul_small(E, A, 3);
  f_sqr(Fq, E);
  jac<F> o;
  f_dbl(t, D);
  f_sub(o.x, Fq, t);
  f_sub(t, D, o.x);
  f_mul(t, E, t);
  f_mul_small(CC, CC, 8);
  f_sub(o.y, t, CC);
  f_mul(t, p.y, p.z);
  f_dbl(o.z, t);
  r = o;
}

// P + Q with Q affine, 7M + 4S; callers guarantee P != O and P != +-Q
template <typename F>
LT_NOINL void jac_add_mixed(jac<F> &r, const jac<F> &p, const aff<F> &q) {
  F Z1Z1, U2, S2, H, HH, I, J, rr, V, t;
  f_sqr(Z1Z1, p.z);
  f_mul(U2, q.x, Z1Z1);
  f_mul(S2, q.y, p.z);
  f_mul(S2, S2, Z1Z1);
  f_sub(H, U2, p.x);
  f_sqr(HH, H);
  f_mul_small(I, HH, 4);
  f_mul(J, H, I);
  f_sub(rr, S2, p.y);
  f_dbl(rr, rr);
  f_mul(V, p.x, I);
  jac<F> o;
  f_sqr(t, rr);
  f_sub(t, t, J);
  f_dbl(U2, V);
  f_sub(o.x, t, U2);
  f_sub(t, V, o.x);
  f_mul(t, rr, t);
  f_mul(U2, p.y, J);
  f_dbl(U2, U2);
  f_sub(o.y, t, U2);
  f_add(t, p.z, H);
  f_sqr(t, t);
  f_sub(t, t, Z1Z1);
  f_sub(o.z, t, HH);
  r = o;
}

// P + Q, both Jacobian, with no equal or infinity dispatch: 12M + 4S.
// h_zero and r_zero report H == 0 and R == 0 for the callers that
// dispatch (jac_add_full).
template <typename F>
LT_NOINL void jac_add_core(jac<F> &r, bool &h_zero, bool &r_zero, const jac<F> &p,
                           const jac<F> &q) {
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, R, HH, HHH, V, t;
  f_sqr(Z1Z1, p.z);
  f_sqr(Z2Z2, q.z);
  f_mul(U1, p.x, Z2Z2);
  f_mul(U2, q.x, Z1Z1);
  f_mul(S1, p.y, q.z);
  f_mul(S1, S1, Z2Z2);
  f_mul(S2, q.y, p.z);
  f_mul(S2, S2, Z1Z1);
  f_sub(H, U2, U1);
  f_sub(R, S2, S1);
  h_zero = f_is_zero(H);
  r_zero = f_is_zero(R);
  f_sqr(HH, H);
  f_mul(HHH, H, HH);
  f_mul(V, U1, HH);
  jac<F> o;
  f_sqr(t, R);
  f_sub(t, t, HHH);
  f_dbl(U2, V);
  f_sub(o.x, t, U2);
  f_sub(t, V, o.x);
  f_mul(t, R, t);
  f_mul(U2, S1, HHH);
  f_sub(o.y, t, U2);
  f_mul(t, p.z, q.z);
  f_mul(o.z, t, H);
  r = o;
}

// P + Q inside the windowed scalar multiplication, where the callers rule
// out P == +-Q and infinity (lodestar_tpu/kernels/curve.py:305)
template <typename F>
LT_DEV void jac_add_mixed_or_full(jac<F> &r, const jac<F> &p, const jac<F> &q) {
  bool h_zero, r_zero;
  jac_add_core(r, h_zero, r_zero, p, q);
}

// P + Q with infinity masks: P = O and Q = O through the masks, P == Q by
// an exact zero test dispatching to doubling, P == -Q giving infinity
template <typename F>
LT_NOINL void jac_add_full(jac<F> &r, bool &r_inf, const jac<F> &p, bool p_inf,
                           const jac<F> &q, bool q_inf) {
  jac<F> o, d;
  bool h_zero, r_zero;
  jac_add_core(o, h_zero, r_zero, p, q);
  jac_dbl(d, p);
  jac_select(o, h_zero && r_zero, d, o);
  jac_select(o, q_inf, p, o);
  jac_select(o, p_inf, q, o);
  r_inf = (p_inf && q_inf) || (h_zero && !r_zero && !p_inf && !q_inf);
  r = o;
}

template <typename F>
LT_DEV void jac_neg(jac<F> &r, const jac<F> &p) {
  r.x = p.x;
  f_neg(r.y, p.y);
  r.z = p.z;
}

// equality of Jacobian points (cross-multiplied), infinity-aware
template <typename F>
LT_NOINL bool jac_eq(const jac<F> &p, bool p_inf, const jac<F> &q, bool q_inf) {
  F Z1Z1, Z2Z2, a, b, t;
  f_sqr(Z1Z1, p.z);
  f_sqr(Z2Z2, q.z);
  f_mul(a, p.x, Z2Z2);
  f_mul(b, q.x, Z1Z1);
  const bool ex = f_eq(a, b);
  f_mul(t, p.y, q.z);
  f_mul(a, t, Z2Z2);
  f_mul(t, q.y, p.z);
  f_mul(b, t, Z1Z1);
  const bool ey = f_eq(a, b);
  return (p_inf && q_inf) || (!p_inf && !q_inf && ex && ey);
}

// k*Q for a static scalar 2 <= k < 2^64 with its top bit at `top`, Q affine
// and not O: double, then mixed-add where the bit is set (the accumulator
// is then an even multiple >= 2, never +-Q)
template <typename F>
LT_NOINL void scalar_mul_static(jac<F> &r, const aff<F> &q, uint64_t k, int top) {
  jac<F> t;
  t.x = q.x;
  t.y = q.y;
  f_one(t.z);
  for (int bit = top - 1; bit >= 0; bit--) {
    jac_dbl(t, t);
    if ((k >> bit) & 1u) jac_add_mixed(t, t, q);
  }
  r = t;
}

// psi on Jacobian twist coordinates
LT_DEV void g2_psi(jac<fp2> &r, const jac<fp2> &q) {
  fp2 c, t;
  fp2_const(c, LT_PSI_CX);
  fp2_conj(t, q.x);
  fp2_mul(r.x, t, c);
  fp2_const(c, LT_PSI_CY);
  fp2_conj(t, q.y);
  fp2_mul(r.y, t, c);
  fp2_conj(r.z, q.z);
}

// Q in G2 <=> psi(Q) == [x]Q = -[|x|]Q; O is in the subgroup
LT_DEV bool g2_subgroup_check(const aff<fp2> &q, bool q_inf) {
  jac<fp2> qj, zq, lhs;
  qj.x = q.x;
  qj.y = q.y;
  fp2_one(qj.z);
  scalar_mul_static(zq, q, LT_X_ABS, 63);
  g2_psi(lhs, qj);
  jac_neg(zq, zq);
  return jac_eq(lhs, q_inf, zq, q_inf) || q_inf;
}
