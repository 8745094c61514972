// Jacobian arithmetic on a = 0 short Weierstrass curves for the
// one-thread-per-lane G1 kernel (csrc/aggpk.cu),
// generic over the base field; the G2 operations run on the warp engine
// (csrc/warp12.cuh, kernels/warp_schedule.py).  The CUDA twin of
// lodestar_tpu_torch/kernels/curve.py; formulas and infinity-mask semantics
// as in lodestar_tpu/kernels/curve.py.
#pragma once

#include "fp.cuh"

// the Fp operations under the field-generic names the formulas use
LT_DEV void f_add(fp &r, const fp &a, const fp &b) { fp_add(r, a, b); }
LT_DEV void f_sub(fp &r, const fp &a, const fp &b) { fp_sub(r, a, b); }
LT_DEV void f_dbl(fp &r, const fp &a) { fp_dbl(r, a); }
LT_DEV void f_mul(fp &r, const fp &a, const fp &b) { fp_mul(r, a, b); }
LT_DEV void f_sqr(fp &r, const fp &a) { fp_sqr(r, a); }
LT_DEV bool f_is_zero(const fp &a) { return fp_is_zero(a); }
LT_DEV void f_select(fp &r, bool c, const fp &a, const fp &b) { fp_select(r, c, a, b); }

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
