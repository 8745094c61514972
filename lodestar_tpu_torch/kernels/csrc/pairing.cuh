// Optimal ate pairing: Miller loop and final exponentiation.
// The CUDA twin of lodestar_tpu_torch/kernels/pairing.py.  The formulas,
// line scalings and the loop structure are those of
// lodestar_tpu/kernels/pairing.py, so the Miller value equals the JAX
// package's as canonical Fp12 integers.
#pragma once

#include "curve.cuh"

// per-pairing planes (Y1, X1 Z1, Z1^3) that replace (yP, xP, 1)
struct pplanes {
  fp wy, wx, w1;
};

LT_DEV void p_planes(pplanes &pw, const jac<fp> &p) {
  fp z2;
  pw.wy = p.y;
  fp_mul(pw.wx, p.x, p.z);
  fp_sqr(z2, p.z);
  fp_mul(pw.w1, z2, p.z);
}

// a sparse line a0 + b1 v w + b2 v^2 w
struct line12 {
  fp2 a0, b1, b2;
};

// f * line: 15 Fp2 products (f0 * a0, f1 * (0, b1, b2), and one Fp6
// product of the sums)
LT_NOINL void fp12_mul_sparse(fp12 &r, const fp12 &f, const line12 &l) {
  fp6 f0a, f1b, fm, ab, s;
  fp2 t, u;
  fp2_mul(f0a.c0, f.c0.c0, l.a0);
  fp2_mul(f0a.c1, f.c0.c1, l.a0);
  fp2_mul(f0a.c2, f.c0.c2, l.a0);
  // f1 * (0, b1, b2) = (xi (f11 b2 + f12 b1), xi f12 b2 + f10 b1, f10 b2 + f11 b1)
  fp2_mul(t, f.c1.c1, l.b2);
  fp2_mul(u, f.c1.c2, l.b1);
  fp2_add(t, t, u);
  fp2_mul_xi(f1b.c0, t);
  fp2_mul(t, f.c1.c2, l.b2);
  fp2_mul_xi(t, t);
  fp2_mul(u, f.c1.c0, l.b1);
  fp2_add(f1b.c1, t, u);
  fp2_mul(t, f.c1.c0, l.b2);
  fp2_mul(u, f.c1.c1, l.b1);
  fp2_add(f1b.c2, t, u);
  ab.c0 = l.a0;
  ab.c1 = l.b1;
  ab.c2 = l.b2;
  fp6_add(s, f.c0, f.c1);
  fp6_mul(fm, s, ab);
  fp6_sub(fm, fm, f0a);
  fp6_sub(r.c1, fm, f1b);
  fp6_mul_by_v(f1b, f1b);
  fp6_add(r.c0, f0a, f1b);
}

LT_DEV void line_eval(line12 &l, const fp2 &e0, const fp2 &e1, const fp2 &e2, const pplanes &pw) {
  fp2_mul_fp(l.a0, e0, pw.wy);
  fp2_mul_fp(l.b1, e1, pw.w1);
  fp2_mul_fp(l.b2, e2, pw.wx);
}

// tangent line at T evaluated at P, and T <- 2T
LT_NOINL void miller_dbl_step(line12 &l, jac<fp2> &T, const pplanes &pw) {
  fp2 A, B, CC, D, E, F, t, Z2, e0, e1, e2;
  fp2_sqr(A, T.x);
  fp2_sqr(B, T.y);
  fp2_sqr(CC, B);
  fp2_add(t, T.x, B);
  fp2_sqr(t, t);
  fp2_sub(t, t, A);
  fp2_sub(t, t, CC);
  fp2_dbl(D, t);
  fp2_mul_small(E, A, 3);
  fp2_sqr(F, E);
  // line coefficients from the input T
  fp2_sqr(Z2, T.z);
  fp2_mul(t, Z2, T.z);   // Z^3
  fp2_mul(t, T.y, t);    // Y Z^3
  fp2_dbl(t, t);
  fp2_mul_xi(e0, t);     // 2 xi Y Z^3
  fp2_mul(t, A, T.x);    // X^3
  fp2_mul_small(t, t, 3);
  fp2_dbl(e1, B);
  fp2_sub(e1, t, e1);    // 3 X^3 - 2 Y^2
  fp2_mul(t, A, Z2);
  fp2_mul_small(t, t, 3);
  fp2_neg(e2, t);        // -3 X^2 Z^2
  // 2T
  jac<fp2> o;
  fp2_dbl(t, D);
  fp2_sub(o.x, F, t);
  fp2_sub(t, D, o.x);
  fp2_mul(t, E, t);
  fp2_mul_small(CC, CC, 8);
  fp2_sub(o.y, t, CC);
  fp2_mul(t, T.y, T.z);
  fp2_dbl(o.z, t);
  T = o;
  line_eval(l, e0, e1, e2, pw);
}

// chord line through T and Q evaluated at P, and T <- T + Q
LT_NOINL void miller_add_step(line12 &l, jac<fp2> &T, const aff<fp2> &q, const pplanes &pw) {
  fp2 Z1Z1, Z1c, U2, S2, H, J, HH, I, JJ, rr, V, t, u, e0, e1, e2;
  fp2_sqr(Z1Z1, T.z);
  fp2_mul(Z1c, T.z, Z1Z1);
  fp2_mul(U2, q.x, Z1Z1);
  fp2_mul(S2, q.y, Z1c);
  fp2_sub(H, U2, T.x);
  fp2_sub(J, S2, T.y);
  fp2_sqr(HH, H);
  fp2_mul_small(I, HH, 4);
  fp2_mul(JJ, H, I);
  fp2_dbl(rr, J);
  fp2_mul(V, T.x, I);
  // line coefficients from the input T
  fp2_mul(t, H, Z1c);
  fp2_mul_xi(e0, t);       // xi H Z^3
  fp2_mul(t, J, T.x);
  fp2_mul(u, H, T.y);
  fp2_sub(e1, t, u);       // J X - H Y
  fp2_mul(t, J, Z1Z1);
  fp2_neg(e2, t);          // -J Z^2
  // T + Q
  jac<fp2> o;
  fp2_sqr(t, rr);
  fp2_sub(t, t, JJ);
  fp2_dbl(u, V);
  fp2_sub(o.x, t, u);
  fp2_sub(t, V, o.x);
  fp2_mul(t, rr, t);
  fp2_mul(u, T.y, JJ);
  fp2_dbl(u, u);
  fp2_sub(o.y, t, u);
  fp2_add(t, T.z, H);
  fp2_sqr(t, t);
  fp2_sub(t, t, Z1Z1);
  fp2_sub(o.z, t, HH);
  T = o;
  line_eval(l, e0, e1, e2, pw);
}

// f_{|x|,Q}(P) conjugated (x < 0); P Jacobian and not O, Q affine and not O
LT_DEV void miller_loop(fp12 &f, const jac<fp> &p, const aff<fp2> &q) {
  pplanes pw;
  p_planes(pw, p);
  jac<fp2> T;
  T.x = q.x;
  T.y = q.y;
  fp2_one(T.z);
  fp12_one(f);
  line12 l;
  for (int bit = 62; bit >= 0; bit--) {  // the bits of |x| below its top bit
    miller_dbl_step(l, T, pw);
    fp12_sqr(f, f);
    fp12_mul_sparse(f, f, l);
    if ((LT_X_ABS >> bit) & 1u) {
      miller_add_step(l, T, q, pw);
      fp12_mul_sparse(f, f, l);
    }
  }
  fp12_conj(f, f);
}

// f^(3 (p^12 - 1) / r) through the (x-1)^2 (x+p) (x^2+p^2-1) + 3 chain
LT_DEV void final_exponentiation(fp12 &r, const fp12 &f) {
  fp12 g, m, t0, t1, t2, m3;
  // easy part: m = (conj(f) / f)^(p^2) * (conj(f) / f)
  fp12_inv(t0, f);
  fp12_conj(t1, f);
  fp12_mul(g, t1, t0);
  fp12_frob(t0, g, 2);
  fp12_mul(m, t0, g);
  // hard part
  fp12_cyclo_sqr(t0, m);          // m^2
  fp12_cyclo_pow_x_neg(t1, m);    // m^x
  fp12_conj(t2, m);
  fp12_mul(t1, t1, t2);           // m^(x-1)
  fp12_cyclo_pow_x_neg(t2, t1);
  fp12_conj(t1, t1);
  fp12_mul(t1, t1, t2);           // m^((x-1)^2)
  fp12_cyclo_pow_x_neg(t2, t1);
  fp12_frob(t1, t1, 1);
  fp12_mul(t1, t1, t2);           // m^((x-1)^2 (p+x))
  fp12_mul(m3, m, t0);            // m^3
  fp12_cyclo_pow_x_neg(t0, t1);
  fp12_cyclo_pow_x_neg(t2, t0);   // ^x^2
  fp12_frob(t0, t1, 2);           // ^p^2
  fp12_conj(t1, t1);
  fp12_mul(t1, t1, t2);           // ^(x^2 - 1)
  fp12_mul(t1, t1, t0);           // ^(x^2 + p^2 - 1)
  fp12_mul(r, t1, m3);
}
