// K11 and K12: device ingest of wire signatures and signing roots.
//
//   lt_g2_decompress  wire x as plain limbs and the (sign, infinity) bits ->
//                     Montgomery (x, y), y a root of x^3 + 4(1 + i) with
//                     fp2_sgn(y) == sign, and ok | inf (replaces
//                     lodestar_tpu/kernels/ingest.py _k_g2_decompress)
//   lt_hash_g2        (u0, u1) as plain limbs and their sgn0 bits -> SSWU
//                     on the isogenous curve -> iso3 -> add -> cofactor
//                     clearing by H_EFF -> Jacobian G2, and ok = both iso3
//                     denominators nonzero (replaces _k_hash_g2)
//
// One thread per lane, as the other kernels: a lane runs its whole chain.
// The values and selects are those of the JAX package's value-level
// functions (g2_decompress_y, sswu_map_g2, iso3_map,
// clear_cofactor_g2_jac, hash_to_g2_values), so the outputs equal the
// plain versions in kernels/ingest.py bit for bit.
//
// Bound on this card: 32-bit integer multiplies.  g2_decompress is one
// Fp2 square root (five exponentiations by (p + 1) / 4 and one by p - 2)
// plus the conversions and the sign: 3,656 Fp products per lane.  hash_g2
// is four square roots, four Fp2 inversions and the 636-bit H_EFF chain
// (635 doublings, 304 additions): 41,987 Fp products per lane
// (kernels/verify.py FP_MULS_PER_LANE, checked against the host build's
// count).  Bytes per lane are under 0.5 KB.  The long static-exponent
// loops (fp_pow_words, g2_mul_words) are not inlined, against the nvcc
// miscompile of force-inlined loops seen with the windowed scalar
// multiplication (csrc/curve.cuh); the H_EFF bits come from a constant
// table, not an unrolled body.
#include "canonical.cuh"
#include "curve.cuh"

// ---------------------------------------------------------------------------
// Decompression (lodestar_tpu/kernels/ingest.py g2_decompress_y)
// ---------------------------------------------------------------------------

// y with y^2 = x^3 + 4(1 + i) and fp2_sgn(y) == sign; returns on-curve
LT_NOINL bool g2_decompress_y(fp2 &y, const fp2 &x, bool sign) {
  fp2 rhs, b, ny;
  fp2_sqr(rhs, x);
  fp2_mul(rhs, rhs, x);
  fp2_const(b, LT_G2_B);
  fp2_add(rhs, rhs, b);
  const bool ok = fp2_sqrt(y, rhs);
  fp2_neg(ny, y);
  fp2_select(y, fp2_sgn(y) == sign, y, ny);
  return ok;
}

// x: plain planes [2, 12, n]; flags: [2, n] (sign, inf); xy: Montgomery
// affine planes [2, 2, 12, n] (x, y); ok: [n]
LT_DEV void g2_decompress_lane(const int32_t *x, const int32_t *flags, int32_t *xy, int32_t *ok,
                               int n, int lane) {
  fp2 xp, xm, y;
  fp2_load(xp, x, n, lane);
  fp_mont_convert(xm.c0, xp.c0);
  fp_mont_convert(xm.c1, xp.c1);
  const bool on_curve = g2_decompress_y(y, xm, flags[lane] != 0);
  fp2_store(xy, n, lane, xm);
  fp2_store(xy + 2 * LT_NL * n, n, lane, y);
  // an infinity encoding skips the curve check: the path masks it
  ok[lane] = (on_curve || flags[n + lane] != 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Hash to G2 (sswu_map_g2, iso3_map, clear_cofactor_g2_jac,
// hash_to_g2_values)
// ---------------------------------------------------------------------------

// x^3 + A x + B on the isogenous curve E2'
LT_DEV void sswu_g(fp2 &r, const fp2 &x) {
  fp2 a, b, t;
  fp2_const(a, LT_SSWU_A);
  fp2_const(b, LT_SSWU_B);
  fp2_sqr(t, x);
  fp2_add(t, t, a);
  fp2_mul(t, t, x);
  fp2_add(r, t, b);
}

// Simplified SWU on E2' for one u, branch-free; u_sgn0 is RFC 9380
// sgn0(u), computed on the host beside hash_to_field
LT_NOINL void sswu_map_g2(aff<fp2> &r, const fp2 &u, bool u_sgn0) {
  fp2 c, zu2, tv1, t, one, x1, x2, gx, y1, y2;
  fp2_sqr(t, u);
  fp2_const(c, LT_SSWU_Z);
  fp2_mul(zu2, t, c);
  fp2_sqr(tv1, zu2);
  fp2_add(tv1, tv1, zu2);
  const bool tv1_z = fp2_is_zero(tv1);
  fp2_inv(t, tv1);  // 0 for tv1 = 0, as pow(p - 2) gives; the select takes B / (Z A) there
  fp2_one(one);
  fp2_add(t, one, t);
  fp2_const(c, LT_SSWU_MBA);
  fp2_mul(x1, t, c);
  fp2_const(c, LT_SSWU_BZA);
  fp2_select(x1, tv1_z, c, x1);
  sswu_g(gx, x1);
  const bool ok1 = fp2_sqrt(y1, gx);
  fp2_mul(x2, zu2, x1);
  sswu_g(gx, x2);
  fp2_sqrt(y2, gx);
  fp2_select(r.x, ok1, x1, x2);
  fp2_select(r.y, ok1, y1, y2);
  fp2_neg(t, r.y);
  fp2_select(r.y, fp2_sgn0(r.y) == u_sgn0, r.y, t);
}

// Horner over a constant coefficient table (constant term first), from 0
LT_DEV void iso_poly(fp2 &r, const uint32_t (*c)[2][LT_NL], int len, const fp2 &x) {
  fp2 acc, k;
  fp2_zero(acc);
  for (int i = len - 1; i >= 0; i--) {
    fp2_mul(acc, acc, x);
    fp2_const(k, c[i]);
    fp2_add(acc, acc, k);
  }
  r = acc;
}

// the 3-isogeny E2' -> E2; false where a denominator vanishes
LT_NOINL bool iso3_map(aff<fp2> &r, const aff<fp2> &p) {
  fp2 xden, yden, num, t;
  iso_poly(xden, LT_ISO_XDEN, LT_ISO_XDEN_LEN, p.x);
  iso_poly(yden, LT_ISO_YDEN, LT_ISO_YDEN_LEN, p.x);
  const bool ok = !fp2_is_zero(xden) && !fp2_is_zero(yden);
  iso_poly(num, LT_ISO_XNUM, LT_ISO_XNUM_LEN, p.x);
  fp2_inv(t, xden);
  fp2_mul(r.x, num, t);
  iso_poly(num, LT_ISO_YNUM, LT_ISO_YNUM_LEN, p.x);
  fp2_mul(num, p.y, num);
  fp2_inv(t, yden);
  fp2_mul(r.y, num, t);
  return ok;
}

// [e] Q for a static exponent e (little-endian words, top bit at `top`):
// double, then add Q with the generic Jacobian addition where the bit is
// set (clear_cofactor_g2_jac; hash outputs make T == +-Q negligible)
LT_NOINL void g2_mul_words(jac<fp2> &r, const jac<fp2> &q, const uint32_t *e, int top) {
  jac<fp2> t = q;
  for (int bit = top - 1; bit >= 0; bit--) {
    jac_dbl(t, t);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) jac_add_mixed_or_full(t, t, q);
  }
  r = t;
}

// one message: two SSWU points through iso3, added, cofactor-cleared
LT_NOINL bool hash_to_g2_values(jac<fp2> &r, const fp2 &u0, const fp2 &u1, bool s0, bool s1) {
  aff<fp2> p, q0, q1;
  sswu_map_g2(p, u0, s0);
  const bool ok0 = iso3_map(q0, p);
  sswu_map_g2(p, u1, s1);
  const bool ok1 = iso3_map(q1, p);
  jac<fp2> s;
  s.x = q0.x;
  s.y = q0.y;
  fp2_one(s.z);
  jac_add_mixed(s, s, q1);  // q0 == +-q1 is negligible for hash outputs
  g2_mul_words(r, s, LT_H_EFF, LT_H_EFF_TOP);
  return ok0 && ok1;
}

// u: plain planes [2, 2, 12, n] (u0, u1); sgn: [2, n] (sgn0(u0), sgn0(u1));
// out: Jacobian planes [3, 2, 12, n]; ok: [n]
LT_DEV void hash_g2_lane(const int32_t *u, const int32_t *sgn, int32_t *out, int32_t *ok, int n,
                         int lane) {
  fp2 p0, p1, u0, u1;
  fp2_load(p0, u, n, lane);
  fp2_load(p1, u + 2 * LT_NL * n, n, lane);
  fp_mont_convert(u0.c0, p0.c0);
  fp_mont_convert(u0.c1, p0.c1);
  fp_mont_convert(u1.c0, p1.c0);
  fp_mont_convert(u1.c1, p1.c1);
  jac<fp2> r;
  const bool good = hash_to_g2_values(r, u0, u1, sgn[lane] != 0, sgn[n + lane] != 0);
  fp2_store(out, n, lane, r.x);
  fp2_store(out + 2 * LT_NL * n, n, lane, r.y);
  fp2_store(out + 4 * LT_NL * n, n, lane, r.z);
  ok[lane] = good ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_g2_decompress_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ flags,
                            int32_t *__restrict__ xy, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) g2_decompress_lane(x, flags, xy, ok, n, lane);
}

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_hash_g2_kernel(const int32_t *__restrict__ u, const int32_t *__restrict__ sgn,
                      int32_t *__restrict__ out, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) hash_g2_lane(u, sgn, out, ok, n, lane);
}

extern "C" int lt_g2_decompress(const void *x, const void *flags, void *xy, void *ok, int n,
                                void *stream) {
  if (n > 0)
    lt_g2_decompress_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                              (cudaStream_t)stream>>>((const int32_t *)x, (const int32_t *)flags,
                                                      (int32_t *)xy, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

extern "C" int lt_hash_g2(const void *u, const void *sgn, void *out, void *ok, int n,
                          void *stream) {
  if (n > 0)
    lt_hash_g2_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                        (cudaStream_t)stream>>>((const int32_t *)u, (const int32_t *)sgn,
                                                (int32_t *)out, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

#else  // host build: the same lane functions over every lane

extern "C" int lt_g2_decompress(const void *x, const void *flags, void *xy, void *ok, int n,
                                void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    g2_decompress_lane((const int32_t *)x, (const int32_t *)flags, (int32_t *)xy, (int32_t *)ok,
                       n, lane);
  return 0;
}

extern "C" int lt_hash_g2(const void *u, const void *sgn, void *out, void *ok, int n,
                          void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    hash_g2_lane((const int32_t *)u, (const int32_t *)sgn, (int32_t *)out, (int32_t *)ok, n, lane);
  return 0;
}

// The building blocks on their own, for the tests: Montgomery inputs.

// a: Fp2 planes [2, 12, n] -> r: [2, 12, n], ok: [n]
extern "C" int lt_host_fp2_sqrt(const void *a, void *r, void *ok, int n) {
  for (int lane = 0; lane < n; lane++) {
    fp2 x, y;
    fp2_load(x, (const int32_t *)a, n, lane);
    ((int32_t *)ok)[lane] = fp2_sqrt(y, x) ? 1 : 0;
    fp2_store((int32_t *)r, n, lane, y);
  }
  return 0;
}

// a: Fp2 planes [2, 12, n] -> out [4, n]: fp_sgn(a0), fp_sgn0(a0),
// fp2_sgn(a), fp2_sgn0(a)
extern "C" int lt_host_signs(const void *a, void *out, int n) {
  int32_t *o = (int32_t *)out;
  for (int lane = 0; lane < n; lane++) {
    fp2 x;
    fp2_load(x, (const int32_t *)a, n, lane);
    o[lane] = fp_sgn(x.c0);
    o[n + lane] = fp_sgn0(x.c0);
    o[2 * n + lane] = fp2_sgn(x);
    o[3 * n + lane] = fp2_sgn0(x);
  }
  return 0;
}

// u: Fp2 planes [2, 12, n]; sgn: [n] -> r: affine E2' planes [2, 2, 12, n]
extern "C" int lt_host_sswu(const void *u, const void *sgn, void *r, int n) {
  for (int lane = 0; lane < n; lane++) {
    fp2 x;
    aff<fp2> p;
    fp2_load(x, (const int32_t *)u, n, lane);
    sswu_map_g2(p, x, ((const int32_t *)sgn)[lane] != 0);
    fp2_store((int32_t *)r, n, lane, p.x);
    fp2_store((int32_t *)r + 2 * LT_NL * n, n, lane, p.y);
  }
  return 0;
}

#endif
