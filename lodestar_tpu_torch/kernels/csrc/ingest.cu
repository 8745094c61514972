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
// The values and selects are those of the JAX package's value-level
// functions (g2_decompress_y, sswu_map_g2, iso3_map,
// clear_cofactor_g2_jac, hash_to_g2_values), so the outputs equal the
// plain versions in kernels/ingest.py bit for bit.
//
// Bound on this card: 32-bit integer multiplies.  Bytes per lane are under
// 0.5 KB.
//
// g2_decompress: one warp per lane (csrc/warp12.cuh).  One thread per lane
// ran its Fp2 square root as six exponentiations back to back (five by
// (p + 1) / 4, one by p - 2: 3,656 products in one chain).  The program
// (warp_prog.cuh, from kernels/warp_schedule.py decompress_program) runs
// the independent chains in the same rounds (d and sp; then rp and rm,
// whose chain by (p - 3) / 4 also gives their inverses), each a fixed
// sliding-window chain: 899 rounds and 1,864 products per lane
// (kernels/verify.py ROUNDS_PER_LANE, FP_MULS_PER_LANE).  Its four segments
// are the norm method's straight-line parts; between them the segment loop
// below makes the method's per-lane selects (p_ok, sp_ok, a1 == 0, the
// sign) on comparisons the warp votes on, moving slots with w_copy, so the
// warp never diverges.
//
// hash_g2: one thread per lane, a lane's whole chain: four square roots,
// four Fp2 inversions and the 636-bit H_EFF chain (635 doublings, 304
// additions): 41,987 Fp products per lane.  The long static-exponent loops
// (fp_pow_words, g2_mul_words) are not inlined, against the nvcc
// miscompile of force-inlined loops seen with the one-thread windowed
// scalar multiplication of earlier versions; the H_EFF bits come from a
// constant table, not an unrolled body.
#include "canonical.cuh"
#include "curve.cuh"
#define LT_WANT_DECOMP
#include "warp12.cuh"

// ---------------------------------------------------------------------------
// Decompression (lodestar_tpu/kernels/ingest.py g2_decompress_y and
// sqrt.py fp2_sqrt): segments A-D of warp_schedule.decompress_program
// ---------------------------------------------------------------------------

// x: plain planes [2, 12, n]; flags: [2, n] (sign, inf); xy: Montgomery
// affine planes [2, 2, 12, n] (x, y); ok: [n].  One warp.
LT_DEV void g2_decompress_warp(const wmem &m, const int32_t *x, const int32_t *flags, int32_t *xy, int32_t *ok,
                               int n, int lane) {
  const wprog prog = {LT_DECOMP_SEG, LT_DECOMP_PHASE, LT_DECOMP_INS};
  w_load_planes(m, LT_DECOMP_XIN, x, 2, n, lane);
  LT_SYNCWARP();
  w_segment(m, prog, 0);  // A: x, rhs, d, sp, sm, xp, xm
  const bool sp_ok = w_eq(m, LT_DECOMP_SP2, LT_DECOMP_RHS, 1);  // sp^2 == rhs0
  const bool a1z = w_eq(m, LT_DECOMP_RHS + 1, -1, 1);  // rhs1 == 0
  w_segment(m, prog, 1);  // B: rp, rm, their inverses, rp^2
  const bool p_ok = w_eq(m, LT_DECOMP_RP2, LT_DECOMP_XP, 1);
  w_copy(m, LT_DECOMP_Y, p_ok ? LT_DECOMP_RP : LT_DECOMP_RM, 1);  // x0
  w_copy(m, LT_DECOMP_IX0, p_ok ? LT_DECOMP_IP : LT_DECOMP_IM, 1);  // 1 / x0 (0 for x0 = 0)
  w_segment(m, prog, 2);  // C: x1 = rhs1 / (2 x0)
  if (a1z) {  // the root is (sqrt(rhs0), 0) or (0, sqrt(-rhs0))
    if (sp_ok) {
      w_copy(m, LT_DECOMP_Y, LT_DECOMP_SP, 1);
      w_zero(m, LT_DECOMP_Y1, 1);
    } else {
      w_zero(m, LT_DECOMP_Y, 1);
      w_copy(m, LT_DECOMP_Y1, LT_DECOMP_SM, 1);
    }
  }
  w_segment(m, prog, 3);  // D: r^2, -r, r out of Montgomery form
  const bool on_curve = w_eq(m, LT_DECOMP_S, LT_DECOMP_RHS, 2);
  fp v0, v1;  // every thread reads both: the sign is uniform across the warp
  w_get(v0, m, LT_DECOMP_RAW);
  w_get(v1, m, LT_DECOMP_RAW + 1);
  const bool sgn = fp_is_zero(v1) ? fp_gt_words(v0, LT_HALF_P) : fp_gt_words(v1, LT_HALF_P);  // fp2_sgn
  if (sgn != (flags[lane] != 0)) w_copy(m, LT_DECOMP_Y, LT_DECOMP_NY, 2);
  w_store_planes(m, LT_DECOMP_X, xy, 4, n, lane);  // X and Y are consecutive
  // an infinity encoding skips the curve check: the path masks it
  if (LT_T0 == 0) ok[lane] = on_curve || flags[n + lane] != 0 ? 1 : 0;
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

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g2_decompress_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ flags,
                            int32_t *__restrict__ xy, int32_t *__restrict__ ok, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g2_decompress_warp(m, x, flags, xy, ok, n, lane);
}

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_hash_g2_kernel(const int32_t *__restrict__ u, const int32_t *__restrict__ sgn,
                      int32_t *__restrict__ out, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) hash_g2_lane(u, sgn, out, ok, n, lane);
}

extern "C" int lt_g2_decompress(const void *x, const void *flags, void *xy, void *ok, int n,
                                void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("g2_decompress", n, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_PHASES,
                               LT_DECOMP_ROUNDS);
    cudaFuncSetAttribute(lt_g2_decompress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g2_decompress_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)x, (const int32_t *)flags, (int32_t *)xy, (int32_t *)ok, n);
  }
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

#include <stdlib.h>

extern "C" int lt_g2_decompress(const void *x, const void *flags, void *xy, void *ok, int n,
                                void *stream) {
  (void)stream;
  const wlaunch l = w_launch("g2_decompress", n, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_PHASES,
                             LT_DECOMP_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_CONST, lane % LT_LPB);
    g2_decompress_warp(m, (const int32_t *)x, (const int32_t *)flags, (int32_t *)xy, (int32_t *)ok, n, lane);
  }
  free(sm);
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
