// K14: G1 pubkey decompression and KeyValidate at registration.
//
//   lt_g1_keyvalidate  x as plain limbs and the (sign, infinity) bits ->
//                      Montgomery (x, y), y = sqrt(x^3 + 4) with
//                      fp_sgn(y) == sign, and ok = on-curve and [r]P = O
//                      and not flagged infinity (replaces
//                      lodestar_tpu/kernels/ingest.py _k_g1_keyvalidate)
//
// One thread per lane, as the other kernels: a lane runs its whole chain.
// The steps and selects of the JAX package's g1_keyvalidate, so (x, y)
// and ok equal the plain version in kernels/ingest.py bit for bit:
//   x -> Montgomery; rhs = x^3 + 4; y = rhs^((p + 1) / 4), on-curve iff
//   y^2 == rhs; y negated where fp_sgn(y) differs from the sign bit; then
//   T = [r]P by MSB-first double-and-add over the 255 bits of r with the
//   COMPLETE addition (jac_add_full) and T's infinity flag carried through
//   the chain: a key of small order (x = 0 decodes to (0, +-2), of order
//   3) meets T == +-P mid-chain, where an incomplete addition gives a
//   wrong verdict.  Doubling keeps Z = 0 at infinity, so P is in G1 iff
//   T's flag is set or T.Z == 0.
//
// Bound on this card: 32-bit integer multiplies.  A lane makes 254
// doublings (7 Fp products), 133 complete additions (23: the generic
// addition and the doubling it may select), one square root (a 379-bit
// power, 606) and the conversions (5): 5,448 Fp products
// (kernels/verify.py FP_MULS_PER_LANE, checked against the host build's
// count).  The function needs 3,852 (FP_MULS_NEEDED): P is affine, so a
// mixed addition (11) would do, and a key's chain never selects the
// doubling (its last step is P + (-P), infinity without one).  Bytes per
// lane: 56 in, 100 out.  Registration launches 65,536 lanes at a time,
// 2,048 warps: the first kernel of the port with lanes enough to fill
// the card, so its time is throughput, not one lane's latency.  The
// exponent loops are not inlined (the nvcc miscompile of force-inlined
// loops seen with the windowed scalar multiplication, csrc/curve.cuh), and
// the bits of r come from a constant word table, as LT_H_EFF's do.
#include "canonical.cuh"
#include "curve.cuh"

// [r] P with the complete addition; returns whether the result is O
LT_NOINL bool g1_mul_r_is_inf(const jac<fp> &p) {
  jac<fp> t = p;
  bool t_inf = false;
  for (int bit = LT_R_TOP - 1; bit >= 0; bit--) {
    jac_dbl(t, t);
    if ((LT_R_ORDER[bit >> 5] >> (bit & 31)) & 1u) jac_add_full(t, t_inf, t, t_inf, p, false);
  }
  return t_inf || fp_is_zero(t.z);
}

// y with y^2 = x^3 + 4 and fp_sgn(y) == sign; returns on-curve and in G1
LT_NOINL bool g1_keyvalidate(fp &y, const fp &x, bool sign) {
  fp rhs, b, ny, c;
  fp_sqr(rhs, x);
  fp_mul(rhs, rhs, x);
  fp_const(b, LT_G1_B);
  fp_add(rhs, rhs, b);
  fp_sqrt_cand(y, rhs);
  fp_sqr(c, y);
  const bool on_curve = fp_eq(c, rhs);
  fp_neg(ny, y);
  fp_select(y, fp_sgn(y) == sign, y, ny);
  jac<fp> p;
  p.x = x;
  p.y = y;
  fp_one(p.z);
  return on_curve && g1_mul_r_is_inf(p);
}

// x: plain planes [12, n]; flags: [2, n] (sign, inf); xy: Montgomery
// affine planes [2, 12, n] (x, y); ok: [n]
LT_DEV void g1_keyvalidate_lane(const int32_t *x, const int32_t *flags, int32_t *xy, int32_t *ok, int n,
                                int lane) {
  fp xp, xm, y;
  fp_load(xp, x, n, lane);
  fp_mont_convert(xm, xp);
  const bool good = g1_keyvalidate(y, xm, flags[lane] != 0);
  fp_store(xy, n, lane, xm);
  fp_store(xy + LT_NL * n, n, lane, y);
  ok[lane] = (good && flags[n + lane] == 0) ? 1 : 0;  // infinity is never a valid key
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_g1_keyvalidate_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ flags,
                             int32_t *__restrict__ xy, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) g1_keyvalidate_lane(x, flags, xy, ok, n, lane);
}

extern "C" int lt_g1_keyvalidate(const void *x, const void *flags, void *xy, void *ok, int n,
                                 void *stream) {
  if (n > 0)
    lt_g1_keyvalidate_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                               (cudaStream_t)stream>>>((const int32_t *)x, (const int32_t *)flags,
                                                       (int32_t *)xy, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

#else  // host build: the same lane function over every lane

extern "C" int lt_g1_keyvalidate(const void *x, const void *flags, void *xy, void *ok, int n,
                                 void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    g1_keyvalidate_lane((const int32_t *)x, (const int32_t *)flags, (int32_t *)xy, (int32_t *)ok, n,
                        lane);
  return 0;
}

#endif
