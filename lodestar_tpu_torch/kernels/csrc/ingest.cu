// K11 and K12: device ingest of wire signatures and signing roots.
//
//   lt_g2_decompress  wire x as plain limbs and the (sign, infinity) bits ->
//                     Montgomery (x, y), y a root of x^3 + 4(1 + i) with
//                     fp2_sgn(y) == sign, and ok | inf (replaces
//                     lodestar_tpu/kernels/ingest.py _k_g2_decompress);
//                     beside them the job's message planes, plain limbs of
//                     any integers below 2^384, to Montgomery form (the
//                     wire paths' _k_mont4, lodestar_tpu/kernels/verify.py)
//   lt_hash_g2        (u0, u1) as plain limbs and their sgn0 bits -> SSWU
//                     on the isogenous curve -> iso3 -> add -> cofactor
//                     clearing -> Jacobian G2, and ok = both iso3
//                     denominators nonzero (replaces _k_hash_g2)
//
// The decompression's values and selects are those of the JAX package's
// g2_decompress_y; the hash's are those of the port's plain version
// (kernels/ingest.py hash_to_g2_values: the isogeny's image in Jacobian
// form, the cofactor cleared by psi, RFC 9380 appendix G.3, where JAX's
// _k_hash_g2 inverts the denominators and runs the 636-bit H_EFF chain:
// the same points).  The outputs equal the plain versions bit for bit.
//
// Bound on this card: 32-bit integer multiplies.  Bytes per lane are under
// 0.5 KB.
//
// Both run one warp per lane (csrc/warp12.cuh), four lanes per block, on
// programs of kernels/warp_schedule.py written into warp_prog.cuh.
//
// g2_decompress: one thread per lane ran its Fp2 square root as six
// exponentiations back to back (five by (p + 1) / 4, one by p - 2: 3,656
// products in one chain).  The program (decompress_program) runs the
// independent chains in the same rounds (d and sp; then rp and rm, whose
// chain by (p - 3) / 4 also gives their inverses), each a fixed
// sliding-window chain: 899 rounds and 1,864 products per lane
// (kernels/verify.py ROUNDS_PER_LANE, FP_MULS_PER_LANE).  Its four segments
// are the norm method's straight-line parts; between them the segment loop
// below makes the method's per-lane selects (p_ok, sp_ok, a1 == 0, the
// sign) on comparisons the warp votes on, moving slots with w_copy, so the
// warp never diverges.  Segment A's first round converts the wire x and,
// in four of the threads x's two products leave idle, the job's message
// planes: the wire paths' Montgomery ingest costs no round and no launch
// of its own.  Without messages (the pre-verify aggregation) the kernel
// zeroes their slots and stores nothing.
//
// hash_g2: the program (hash_program: 1,361 rounds, 10,412 products per
// lane) runs the two SSWU evaluations side by side: their two Fp
// inversions in one phase (the binary GCD, one per thread), the four square
// roots of gx1 and gx2 of u0 and u1 as the norm method's segments with
// eight exponentiations in the same rounds, the isogeny without inversion,
// then the complete additions and the two static chains by |x| of the psi
// clearing.  The segment loop makes the square roots' selects as
// g2_decompress does, picks each u's (x, y) and its sign, and makes
// jac_add_full's selects after each of the six additions.
#include "canonical.cuh"
#define LT_WANT_DECOMP
#define LT_WANT_HASH
#include "warp12.cuh"

// ---------------------------------------------------------------------------
// Decompression (lodestar_tpu/kernels/ingest.py g2_decompress_y and
// sqrt.py fp2_sqrt): segments A-D of warp_schedule.decompress_program
// ---------------------------------------------------------------------------

// x: plain planes [2, 12, n]; flags: [2, n] (sign, inf); msg: plain planes
// [4, 12, n] or null; xy: Montgomery affine planes [2, 2, 12, n] (x, y);
// msg_out: Montgomery planes [4, 12, n] (null where msg is); ok: [n].  One
// warp.
LT_DEV void g2_decompress_warp(const wmem &m, const int32_t *x, const int32_t *flags, const int32_t *msg,
                               int32_t *xy, int32_t *msg_out, int32_t *ok, int n, int lane) {
  const wprog prog = {LT_DECOMP_SEG, LT_DECOMP_PHASE, LT_DECOMP_INS};
  w_load_planes(m, LT_DECOMP_XIN, x, 2, n, lane);
  if (msg)
    w_load_planes(m, LT_DECOMP_MSGIN, msg, 4, n, lane);
  else
    w_zero(m, LT_DECOMP_MSGIN, 4);
  LT_SYNCWARP();
  w_segment<false>(m, prog, 0);  // A: x and the message, rhs, d, sp, sm, xp, xm
  if (msg_out) w_store_planes(m, LT_DECOMP_MSG, msg_out, 4, n, lane);  // before B writes its slots
  LT_SYNCWARP();
  const bool sp_ok = w_eq(m, LT_DECOMP_SP2, LT_DECOMP_RHS, 1);  // sp^2 == rhs0
  const bool a1z = w_eq(m, LT_DECOMP_RHS + 1, -1, 1);  // rhs1 == 0
  w_segment<false>(m, prog, 1);  // B: rp, rm, their inverses, rp^2
  const bool p_ok = w_eq(m, LT_DECOMP_RP2, LT_DECOMP_XP, 1);
  w_copy(m, LT_DECOMP_Y, p_ok ? LT_DECOMP_RP : LT_DECOMP_RM, 1);  // x0
  w_copy(m, LT_DECOMP_IX0, p_ok ? LT_DECOMP_IP : LT_DECOMP_IM, 1);  // 1 / x0 (0 for x0 = 0)
  w_segment<false>(m, prog, 2);  // C: x1 = rhs1 / (2 x0)
  if (a1z) {  // the root is (sqrt(rhs0), 0) or (0, sqrt(-rhs0))
    if (sp_ok) {
      w_copy(m, LT_DECOMP_Y, LT_DECOMP_SP, 1);
      w_zero(m, LT_DECOMP_Y1, 1);
    } else {
      w_zero(m, LT_DECOMP_Y, 1);
      w_copy(m, LT_DECOMP_Y1, LT_DECOMP_SM, 1);
    }
  }
  w_segment<false>(m, prog, 3);  // D: r^2, -r, r out of Montgomery form
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
// Hash to G2: the segments of warp_schedule.hash_program and its selects
// ---------------------------------------------------------------------------

// slot of the norm method's value `off` for square root k (2 i: gx1 of
// u_i, 2 i + 1: gx2)
LT_DEV int hash_sq(int k, int off) { return LT_HASH_SQ + k * LT_HASH_SQ_STRIDE + off; }

// The square roots' selects, as g2_decompress_warp makes them for its one
// root: after A sp_ok and rhs1 == 0 are voted on; after B x0 (rp where
// rp^2 == xp, else rm) and its inverse are kept; after C the root becomes
// (sp, 0) or (0, sm) where rhs1 == 0.
LT_DEV void hash_roots(const wmem &m, const wprog &prog) {
  bool sp_ok[4], a1z[4];
  for (int k = 0; k < 4; k++) {
    sp_ok[k] = w_eq(m, hash_sq(k, LT_HASH_SQ_SP2), hash_sq(k, LT_HASH_SQ_A), 1);
    a1z[k] = w_eq(m, hash_sq(k, LT_HASH_SQ_A) + 1, -1, 1);
  }
  w_segment(m, prog, 1);  // B
  for (int k = 0; k < 4; k++) {
    const bool p_ok = w_eq(m, hash_sq(k, LT_HASH_SQ_RP2), hash_sq(k, LT_HASH_SQ_XP), 1);
    w_copy(m, hash_sq(k, LT_HASH_SQ_Y), hash_sq(k, p_ok ? LT_HASH_SQ_RP : LT_HASH_SQ_RM), 1);
    w_copy(m, hash_sq(k, LT_HASH_SQ_IX0), hash_sq(k, p_ok ? LT_HASH_SQ_IP : LT_HASH_SQ_IM), 1);
  }
  w_segment(m, prog, 2);  // C
  for (int k = 0; k < 4; k++)
    if (a1z[k]) {
      if (sp_ok[k]) {
        w_copy(m, hash_sq(k, LT_HASH_SQ_Y), hash_sq(k, LT_HASH_SQ_SP), 1);
        w_zero(m, hash_sq(k, LT_HASH_SQ_Y1), 1);
      } else {
        w_zero(m, hash_sq(k, LT_HASH_SQ_Y), 1);
        w_copy(m, hash_sq(k, LT_HASH_SQ_Y1), hash_sq(k, LT_HASH_SQ_SM), 1);
      }
    }
  w_segment(m, prog, 3);  // D
}

// SSWU's last selects for u_i: (x1, r) where r^2 == gx1 for gx1's root r,
// else (x2, gx2's root), into AFF; y negated where RFC 9380 sgn0(y)
// differs from the host's sgn0(u) bit
LT_DEV void hash_pick(const wmem &m, int i, bool u_sgn0) {
  const bool ok1 = w_eq(m, hash_sq(2 * i, LT_HASH_SQ_S), hash_sq(2 * i, LT_HASH_SQ_A), 2);
  const int k = 2 * i + (ok1 ? 0 : 1);
  w_copy(m, LT_HASH_AFF + 4 * i, LT_HASH_CX + 4 * i + (ok1 ? 0 : 2), 2);
  fp v0, v1;  // every thread reads both: the sign is uniform across the warp
  w_get(v0, m, hash_sq(k, LT_HASH_SQ_RAW));
  w_get(v1, m, hash_sq(k, LT_HASH_SQ_RAW) + 1);
  const bool sgn0 = (v0.w[0] & 1u) || (fp_is_zero(v0) && (v1.w[0] & 1u));
  w_copy(m, LT_HASH_AFF + 4 * i + 2, hash_sq(k, sgn0 == u_sgn0 ? LT_HASH_SQ_Y : LT_HASH_SQ_NY), 2);
}

// segment k, an addition of AP and AQ, then jac_add_full's selects into
// dst (the point at infinity is Z = 0): Q where P is infinity, P where Q
// is, 2P where H = R = 0, else the sum (Z = 0 where H = 0 alone)
LT_DEV void hash_add(const wmem &m, const wprog &prog, int k, int dst) {
  w_segment(m, prog, k);
  const bool p_inf = w_eq(m, LT_HASH_AP + 4, -1, 2), q_inf = w_eq(m, LT_HASH_AQ + 4, -1, 2);
  const bool h_zero = w_eq(m, LT_HASH_AH, -1, 2), r_zero = w_eq(m, LT_HASH_AR, -1, 2);
  w_copy(m, dst, p_inf ? LT_HASH_AQ : q_inf ? LT_HASH_AP : h_zero && r_zero ? LT_HASH_AD : LT_HASH_AS, 6);
}

// AP <- a, AQ <- b, then the addition (segment k) into dst
LT_DEV void hash_add_regs(const wmem &m, const wprog &prog, int k, int a, int b, int dst) {
  w_copy(m, LT_HASH_AP, a, 6);
  w_copy(m, LT_HASH_AQ, b, 6);
  hash_add(m, prog, k, dst);
}

// u: plain planes [2, 2, 12, n] (u0, u1); sgn: [2, n] (sgn0(u0), sgn0(u1));
// out: Jacobian planes [3, 2, 12, n]; ok: [n].  One warp.
LT_DEV void hash_g2_warp(const wmem &m, const int32_t *u, const int32_t *sgn, int32_t *out, int32_t *ok, int n,
                         int lane) {
  const wprog prog = {LT_HASH_SEG, LT_HASH_PHASE, LT_HASH_INS};
  w_load_planes(m, LT_HASH_UIN, u, 4, n, lane);
  LT_SYNCWARP();
  w_segment(m, prog, 0);  // a: SSWU to gx1, gx2 of both u; the roots' A
  hash_roots(m, prog);    // b, c, d
  hash_pick(m, 0, sgn[lane] != 0);
  hash_pick(m, 1, sgn[n + lane] != 0);
  w_segment(m, prog, 4);  // iso: q0 -> AP, q1 -> AQ
  const bool good = !w_eq(m, LT_HASH_AP + 4, -1, 2) && !w_eq(m, LT_HASH_AQ + 4, -1, 2);
  hash_add(m, prog, 5, LT_HASH_PT);  // P = q0 + q1
  w_segment(m, prog, 6);             // chain_p: t1, -t1, t2, -P; AP, AQ = psi^2(2P), -t2
  hash_add(m, prog, 7, LT_HASH_T3);  // t3 = psi^2(2P) - t2
  hash_add_regs(m, prog, 8, LT_HASH_T1, LT_HASH_T2, LT_HASH_U);  // t1 + t2
  w_segment(m, prog, 9);             // chain_u: t2 = [x](t1 + t2)
  hash_add_regs(m, prog, 10, LT_HASH_T3, LT_HASH_T2B, LT_HASH_T3);  // t3 + t2
  hash_add_regs(m, prog, 11, LT_HASH_T3, LT_HASH_MT1, LT_HASH_T3);  // - t1
  hash_add_regs(m, prog, 12, LT_HASH_T3, LT_HASH_MP, LT_HASH_OUT);  // - P
  w_store_planes(m, LT_HASH_OUT, out, 6, n, lane);
  if (LT_T0 == 0) ok[lane] = good ? 1 : 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g2_decompress_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ flags,
                            const int32_t *__restrict__ msg, int32_t *__restrict__ xy,
                            int32_t *__restrict__ msg_out, int32_t *__restrict__ ok, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g2_decompress_warp(m, x, flags, msg, xy, msg_out, ok, n, lane);
}

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_hash_g2_kernel(const int32_t *__restrict__ u, const int32_t *__restrict__ sgn, int32_t *__restrict__ out,
                      int32_t *__restrict__ ok, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_HASH_SLOTS, LT_HASH_CONSTS, LT_HASH_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) hash_g2_warp(m, u, sgn, out, ok, n, lane);
}

// msg and msg_out: both given (the wire paths' messages) or both null
extern "C" int lt_g2_decompress(const void *x, const void *flags, const void *msg, void *xy, void *msg_out,
                                void *ok, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("g2_decompress", n, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_PHASES,
                               LT_DECOMP_ROUNDS);
    cudaFuncSetAttribute(lt_g2_decompress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g2_decompress_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)x, (const int32_t *)flags, (const int32_t *)msg, (int32_t *)xy, (int32_t *)msg_out,
        (int32_t *)ok, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int lt_hash_g2(const void *u, const void *sgn, void *out, void *ok, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("hash_g2", n, LT_HASH_SLOTS, LT_HASH_CONSTS, LT_HASH_PHASES, LT_HASH_ROUNDS);
    cudaFuncSetAttribute(lt_hash_g2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_hash_g2_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)u, (const int32_t *)sgn, (int32_t *)out, (int32_t *)ok, n);
  }
  return (int)cudaGetLastError();
}

#else  // host build: the same lane functions over every lane

#include <stdlib.h>

extern "C" int lt_g2_decompress(const void *x, const void *flags, const void *msg, void *xy, void *msg_out,
                                void *ok, int n, void *stream) {
  (void)stream;
  const wlaunch l = w_launch("g2_decompress", n, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_PHASES,
                             LT_DECOMP_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_DECOMP_SLOTS, LT_DECOMP_CONSTS, LT_DECOMP_CONST, lane % LT_LPB);
    g2_decompress_warp(m, (const int32_t *)x, (const int32_t *)flags, (const int32_t *)msg, (int32_t *)xy,
                       (int32_t *)msg_out, (int32_t *)ok, n, lane);
  }
  free(sm);
  return 0;
}

extern "C" int lt_hash_g2(const void *u, const void *sgn, void *out, void *ok, int n, void *stream) {
  (void)stream;
  const wlaunch l = w_launch("hash_g2", n, LT_HASH_SLOTS, LT_HASH_CONSTS, LT_HASH_PHASES, LT_HASH_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {
    const wmem m = w_block(sm, LT_HASH_SLOTS, LT_HASH_CONSTS, LT_HASH_CONST, lane % LT_LPB);
    hash_g2_warp(m, (const int32_t *)u, (const int32_t *)sgn, (int32_t *)out, (int32_t *)ok, n, lane);
  }
  free(sm);
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

// u: Fp2 planes [2, 12, n] (Montgomery); sgn: [n] -> r: affine E2' planes
// [2, 2, 12, n], the SSWU point of u as hash_g2_warp selects it (u is
// given as both u0 and u1, out of Montgomery form)
extern "C" int lt_host_sswu(const void *u, const void *sgn, void *r, int n) {
  const size_t smem = w_smem_bytes(LT_HASH_SLOTS, LT_HASH_CONSTS);
  uint32_t *sm = (uint32_t *)malloc(smem);
  const wmem m = w_block(sm, LT_HASH_SLOTS, LT_HASH_CONSTS, LT_HASH_CONST, 0);
  const wprog prog = {LT_HASH_SEG, LT_HASH_PHASE, LT_HASH_INS};
  fp raw1 = {{1u}};
  for (int lane = 0; lane < n; lane++) {
    for (int c = 0; c < 2; c++) {
      fp v, plain;
      fp_load(v, (const int32_t *)u + c * LT_NL * n, n, lane);
      fp_mont_mul(plain, v, raw1);
      w_put(m, LT_HASH_UIN + c, plain);
      w_put(m, LT_HASH_UIN + 2 + c, plain);
    }
    w_segment(m, prog, 0);
    hash_roots(m, prog);
    hash_pick(m, 0, ((const int32_t *)sgn)[lane] != 0);
    for (int c = 0; c < 4; c++) {
      fp v;
      w_get(v, m, LT_HASH_AFF + c);
      fp_store((int32_t *)r + c * LT_NL * n, n, lane, v);
    }
  }
  free(sm);
  return 0;
}

#endif
