// K5 and K6: the RLC batch's randomized scalar multiplications.
//
//   lt_g1_rpk       r_i pk_i in G1 (replaces lodestar_tpu/kernels/verify.py
//                   _k_g1_rpk)
//   lt_g2_rsig_sub  r_i sig_i in G2, and the psi subgroup check of sig_i
//                   (replaces _k_g2_rsig_sub); on the decoded batch path
//                   also that path's Montgomery ingest (_k_mont8): given
//                   the signature and the message as plain limbs (any
//                   integers below 2^384), the program's first segment
//                   converts both (8 products, one round) and the kernel
//                   stores the message for the Miller loop; given a
//                   Montgomery signature (the wire paths) it skips it
//
// Both follow lodestar_tpu/kernels/curve.py scalar_mul_window_jac: 128-bit
// scalars read from packed word planes, 4-bit windows MSB-first, a table
// {Q .. 15 Q}, four doublings and one addition of the digit's entry per
// window, kept where the digit is nonzero; so the Jacobian outputs equal
// the JAX kernels' and the plain versions' bit for bit.
//
// Bound on this card: 32-bit integer multiplies, 588 multiply instructions
// per Fp product; the bytes per lane (under 0.5 KB) are negligible.
//
// Both run one warp per lane (csrc/warp12.cuh).  One thread per lane ran
// a lane's products as one chain at ~1.7 us each (5,057 for r sig, 1,569
// for r pk), 16 of the 132 SMs busy at N = 512.  The programs
// (warp_prog.cuh, from kernels/warp_schedule.py rsig_program and
// rpk_program) pack a doubling's independent Fp products into rounds; in
// r sig's idle threads of the same rounds runs the subgroup check's
// static chain by |x|, two of its steps per window.  Their slots hold the
// table, the accumulator and the temporaries in shared memory.  The
// scalar's digits are the only per-lane choice: the window loop
// (w_scalar_windows, one template over the point's width in Fp slots)
// runs a program a segment at a time (the table, then one segment per
// window) and, between segments, copies the digit's table entry into the
// addend's slots and keeps the window's sum, its doubled accumulator or
// the entry itself (jac_select).  One warp serves one lane, so the digit
// is uniform across it and the warp never diverges.
#define LT_WANT_RSIG
#define LT_WANT_RPK
#include "warp12.cuh"

#define LT_RAND_BITS 128
#define LT_RAND_WORDS (LT_RAND_BITS / 32)
#define LT_WINDOW 4  // divides 32: a digit never straddles two words

// digit t (MSB-first) of a scalar held as LT_RAND_WORDS big-endian words
// (row 0 of the word planes most significant); the twin of
// kernels/verify.py _word_digit
LT_DEV uint32_t w_digit(const uint32_t *rw, int t) {
  const int pos = LT_RAND_BITS - LT_WINDOW - LT_WINDOW * t;  // LSB offset of the digit
  return (rw[LT_RAND_WORDS - 1 - (pos >> 5)] >> (pos & 31)) & ((1u << LT_WINDOW) - 1);
}

// The window loop of a scalar-multiplication program whose points take W
// Fp slots (3 in G1, 6 in G2): the table segment (segment `first` of the
// program's order), then per window the
// digit's entry copied to ADD, the window's segment (DBL = T doubled four
// times, the other T = DBL + ADD), and DBL (digit 0) or ADD (accumulator
// still infinity) kept in place of the sum.  T is a placeholder (the base
// doubled) while t_inf, as in the JAX loop, so a zero scalar returns
// 2^128 times the base exactly as the plain version does.  Returns t_inf;
// the result is in T0 (32 windows: T ends where it began).
template <int W>
LT_DEV bool w_scalar_windows(const wmem &m, const wprog &p, int first, const int32_t *rwords, int n, int lane,
                             int tbl, int add, int dbl, int t0, int t1) {
  uint32_t rw[LT_RAND_WORDS];
  for (int i = 0; i < LT_RAND_WORDS; i++) rw[i] = (uint32_t)rwords[i * n + lane];
  w_segment(m, p, first);
  bool t_inf = true;
  for (int t = 0; t < LT_RAND_BITS / LT_WINDOW; t++) {
    const uint32_t d = w_digit(rw, t);
    w_copy(m, add, tbl + W * (d == 0 ? 0 : (int)d - 1), W);
    w_segment(m, p, first + 1 + t);
    const int next = t % 2 ? t0 : t1;
    if (d == 0)
      w_copy(m, next, dbl, W);
    else if (t_inf)
      w_copy(m, next, add, W);
    t_inf = t_inf && d == 0;
  }
  return t_inf;
}

// p: Jacobian planes [3, 12, n]; p_inf, out_inf: [n]; rwords: [4, n];
// out: [3, 12, n].  One warp.
LT_DEV void g1_rpk_warp(const wmem &m, const int32_t *p, const int32_t *p_inf, const int32_t *rwords,
                        int32_t *out, int32_t *out_inf, int n, int lane) {
  const wprog prog = {LT_RPK_SEG, LT_RPK_PHASE, LT_RPK_INS};
  w_load_planes(m, LT_RPK_P, p, 3, n, lane);
  LT_SYNCWARP();
  const bool t_inf = w_scalar_windows<3>(m, prog, 0, rwords, n, lane, LT_RPK_TBL, LT_RPK_ADD, LT_RPK_DBL,
                                         LT_RPK_T0, LT_RPK_T1);
  w_store_planes(m, LT_RPK_T0, out, 3, n, lane);
  if (LT_T0 == 0) out_inf[lane] = t_inf || p_inf[lane] != 0 ? 1 : 0;  // k O = O; k = 0 stays infinity
}

// q: affine planes [2, 2, 12, n] (x, y), plain limbs where msg is given,
// else Montgomery; msg: plain planes [2, 2, 12, n] or null; q_inf, out_inf,
// sub: [n]; rwords: [4, n]; out: Jacobian planes [3, 2, 12, n]; msg_out:
// the Montgomery message [2, 2, 12, n] (written where msg is given).  One
// warp.
LT_DEV void g2_rsig_sub_warp(const wmem &m, const int32_t *q, const int32_t *q_inf, const int32_t *msg,
                             const int32_t *rwords, int32_t *out, int32_t *out_inf, int32_t *sub, int32_t *msg_out,
                             int n, int lane) {
  const wprog prog = {LT_RSIG_SEG, LT_RSIG_PHASE, LT_RSIG_INS};
  if (msg) {
    w_load_planes(m, LT_RSIG_QIN, q, 4, n, lane);
    w_load_planes(m, LT_RSIG_MSGIN, msg, 4, n, lane);
    LT_SYNCWARP();
    w_segment(m, prog, 0);  // the ingest: QIN, MSGIN -> Q, MSG
    w_store_planes(m, LT_RSIG_MSG, msg_out, 4, n, lane);  // before the table writes its slots
  } else {
    w_load_planes(m, LT_RSIG_Q, q, 4, n, lane);
  }
  LT_SYNCWARP();
  const bool t_inf = w_scalar_windows<6>(m, prog, 1, rwords, n, lane, LT_RSIG_TBL, LT_RSIG_ADD, LT_RSIG_DBL,
                                         LT_RSIG_T0, LT_RSIG_T1);
  w_store_planes(m, LT_RSIG_T0, out, 6, n, lane);
  // jac_eq: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, the pairs at
  // EQ + {0, 1} / {2, 3} and EQ + {4, 5} / {6, 7}
  const bool eq = w_eq(m, LT_RSIG_EQ, LT_RSIG_EQ + 2, 2) && w_eq(m, LT_RSIG_EQ + 4, LT_RSIG_EQ + 6, 2);
  if (LT_T0 == 0) {
    const bool inf = q_inf[lane] != 0;
    out_inf[lane] = t_inf || inf ? 1 : 0;  // k O = O; k = 0 stays infinity
    sub[lane] = eq || inf ? 1 : 0;  // O is in the subgroup
  }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g1_rpk_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ p_inf,
                     const int32_t *__restrict__ rwords, int32_t *__restrict__ out,
                     int32_t *__restrict__ out_inf, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_RPK_SLOTS, LT_RPK_CONSTS, LT_RPK_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g1_rpk_warp(m, p, p_inf, rwords, out, out_inf, n, lane);
}

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g2_rsig_sub_kernel(const int32_t *__restrict__ q, const int32_t *__restrict__ q_inf,
                          const int32_t *__restrict__ msg, const int32_t *__restrict__ rwords,
                          int32_t *__restrict__ out, int32_t *__restrict__ out_inf, int32_t *__restrict__ sub,
                          int32_t *__restrict__ msg_out, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g2_rsig_sub_warp(m, q, q_inf, msg, rwords, out, out_inf, sub, msg_out, n, lane);
}
#endif

// The launch's record: a launch on a Montgomery signature runs the program
// without its ingest segment.
static wlaunch rsig_launch(int n, bool ingest) {
  return w_launch("g2_rsig_sub", n, LT_RSIG_SLOTS, LT_RSIG_CONSTS,
                  LT_RSIG_PHASES - (ingest ? 0 : LT_RSIG_INGEST_PHASES),
                  LT_RSIG_ROUNDS - (ingest ? 0 : LT_RSIG_INGEST_ROUNDS));
}

#ifdef __CUDACC__

extern "C" int lt_g1_rpk(const void *p, const void *p_inf, const void *rwords, void *out,
                         void *out_inf, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("g1_rpk", n, LT_RPK_SLOTS, LT_RPK_CONSTS, LT_RPK_PHASES, LT_RPK_ROUNDS);
    cudaFuncSetAttribute(lt_g1_rpk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g1_rpk_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)p, (const int32_t *)p_inf, (const int32_t *)rwords, (int32_t *)out, (int32_t *)out_inf, n);
  }
  return (int)cudaGetLastError();
}

// msg and msg_out: both given (the decoded batch path) or both null
extern "C" int lt_g2_rsig_sub(const void *q, const void *q_inf, const void *msg, const void *rwords, void *out,
                              void *out_inf, void *sub, void *msg_out, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = rsig_launch(n, msg != nullptr);
    cudaFuncSetAttribute(lt_g2_rsig_sub_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g2_rsig_sub_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)msg, (const int32_t *)rwords, (int32_t *)out,
        (int32_t *)out_inf, (int32_t *)sub, (int32_t *)msg_out, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_g1_rpk(const void *p, const void *p_inf, const void *rwords, void *out,
                         void *out_inf, int n, void *stream) {
  (void)stream;
  const wlaunch l = w_launch("g1_rpk", n, LT_RPK_SLOTS, LT_RPK_CONSTS, LT_RPK_PHASES, LT_RPK_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_RPK_SLOTS, LT_RPK_CONSTS, LT_RPK_CONST, lane % LT_LPB);
    g1_rpk_warp(m, (const int32_t *)p, (const int32_t *)p_inf, (const int32_t *)rwords, (int32_t *)out,
                (int32_t *)out_inf, n, lane);
  }
  free(sm);
  return 0;
}

extern "C" int lt_g2_rsig_sub(const void *q, const void *q_inf, const void *msg, const void *rwords, void *out,
                              void *out_inf, void *sub, void *msg_out, int n, void *stream) {
  (void)stream;
  const wlaunch l = rsig_launch(n, msg != nullptr);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_CONST, lane % LT_LPB);
    g2_rsig_sub_warp(m, (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)msg, (const int32_t *)rwords,
                     (int32_t *)out, (int32_t *)out_inf, (int32_t *)sub, (int32_t *)msg_out, n, lane);
  }
  free(sm);
  return 0;
}

#endif
