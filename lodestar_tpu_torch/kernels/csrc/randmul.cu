// K5 and K6: the RLC batch's randomized scalar multiplications.
//
//   lt_g1_rpk       r_i pk_i in G1 (replaces lodestar_tpu/kernels/verify.py
//                   _k_g1_rpk)
//   lt_g2_rsig_sub  r_i sig_i in G2, and the psi subgroup check of sig_i
//                   (replaces _k_g2_rsig_sub)
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
// g1_rpk: one thread per lane (curve.cuh scalar_mul_window), 1,569 Fp
// products in one dependent chain; the table (2.2 KB) in the thread's
// stack frame.
//
// g2_rsig_sub: one warp per lane (csrc/warp12.cuh).  One thread per lane
// ran its 5,057 products as one chain at ~1.7 us each, 16 of the 132 SMs
// busy at N = 512.  The program (warp_prog.cuh, from kernels/
// warp_schedule.py rsig_program) packs a G2 doubling's ~5 independent Fp
// products per round and, in the idle threads of the same rounds, the
// subgroup check's static chain by |x|, two of its steps per window; its
// slots hold the table, the accumulator, the subgroup chain and the
// temporaries in shared memory.  The scalar's digits are the only
// per-lane choice: the window loop below runs the program a segment at a time
// (the table, then one segment per window) and, between segments, copies
// the digit's table entry into the addend's slots and keeps the window's
// sum, its doubled accumulator or the entry itself (jac_select).  One
// warp serves one lane, so the digit is uniform across it and the warp
// never diverges.
#include "curve.cuh"
#define LT_WANT_RSIG
#include "warp12.cuh"

// p: Jacobian planes [3, 12, n]; p_inf, out_inf: [n]; rwords: [4, n];
// out: [3, 12, n]
LT_DEV void g1_rpk_lane(const int32_t *p, const int32_t *p_inf, const int32_t *rwords,
                        int32_t *out, int32_t *out_inf, int n, int lane) {
  jac<fp> q, r;
  fp_load(q.x, p, n, lane);
  fp_load(q.y, p + LT_NL * n, n, lane);
  fp_load(q.z, p + 2 * LT_NL * n, n, lane);
  bool r_inf;
  scalar_mul_window(r, r_inf, q, p_inf[lane] != 0, rwords, n, lane);
  fp_store(out, n, lane, r.x);
  fp_store(out + LT_NL * n, n, lane, r.y);
  fp_store(out + 2 * LT_NL * n, n, lane, r.z);
  out_inf[lane] = r_inf ? 1 : 0;
}

// digit t (MSB-first) of a scalar held as LT_RAND_WORDS big-endian words
LT_DEV uint32_t rsig_digit(const uint32_t *rw, int t) {
  const int pos = LT_RAND_BITS - LT_WINDOW - LT_WINDOW * t;  // LSB offset of the digit
  return (rw[LT_RAND_WORDS - 1 - (pos >> 5)] >> (pos & 31)) & ((1u << LT_WINDOW) - 1);
}

// segment k, in the order the program runs them (0: the table, 1 + t:
// window t)
LT_DEV void rsig_segment(const wmem &m, int k) {
  const uint32_t a = LT_RSIG_SEG[k], b = LT_RSIG_SEG[k + 1];
  w_run(m, LT_RSIG_PHASE + a, (int)(b - a), LT_RSIG_INS);
}

// q: affine planes [2, 2, 12, n] (x, y); q_inf, out_inf, sub: [n];
// rwords: [4, n]; out: Jacobian planes [3, 2, 12, n].  One warp.
LT_DEV void g2_rsig_sub_warp(const wmem &m, const int32_t *q, const int32_t *q_inf, const int32_t *rwords,
                             int32_t *out, int32_t *out_inf, int32_t *sub, int n, int lane) {
  w_load_planes(m, LT_RSIG_Q, q, 4, n, lane);
  uint32_t rw[LT_RAND_WORDS];
  for (int i = 0; i < LT_RAND_WORDS; i++) rw[i] = (uint32_t)rwords[i * n + lane];
  LT_SYNCWARP();
  rsig_segment(m, 0);
  // T is a placeholder (Q doubled) while t_inf, as in the JAX loop
  bool t_inf = true;
  for (int t = 0; t < LT_RAND_BITS / LT_WINDOW; t++) {
    const uint32_t d = rsig_digit(rw, t);
    w_copy(m, LT_RSIG_ADD, LT_RSIG_TBL + 6 * (d == 0 ? 0 : (int)d - 1), 6);
    rsig_segment(m, 1 + t);  // DBL = T doubled four times, the other T = DBL + ADD
    const int next = t % 2 ? LT_RSIG_T0 : LT_RSIG_T1;
    if (d == 0)
      w_copy(m, next, LT_RSIG_DBL, 6);
    else if (t_inf)
      w_copy(m, next, LT_RSIG_ADD, 6);
    t_inf = t_inf && d == 0;
  }
  w_store_planes(m, LT_RSIG_T0, out, 6, n, lane);
  // jac_eq: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, the pairs at
  // EQ + {0, 1} / {2, 3} and EQ + {4, 5} / {6, 7}, canonical
  uint32_t diff = 0;
  for (int i = LT_T0; i < 4 * LT_NL; i += LT_TSTEP) {
    const int k = i / LT_NL, a = LT_RSIG_EQ + (k / 2) * 4 + k % 2;
    const uint32_t *row = m.sm + (i % LT_NL) * m.cols + m.base;
    diff |= row[a] ^ row[a + 2];
  }
#ifdef __CUDACC__
  const bool eq = !__any_sync(0xffffffffu, diff != 0);
#else
  const bool eq = diff == 0;
#endif
  if (LT_T0 == 0) {
    const bool inf = q_inf[lane] != 0;
    out_inf[lane] = t_inf || inf ? 1 : 0;  // k O = O; k = 0 stays infinity
    sub[lane] = eq || inf ? 1 : 0;  // O is in the subgroup
  }
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_g1_rpk_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ p_inf,
                     const int32_t *__restrict__ rwords, int32_t *__restrict__ out,
                     int32_t *__restrict__ out_inf, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) g1_rpk_lane(p, p_inf, rwords, out, out_inf, n, lane);
}

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g2_rsig_sub_kernel(const int32_t *__restrict__ q, const int32_t *__restrict__ q_inf,
                          const int32_t *__restrict__ rwords, int32_t *__restrict__ out,
                          int32_t *__restrict__ out_inf, int32_t *__restrict__ sub, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g2_rsig_sub_warp(m, q, q_inf, rwords, out, out_inf, sub, n, lane);
}

extern "C" int lt_g1_rpk(const void *p, const void *p_inf, const void *rwords, void *out,
                         void *out_inf, int n, void *stream) {
  if (n > 0)
    lt_g1_rpk_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                       (cudaStream_t)stream>>>((const int32_t *)p, (const int32_t *)p_inf,
                                               (const int32_t *)rwords, (int32_t *)out,
                                               (int32_t *)out_inf, n);
  return (int)cudaGetLastError();
}

extern "C" int lt_g2_rsig_sub(const void *q, const void *q_inf, const void *rwords, void *out,
                              void *out_inf, void *sub, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch(n, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_PHASES, LT_RSIG_ROUNDS);
    cudaFuncSetAttribute(lt_g2_rsig_sub_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g2_rsig_sub_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)rwords, (int32_t *)out,
        (int32_t *)out_inf, (int32_t *)sub, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_g1_rpk(const void *p, const void *p_inf, const void *rwords, void *out,
                         void *out_inf, int n, void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    g1_rpk_lane((const int32_t *)p, (const int32_t *)p_inf, (const int32_t *)rwords,
                (int32_t *)out, (int32_t *)out_inf, n, lane);
  return 0;
}

extern "C" int lt_g2_rsig_sub(const void *q, const void *q_inf, const void *rwords, void *out,
                              void *out_inf, void *sub, int n, void *stream) {
  (void)stream;
  const wlaunch l = w_launch(n, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_PHASES, LT_RSIG_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_RSIG_SLOTS, LT_RSIG_CONSTS, LT_RSIG_CONST, lane % LT_LPB);
    g2_rsig_sub_warp(m, (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)rwords, (int32_t *)out,
                     (int32_t *)out_inf, (int32_t *)sub, n, lane);
  }
  free(sm);
  return 0;
}

#endif
