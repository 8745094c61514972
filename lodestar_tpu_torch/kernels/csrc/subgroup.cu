// K2: G2 subgroup check of affine signatures, psi(Q) == -[|x|]Q.
//
// Replaces lodestar_tpu/kernels/verify.py _k_sub_only (the per-set path's
// check; _k_g2_rsig_sub runs the same check beside the RLC scalar multiply).
//
// On the decoded per-set path it also makes that path's Montgomery ingest
// (_k_mont8, lodestar_tpu/kernels/verify.py): given the job's signature
// and message as plain limbs (any integers below 2^384), the program's
// first segment converts both, 8 products in one round, and the kernel
// stores them for the path's two Miller loops.  Given Montgomery points
// (the wire per-set path, whose g2_decompress made them) it skips that
// segment.
//
// One warp per lane on the warp engine (csrc/warp12.cuh): the program
// (warp_prog.cuh, from kernels/warp_schedule.py sub_program) runs the
// static chain [|x|] Q (63 doublings, 5 mixed additions: the plain
// version's formulas, so its Jacobian triple), psi(Q) and jac_eq's cross
// products of psi(Q) against -[|x|] Q in one segment, packing each step's
// independent Fp products into rounds; the warp then compares the
// products' canonical limbs on a vote.  A lane at infinity passes.  The
// program makes no inversion: the interpreter is compiled without it.
//
// Bound on this card: 32-bit integer multiplies.  The check needs 1,181
// Fp multiplications per lane (588 multiply instructions each; 1,189 with
// the ingest) and moves 200 bytes per lane (776 with the ingest's planes).  One thread per lane ran them as one chain at
// ~1.75 us a product; the warp runs them in 206 rounds of a product's
// latency (207 with the ingest), and 512 lanes take 128 blocks of 4 warps.
#define LT_WANT_SUB
#include "warp12.cuh"

// q: affine planes [2, 2, 12, n] (x, y), plain limbs where msg is given,
// else Montgomery; msg: plain planes [2, 2, 12, n] or null; q_inf, out:
// [n]; conv: the Montgomery signature and message, planes [8, 12, n]
// (written where msg is given).  One warp.
LT_DEV void g2_subgroup_warp(const wmem &m, const int32_t *q, const int32_t *q_inf, const int32_t *msg,
                             int32_t *out, int32_t *conv, int n, int lane) {
  const wprog prog = {LT_SUB_SEG, LT_SUB_PHASE, LT_SUB_INS};
  if (msg) {
    w_load_planes(m, LT_SUB_QIN, q, 4, n, lane);
    w_load_planes(m, LT_SUB_MSGIN, msg, 4, n, lane);
    LT_SYNCWARP();
    w_segment<false>(m, prog, 0);  // the ingest: QIN, MSGIN -> Q, MSG
    w_store_planes(m, LT_SUB_Q, conv, 4, n, lane);
    w_store_planes(m, LT_SUB_MSG, conv + (size_t)4 * LT_NL * n, 4, n, lane);
  } else {
    w_load_planes(m, LT_SUB_Q, q, 4, n, lane);
  }
  LT_SYNCWARP();
  w_segment<false>(m, prog, 1);  // the check
  // X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3: the pairs at EQ + {0, 1} /
  // {2, 3} and EQ + {4, 5} / {6, 7}
  const bool eq = w_eq(m, LT_SUB_EQ, LT_SUB_EQ + 2, 2) && w_eq(m, LT_SUB_EQ + 4, LT_SUB_EQ + 6, 2);
  if (LT_T0 == 0) out[lane] = eq || q_inf[lane] != 0 ? 1 : 0;  // O is in the subgroup
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_g2_subgroup_check_kernel(const int32_t *__restrict__ q, const int32_t *__restrict__ q_inf,
                                const int32_t *__restrict__ msg, int32_t *__restrict__ out,
                                int32_t *__restrict__ conv, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_SUB_SLOTS, LT_SUB_CONSTS, LT_SUB_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) g2_subgroup_warp(m, q, q_inf, msg, out, conv, n, lane);
}
#endif

// The launch's record: a launch on Montgomery points runs the program
// without its ingest segment.
static wlaunch sub_launch(int n, bool ingest) {
  return w_launch("g2_subgroup_check", n, LT_SUB_SLOTS, LT_SUB_CONSTS,
                  LT_SUB_PHASES - (ingest ? 0 : LT_SUB_INGEST_PHASES),
                  LT_SUB_ROUNDS - (ingest ? 0 : LT_SUB_INGEST_ROUNDS));
}

#ifdef __CUDACC__

// msg and conv: both given (the decoded per-set path) or both null
extern "C" int lt_g2_subgroup_check(const void *q, const void *q_inf, const void *msg, void *out, void *conv,
                                    int n, void *stream) {
  if (n > 0) {
    const wlaunch l = sub_launch(n, msg != nullptr);
    cudaFuncSetAttribute(lt_g2_subgroup_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_g2_subgroup_check_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)msg, (int32_t *)out, (int32_t *)conv, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_g2_subgroup_check(const void *q, const void *q_inf, const void *msg, void *out, void *conv,
                                    int n, void *stream) {
  (void)stream;
  const wlaunch l = sub_launch(n, msg != nullptr);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_SUB_SLOTS, LT_SUB_CONSTS, LT_SUB_CONST, lane % LT_LPB);
    g2_subgroup_warp(m, (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)msg, (int32_t *)out,
                     (int32_t *)conv, n, lane);
  }
  free(sm);
  return 0;
}

#endif
