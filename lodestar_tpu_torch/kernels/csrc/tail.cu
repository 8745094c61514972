// K9 and K10: the RLC batch's tail, on the one lane that carries the
// aggregate.
//
//   lt_affine_g2  Jacobian G2 -> affine by one Fp2 inversion; infinity
//                 (flagged, or Z = 0) gives the generator and a flag
//                 (replaces lodestar_tpu/kernels/verify.py _k_affine_g2)
//   lt_final_one  prod * (a_inf ? 1 : fA) -> final exponentiation -> is-one
//                 (replaces _k_final_one; K4's program, csrc/final.cu, with
//                 another prologue)
//
// Between them the path runs the Miller loop of the aggregate pair
// (-G1, A) on one lane (csrc/miller.cu).  The TPU kernels run all 128
// lanes of a tile with the same value; here each kernel takes any number
// of lanes and the path gives it one (pre-verify aggregation gives
// affine_g2 a 128-lane tile).
//
// Both run one warp per lane (csrc/warp12.cuh).  lt_affine_g2's program
// (warp_schedule.affine_program) inverts Z through its norm, whose one Fp
// inversion is the variable-time binary GCD fp_inv_var on one thread, where
// one thread ran the ~608-product Fermat chain; the rest is 16 Fp products
// in 6 rounds.  Its time is the inversion's.  lt_final_one runs the final
// exponentiation's 7,730 Fp products in 396 rounds of up to 32.  The
// card-wide IMAD bound of either is microseconds.
#define LT_WANT_AFFINE
#define LT_WANT_FINAL
#include "pairing.cuh"

// p: Jacobian planes [3, 2, 12, n]; p_inf, a_inf: [n]; a: affine planes
// [2, 2, 12, n].  One warp.
LT_DEV void affine_g2_warp(const wmem &m, const int32_t *p, const int32_t *p_inf, int32_t *a, int32_t *a_inf, int n,
                           int lane) {
  w_load_planes(m, LT_AFFINE_P, p, 6, n, lane);
  LT_SYNCWARP();
  const bool inf = p_inf[lane] != 0 || w_eq(m, LT_AFFINE_P + 4, -1, 2);
  w_run(m, LT_AFFINE_PHASE, LT_AFFINE_PHASES, LT_AFFINE_INS);
  if (inf) w_copy_cols(m, LT_AFFINE_A, m.cbase + LT_AFFINE_G2, 4);  // the generator
  w_store_planes(m, LT_AFFINE_A, a, 4, n, lane);
  if (LT_T0 == 0) a_inf[lane] = inf ? 1 : 0;
}

// a_inf, ok: [n]; prod, fa: [12, 12, n]
LT_DEV void final_one_warp(const wmem &m, const int32_t *a_inf, const int32_t *prod, const int32_t *fa,
                           int32_t *ok, int n, int lane) {
  w_load_planes(m, LT_FINAL_A, prod, 12, n, lane);
  if (a_inf[lane] != 0)
    w_load_one12(m, LT_FINAL_B);  // A = O: e(-G1, O) = 1
  else
    w_load_planes(m, LT_FINAL_B, fa, 12, n, lane);
  const bool one = final_warp_is_one(m);
  if (LT_T0 == 0) ok[lane] = one ? 1 : 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_affine_g2_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ p_inf,
                        int32_t *__restrict__ a, int32_t *__restrict__ a_inf, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_AFFINE_SLOTS, LT_AFFINE_CONSTS, LT_AFFINE_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) affine_g2_warp(m, p, p_inf, a, a_inf, n, lane);
}

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_final_one_kernel(const int32_t *__restrict__ a_inf, const int32_t *__restrict__ prod,
                        const int32_t *__restrict__ fa, int32_t *__restrict__ ok, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) final_one_warp(m, a_inf, prod, fa, ok, n, lane);
}

extern "C" int lt_affine_g2(const void *p, const void *p_inf, void *a, void *a_inf, int n,
                            void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("affine_g2", n, LT_AFFINE_SLOTS, LT_AFFINE_CONSTS, LT_AFFINE_PHASES, LT_AFFINE_ROUNDS);
    cudaFuncSetAttribute(lt_affine_g2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_affine_g2_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)p, (const int32_t *)p_inf, (int32_t *)a, (int32_t *)a_inf, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int lt_final_one(const void *a_inf, const void *prod, const void *fa, void *ok, int n,
                            void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("final_one", n, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_PHASES, LT_FINAL_ROUNDS);
    cudaFuncSetAttribute(lt_final_one_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_final_one_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)a_inf, (const int32_t *)prod, (const int32_t *)fa, (int32_t *)ok, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_affine_g2(const void *p, const void *p_inf, void *a, void *a_inf, int n,
                            void *stream) {
  (void)stream;
  const wlaunch l = w_launch("affine_g2", n, LT_AFFINE_SLOTS, LT_AFFINE_CONSTS, LT_AFFINE_PHASES, LT_AFFINE_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {
    const wmem m = w_block(sm, LT_AFFINE_SLOTS, LT_AFFINE_CONSTS, LT_AFFINE_CONST, lane % LT_LPB);
    affine_g2_warp(m, (const int32_t *)p, (const int32_t *)p_inf, (int32_t *)a, (int32_t *)a_inf, n, lane);
  }
  free(sm);
  return 0;
}

extern "C" int lt_final_one(const void *a_inf, const void *prod, const void *fa, void *ok, int n,
                            void *stream) {
  (void)stream;
  const wlaunch l = w_launch("final_one", n, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_PHASES, LT_FINAL_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {
    const wmem m = w_block(sm, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_CONST, lane % LT_LPB);
    final_one_warp(m, (const int32_t *)a_inf, (const int32_t *)prod, (const int32_t *)fa, (int32_t *)ok, n,
                   lane);
  }
  free(sm);
  return 0;
}

#endif
