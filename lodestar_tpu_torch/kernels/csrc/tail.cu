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
// of lanes and the path gives it one.
//
// lt_affine_g2 runs one thread per lane: its time is one thread's chain of
// 623 Fp products (608 of them the Fermat inversion).  lt_final_one runs
// one warp per lane (csrc/warp12.cuh): the final exponentiation's 7,730
// Fp products in 396 rounds of up to 32.  The card-wide IMAD bound of
// either is microseconds.
#include "curve.cuh"
#define LT_WANT_FINAL
#include "pairing.cuh"

// p: Jacobian planes [3, 2, 12, n]; p_inf, a_inf: [n]; a: affine planes
// [2, 2, 12, n]
LT_DEV void affine_g2_lane(const int32_t *p, const int32_t *p_inf, int32_t *a, int32_t *a_inf,
                           int n, int lane) {
  jac<fp2> j;
  fp2_load(j.x, p, n, lane);
  fp2_load(j.y, p + 2 * LT_NL * n, n, lane);
  fp2_load(j.z, p + 4 * LT_NL * n, n, lane);
  const bool inf = p_inf[lane] != 0 || fp2_is_zero(j.z);
  fp2 zi, zi2, t, x, y, g;
  fp2_inv(zi, j.z);
  fp2_sqr(zi2, zi);
  fp2_mul(x, j.x, zi2);
  fp2_mul(t, zi2, zi);
  fp2_mul(y, j.y, t);
  fp2_const(g, LT_G2X);
  fp2_select(x, inf, g, x);
  fp2_const(g, LT_G2Y);
  fp2_select(y, inf, g, y);
  fp2_store(a, n, lane, x);
  fp2_store(a + 2 * LT_NL * n, n, lane, y);
  a_inf[lane] = inf ? 1 : 0;
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

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_affine_g2_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ p_inf,
                        int32_t *__restrict__ a, int32_t *__restrict__ a_inf, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) affine_g2_lane(p, p_inf, a, a_inf, n, lane);
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
  if (n > 0)
    lt_affine_g2_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                          (cudaStream_t)stream>>>((const int32_t *)p, (const int32_t *)p_inf,
                                                  (int32_t *)a, (int32_t *)a_inf, n);
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
  for (int lane = 0; lane < n; lane++)
    affine_g2_lane((const int32_t *)p, (const int32_t *)p_inf, (int32_t *)a, (int32_t *)a_inf,
                   n, lane);
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
