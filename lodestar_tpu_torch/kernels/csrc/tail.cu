// K9 and K10: the RLC batch's tail, on the one lane that carries the
// aggregate.
//
//   lt_affine_g2  Jacobian G2 -> affine by one Fp2 inversion; infinity
//                 (flagged, or Z = 0) gives the generator and a flag
//                 (replaces lodestar_tpu/kernels/verify.py _k_affine_g2)
//   lt_final_one  prod * (a_inf ? 1 : fA) -> final exponentiation -> is-one
//                 (replaces _k_final_one; K4's body with another prologue)
//
// Between them the path runs the Miller loop of the aggregate pair
// (-G1, A) on one lane (csrc/miller.cu).  The TPU kernels run all 128
// lanes of a tile with the same value; here each kernel takes any number
// of lanes, one thread each, and the path gives it one.
//
// Bound on this card: one lane is one thread, so the time is one thread's
// dependent chain: 623 Fp products (608 of them the Fp inversion) in
// lt_affine_g2, one Fp12 product and the final exponentiation (8,337 Fp
// products) in lt_final_one.  The card-wide IMAD bound is microseconds.
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
LT_DEV void final_one_lane(const int32_t *a_inf, const int32_t *prod, const int32_t *fa,
                           int32_t *ok, int n, int lane) {
  fp12 a, b, one;
  fp12_load(a, prod, n, lane);
  fp12_load(b, fa, n, lane);
  fp12_one(one);
  fp12_select(b, a_inf[lane] != 0, one, b);  // A = O: e(-G1, O) = 1
  fp12_mul(a, a, b);
  final_exponentiation(b, a);
  ok[lane] = fp12_is_one(b) ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_affine_g2_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ p_inf,
                        int32_t *__restrict__ a, int32_t *__restrict__ a_inf, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) affine_g2_lane(p, p_inf, a, a_inf, n, lane);
}

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_final_one_kernel(const int32_t *__restrict__ a_inf, const int32_t *__restrict__ prod,
                        const int32_t *__restrict__ fa, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) final_one_lane(a_inf, prod, fa, ok, n, lane);
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
  if (n > 0)
    lt_final_one_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                          (cudaStream_t)stream>>>((const int32_t *)a_inf, (const int32_t *)prod,
                                                  (const int32_t *)fa, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

#else

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
  for (int lane = 0; lane < n; lane++)
    final_one_lane((const int32_t *)a_inf, (const int32_t *)prod, (const int32_t *)fa,
                   (int32_t *)ok, n, lane);
  return 0;
}

#endif
