// K5 and K6: the RLC batch's randomized scalar multiplications.
//
//   lt_g1_rpk       r_i pk_i in G1 (replaces lodestar_tpu/kernels/verify.py
//                   _k_g1_rpk)
//   lt_g2_rsig_sub  r_i sig_i in G2, and the psi subgroup check of sig_i
//                   (replaces _k_g2_rsig_sub)
//
// One template (curve.cuh scalar_mul_window) over Fp and Fp2: 128-bit
// scalars read from packed word planes, 4-bit windows, a 15-entry table
// indexed by the digit.  One thread per lane, as in K2-K4; the table
// (2.2 KB in G1, 4.3 KB in G2) lives in the thread's stack frame in local
// memory.
//
// Bound on this card: 32-bit integer multiplies, 1,569 (G1) and 5,057
// (G2, 3,876 for the multiplication and 1,181 for the subgroup check) Fp
// products per lane, 588 multiply instructions each; the bytes per lane
// (under 0.5 KB) are negligible.  Every window's addition is computed and
// kept by a select, so the lanes of a warp never diverge.
#include "curve.cuh"

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

// q: affine planes [2, 2, 12, n] (x, y); q_inf, out_inf, sub: [n];
// rwords: [4, n]; out: Jacobian planes [3, 2, 12, n]
LT_DEV void g2_rsig_sub_lane(const int32_t *q, const int32_t *q_inf, const int32_t *rwords,
                             int32_t *out, int32_t *out_inf, int32_t *sub, int n, int lane) {
  aff<fp2> a;
  fp2_load(a.x, q, n, lane);
  fp2_load(a.y, q + 2 * LT_NL * n, n, lane);
  const bool inf = q_inf[lane] != 0;
  jac<fp2> qj, r;
  qj.x = a.x;
  qj.y = a.y;
  fp2_one(qj.z);
  bool r_inf;
  scalar_mul_window(r, r_inf, qj, inf, rwords, n, lane);
  fp2_store(out, n, lane, r.x);
  fp2_store(out + 2 * LT_NL * n, n, lane, r.y);
  fp2_store(out + 4 * LT_NL * n, n, lane, r.z);
  out_inf[lane] = r_inf ? 1 : 0;
  sub[lane] = g2_subgroup_check(a, inf) ? 1 : 0;
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

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_g2_rsig_sub_kernel(const int32_t *__restrict__ q, const int32_t *__restrict__ q_inf,
                          const int32_t *__restrict__ rwords, int32_t *__restrict__ out,
                          int32_t *__restrict__ out_inf, int32_t *__restrict__ sub, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) g2_rsig_sub_lane(q, q_inf, rwords, out, out_inf, sub, n, lane);
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
  if (n > 0)
    lt_g2_rsig_sub_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)rwords, (int32_t *)out,
        (int32_t *)out_inf, (int32_t *)sub, n);
  return (int)cudaGetLastError();
}

#else

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
  for (int lane = 0; lane < n; lane++)
    g2_rsig_sub_lane((const int32_t *)q, (const int32_t *)q_inf, (const int32_t *)rwords,
                     (int32_t *)out, (int32_t *)out_inf, (int32_t *)sub, n, lane);
  return 0;
}

#endif
