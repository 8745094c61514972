// K2: G2 subgroup check of affine signatures, psi(Q) == -[|x|]Q.
//
// Replaces lodestar_tpu/kernels/verify.py _k_sub_only (the per-set path's
// check; _k_g2_rsig_sub runs the same check beside the RLC scalar multiply).
// One thread per lane runs the whole static double-and-add chain (63
// doublings, 5 mixed additions over Fp2), psi and the cross-multiplied
// equality.
//
// Bound on this card: 32-bit integer multiplies.  The chain costs 1,181
// Fp multiplications per lane (588 multiply instructions each) and no
// memory traffic beyond 200 bytes per lane, so IMAD throughput bounds it.
// One thread per lane leaves a 512-lane job on 16 of the 132 SMs and keeps
// its Fp2 temporaries in a stack frame in local memory; the design accepts both
// for a first version.  Warp-cooperative products are the next step.
#include "curve.cuh"

LT_DEV void subgroup_lane(const int32_t *q, const int32_t *q_inf, int32_t *out, int n, int lane) {
  aff<fp2> a;
  fp2_load(a.x, q, n, lane);
  fp2_load(a.y, q + 2 * LT_NL * n, n, lane);
  out[lane] = g2_subgroup_check(a, q_inf[lane] != 0) ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_g2_subgroup_kernel(const int32_t *__restrict__ q, const int32_t *__restrict__ q_inf,
                          int32_t *__restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) subgroup_lane(q, q_inf, out, n, lane);
}

extern "C" int lt_g2_subgroup_check(const void *q, const void *q_inf, void *out, int n,
                                    void *stream) {
  if (n > 0)
    lt_g2_subgroup_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                            (cudaStream_t)stream>>>((const int32_t *)q, (const int32_t *)q_inf,
                                                    (int32_t *)out, n);
  return (int)cudaGetLastError();
}

#else

extern "C" int lt_g2_subgroup_check(const void *q, const void *q_inf, void *out, int n,
                                    void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    subgroup_lane((const int32_t *)q, (const int32_t *)q_inf, (int32_t *)out, n, lane);
  return 0;
}

#endif
