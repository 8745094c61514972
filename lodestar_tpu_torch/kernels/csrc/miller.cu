// K3: Miller loop per lane, Jacobian G1 P x affine G2 Q -> Fp12.
//
// Replaces lodestar_tpu/kernels/verify.py _k_miller (the per-set path runs
// it twice per job: (pk, H(m)) and (-G1, sig)).  One thread per lane runs
// the whole loop: 63 doubling steps and 5 addition steps, each with its
// sparse line product into the Fp12 accumulator.  The formulas are those
// of lodestar_tpu/kernels/pairing.py, so the twelve output planes equal
// the JAX kernel's values as canonical integers.
//
// Bound on this card: 32-bit integer multiplies, 7,834 Fp
// multiplications per lane (588 multiply instructions each); the 144-word
// accumulator, the Jacobian T and the line live in the thread's stack
// frame in local memory (ptxas: 3,984 B, no spills), and
// the per-lane bytes in and out (1 KB) are negligible.  One thread per
// lane keeps the loop inside the kernel as on the TPU; a 512-lane job then
// fills 16 SMs with one warp each, which is what a later warp-cooperative
// design has to fix.
#include "pairing.cuh"

// p: planes [3, 12, n] (X, Y, Z); q: [2, 2, 12, n] (x, y of Fp2);
// f: [12, 12, n] in the JAX package's leaf order
LT_DEV void miller_lane(const int32_t *p, const int32_t *q, int32_t *f, int n, int lane) {
  jac<fp> P;
  aff<fp2> Q;
  fp_load(P.x, p, n, lane);
  fp_load(P.y, p + LT_NL * n, n, lane);
  fp_load(P.z, p + 2 * LT_NL * n, n, lane);
  fp2_load(Q.x, q, n, lane);
  fp2_load(Q.y, q + 2 * LT_NL * n, n, lane);
  fp12 acc;
  miller_loop(acc, P, Q);
  fp12_store(f, n, lane, acc);
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_miller_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ q,
                     int32_t *__restrict__ f, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) miller_lane(p, q, f, n, lane);
}

extern "C" int lt_miller_loop(const void *p, const void *q, void *f, int n, void *stream) {
  if (n > 0)
    lt_miller_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                       (cudaStream_t)stream>>>((const int32_t *)p, (const int32_t *)q,
                                               (int32_t *)f, n);
  return (int)cudaGetLastError();
}

#else

extern "C" int lt_miller_loop(const void *p, const void *q, void *f, int n, void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    miller_lane((const int32_t *)p, (const int32_t *)q, (int32_t *)f, n, lane);
  return 0;
}

#endif
