// K3: Miller loop per lane, Jacobian G1 P x affine G2 Q -> Fp12.
//
// Replaces lodestar_tpu/kernels/verify.py _k_miller (the per-set path runs
// it twice per job: (pk, H(m)) and (-G1, sig); the batch paths once over N
// or 128 lanes and once on the tail's one lane).  The formulas are those
// of lodestar_tpu/kernels/pairing.py, so the twelve output planes equal
// the JAX kernel's values as canonical integers.
//
// One warp per lane (csrc/warp12.cuh): the lane's accumulator, T, the
// pending line and the temporaries are shared-memory slots, and the 63
// doubling and 5 addition steps, each with its Fp12 square and sparse
// line product, run as rounds of up to 32 independent Fp products, one per
// thread (7,834 products in 275 rounds; warp_prog.cuh).  A bit's
// segment finishes its accumulator update while it makes the next bit's
// line, so the two chains of products overlap.
//
// Bound on this card: 32-bit integer multiplies, 7,834 Fp products per
// lane (588 multiply instructions each), bytes negligible (1 KB per lane).
// One thread per lane ran them as one dependent chain (~1.75 us each);
// here a round costs about one product's latency and the adds between
// rounds about as much again, whatever the lane count: a lane is one warp
// on one of the SM's four schedulers, four lanes to a block.
#define LT_WANT_MILLER
#include "pairing.cuh"

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_miller_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ q,
                     int32_t *__restrict__ f, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_MILLER_SLOTS, LT_MILLER_CONSTS, LT_MILLER_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) miller_warp(m, p, q, f, n, lane);
}

extern "C" int lt_miller_loop(const void *p, const void *q, void *f, int n, void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("miller_loop", n, LT_MILLER_SLOTS, LT_MILLER_CONSTS, LT_MILLER_PHASES, LT_MILLER_ROUNDS);
    cudaFuncSetAttribute(lt_miller_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_miller_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)p, (const int32_t *)q, (int32_t *)f, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_miller_loop(const void *p, const void *q, void *f, int n, void *stream) {
  (void)stream;
  const wlaunch l = w_launch("miller_loop", n, LT_MILLER_SLOTS, LT_MILLER_CONSTS, LT_MILLER_PHASES, LT_MILLER_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {  // warp lane % LT_LPB of block lane / LT_LPB
    const wmem m = w_block(sm, LT_MILLER_SLOTS, LT_MILLER_CONSTS, LT_MILLER_CONST, lane % LT_LPB);
    miller_warp(m, (const int32_t *)p, (const int32_t *)q, (int32_t *)f, n, lane);
  }
  free(sm);
  return 0;
}

#endif
