// K4: per-lane f1 * f2 -> (dead lanes -> 1) -> final exponentiation -> is-one.
//
// Replaces lodestar_tpu/kernels/verify.py _k_each_final (the per-set
// verdict), keeping the JAX package's cube: f^(3 (p^12 - 1) / r).
//
// One warp per lane (csrc/warp12.cuh), the program of warp_prog.cuh:
// the product f1 f2 and the easy part (one Fp12 inversion, whose one Fp
// inversion is the variable-time binary GCD fp_inv_var on one thread
// instead of the ~608-product Fermat chain), then the hard part's five powers by |x|,
// each 63 cyclotomic squarings (one round of 18 Fp products each) and 5
// Fp12 products (two rounds each): 7,730 Fp products in 396 rounds.
//
// Bound on this card: 32-bit integer multiplies, 7,730 Fp products per
// lane (588 multiply instructions each); its inputs are 1.2 KB per lane
// and its output one word.  A lane's time is its rounds' latencies, about
// one product's each, plus the linear phases and the inversion on one thread.
#define LT_WANT_FINAL
#include "pairing.cuh"

// live: [n] int32; f1, f2: [12, 12, n]; ok: [n] int32
LT_DEV void each_final_warp(const wmem &m, const int32_t *live, const int32_t *f1, const int32_t *f2,
                            int32_t *ok, int n, int lane) {
  if (live[lane] != 0) {
    w_load_planes(m, LT_FINAL_A, f1, 12, n, lane);
    w_load_planes(m, LT_FINAL_B, f2, 12, n, lane);
  } else {  // dead lanes -> 1 -> pass
    w_load_one12(m, LT_FINAL_A);
    w_load_one12(m, LT_FINAL_B);
  }
  const bool one = final_warp_is_one(m);
  if (LT_T0 == 0) ok[lane] = one ? 1 : 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_WARP * LT_LPB)
    lt_each_final_kernel(const int32_t *__restrict__ live, const int32_t *__restrict__ f1,
                         const int32_t *__restrict__ f2, int32_t *__restrict__ ok, int n) {
  extern __shared__ uint32_t lt_sm[];
  const int warp = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_CONST, warp);
  const int lane = blockIdx.x * LT_LPB + warp;
  if (lane < n) each_final_warp(m, live, f1, f2, ok, n, lane);
}

extern "C" int lt_each_final(const void *live, const void *f1, const void *f2, void *ok, int n,
                             void *stream) {
  if (n > 0) {
    const wlaunch l = w_launch("each_final", n, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_PHASES, LT_FINAL_ROUNDS);
    cudaFuncSetAttribute(lt_each_final_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    lt_each_final_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const int32_t *)live, (const int32_t *)f1, (const int32_t *)f2, (int32_t *)ok, n);
  }
  return (int)cudaGetLastError();
}

#else

#include <stdlib.h>

extern "C" int lt_each_final(const void *live, const void *f1, const void *f2, void *ok, int n,
                             void *stream) {
  (void)stream;
  const wlaunch l = w_launch("each_final", n, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_PHASES, LT_FINAL_ROUNDS);
  uint32_t *sm = (uint32_t *)malloc(l.smem);
  for (int lane = 0; lane < n; lane++) {
    const wmem m = w_block(sm, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_CONST, lane % LT_LPB);
    each_final_warp(m, (const int32_t *)live, (const int32_t *)f1, (const int32_t *)f2, (int32_t *)ok, n,
                    lane);
  }
  free(sm);
  return 0;
}

// host build only, for the tests: the final exponentiation's value,
// f^(3 (p^12 - 1) / r) for f: [12, 12, n] -> r: [12, 12, n]
extern "C" int lt_host_final_exp(const void *f, void *r, int n) {
  uint32_t *sm = (uint32_t *)malloc(w_smem_bytes(LT_FINAL_SLOTS, LT_FINAL_CONSTS));
  for (int lane = 0; lane < n; lane++) {
    const wmem m = w_block(sm, LT_FINAL_SLOTS, LT_FINAL_CONSTS, LT_FINAL_CONST, lane % LT_LPB);
    w_load_planes(m, LT_FINAL_A, (const int32_t *)f, 12, n, lane);
    w_load_one12(m, LT_FINAL_B);
    final_warp_is_one(m);
    for (int i = 0; i < 12 * LT_NL; i++)
      ((int32_t *)r)[(size_t)i * n + lane] = (int32_t)m.sm[(i % LT_NL) * m.cols + m.base + LT_FINAL_OUT + i / LT_NL];
  }
  free(sm);
  return 0;
}

// the programs' inversion (the binary GCD's plain inverse of the canonical
// integer, then times R^3) and the Fermat inversion fp_inv, on planes
// [12, n] of Montgomery values
extern "C" int lt_host_fp_inv_var(const void *a, void *r, int n) {
  fp r3;
  for (int i = 0; i < LT_NL; i++) r3.w[i] = LT_FINAL_CONST[LT_FINAL_R3][i];
  for (int lane = 0; lane < n; lane++) {
    fp x, y;
    fp_load(x, (const int32_t *)a, n, lane);
    fp_inv_var(y, x);
    fp_mont_mul(x, y, r3);
    fp_store((int32_t *)r, n, lane, x);
  }
  return 0;
}

extern "C" int lt_host_fp_inv(const void *a, void *r, int n) {
  for (int lane = 0; lane < n; lane++) {
    fp x, y;
    fp_load(x, (const int32_t *)a, n, lane);
    fp_inv(y, x);
    fp_store((int32_t *)r, n, lane, y);
  }
  return 0;
}

#endif
