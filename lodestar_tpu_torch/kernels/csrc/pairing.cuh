// Optimal ate pairing on the warp engine: the Miller loop and the final
// exponentiation, one warp per lane (csrc/warp12.cuh).
//
// The programs (warp_prog.cuh, generated) are the per-thread engine's formulas
// (csrc/tower.cuh, after lodestar_tpu/kernels/pairing.py's doubling and
// addition steps, line scalings and final-exponentiation chain) packed
// into rounds of up to 32 Fp products by kernels/warp_schedule.py.  Every
// value is canonical, so the Miller value equals the JAX package's and the
// plain torch engine's as canonical Fp12 integers whatever the schedule.
#pragma once

#include "warp12.cuh"

// The twelve slots from `slot` set to one (dead or infinity lanes).
LT_DEV void w_load_one12(const wmem &m, int slot) {
  for (int i = LT_T0; i < 12 * LT_NL; i += LT_TSTEP)
    m.sm[(i % LT_NL) * m.cols + m.base + slot + i / LT_NL] = i < LT_NL ? LT_ONE[i] : 0u;
}

#ifdef LT_WANT_MILLER
// f_{|x|,Q}(P) conjugated (x < 0), P Jacobian and not O, Q affine and not
// O.  p: planes [3, 12, n] (X, Y, Z); q: [2, 2, 12, n]; f: [12, 12, n] in
// the JAX package's leaf order.
LT_DEV void miller_warp(const wmem &m, const int32_t *p, const int32_t *q, int32_t *f, int n, int lane) {
  w_load_planes(m, LT_MILLER_P, p, 3, n, lane);
  w_load_planes(m, LT_MILLER_Q, q, 4, n, lane);
  LT_SYNCWARP();
  w_run(m, LT_MILLER_PHASE, LT_MILLER_PHASES, LT_MILLER_INS);
  w_store_planes(m, LT_MILLER_F, f, 12, n, lane);
}
#endif

#ifdef LT_WANT_FINAL
// (A B)^(3 (p^12 - 1) / r) == 1 for A, B already in the slots LT_FINAL_A
// and LT_FINAL_B: the JAX package's cube of the final exponentiation.
LT_DEV bool final_warp_is_one(const wmem &m) {
  LT_SYNCWARP();
  w_run(m, LT_FINAL_PHASE, LT_FINAL_PHASES, LT_FINAL_INS);
  uint32_t diff = 0;
  for (int i = LT_T0; i < 12 * LT_NL; i += LT_TSTEP)
    diff |= m.sm[(i % LT_NL) * m.cols + m.base + LT_FINAL_OUT + i / LT_NL] ^ (i < LT_NL ? LT_ONE[i] : 0u);
#ifdef __CUDACC__
  return !__any_sync(0xffffffffu, diff != 0);
#else
  return diff == 0;
#endif
}
#endif
