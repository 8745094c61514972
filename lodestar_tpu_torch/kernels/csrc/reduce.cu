// K7 and K8: the RLC batch's lane reductions.
//
//   lt_sum_g2  Jacobian G2 sum of the lanes not excluded (replaces
//              lodestar_tpu/kernels/verify.py _k_sum_g2 and the butterfly
//              after it, _j_sum_lanes / curve.py sum_points_lanes)
//   lt_prod12  Fp12 product of the live lanes (replaces _k_prod and
//              _j_product12 / pairing.py product12_lanes)
//
// The TPU kernels carry a running value from one grid step to the next;
// CUDA blocks run in no order, so each reduction is ONE block of 128
// threads.  Thread j folds lanes j, j + 128, j + 256, ... in sequence, then
// the threads combine slots j and j + s for s = 64, 32, .., 1 through a
// global scratch buffer of 128 slots, with __syncthreads() between rounds;
// slot 0 is the result.  At N lanes that is max(N, 128) - 1 combines,
// N / 128 - 1 + 7 of them in sequence.  Slots beyond N start as the
// neutral element (the point at infinity with zero coordinates, the Fp12
// one).  kernels/curve.py sum_points_lanes and kernels/pairing.py
// product12_lanes run the same order, so the Jacobian sum (whose
// coordinates depend on the order) equals the plain version bit for bit.
//
// Bound on this card: one block uses one SM, so the chain of 7 + N / 128 - 1
// dependent combines (60 Fp products per complete G2 addition, 54 per
// Fp12 product) bounds it at the main path's sizes; the card-wide IMAD
// bound counts all N - 1 combines at what the function needs (44 per G2
// addition: the doubling beside it is never selected for distinct points).  Bytes: N lanes of 288 B (G2) or 576 B (Fp12).
#include "curve.cuh"

#define LT_RED_THREADS 128

// G2 Jacobian planes [3, 2, 12, stride]: coordinate c of slot j
LT_DEV void g2j_load(jac<fp2> &r, const int32_t *base, int stride, int j) {
  fp2_load(r.x, base, stride, j);
  fp2_load(r.y, base + 2 * LT_NL * stride, stride, j);
  fp2_load(r.z, base + 4 * LT_NL * stride, stride, j);
}

LT_DEV void g2j_store(int32_t *base, int stride, int j, const jac<fp2> &a) {
  fp2_store(base, stride, j, a.x);
  fp2_store(base + 2 * LT_NL * stride, stride, j, a.y);
  fp2_store(base + 4 * LT_NL * stride, stride, j, a.z);
}

// pts: [3, 2, 12, n]; excl: [n]; scr: [3, 2, 12, 128]; scr_inf: [128]
LT_DEV void sum_g2_fold(const int32_t *pts, const int32_t *excl, int32_t *scr,
                        int32_t *scr_inf, int n, int j) {
  jac<fp2> acc;
  bool inf = true;
  if (j < n) {
    g2j_load(acc, pts, n, j);
    inf = excl[j] != 0;
  } else {
    fp2_zero(acc.x);
    fp2_zero(acc.y);
    fp2_zero(acc.z);
  }
  for (int i = j + LT_RED_THREADS; i < n; i += LT_RED_THREADS) {
    jac<fp2> p;
    g2j_load(p, pts, n, i);
    jac_add_full(acc, inf, acc, inf, p, excl[i] != 0);
  }
  g2j_store(scr, LT_RED_THREADS, j, acc);
  scr_inf[j] = inf ? 1 : 0;
}

// slot j <- slot j + slot j + s
LT_DEV void sum_g2_round(int32_t *scr, int32_t *scr_inf, int s, int j) {
  jac<fp2> a, b;
  g2j_load(a, scr, LT_RED_THREADS, j);
  g2j_load(b, scr, LT_RED_THREADS, j + s);
  bool inf;
  jac_add_full(a, inf, a, scr_inf[j] != 0, b, scr_inf[j + s] != 0);
  g2j_store(scr, LT_RED_THREADS, j, a);
  scr_inf[j] = inf ? 1 : 0;
}

// live: [n]; f: [12, 12, n]; scr: [12, 12, 128]
LT_DEV void prod12_fold(const int32_t *live, const int32_t *f, int32_t *scr, int n, int j) {
  fp12 acc, b, one;
  fp12_one(one);
  acc = one;
  if (j < n) {
    fp12_load(b, f, n, j);
    fp12_select(acc, live[j] != 0, b, one);
  }
  for (int i = j + LT_RED_THREADS; i < n; i += LT_RED_THREADS) {
    fp12_load(b, f, n, i);
    fp12_select(b, live[i] != 0, b, one);
    fp12_mul(acc, acc, b);
  }
  fp12_store(scr, LT_RED_THREADS, j, acc);
}

LT_DEV void prod12_round(int32_t *scr, int s, int j) {
  fp12 a, b;
  fp12_load(a, scr, LT_RED_THREADS, j);
  fp12_load(b, scr, LT_RED_THREADS, j + s);
  fp12_mul(a, a, b);
  fp12_store(scr, LT_RED_THREADS, j, a);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_RED_THREADS)
    lt_sum_g2_kernel(const int32_t *__restrict__ pts, const int32_t *__restrict__ excl,
                     int32_t *scr, int32_t *scr_inf, int n) {
  const int j = threadIdx.x;
  sum_g2_fold(pts, excl, scr, scr_inf, n, j);
  for (int s = LT_RED_THREADS / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (j < s) sum_g2_round(scr, scr_inf, s, j);
  }
}

__global__ void __launch_bounds__(LT_RED_THREADS)
    lt_prod12_kernel(const int32_t *__restrict__ live, const int32_t *__restrict__ f,
                     int32_t *scr, int n) {
  const int j = threadIdx.x;
  prod12_fold(live, f, scr, n, j);
  for (int s = LT_RED_THREADS / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (j < s) prod12_round(scr, s, j);
  }
}

// the result is slot 0 of scr (and scr_inf)
extern "C" int lt_sum_g2(const void *pts, const void *excl, void *scr, void *scr_inf, int n,
                         void *stream) {
  lt_sum_g2_kernel<<<1, LT_RED_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t *)pts, (const int32_t *)excl, (int32_t *)scr, (int32_t *)scr_inf, n);
  return (int)cudaGetLastError();
}

extern "C" int lt_prod12(const void *live, const void *f, void *scr, int n, void *stream) {
  lt_prod12_kernel<<<1, LT_RED_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t *)live, (const int32_t *)f, (int32_t *)scr, n);
  return (int)cudaGetLastError();
}

#else  // host build: the threads of each phase one after another

extern "C" int lt_sum_g2(const void *pts, const void *excl, void *scr, void *scr_inf, int n,
                         void *stream) {
  (void)stream;
  for (int j = 0; j < LT_RED_THREADS; j++)
    sum_g2_fold((const int32_t *)pts, (const int32_t *)excl, (int32_t *)scr,
                (int32_t *)scr_inf, n, j);
  for (int s = LT_RED_THREADS / 2; s >= 1; s >>= 1)
    for (int j = 0; j < s; j++) sum_g2_round((int32_t *)scr, (int32_t *)scr_inf, s, j);
  return 0;
}

extern "C" int lt_prod12(const void *live, const void *f, void *scr, int n, void *stream) {
  (void)stream;
  for (int j = 0; j < LT_RED_THREADS; j++)
    prod12_fold((const int32_t *)live, (const int32_t *)f, (int32_t *)scr, n, j);
  for (int s = LT_RED_THREADS / 2; s >= 1; s >>= 1)
    for (int j = 0; j < s; j++) prod12_round((int32_t *)scr, s, j);
  return 0;
}

#endif
