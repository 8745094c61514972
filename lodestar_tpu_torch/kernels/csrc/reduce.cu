// K7 and K8: the RLC batch's lane reductions.
//
//   lt_sum_g2  Jacobian G2 sum of the lanes not excluded (replaces
//              lodestar_tpu/kernels/verify.py _k_sum_g2 and the butterfly
//              after it, _j_sum_lanes / curve.py sum_points_lanes)
//   lt_prod12  Fp12 product of the live lanes (replaces _k_prod and
//              _j_product12 / pairing.py product12_lanes)
//
// lt_sum_g2 adds the lanes as a pairwise tree over the lane index: level 1
// adds lanes 2i and 2i + 1, each later level the previous level's results
// in the same way, an odd last element passing up unchanged.
// kernels/curve.py sum_points_lanes runs the same tree, so the Jacobian
// sum (whose coordinates depend on the order) equals the plain version bit
// for bit.  One warp makes one complete addition on the warp engine
// (csrc/warp12.cuh; warp_schedule.sumg2_program: P + Q with 2P beside it
// and the H and R of the addition, 60 Fp products in 5 rounds) and makes
// jac_add_full's selects (csrc/curve.cuh) on warp-wide votes.  A block of
// LT_SUM_WARPS warps reduces LT_SUM_SPAN consecutive elements through its
// levels, meeting at __syncthreads() between them, and writes one partial;
// the C entry point launches the kernel again on the partials until one is
// left (2 launches at N = 512, 3 at N = 2048).  The TPU kernel carried its
// sum from one grid step to the next; CUDA blocks run in no order, so the
// partials go through device memory between launches.  A span of 2^5
// elements keeps the blocks' trees the global tree's first five levels.
//
// lt_prod12 is ONE block of 128 threads: thread j folds lanes j, j + 128,
// ... in sequence, then the threads combine slots j and j + s for s = 64,
// 32, .., 1 through a global scratch buffer of 128 slots, with
// __syncthreads() between rounds; slot 0 is the result.  At N lanes that
// is max(N, 128) - 1 products, N / 128 - 1 + 7 of them in sequence.  Slots
// beyond N start as the Fp12 one.  kernels/pairing.py product12_lanes runs
// the same order.
//
// Bound on this card: the card-wide IMAD bound counts the N - 1 combines at
// what the function needs (44 Fp products per G2 addition: the doubling
// beside it is never selected for distinct points; 54 per Fp12 product).
// Bytes: N lanes of 292 B (G2) or 580 B (Fp12).  The sum's time is its
// log2(N) levels of one addition's rounds (the elements of a level add in
// parallel) and its launches; the product's is one block's chain of 7 +
// N / 128 - 1 Fp12 products.
#define LT_WANT_SUMG2
#include "tower.cuh"
#include "warp12.cuh"

#define LT_SUM_WARPS 16                 // warps (additions at once) per block
#define LT_SUM_SPAN (2 * LT_SUM_WARPS)  // elements one block reduces
#define LT_RED_THREADS 128

// The block's tree elements' infinity flags beside the warps' slots: warp
// w's element of a level in its RES register of the level's parity.
struct sumblk {
  int32_t inf[2][LT_SUM_WARPS];
};

LT_DEV int sum_res(int lvl) { return lvl & 1 ? LT_SUMG2_RES1 : LT_SUMG2_RES0; }

// Element e of level lvl of the block's tree into the warp's slots from
// dst; returns its infinity flag.  Level 0 is input lane base + e of
// planes [6, 12, n]; a later level's element e is warp e's RES register.
LT_DEV bool sum_fetch(const wmem &m, const sumblk &b, const int32_t *in, const int32_t *in_inf, int n, int base,
                      int lvl, int e, int dst) {
  if (lvl == 0) {
    w_load_planes(m, dst, in, 6, n, base + e);
    LT_SYNCWARP();
    return in_inf[base + e] != 0;
  }
  w_copy_cols(m, dst, e * m.slots + sum_res(lvl), 6);
  return b.inf[lvl & 1][e] != 0;
}

// Warp w's part of level lvl (cnt elements): elements 2w and 2w + 1 added
// into its RES register of the next level, or element 2w passed up when it
// is the odd last one.  The selects are jac_add_full's: 2P where H = R = 0,
// Q where P is infinity, P where Q is.
LT_DEV void sum_level(const wmem &m, sumblk &b, const int32_t *in, const int32_t *in_inf, int n, int base, int lvl,
                      int cnt, int w) {
  const int nxt = (lvl + 1) & 1, res = sum_res(lvl + 1);
  if (2 * w + 1 < cnt) {
    const bool p_inf = sum_fetch(m, b, in, in_inf, n, base, lvl, 2 * w, LT_SUMG2_P);
    const bool q_inf = sum_fetch(m, b, in, in_inf, n, base, lvl, 2 * w + 1, LT_SUMG2_Q);
    w_run(m, LT_SUMG2_PHASE, LT_SUMG2_PHASES, LT_SUMG2_INS);
    const bool h_zero = w_eq(m, LT_SUMG2_H, -1, 2), r_zero = w_eq(m, LT_SUMG2_R, -1, 2);
    const int src = p_inf ? LT_SUMG2_Q : q_inf ? LT_SUMG2_P : h_zero && r_zero ? LT_SUMG2_DBL : LT_SUMG2_S;
    w_copy(m, res, src, 6);
    if (LT_T0 == 0) b.inf[nxt][w] = (p_inf && q_inf) || (h_zero && !r_zero && !p_inf && !q_inf);
  } else if (2 * w + 1 == cnt) {
    const bool inf = sum_fetch(m, b, in, in_inf, n, base, lvl, 2 * w, res);
    if (LT_T0 == 0) b.inf[nxt][w] = inf;
  }
}

// Warp 0 after the block's last level: its element (the block's one
// input lane where it had one) into out [6, 12, nb] and out_inf [nb] at blk.
LT_DEV void sum_result(const wmem &m, sumblk &b, const int32_t *in, const int32_t *in_inf, int n, int base, int lvl,
                       int32_t *out, int32_t *out_inf, int nb, int blk) {
  const bool inf = lvl == 0 ? sum_fetch(m, b, in, in_inf, n, base, 0, 0, sum_res(0)) : b.inf[lvl & 1][0] != 0;
  w_store_planes(m, sum_res(lvl), out, 6, nb, blk);
  if (LT_T0 == 0) out_inf[blk] = inf ? 1 : 0;
}

LT_DEV int sum_chunk(int n, int blk) {
  return n - blk * LT_SUM_SPAN < LT_SUM_SPAN ? n - blk * LT_SUM_SPAN : LT_SUM_SPAN;
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

__global__ void __launch_bounds__(LT_WARP * LT_SUM_WARPS)
    lt_sum_g2_kernel(const int32_t *__restrict__ in, const int32_t *__restrict__ in_inf, int n,
                     int32_t *__restrict__ out, int32_t *__restrict__ out_inf, int nb) {
  extern __shared__ uint32_t lt_sm[];
  __shared__ sumblk b;
  const int w = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, LT_SUMG2_SLOTS, LT_SUMG2_CONSTS, LT_SUMG2_CONST, w, LT_SUM_WARPS);
  const int base = blockIdx.x * LT_SUM_SPAN;
  int cnt = sum_chunk(n, blockIdx.x), lvl = 0;
  for (; cnt > 1; cnt = (cnt + 1) / 2, lvl++) {
    sum_level(m, b, in, in_inf, n, base, lvl, cnt, w);
    __syncthreads();
  }
  if (w == 0) sum_result(m, b, in, in_inf, n, base, lvl, out, out_inf, nb, blockIdx.x);
}

static int sum_launch(const int32_t *in, const int32_t *in_inf, int n, int32_t *out, int32_t *out_inf, int nb,
                      size_t smem, void *stream) {
  lt_sum_g2_kernel<<<nb, LT_WARP * LT_SUM_WARPS, smem, (cudaStream_t)stream>>>(in, in_inf, n, out, out_inf, nb);
  return (int)cudaGetLastError();
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

extern "C" int lt_prod12(const void *live, const void *f, void *scr, int n, void *stream) {
  lt_prod12_kernel<<<1, LT_RED_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t *)live, (const int32_t *)f, (int32_t *)scr, n);
  return (int)cudaGetLastError();
}

#else  // host build: the threads of each phase one after another

#include <stdlib.h>

// a block's warps one after another at each level, forwards or reversed
// (common.cuh lt_host_warp_order), as virtual threads are in a warp
static int sum_launch(const int32_t *in, const int32_t *in_inf, int n, int32_t *out, int32_t *out_inf, int nb,
                      size_t smem, void *stream) {
  (void)stream;
  uint32_t *sm = (uint32_t *)malloc(smem);
  for (int blk = 0; blk < nb; blk++) {
    sumblk b;
    const int base = blk * LT_SUM_SPAN;
    int cnt = sum_chunk(n, blk), lvl = 0;
    for (; cnt > 1; cnt = (cnt + 1) / 2, lvl++)
      for (int j = 0; j < LT_SUM_WARPS; j++) {
        const int w = lt_host_rev ? LT_SUM_WARPS - 1 - j : j;
        const wmem m = w_block(sm, LT_SUMG2_SLOTS, LT_SUMG2_CONSTS, LT_SUMG2_CONST, w, LT_SUM_WARPS);
        sum_level(m, b, in, in_inf, n, base, lvl, cnt, w);
      }
    const wmem m = w_block(sm, LT_SUMG2_SLOTS, LT_SUMG2_CONSTS, LT_SUMG2_CONST, 0, LT_SUM_WARPS);
    sum_result(m, b, in, in_inf, n, base, lvl, out, out_inf, nb, blk);
  }
  free(sm);
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

// Lanes of lt_sum_g2's partials buffer at n lanes: the first launch's
// partials, then the second's (the launches after them alternate between
// the two ranges).
extern "C" int lt_sum_g2_scratch_lanes(int n) {
  const int nb1 = (n + LT_SUM_SPAN - 1) / LT_SUM_SPAN;
  return nb1 + (nb1 + LT_SUM_SPAN - 1) / LT_SUM_SPAN;
}

// pts: Jacobian planes [3, 2, 12, n]; excl: [n]; out: [3, 2, 12, 1] and
// out_inf [1] the sum and its flag.  scr and scr_inf hold the partials of
// the launches before the last (lt_sum_g2_scratch_lanes(n) lanes), the
// even launches' partials from lane 0 and the odd ones' after the first
// launch's.  *launches is set to the number of kernel launches made.
extern "C" int lt_sum_g2(const void *pts, const void *excl, void *scr, void *scr_inf, void *out, void *out_inf,
                         int n, int *launches, void *stream) {
  *launches = 0;
  if (n <= 0) return 0;
  const size_t smem = w_smem_bytes(LT_SUMG2_SLOTS, LT_SUMG2_CONSTS, LT_SUM_WARPS);
  const int nb1 = (n + LT_SUM_SPAN - 1) / LT_SUM_SPAN;
  const int shape[8] = {n, nb1, LT_WARP * LT_SUM_WARPS, LT_SUM_SPAN, (int)smem, LT_SUMG2_SLOTS, LT_SUMG2_PHASES,
                        LT_SUMG2_ROUNDS};
  w_record("sum_g2", shape);
#ifdef __CUDACC__
  cudaFuncSetAttribute(lt_sum_g2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
#endif
  const int32_t *in = (const int32_t *)pts, *in_inf = (const int32_t *)excl;
  for (int k = 0, cnt = n;; k++) {
    const int nb = (cnt + LT_SUM_SPAN - 1) / LT_SUM_SPAN;
    int32_t *o = nb == 1 ? (int32_t *)out : (int32_t *)scr + (k & 1 ? 6 * LT_NL * nb1 : 0);
    int32_t *oi = nb == 1 ? (int32_t *)out_inf : (int32_t *)scr_inf + (k & 1 ? nb1 : 0);
    const int err = sum_launch(in, in_inf, cnt, o, oi, nb, smem, stream);
    ++*launches;
    if (err != 0 || nb == 1) return err;
    in = o;
    in_inf = oi;
    cnt = nb;
  }
}
