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
// LT_TREE_WARPS warps reduces LT_TREE_SPAN consecutive elements through its
// levels, meeting at __syncthreads() between them, and writes one partial;
// the C entry point launches the kernel again on the partials until one is
// left (2 launches at N = 512, 3 at N = 2048).  The TPU kernel carried its
// sum from one grid step to the next; CUDA blocks run in no order, so the
// partials go through device memory between launches.  A span of 2^5
// elements keeps the blocks' trees the global tree's first five levels.
//
// lt_prod12 runs the same pairwise tree over the lanes, one warp per Fp12
// product (warp_schedule.prod12_program: Tower.mul12, 54 independent Fp
// products in 2 rounds), the same blocks and the same relaunches on the
// partials.  A dead lane enters as the Fp12 one.  Fp12 values are
// canonical, so the product equals the plain version's
// (kernels/pairing.py product12_lanes) in any order.  Both trees are one
// kernel template, host launcher and relaunch loop (tree_reduce) over a
// combine policy (sum_tree, prod_tree): its program, the planes of an
// element, a level's combines and the block's result.
//
// Bound on this card: the card-wide IMAD bound counts the N - 1 combines at
// what the function needs (44 Fp products per G2 addition: the doubling
// beside it is never selected for distinct points; 54 per Fp12 product).
// Bytes: N lanes of 292 B (G2) or 580 B (Fp12).  Each reduction's time is
// its log2(N) levels of one combine's rounds (the elements of a level
// combine in parallel) and its launches.
#define LT_WANT_SUMG2
#define LT_WANT_PROD12
#include "warp12.cuh"

#define LT_TREE_WARPS 16                 // warps (combines at once) per block
#define LT_TREE_SPAN (2 * LT_TREE_WARPS)  // elements one block reduces

// One launch of a tree (host side): n elements of `in` (with the
// policy's per-lane flags where flag is given) reduced by nb blocks into
// out (and out_flag where given) [.., nb].  The device code takes the
// pointers one by one.
struct tree_io {
  const int32_t *in, *flag;
  int32_t *out, *out_flag;
  int n, nb;
};

// blocks of a launch over n elements (the host's launch plan)
static inline int tree_blocks(int n) { return (n + LT_TREE_SPAN - 1) / LT_TREE_SPAN; }

LT_DEV int tree_chunk(int n, int blk) {
  return n - blk * LT_TREE_SPAN < LT_TREE_SPAN ? n - blk * LT_TREE_SPAN : LT_TREE_SPAN;
}

// A combine policy: its program's shape, the planes of one element, the
// block's state beside the warps' slots (blk), and, as overloads on the
// policy, tree_consts (the program's constants), tree_level (warp w's
// part of level lvl of the block's tree, cnt elements, over input lanes
// base.. of in [.., n] and flag: elements 2w and 2w + 1 combined into its
// RES register of the next level, or element 2w passed up when it is the
// odd last one) and tree_result (warp 0 after the block's last level: its
// element, the block's one input lane where it had one, into out [.., nb]
// and out_flag at blk).

// sum_g2: flag is the input's exclusion (level 0) or infinity (partials);
// the block's tree elements' infinity flags beside the warps' slots: warp
// w's element of a level in its RES register of the level's parity.
struct sum_tree {
  enum { slots = LT_SUMG2_SLOTS, consts = LT_SUMG2_CONSTS, phases = LT_SUMG2_PHASES, rounds = LT_SUMG2_ROUNDS,
         planes = 6 };
  struct blk {
    int32_t inf[2][LT_TREE_WARPS];
  };
};

LT_DEV const uint32_t (*tree_consts(sum_tree))[LT_NL] { return LT_SUMG2_CONST; }

LT_DEV int sum_res(int lvl) { return lvl & 1 ? LT_SUMG2_RES1 : LT_SUMG2_RES0; }

// Element e of level lvl of the block's tree into the warp's slots from
// dst; returns its infinity flag.  Level 0 is input lane base + e of
// planes [6, 12, n]; a later level's element e is warp e's RES register.
LT_DEV bool sum_fetch(const wmem &m, const sum_tree::blk &b, const int32_t *in, const int32_t *flag, int n,
                      int base, int lvl, int e, int dst) {
  if (lvl == 0) {
    w_load_planes(m, dst, in, 6, n, base + e);
    LT_SYNCWARP();
    return flag[base + e] != 0;
  }
  w_copy_cols(m, dst, e * m.slots + sum_res(lvl), 6);
  return b.inf[lvl & 1][e] != 0;
}

// The selects are jac_add_full's: 2P where H = R = 0, Q where P is
// infinity, P where Q is.
LT_DEV void tree_level(sum_tree, const wmem &m, sum_tree::blk &b, const int32_t *in, const int32_t *flag, int n,
                       int base, int lvl, int cnt, int w) {
  const int nxt = (lvl + 1) & 1, res = sum_res(lvl + 1);
  if (2 * w + 1 < cnt) {
    const bool p_inf = sum_fetch(m, b, in, flag, n, base, lvl, 2 * w, LT_SUMG2_P);
    const bool q_inf = sum_fetch(m, b, in, flag, n, base, lvl, 2 * w + 1, LT_SUMG2_Q);
    w_run(m, LT_SUMG2_PHASE, LT_SUMG2_PHASES, LT_SUMG2_INS);
    const bool h_zero = w_eq(m, LT_SUMG2_H, -1, 2), r_zero = w_eq(m, LT_SUMG2_R, -1, 2);
    const int src = p_inf ? LT_SUMG2_Q : q_inf ? LT_SUMG2_P : h_zero && r_zero ? LT_SUMG2_DBL : LT_SUMG2_S;
    w_copy(m, res, src, 6);
    if (LT_T0 == 0) b.inf[nxt][w] = (p_inf && q_inf) || (h_zero && !r_zero && !p_inf && !q_inf);
  } else if (2 * w + 1 == cnt) {
    const bool inf = sum_fetch(m, b, in, flag, n, base, lvl, 2 * w, res);
    if (LT_T0 == 0) b.inf[nxt][w] = inf;
  }
}

LT_DEV void tree_result(sum_tree, const wmem &m, sum_tree::blk &b, const int32_t *in, const int32_t *flag, int n,
                        int base, int lvl, int32_t *out, int32_t *out_flag, int nb, int blk) {
  const bool inf = lvl == 0 ? sum_fetch(m, b, in, flag, n, base, 0, 0, sum_res(0)) : b.inf[lvl & 1][0] != 0;
  w_store_planes(m, sum_res(lvl), out, 6, nb, blk);
  if (LT_T0 == 0) out_flag[blk] = inf ? 1 : 0;
}

// prod12: flag is the input's live row (level 0 of the first launch; the
// partials are products of live lanes and have none); no block state.
struct prod_tree {
  enum { slots = LT_PROD12_SLOTS, consts = LT_PROD12_CONSTS, phases = LT_PROD12_PHASES,
         rounds = LT_PROD12_ROUNDS, planes = 12 };
  struct blk {};
};

LT_DEV const uint32_t (*tree_consts(prod_tree))[LT_NL] { return LT_PROD12_CONST; }

LT_DEV int prod_res(int lvl) { return lvl & 1 ? LT_PROD12_RES1 : LT_PROD12_RES0; }

// Element e of level lvl into the warp's slots from dst.  Level 0 is input
// lane base + e of planes [12, 12, n] (the Fp12 one where the live row is
// given and 0 there); a later level's element e is warp e's RES register.
LT_DEV void prod_fetch(const wmem &m, const int32_t *in, const int32_t *flag, int n, int base, int lvl, int e,
                       int dst) {
  if (lvl > 0) {
    w_copy_cols(m, dst, e * m.slots + prod_res(lvl), 12);
  } else if (flag && flag[base + e] == 0) {
    w_zero(m, dst + 1, 11);
    w_copy_cols(m, dst, m.cbase + LT_PROD12_ONE, 1);
  } else {
    w_load_planes(m, dst, in, 12, n, base + e);
    LT_SYNCWARP();
  }
}

LT_DEV void tree_level(prod_tree, const wmem &m, prod_tree::blk &, const int32_t *in, const int32_t *flag, int n,
                       int base, int lvl, int cnt, int w) {
  const int res = prod_res(lvl + 1);
  if (2 * w + 1 < cnt) {
    prod_fetch(m, in, flag, n, base, lvl, 2 * w, LT_PROD12_A);
    prod_fetch(m, in, flag, n, base, lvl, 2 * w + 1, LT_PROD12_B);
    w_run(m, LT_PROD12_PHASE, LT_PROD12_PHASES, LT_PROD12_INS);
    w_copy(m, res, LT_PROD12_C, 12);
  } else if (2 * w + 1 == cnt) {
    prod_fetch(m, in, flag, n, base, lvl, 2 * w, res);
  }
}

LT_DEV void tree_result(prod_tree, const wmem &m, prod_tree::blk &, const int32_t *in, const int32_t *flag, int n,
                        int base, int lvl, int32_t *out, int32_t *, int nb, int blk) {
  if (lvl == 0) prod_fetch(m, in, flag, n, base, 0, 0, prod_res(0));
  w_store_planes(m, prod_res(lvl), out, 12, nb, blk);
}

#ifdef __CUDACC__

template <class T>
__global__ void __launch_bounds__(LT_WARP * LT_TREE_WARPS)
    lt_tree_kernel(const int32_t *__restrict__ in, const int32_t *__restrict__ flag, int n,
                   int32_t *__restrict__ out, int32_t *__restrict__ out_flag, int nb) {
  extern __shared__ uint32_t lt_sm[];
  __shared__ typename T::blk b;
  const int w = threadIdx.x / LT_WARP;
  const wmem m = w_block(lt_sm, T::slots, T::consts, tree_consts(T{}), w, LT_TREE_WARPS);
  const int base = blockIdx.x * LT_TREE_SPAN;
  int cnt = tree_chunk(n, blockIdx.x), lvl = 0;
  for (; cnt > 1; cnt = (cnt + 1) / 2, lvl++) {
    tree_level(T{}, m, b, in, flag, n, base, lvl, cnt, w);
    __syncthreads();
  }
  if (w == 0) tree_result(T{}, m, b, in, flag, n, base, lvl, out, out_flag, nb, blockIdx.x);
}

template <class T>
static int tree_launch(const tree_io &io, size_t smem, void *stream) {
  lt_tree_kernel<T><<<io.nb, LT_WARP * LT_TREE_WARPS, smem, (cudaStream_t)stream>>>(io.in, io.flag, io.n, io.out,
                                                                                     io.out_flag, io.nb);
  return (int)cudaGetLastError();
}

#else  // host build: the threads of each phase one after another

#include <stdlib.h>

// a block's warps one after another at each level, forwards or reversed
// (common.cuh lt_host_warp_order), as virtual threads are in a warp
template <class T>
static int tree_launch(const tree_io &io, size_t smem, void *stream) {
  (void)stream;
  uint32_t *sm = (uint32_t *)malloc(smem);
  for (int blk = 0; blk < io.nb; blk++) {
    typename T::blk b;
    const int base = blk * LT_TREE_SPAN;
    int cnt = tree_chunk(io.n, blk), lvl = 0;
    for (; cnt > 1; cnt = (cnt + 1) / 2, lvl++)
      for (int j = 0; j < LT_TREE_WARPS; j++) {
        const int w = lt_host_rev ? LT_TREE_WARPS - 1 - j : j;
        const wmem m = w_block(sm, T::slots, T::consts, tree_consts(T{}), w, LT_TREE_WARPS);
        tree_level(T{}, m, b, io.in, io.flag, io.n, base, lvl, cnt, w);
      }
    const wmem m = w_block(sm, T::slots, T::consts, tree_consts(T{}), 0, LT_TREE_WARPS);
    tree_result(T{}, m, b, io.in, io.flag, io.n, base, lvl, io.out, io.out_flag, io.nb, blk);
  }
  free(sm);
  return 0;
}

#endif

// Lanes of a tree's partials buffer at n lanes: the first launch's
// partials, then the second's (the launches after them alternate between
// the two ranges).  Both trees' scratch (T::planes * 12 words a lane, and
// sum_g2's flags one word a lane) is sized by it.
extern "C" int lt_tree_scratch_lanes(int n) {
  const int nb1 = tree_blocks(n);
  return nb1 + tree_blocks(nb1);
}

// The relaunch loop: the tree over n elements of in (flags where given),
// relaunched on the blocks' partials until one is left, which goes to out
// (out_flag where given).  scr (and scr_flag where given) hold the
// partials of the launches before the last, the even launches' from lane 0
// and the odd ones' after the first launch's.  *launches is set to the
// number of kernel launches made.
template <class T>
static int tree_reduce(const char *name, const int32_t *in, const int32_t *flag, int32_t *scr, int32_t *scr_flag,
                       int32_t *out, int32_t *out_flag, int n, int *launches, void *stream) {
  *launches = 0;
  if (n <= 0) return 0;
  const size_t smem = w_smem_bytes(T::slots, T::consts, LT_TREE_WARPS);
  const int nb1 = tree_blocks(n);
  const int shape[8] = {n, nb1, LT_WARP * LT_TREE_WARPS, LT_TREE_SPAN, (int)smem, T::slots, T::phases, T::rounds};
  w_record(name, shape);
#ifdef __CUDACC__
  cudaFuncSetAttribute(lt_tree_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
#endif
  tree_io io = {in, flag, NULL, NULL, n, 0};
  for (int k = 0;; k++) {
    io.nb = tree_blocks(io.n);
    const bool last = io.nb == 1;
    io.out = last ? out : scr + (k & 1 ? T::planes * LT_NL * nb1 : 0);
    io.out_flag = last ? out_flag : scr_flag ? scr_flag + (k & 1 ? nb1 : 0) : NULL;
    const int err = tree_launch<T>(io, smem, stream);
    ++*launches;
    if (err != 0 || last) return err;
    io.in = io.out;
    io.flag = io.out_flag;
    io.n = io.nb;
  }
}

// pts: Jacobian planes [3, 2, 12, n]; excl: [n]; out: [3, 2, 12, 1] and
// out_inf [1] the sum and its flag; scr [lt_tree_scratch_lanes(n) lanes
// of 72 words] and scr_inf [lt_tree_scratch_lanes(n)] the partials.
extern "C" int lt_sum_g2(const void *pts, const void *excl, void *scr, void *scr_inf, void *out, void *out_inf,
                         int n, int *launches, void *stream) {
  return tree_reduce<sum_tree>("sum_g2", (const int32_t *)pts, (const int32_t *)excl, (int32_t *)scr,
                               (int32_t *)scr_inf, (int32_t *)out, (int32_t *)out_inf, n, launches, stream);
}

// live: [n]; f: Fp12 planes [12, 12, n]; out: [12, 12, 1] the product of
// the live lanes; scr [lt_tree_scratch_lanes(n) lanes of 144 words] the
// partials.
extern "C" int lt_prod12(const void *live, const void *f, void *scr, void *out, int n, int *launches, void *stream) {
  return tree_reduce<prod_tree>("prod12", (const int32_t *)f, (const int32_t *)live, (int32_t *)scr, NULL,
                                (int32_t *)out, NULL, n, launches, stream);
}
