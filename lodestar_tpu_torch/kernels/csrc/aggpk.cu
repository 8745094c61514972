// K13: pubkey aggregation of aggregate sets (K > 1 pubkeys per set).
//
// Replaces lodestar_tpu/kernels/verify.py _k_agg_pk and the gather before
// it (_gather_pk's jnp.take): per set, read the K table rows named by idx
// and their kmask bits, and sum the points with masked rows as infinity.
// The order of additions is the JAX kernel's, so the Jacobian output
// equals it (and the plain version, kernels/verify.py agg_pk_plain) bit
// for bit: chunks of kc = min(K, 32) rows, each summed by the tree of
// kernels/curve.py sum_points_axis0 (half = (m + 1) / 2, row i paired with
// row i + half, the odd middle passed through), then the chunk sums
// accumulated in order with jac_add_full.
//
// A row outside [0, v) is read as row 0 and counted as infinity; if its
// kmask bit is set, the set's output is flagged infinity, so its set
// fails (the plain version does the same).  v >= 1.
//
// One block per set.  The pairs of a tree level are independent, and so
// are the chunks' trees: the block's threads take a level's pairs of up
// to LT_AGG_BATCH chunks at once (the first level straight from the table
// rows, the later ones from shared memory, limb-major, a __syncthreads
// between levels), so a chunk costs its tree's depth (5 levels at
// kc = 32) where one thread per set made kc - 1 dependent additions.  One
// thread then accumulates the chunk sums in order.  An entirely masked
// chunk sums to infinity, and jac_add_full of a finite accumulator and
// infinity returns the accumulator unchanged, so that addition is skipped
// (the packed live rows of an aggregate leave most chunks of its K bucket
// masked); with the accumulator at infinity it is made, since its result
// then takes the chunk's placeholder coordinates.
//
// Bound on this card: 32-bit integer multiplies, one addition per live
// row after a set's first; the rows are affine, so a mixed addition of 11
// Fp products would do (kernels/verify.py FP_MULS_NEEDED), where the
// kernel makes a complete one of 23 (FP_MULS_PER_LANE).  Bytes: each set
// reads its live rows of 96 bytes and K index and mask words, and writes
// 148 bytes.
#include <stddef.h>

#include "curve.cuh"

#define LT_AGG_CHUNK 32
#define LT_AGG_HALF (LT_AGG_CHUNK / 2)  // points a chunk keeps after its first level
#define LT_AGG_BATCH 16                 // chunks whose trees run at once
#define LT_AGG_PTS (LT_AGG_BATCH * LT_AGG_HALF)
#define LT_AGG_THREADS 256  // at most: K = 2048 would ask 1,024 threads of ~80 registers

// the tree's points between levels: chunk c of the batch at c * HALF + i
struct agg_smem {
  uint32_t x[LT_NL][LT_AGG_PTS], y[LT_NL][LT_AGG_PTS], z[LT_NL][LT_AGG_PTS];
  int inf[LT_AGG_PTS];
  int live[LT_AGG_BATCH];  // a kmask bit of the chunk is set
};

LT_DEV void agg_get(jac<fp> &p, bool &inf, const agg_smem &s, int i) {
#pragma unroll
  for (int l = 0; l < LT_NL; l++) {
    p.x.w[l] = s.x[l][i];
    p.y.w[l] = s.y[l][i];
    p.z.w[l] = s.z[l][i];
  }
  inf = s.inf[i] != 0;
}

LT_DEV void agg_put(agg_smem &s, int i, const jac<fp> &p, bool inf) {
#pragma unroll
  for (int l = 0; l < LT_NL; l++) {
    s.x[l][i] = p.x.w[l];
    s.y[l][i] = p.y.w[l];
    s.z[l][i] = p.z.w[l];
  }
  s.inf[i] = inf ? 1 : 0;
}

// a table row as a Jacobian point (Z = 1) and its infinity flag
LT_DEV void agg_row(jac<fp> &p, bool &inf, bool &bad, const int32_t *tx, const int32_t *ty, int v, int row,
                    int mask) {
  const bool in_range = row >= 0 && row < v;
  fp_load(p.x, tx, v, in_range ? row : 0);
  fp_load(p.y, ty, v, in_range ? row : 0);
  fp_one(p.z);
  inf = mask == 0 || !in_range;
  bad = bad || (mask != 0 && !in_range);
}

// The first level of the batch's trees, from the table: item i of chunk c
// adds rows i and i + half, or passes the odd middle row through
LT_DEV void agg_leaves(agg_smem &s, bool &bad, const int32_t *tx, const int32_t *ty, int v, const int32_t *rows,
                       const int32_t *mask, int kc, int nb, int tid, int bs) {
  const int half = (kc + 1) / 2;
  for (int p = tid; p < nb * half; p += bs) {
    const int c = p / half, i = p % half, r = c * kc + i;
    jac<fp> a, b;
    bool a_inf, b_inf;
    agg_row(a, a_inf, bad, tx, ty, v, rows[r], mask[r]);
    int any = mask[r];
    if (i < kc - half) {
      agg_row(b, b_inf, bad, tx, ty, v, rows[r + half], mask[r + half]);
      any |= mask[r + half];
      jac_add_full(a, a_inf, a, a_inf, b, b_inf);
    }
    agg_put(s, c * LT_AGG_HALF + i, a, a_inf);
    if (any) s.live[c] = 1;  // threads may race here, all writing 1
  }
}

// a later level: m points per chunk, i + half added into i
LT_DEV void agg_level(agg_smem &s, int m, int nb, int tid, int bs) {
  const int half = (m + 1) / 2, pairs = m - half;
  for (int p = tid; p < nb * pairs; p += bs) {
    const int at = (p / pairs) * LT_AGG_HALF + p % pairs;
    jac<fp> a, b;
    bool a_inf, b_inf;
    agg_get(a, a_inf, s, at);
    agg_get(b, b_inf, s, at + half);
    jac_add_full(a, a_inf, a, a_inf, b, b_inf);
    agg_put(s, at, a, a_inf);
  }
}

// the batch's chunk sums into the accumulator, in order (one thread)
LT_DEV void agg_accumulate(jac<fp> &acc, bool &acc_inf, const agg_smem &s, int c0, int nb) {
  for (int c = 0; c < nb; c++) {
    if (c0 + c > 0 && !s.live[c] && !acc_inf) continue;  // + O: acc unchanged
    jac<fp> p;
    bool p_inf;
    agg_get(p, p_inf, s, c * LT_AGG_HALF);
    if (c0 + c == 0) {
      acc = p;
      acc_inf = p_inf;
    } else {
      jac_add_full(acc, acc_inf, acc, acc_inf, p, p_inf);
    }
  }
}

#ifdef __CUDACC__
// every thread of the block runs `stmt` as thread `tid`, then the block meets
#define LT_EACH_THREAD(stmt)       \
  do {                             \
    {                              \
      const int tid = threadIdx.x; \
      stmt;                        \
    }                              \
    __syncthreads();               \
  } while (0)
#define LT_BLOCK_OR(x) __syncthreads_or(x)
#else
#define LT_EACH_THREAD(stmt)                      \
  do {                                            \
    for (int j = 0; j < bs; j++) {                \
      const int tid = lt_host_rev ? bs - 1 - j : j; \
      stmt;                                       \
    }                                             \
  } while (0)
#define LT_BLOCK_OR(x) (x)  // one flag serves every virtual thread
#endif

// Set `lane` on a block of bs threads.  tx, ty: Montgomery table planes
// [12, v]; idx, kmask: [n, k] row-major; out: Jacobian planes [3, 12, n];
// out_inf: [n]
LT_DEV void agg_pk_block(agg_smem &s, const int32_t *tx, const int32_t *ty, int v, const int32_t *idx,
                         const int32_t *kmask, int k, int32_t *out, int32_t *out_inf, int n, int lane, int bs) {
  const int kc = k < LT_AGG_CHUNK ? k : LT_AGG_CHUNK, nch = k / kc;
  jac<fp> acc;
  bool acc_inf = true, bad = false;
  for (int c0 = 0; c0 < nch; c0 += LT_AGG_BATCH) {
    const int nb = nch - c0 < LT_AGG_BATCH ? nch - c0 : LT_AGG_BATCH;
    const int32_t *rows = idx + (size_t)lane * k + c0 * kc, *mask = kmask + (size_t)lane * k + c0 * kc;
    LT_EACH_THREAD(if (tid < nb) s.live[tid] = 0);
    LT_EACH_THREAD(agg_leaves(s, bad, tx, ty, v, rows, mask, kc, nb, tid, bs));
    for (int m = (kc + 1) / 2; m > 1; m = (m + 1) / 2) LT_EACH_THREAD(agg_level(s, m, nb, tid, bs));
    LT_EACH_THREAD(if (tid == 0) agg_accumulate(acc, acc_inf, s, c0, nb));
  }
  bad = LT_BLOCK_OR(bad);
  LT_EACH_THREAD(if (tid == 0) {
    fp_store(out, n, lane, acc.x);
    fp_store(out + LT_NL * n, n, lane, acc.y);
    fp_store(out + 2 * LT_NL * n, n, lane, acc.z);
    out_inf[lane] = acc_inf || bad ? 1 : 0;
  });
}

// threads per block: a level's pairs of one batch, in whole warps, at most
// LT_AGG_THREADS
static inline int agg_threads(int k) {
  const int kc = k < LT_AGG_CHUNK ? k : LT_AGG_CHUNK, nch = k / kc;
  const int items = (nch < LT_AGG_BATCH ? nch : LT_AGG_BATCH) * ((kc + 1) / 2);
  const int t = (items + 31) / 32 * 32;
  return t < LT_AGG_THREADS ? t : LT_AGG_THREADS;
}

// tree levels of a chunk of kc rows (the first one from the table included)
static inline int agg_levels(int k) {
  int levels = 0;
  for (int m = k < LT_AGG_CHUNK ? k : LT_AGG_CHUNK; m > 1; m = (m + 1) / 2) levels++;
  return levels;
}

static int lt_agg_last[4];

static inline int agg_launch(int n, int k) {
  const int shape[4] = {n, agg_threads(k), (int)sizeof(agg_smem), agg_levels(k)};
  for (int i = 0; i < 4; i++) lt_agg_last[i] = shape[i];
  return shape[1];
}

// out[4]: blocks (one per set), threads per block, static shared bytes per
// block and tree levels per chunk of the library's last launch (zeros
// before the first)
extern "C" int lt_agg_last_launch(int *out) {
  for (int i = 0; i < 4; i++) out[i] = lt_agg_last[i];
  return 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_AGG_THREADS)
    lt_agg_pk_kernel(const int32_t *__restrict__ tx, const int32_t *__restrict__ ty, int v,
                     const int32_t *__restrict__ idx, const int32_t *__restrict__ kmask, int k,
                     int32_t *__restrict__ out, int32_t *__restrict__ out_inf, int n) {
  __shared__ agg_smem s;
  agg_pk_block(s, tx, ty, v, idx, kmask, k, out, out_inf, n, blockIdx.x, blockDim.x);
}

extern "C" int lt_agg_pk(const void *tx, const void *ty, int v, const void *idx, const void *kmask,
                         int k, void *out, void *out_inf, int n, void *stream) {
  const int threads = agg_launch(n, k);
  if (n > 0)
    lt_agg_pk_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t *)tx, (const int32_t *)ty, v, (const int32_t *)idx, (const int32_t *)kmask, k,
        (int32_t *)out, (int32_t *)out_inf, n);
  return (int)cudaGetLastError();
}

#else  // host build: a block's threads as virtual threads, set after set

#include <stdlib.h>

extern "C" int lt_agg_pk(const void *tx, const void *ty, int v, const void *idx, const void *kmask,
                         int k, void *out, void *out_inf, int n, void *stream) {
  (void)stream;
  const int threads = agg_launch(n, k);
  agg_smem *s = (agg_smem *)malloc(sizeof(agg_smem));
  for (int lane = 0; lane < n; lane++)
    agg_pk_block(*s, (const int32_t *)tx, (const int32_t *)ty, v, (const int32_t *)idx, (const int32_t *)kmask,
                 k, (int32_t *)out, (int32_t *)out_inf, n, lane, threads);
  free(s);
  return 0;
}

#endif
