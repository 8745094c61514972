// K13: pubkey aggregation of aggregate sets (K > 1 pubkeys per set).
//
// Replaces lodestar_tpu/kernels/verify.py _k_agg_pk and the gather before
// it (_gather_pk's jnp.take): per set lane, read the K table rows named by
// idx and their kmask bits, and sum the points with masked rows as
// infinity.  The order of additions is the JAX kernel's, so the Jacobian
// output equals it (and the plain version, kernels/verify.py
// agg_pk_plain) bit for bit: chunks of kc = min(K, 32) rows, each summed
// by the tree of kernels/curve.py sum_points_axis0 (half = (k + 1) / 2,
// row i paired with row i + half, the odd middle passed through), then
// the chunk sums accumulated in order with jac_add_full.
//
// A row outside [0, v) is read as row 0 and counted as infinity; if its
// kmask bit is set, the lane's output is flagged infinity, so its set
// fails (the plain version does the same).  v >= 1.
//
// One thread per set lane.  A chunk's tree holds up to 32 Jacobian G1
// points in the thread's stack frame (4.6 KB of local memory): the simple
// choice, over a warp-shared tree, for a first version.
//
// Bound on this card: 32-bit integer multiplies, one addition per live
// row after a lane's first; the rows are affine, so a mixed addition of
// 11 Fp products would do (kernels/verify.py FP_MULS_NEEDED), where the
// kernel makes a complete one of 23 (FP_MULS_PER_LANE) per slot.  Bytes: each lane
// reads its live rows of 96 bytes and K index and mask words, and writes
// 148 bytes.
#include "curve.cuh"

#define LT_AGG_CHUNK 32

// the tree sum of kc <= 32 rows; rows, mask: kc words of this lane;
// bad: set where a row with its mask bit set lies outside [0, v)
LT_NOINL void agg_chunk(jac<fp> &r, bool &r_inf, bool &bad, const int32_t *tx, const int32_t *ty,
                        int v, const int32_t *rows, const int32_t *mask, int kc) {
  jac<fp> pts[LT_AGG_CHUNK];
  bool inf[LT_AGG_CHUNK];
  for (int j = 0; j < kc; j++) {
    const bool in_range = rows[j] >= 0 && rows[j] < v;
    const int row = in_range ? rows[j] : 0;
    fp_load(pts[j].x, tx, v, row);
    fp_load(pts[j].y, ty, v, row);
    fp_one(pts[j].z);
    inf[j] = mask[j] == 0 || !in_range;
    bad = bad || (mask[j] != 0 && !in_range);
  }
  for (int m = kc; m > 1;) {
    const int half = (m + 1) / 2;
    for (int i = 0; i < m - half; i++)
      jac_add_full(pts[i], inf[i], pts[i], inf[i], pts[i + half], inf[i + half]);
    m = half;
  }
  r = pts[0];
  r_inf = inf[0];
}

// tx, ty: Montgomery table planes [12, v]; idx, kmask: [n, k] row-major;
// out: Jacobian planes [3, 12, n]; out_inf: [n]
LT_DEV void agg_pk_lane(const int32_t *tx, const int32_t *ty, int v, const int32_t *idx,
                        const int32_t *kmask, int k, int32_t *out, int32_t *out_inf, int n,
                        int lane) {
  const int kc = k < LT_AGG_CHUNK ? k : LT_AGG_CHUNK;
  jac<fp> acc, s;
  bool acc_inf = true, s_inf, bad = false;
  for (int c = 0; c < k; c += kc) {
    agg_chunk(s, s_inf, bad, tx, ty, v, idx + lane * k + c, kmask + lane * k + c, kc);
    if (c == 0) {
      acc = s;
      acc_inf = s_inf;
    } else {
      jac_add_full(acc, acc_inf, acc, acc_inf, s, s_inf);
    }
  }
  fp_store(out, n, lane, acc.x);
  fp_store(out + LT_NL * n, n, lane, acc.y);
  fp_store(out + 2 * LT_NL * n, n, lane, acc.z);
  out_inf[lane] = acc_inf || bad ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_agg_pk_kernel(const int32_t *__restrict__ tx, const int32_t *__restrict__ ty, int v,
                     const int32_t *__restrict__ idx, const int32_t *__restrict__ kmask, int k,
                     int32_t *__restrict__ out, int32_t *__restrict__ out_inf, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) agg_pk_lane(tx, ty, v, idx, kmask, k, out, out_inf, n, lane);
}

extern "C" int lt_agg_pk(const void *tx, const void *ty, int v, const void *idx, const void *kmask,
                         int k, void *out, void *out_inf, int n, void *stream) {
  if (n > 0)
    lt_agg_pk_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                       (cudaStream_t)stream>>>((const int32_t *)tx, (const int32_t *)ty, v,
                                               (const int32_t *)idx, (const int32_t *)kmask, k,
                                               (int32_t *)out, (int32_t *)out_inf, n);
  return (int)cudaGetLastError();
}

#else  // host build: the same lane function over every lane

extern "C" int lt_agg_pk(const void *tx, const void *ty, int v, const void *idx, const void *kmask,
                         int k, void *out, void *out_inf, int n, void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    agg_pk_lane((const int32_t *)tx, (const int32_t *)ty, v, (const int32_t *)idx,
                (const int32_t *)kmask, k, (int32_t *)out, (int32_t *)out_inf, n, lane);
  return 0;
}

#endif
