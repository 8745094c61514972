// K15 and K16: segmented Jacobian prefix sums over the lane axis.
//
//   lt_seg_sum_g1  Jacobian G1 points, dead flags and group ids -> the
//                  inclusive sum of each lane's group up to the lane; the
//                  last lane of a group holds its total (replaces
//                  lodestar_tpu/kernels/verify.py _j_seg_sum_g1, the
//                  message grouping of the RLC batch)
//   lt_seg_sum_g2  the same over affine G2 points with Z = 1 (replaces
//                  _j_seg_sum_g2, the pre-verify signature aggregation)
//
// One template over the base field serves both.  The scan is JAX's, round
// by round: for s = 1, 2, 4, .. < n, lane l adds the PREVIOUS round's value
// of lane (l - s) mod n with the complete addition (jac_add_full), the
// partner counting as infinity unless l >= s and both lanes are in one
// group.  Dead lanes start at infinity.  The order of the additions fixes
// the Jacobian coordinates, so every lane (its value and its infinity
// flag) equals the plain version in kernels/verify.py, and JAX's scan,
// bit for bit.
//
// Groups may span more lanes than one block holds (n up to 2,048), and
// CUDA blocks run in no order, so each round is one launch of one thread
// per lane, reading one buffer and writing the other: log2 n launches in
// sequence, the last writing the output.
//
// Bound on this card: 32-bit integer multiplies.  The function needs one
// addition per live lane after its group's first (16 Fp products in G1,
// 44 in G2: kernels/verify.py FP_MULS_NEEDED); the scan makes n log2 n
// complete additions, n per round, at 23 and 60 (the doubling beside
// each), so at n = 512 it does ~13x the needed work, in 9 dependent
// launches of one addition's latency each.
#include "curve.cuh"

LT_DEV void f_load(fp &r, const int32_t *base, int n, int lane) { fp_load(r, base, n, lane); }
LT_DEV void f_load(fp2 &r, const int32_t *base, int n, int lane) { fp2_load(r, base, n, lane); }
LT_DEV void f_store(int32_t *base, int n, int lane, const fp &a) { fp_store(base, n, lane, a); }
LT_DEV void f_store(int32_t *base, int n, int lane, const fp2 &a) { fp2_store(base, n, lane, a); }

// planes of one point: Jacobian [3, W, n], or affine [2, W, n] with Z = 1,
// W = 12 (Fp) or 24 (Fp2) words per coordinate
template <typename F>
LT_DEV void pt_load(jac<F> &r, const int32_t *base, int n, int lane, bool aff) {
  const int w = (int)(sizeof(F) / sizeof(uint32_t));
  f_load(r.x, base, n, lane);
  f_load(r.y, base + w * n, n, lane);
  if (aff)
    f_one(r.z);
  else
    f_load(r.z, base + 2 * w * n, n, lane);
}

template <typename F>
LT_DEV void pt_store(int32_t *base, int n, int lane, const jac<F> &a) {
  const int w = (int)(sizeof(F) / sizeof(uint32_t));
  f_store(base, n, lane, a.x);
  f_store(base + w * n, n, lane, a.y);
  f_store(base + 2 * w * n, n, lane, a.z);
}

// one round at lane `lane`: src / src_inf the previous round's values
// (the input points and dead flags in round one), dst / dst_inf this one's
template <typename F>
LT_DEV void seg_round_lane(const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group,
                           int32_t *dst, int32_t *dst_inf, int n, int s, int lane) {
  const int j = lane >= s ? lane - s : lane - s + n;
  jac<F> p, q, r;
  pt_load(p, src, n, lane, aff);
  pt_load(q, src, n, j, aff);
  const bool q_inf = !(lane >= s && group[j] == group[lane]) || src_inf[j] != 0;
  bool r_inf;
  jac_add_full(r, r_inf, p, src_inf[lane] != 0, q, q_inf);
  pt_store(dst, n, lane, r);
  dst_inf[lane] = r_inf ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

template <typename F>
__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_seg_round_kernel(const int32_t *__restrict__ src, const int32_t *__restrict__ src_inf, int aff,
                        const int32_t *__restrict__ group, int32_t *__restrict__ dst,
                        int32_t *__restrict__ dst_inf, int n, int s) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) seg_round_lane<F>(src, src_inf, aff != 0, group, dst, dst_inf, n, s, lane);
}

template <typename F>
int seg_round(const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group, int32_t *dst,
              int32_t *dst_inf, int n, int s, void *stream) {
  lt_seg_round_kernel<F><<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                           (cudaStream_t)stream>>>(src, src_inf, aff ? 1 : 0, group, dst, dst_inf, n, s);
  return (int)cudaGetLastError();
}

#else  // host build: the same lane function over every lane

template <typename F>
int seg_round(const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group, int32_t *dst,
              int32_t *dst_inf, int n, int s, void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++) seg_round_lane<F>(src, src_inf, aff, group, dst, dst_inf, n, s, lane);
  return 0;
}

#endif

// rounds s = 1, 2, 4, .. < n (one round with s = 1, which adds nothing, for
// n = 1), ping-ponging between scr and out so that the last writes out
template <typename F>
int seg_sum(const void *pts, const void *dead, const void *group, void *out, void *out_inf, void *scr,
            void *scr_inf, int n, bool aff, void *stream) {
  if (n <= 0) return 0;
  int rounds = 0;
  for (int s = 1; s < n; s *= 2) rounds++;
  if (rounds == 0) rounds = 1;
  const int32_t *src = (const int32_t *)pts, *src_inf = (const int32_t *)dead;
  for (int k = 0, s = 1; k < rounds; k++, s *= 2) {
    const bool last_parity = (rounds - 1 - k) % 2 == 0;
    int32_t *dst = (int32_t *)(last_parity ? out : scr);
    int32_t *dst_inf = (int32_t *)(last_parity ? out_inf : scr_inf);
    const int err = seg_round<F>(src, src_inf, aff && k == 0, (const int32_t *)group, dst, dst_inf, n, s, stream);
    if (err != 0) return err;
    src = dst;
    src_inf = dst_inf;
  }
  return 0;
}

// pts: Jacobian G1 planes [3, 12, n]; dead, group: [n]; out, scr: [3, 12, n];
// out_inf, scr_inf: [n]
extern "C" int lt_seg_sum_g1(const void *pts, const void *dead, const void *group, void *out, void *out_inf,
                             void *scr, void *scr_inf, int n, void *stream) {
  return seg_sum<fp>(pts, dead, group, out, out_inf, scr, scr_inf, n, false, stream);
}

// pts: affine G2 planes [2, 2, 12, n]; dead, group: [n]; out, scr:
// Jacobian [3, 2, 12, n]; out_inf, scr_inf: [n]
extern "C" int lt_seg_sum_g2(const void *pts, const void *dead, const void *group, void *out, void *out_inf,
                             void *scr, void *scr_inf, int n, void *stream) {
  return seg_sum<fp2>(pts, dead, group, out, out_inf, scr, scr_inf, n, true, stream);
}
