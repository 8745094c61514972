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
// The scan is JAX's, round by round: for s = 1, 2, 4, .. < n, lane l adds
// the PREVIOUS round's value of lane (l - s) mod n with the complete
// addition (jac_add_full), the partner counting as infinity unless l >= s
// and both lanes are in one group.  Dead lanes start at infinity.  The
// order of the additions fixes the Jacobian coordinates, so every lane
// (its value and its infinity flag) equals the plain version in
// kernels/verify.py, and JAX's scan, bit for bit.
//
// One warp makes one lane's addition of a round on the warp engine
// (csrc/warp12.cuh; warp_schedule.sumg1_program over Fp, sumg2_program over
// Fp2: P + Q with 2P beside it and the H and R of the addition, 23 and 60
// Fp products in 5 rounds) and makes jac_add_full's selects on warp-wide
// votes.  A block holds as few lanes (warps) as keep the launch within
// LT_SEG_BLOCKS blocks, 4 to 16 (seg_warps): the H100's 132 SMs then hold
// one block each, and a warp shares its SM's multipliers with 3 others at
// N = 512 rather than 15 (on an H100 at 700 W, 16 lanes to a block took
// 0.300 ms for the G2 scan at N = 512, 4 took 0.202:
// tools/segsum_blocks.py).  A lane whose partner counts as infinity, or
// which is infinity itself, only copies (jac_add_full then returns the
// other operand) and makes no product.  Groups may span more
// lanes than one block holds (n up to 2,048), and CUDA blocks run in no
// order, so each round is one launch, reading one buffer and writing the
// other: log2 n launches in sequence, the last writing the output; the C
// entry points report how many they made.
//
// Bound on this card: 32-bit integer multiplies.  The function needs one
// addition per live lane after its group's first (16 Fp products in G1, 44
// in G2: kernels/verify.py FP_MULS_NEEDED); the scan makes up to n log2 n
// complete additions, at 23 and 60 (the doubling beside each), in log2 n
// dependent launches of one warp-engine addition's latency each.
#define LT_WANT_SUMG1
#define LT_WANT_SUMG2
#include "warp12.cuh"

#define LT_SEG_MAX_WARPS 16  // lanes (warps) per block, at most
#define LT_SEG_BLOCKS 128     // blocks a launch keeps within while a block may grow

// Lanes (warps) per block at n lanes: 4, 8 or 16, the fewest that keep the
// launch within LT_SEG_BLOCKS blocks (kernels/verify.py seg_warps, its
// twin).  tools/segsum_blocks.py builds fixed counts (LT_SEG_FIXED_WARPS)
// to compare.
static inline int seg_warps(int n) {
#ifdef LT_SEG_FIXED_WARPS
  (void)n;
  return LT_SEG_FIXED_WARPS;
#else
  int w = 4;
  while (w < LT_SEG_MAX_WARPS && (n + w - 1) / w > LT_SEG_BLOCKS) w *= 2;
  return w;
#endif
}

// The two fields' programs: the width of a coordinate in Fp slots (w), the
// program's shape and registers, and, as overloads on the policy, its
// tables.
struct seg_g1 {
  enum { w = 1, slots = LT_SUMG1_SLOTS, consts = LT_SUMG1_CONSTS, phases = LT_SUMG1_PHASES, rounds = LT_SUMG1_ROUNDS,
         P = LT_SUMG1_P, Q = LT_SUMG1_Q, S = LT_SUMG1_S, DBL = LT_SUMG1_DBL, H = LT_SUMG1_H, R = LT_SUMG1_R,
         ONE = LT_SUMG1_ONE, ZERO = LT_SUMG1_ZERO };
};

struct seg_g2 {
  enum { w = 2, slots = LT_SUMG2_SLOTS, consts = LT_SUMG2_CONSTS, phases = LT_SUMG2_PHASES, rounds = LT_SUMG2_ROUNDS,
         P = LT_SUMG2_P, Q = LT_SUMG2_Q, S = LT_SUMG2_S, DBL = LT_SUMG2_DBL, H = LT_SUMG2_H, R = LT_SUMG2_R,
         ONE = LT_SUMG2_ONE, ZERO = LT_SUMG2_ZERO };
};

LT_DEV const uint32_t (*seg_consts(seg_g1))[LT_NL] { return LT_SUMG1_CONST; }
LT_DEV const uint32_t (*seg_consts(seg_g2))[LT_NL] { return LT_SUMG2_CONST; }
LT_DEV void seg_run(seg_g1, const wmem &m) { w_run<false>(m, LT_SUMG1_PHASE, LT_SUMG1_PHASES, LT_SUMG1_INS); }
LT_DEV void seg_run(seg_g2, const wmem &m) { w_run<false>(m, LT_SUMG2_PHASE, LT_SUMG2_PHASES, LT_SUMG2_INS); }

// Lane `lane` of planes src into the warp's slots from dst: Jacobian
// [3, w, 12, n], or affine [2, w, 12, n] with Z = 1 from the constants.
template <class T>
LT_DEV void seg_fetch(T, const wmem &m, const int32_t *src, bool aff, int n, int lane, int dst) {
  w_load_planes(m, dst, src, (aff ? 2 : 3) * T::w, n, lane);
  if (aff) {
    w_copy_cols(m, dst + 2 * T::w, m.cbase + T::ONE, 1);
    if (T::w == 2) w_copy_cols(m, dst + 2 * T::w + 1, m.cbase + T::ZERO, 1);
  }
  LT_SYNCWARP();
}

// One round at lane `lane`, one warp: src / src_inf the previous round's
// values (the input points and dead flags in round one), dst / dst_inf
// this one's.  jac_add_full(P, Q): Q where P is infinity, P where Q is,
// else 2P where H = R = 0, P + Q otherwise.
template <class T>
LT_DEV void seg_lane(T, const wmem &m, const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group,
                     int32_t *dst, int32_t *dst_inf, int n, int s, int lane) {
  const int j = lane >= s ? lane - s : lane - s + n;
  const bool p_inf = src_inf[lane] != 0;
  const bool q_inf = !(lane >= s && group[j] == group[lane]) || src_inf[j] != 0;
  int res = T::P;
  bool inf = p_inf && q_inf;
  if (p_inf || q_inf) {  // a copy of the other operand: no product
    seg_fetch(T{}, m, src, aff, n, p_inf ? j : lane, T::P);
  } else {
    seg_fetch(T{}, m, src, aff, n, lane, T::P);
    seg_fetch(T{}, m, src, aff, n, j, T::Q);
    seg_run(T{}, m);
    const bool h_zero = w_eq(m, T::H, -1, T::w), r_zero = w_eq(m, T::R, -1, T::w);
    res = h_zero && r_zero ? T::DBL : T::S;
    inf = h_zero && !r_zero;
  }
  w_store_planes(m, res, dst, 3 * T::w, n, lane);
  if (LT_T0 == 0) dst_inf[lane] = inf ? 1 : 0;
}

#ifdef __CUDACC__

template <class T>
__global__ void __launch_bounds__(LT_WARP * LT_SEG_MAX_WARPS)
    lt_seg_round_kernel(const int32_t *__restrict__ src, const int32_t *__restrict__ src_inf, int aff,
                        const int32_t *__restrict__ group, int32_t *__restrict__ dst, int32_t *__restrict__ dst_inf,
                        int n, int s) {
  extern __shared__ uint32_t lt_sm[];
  const int w = threadIdx.x / LT_WARP, warps = blockDim.x / LT_WARP;
  const wmem m = w_block(lt_sm, T::slots, T::consts, seg_consts(T{}), w, warps);
  const int lane = blockIdx.x * warps + w;
  if (lane < n) seg_lane(T{}, m, src, src_inf, aff != 0, group, dst, dst_inf, n, s, lane);
}

template <class T>
static int seg_round(const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group, int32_t *dst,
                     int32_t *dst_inf, int n, int s, int blocks, int warps, size_t smem, void *stream) {
  lt_seg_round_kernel<T><<<blocks, LT_WARP * warps, smem, (cudaStream_t)stream>>>(src, src_inf, aff ? 1 : 0, group,
                                                                                 dst, dst_inf, n, s);
  return (int)cudaGetLastError();
}

#else  // host build: a block's warps one after another, forwards or reversed

#include <stdlib.h>

template <class T>
static int seg_round(const int32_t *src, const int32_t *src_inf, bool aff, const int32_t *group, int32_t *dst,
                     int32_t *dst_inf, int n, int s, int blocks, int warps, size_t smem, void *stream) {
  (void)stream;
  uint32_t *sm = (uint32_t *)malloc(smem);
  for (int blk = 0; blk < blocks; blk++)
    for (int j = 0; j < warps; j++) {
      const int w = lt_host_rev ? warps - 1 - j : j, lane = blk * warps + w;
      const wmem m = w_block(sm, T::slots, T::consts, seg_consts(T{}), w, warps);
      if (lane < n) seg_lane(T{}, m, src, src_inf, aff, group, dst, dst_inf, n, s, lane);
    }
  free(sm);
  return 0;
}

#endif

// Rounds s = 1, 2, 4, .. < n (one round with s = 1, which adds nothing, for
// n = 1), ping-ponging between scr and out so that the last writes out;
// *launches is set to the number of kernel launches made.
template <class T>
static int seg_sum(const char *name, const void *pts, const void *dead, const void *group, void *out, void *out_inf,
                   void *scr, void *scr_inf, int n, bool aff, int *launches, void *stream) {
  *launches = 0;
  if (n <= 0) return 0;
  int rounds = 0;
  for (int s = 1; s < n; s *= 2) rounds++;
  if (rounds == 0) rounds = 1;
  const int warps = seg_warps(n), blocks = (n + warps - 1) / warps;
  const size_t smem = w_smem_bytes(T::slots, T::consts, warps);
  const int shape[8] = {n, blocks, LT_WARP * warps, warps, (int)smem, T::slots, T::phases, T::rounds};
  w_record(name, shape);
#ifdef __CUDACC__
  cudaFuncSetAttribute(lt_seg_round_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
#endif
  const int32_t *src = (const int32_t *)pts, *src_inf = (const int32_t *)dead;
  for (int k = 0, s = 1; k < rounds; k++, s *= 2) {
    const bool last_parity = (rounds - 1 - k) % 2 == 0;
    int32_t *dst = (int32_t *)(last_parity ? out : scr);
    int32_t *dst_inf = (int32_t *)(last_parity ? out_inf : scr_inf);
    const int err = seg_round<T>(src, src_inf, aff && k == 0, (const int32_t *)group, dst, dst_inf, n, s, blocks,
                                 warps, smem, stream);
    ++*launches;
    if (err != 0) return err;
    src = dst;
    src_inf = dst_inf;
  }
  return 0;
}

// pts: Jacobian G1 planes [3, 12, n]; dead, group: [n]; out, scr: [3, 12, n];
// out_inf, scr_inf: [n]
extern "C" int lt_seg_sum_g1(const void *pts, const void *dead, const void *group, void *out, void *out_inf,
                             void *scr, void *scr_inf, int n, int *launches, void *stream) {
  return seg_sum<seg_g1>("seg_sum_g1", pts, dead, group, out, out_inf, scr, scr_inf, n, false, launches, stream);
}

// pts: affine G2 planes [2, 2, 12, n]; dead, group: [n]; out, scr:
// Jacobian [3, 2, 12, n]; out_inf, scr_inf: [n]
extern "C" int lt_seg_sum_g2(const void *pts, const void *dead, const void *group, void *out, void *out_inf,
                             void *scr, void *scr_inf, int n, int *launches, void *stream) {
  return seg_sum<seg_g2>("seg_sum_g2", pts, dead, group, out, out_inf, scr, scr_inf, n, true, launches, stream);
}
