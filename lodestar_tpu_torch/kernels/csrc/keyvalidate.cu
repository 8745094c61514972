// K14: G1 pubkey decompression and KeyValidate at registration.
//
//   lt_g1_keyvalidate  x as plain limbs and the (sign, infinity) bits ->
//                      Montgomery (x, y), y = sqrt(x^3 + 4) with
//                      fp_sgn(y) == sign, and ok = on-curve and in G1 and
//                      not flagged infinity (replaces
//                      lodestar_tpu/kernels/ingest.py _k_g1_keyvalidate)
//
// One thread per lane.  The subgroup check is the sigma endomorphism test
// P in G1 iff sigma(P) = [-z^2] P, sigma(x, y) = (beta x, y) (Scott, ePrint
// 2021/1130; beta and |z| in constants.cuh, beta's pairing with the sign
// from kernels/layout.py g1_beta): A = [|z|] P, B = [|z|] A = [z^2] P, and
// the lane is in G1 iff X_B = beta x Z_B^2, Y_B = -y Z_B^3 and Z_B != 0.
// The test is exact on E(Fp), so ok equals the plain version's [r]P = O
// (kernels/ingest.py g1_keyvalidate) bit for bit, and (x, y) are the same
// canonical values.
//
// The lane runs kernels/kv_program.py's program (kv_prog.cuh, written at
// build time), 1,488 Fp products: x to Montgomery and x^3 (3); the square
// root rhs^((p + 1) / 4) by a 4-bit sliding window over a table of 8 odd
// powers (461, where the binary ladder made 606); y^2, and y out of
// Montgomery form for the sign (2); the two chains, each 63 doublings (7)
// and 5 additions: mixed in A's (11, P is affine), generic in B's (16, A
// is Jacobian): 1,017; the test (5).  No addition is complete, and none
// needs to be.  A key of G1 has order r > 2^65, so no addition of its
// chains meets T = +-addend or T = O.  An addition that does meet one
// (H = 0; the x = 0 key of order 3 meets T = 2P = -P at the first) makes
// Z = 0, which every later doubling and addition keeps, so Z_B = 0 and
// the lane is refused.  Without one, every addition is exact
// (kernels/kv_program.py).  The kernel makes only the products the
// function needs (kernels/verify.py FP_MULS_PER_LANE = FP_MULS_NEEDED,
// checked against the host build's count).
//
// A stack-free lane: its 9 Fp slots live in the block's shared memory, 432
// contiguous bytes a thread (read and written 16 bytes at a time: the
// 8 threads of a quarter warp hit distinct banks), and one loop interprets
// the program a word at a time, with the segments' per-lane steps (stores,
// the on-curve test, the sign select, the verdict) between segments.  The
// one Montgomery product, additions and subtractions are inlined once in
// that loop; nothing is called and no struct is passed by reference.
// Bound on this card: 32-bit integer multiplies (588 a product).  Bytes per
// lane: 56 in, 100 out.  Registration launches 65,536 lanes at a time in
// blocks of LT_KV_BLOCK threads, 55,296 B of shared memory each: 4 blocks
// (16 warps) fit an SM and 512 blocks fill the card in one wave
// (lt_kv_launch_shape reports the occupancy API's count).  On an H100
// 128 threads were 1-2 % faster than 64 at 256 to 65,536 lanes, and 32
// (15 blocks an SM by shared memory, two waves) 6 % slower
// (tools/keyvalidate_blocks.py).
#include "canonical.cuh"
#include "kv_prog.cuh"

static_assert(LT_KV_Z_ABS == LT_Z_ABS, "the program's chains follow constants.cuh's |z|");

#define LT_KV_BLOCK 128  // threads (lanes) per block
#define LT_KV_LANE_WORDS (LT_KV_SLOTS * LT_NL)
#define LT_KV_SMEM (LT_KV_BLOCK * LT_KV_LANE_WORDS * 4)  // dynamic shared bytes per block

// a constant operand of the program (kernels/kv_program.py CONSTS)
LT_DEV void kv_const(fp &r, uint32_t c) {
  fp_zero(r);
  if (c == LT_KV_C_ONE_PLAIN) r.w[0] = 1u;
  else if (c == LT_KV_C_R2) fp_const(r, LT_R2);
  else if (c == LT_KV_C_G1_B) fp_const(r, LT_G1_B);
  else if (c == LT_KV_C_BETA) fp_const(r, LT_G1_BETA);
}

// the lane's slot idx (its LT_KV_LANE_WORDS words at sm), or a constant
LT_DEV void kv_get(fp &r, const uint32_t *sm, uint32_t idx) {
  if (idx >= LT_KV_SLOTS) {
    kv_const(r, idx - LT_KV_SLOTS);
    return;
  }
  const uint32_t *p = sm + idx * LT_NL;
#ifdef __CUDACC__
#pragma unroll
  for (int j = 0; j < 3; j++) {
    const uint4 v = reinterpret_cast<const uint4 *>(p)[j];
    r.w[4 * j] = v.x;
    r.w[4 * j + 1] = v.y;
    r.w[4 * j + 2] = v.z;
    r.w[4 * j + 3] = v.w;
  }
#else
  for (int i = 0; i < LT_NL; i++) r.w[i] = p[i];
#endif
}

LT_DEV void kv_put(uint32_t *sm, uint32_t idx, const fp &a) {
  uint32_t *p = sm + idx * LT_NL;
#ifdef __CUDACC__
#pragma unroll
  for (int j = 0; j < 3; j++)
    reinterpret_cast<uint4 *>(p)[j] = make_uint4(a.w[4 * j], a.w[4 * j + 1], a.w[4 * j + 2], a.w[4 * j + 3]);
#else
  for (int i = 0; i < LT_NL; i++) p[i] = a.w[i];
#endif
}

// x: plain planes [12, n]; flags: [2, n] (sign, inf); xy: Montgomery
// affine planes [2, 12, n] (x, y); ok: [n]; sm: the lane's slots
LT_DEV void g1_keyvalidate_lane(const int32_t *x, const int32_t *flags, int32_t *xy, int32_t *ok, int n,
                                int lane, uint32_t *sm) {
  fp u, v;
  fp_load(u, x, n, lane);
  kv_put(sm, LT_KV_XIN, u);
  bool on_curve = false;
#pragma unroll 1
  for (int seg = 0; seg < LT_KV_SEGS; seg++) {
#pragma unroll 1
    for (uint32_t k = LT_KV_SEG[seg]; k < LT_KV_SEG[seg + 1]; k++) {
      const uint32_t op = LT_KV_PROG[k], kind = op >> 30;
      fp a, b, r;
      kv_get(a, sm, (op >> 10) & 1023u);
      kv_get(b, sm, op & 1023u);
      if (kind == LT_KV_OP_MUL)
        fp_mont_mul(r, a, b);
      else if (kind == LT_KV_OP_ADD)
        fp_add(r, a, b);
      else
        fp_sub(r, a, b);
      kv_put(sm, (op >> 20) & 1023u, r);
    }
    if (seg == 0) {  // x in Montgomery form is the first output plane
      kv_get(u, sm, LT_KV_X);
      fp_store(xy, n, lane, u);
    } else if (seg == 1) {  // on-curve test, the root of the key's sign; T = Q = (x, y, 1)
      kv_get(u, sm, LT_KV_RHS);
      kv_get(v, sm, LT_KV_YSQ);
      on_curve = fp_eq(u, v);
      kv_get(u, sm, LT_KV_YPLAIN);
      const bool keep = fp_gt_words(u, LT_HALF_P) == (flags[lane] != 0);
      kv_get(u, sm, LT_KV_Y);
      kv_get(v, sm, LT_KV_NY);
      fp_select(u, keep, u, v);
      fp_store(xy + LT_NL * n, n, lane, u);
      kv_put(sm, LT_KV_TY, u);
      kv_put(sm, LT_KV_QY, u);
      fp_load(u, xy, n, lane);
      kv_put(sm, LT_KV_TX, u);
      kv_put(sm, LT_KV_QX, u);
      fp_one(u);
      kv_put(sm, LT_KV_TZ, u);
    } else if (seg == 2) {  // B = [z^2] P in T; (x, y) for the test
      fp_load(u, xy, n, lane);
      kv_put(sm, LT_KV_QX, u);
      fp_load(u, xy + LT_NL * n, n, lane);
      kv_put(sm, LT_KV_QY, u);
    }
  }
  fp bx, s, tz;
  kv_get(bx, sm, LT_KV_BX);
  kv_get(u, sm, LT_KV_TX);
  kv_get(s, sm, LT_KV_SUM);
  kv_get(tz, sm, LT_KV_TZ);
  const bool in_g1 = fp_eq(bx, u) && fp_is_zero(s) && !fp_is_zero(tz);
  ok[lane] = (on_curve && in_g1 && flags[n + lane] == 0) ? 1 : 0;  // infinity is never a valid key
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LT_KV_BLOCK, 512 / LT_KV_BLOCK)
    lt_g1_keyvalidate_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ flags,
                             int32_t *__restrict__ xy, int32_t *__restrict__ ok, int n) {
  extern __shared__ uint4 kv_smem[];
  const int lane = blockIdx.x * LT_KV_BLOCK + threadIdx.x;
  uint32_t *sm = reinterpret_cast<uint32_t *>(kv_smem) + threadIdx.x * LT_KV_LANE_WORDS;
  if (lane < n) g1_keyvalidate_lane(x, flags, xy, ok, n, lane, sm);
}

// the block's shared memory (above the 48 KB default), and the carveout
// that gives shared memory all it can take
static int kv_configure() {
  cudaError_t e = cudaFuncSetAttribute(lt_g1_keyvalidate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       LT_KV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lt_g1_keyvalidate_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

extern "C" int lt_g1_keyvalidate(const void *x, const void *flags, void *xy, void *ok, int n,
                                 void *stream) {
  static int configured = -1;
  if (configured != 0) configured = kv_configure();
  if (configured != 0) return configured;
  if (n > 0)
    lt_g1_keyvalidate_kernel<<<(n + LT_KV_BLOCK - 1) / LT_KV_BLOCK, LT_KV_BLOCK, LT_KV_SMEM,
                               (cudaStream_t)stream>>>((const int32_t *)x, (const int32_t *)flags,
                                                       (int32_t *)xy, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

// out[4]: threads per block, dynamic shared bytes per block, the blocks an
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), slots
extern "C" int lt_kv_launch_shape(void *out) {
  int *o = (int *)out;
  const int e = kv_configure();
  if (e != 0) return e;
  o[0] = LT_KV_BLOCK;
  o[1] = LT_KV_SMEM;
  o[3] = LT_KV_SLOTS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[2], lt_g1_keyvalidate_kernel, LT_KV_BLOCK,
                                                            LT_KV_SMEM);
}

#else  // host build: the same lane function over every lane, one lane's slots

extern "C" int lt_g1_keyvalidate(const void *x, const void *flags, void *xy, void *ok, int n,
                                 void *stream) {
  (void)stream;
  static uint32_t sm[LT_KV_LANE_WORDS];
  for (int lane = 0; lane < n; lane++)
    g1_keyvalidate_lane((const int32_t *)x, (const int32_t *)flags, (int32_t *)xy, (int32_t *)ok, n, lane, sm);
  return 0;
}

#endif
