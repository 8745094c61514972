// The warp engine of the pairing kernels, r sig, r pk, the G2 decompression,
// the hash to G2 and the affine conversion (one warp per lane), and of the
// G2 lane sum and the Fp12 lane product (one warp per addition or product).
//
// A lane's values are Fp "slots" in shared memory, stored limb-major: the
// block's memory is [12][cols], slot s of warp w in column w * slots + s
// and the program's constants after every warp's slots, so the 32 threads
// of a warp that read limb i of slots distinct mod 32 hit 32 banks.  A
// program (warp_prog.cuh, written from kernels/warp_schedule.py by
// kernels/build.py at build time) is a list of phases; in a phase every thread that has work performs one Fp
// operation from operand slots to a result slot (thread t takes the
// phase's operations t, t + 32, ...), then the warp meets at
// __syncwarp().  No thread of a phase reads or writes a slot another one
// writes, so the threads of a phase may run in any order.  A round is a
// phase of Montgomery products: up to 32 independent products at once,
// where one thread per lane ran one after another.
//
// In the host build a warp is a loop over its 32 virtual threads, forwards
// or reversed (common.cuh lt_host_warp_order), shared memory a plain array and
// __syncwarp() nothing; lt_host_rounds() counts the rounds it ran and
// lt_host_gcd_steps() the outer steps of the inversion fp_inv_var.
#pragma once

#include <stddef.h>
#include <string.h>

#include "fp.cuh"

#include "warp_prog.cuh"

#define LT_WARP 32
#define LT_LPB 4  // lanes (warps) per block
#define LT_OP_MUL 0u  // operation kinds (kernels/warp_schedule.py)
#define LT_OP_ADD 1u
#define LT_OP_SUB 2u
#define LT_OP_INV 3u

#ifdef __CUDACC__
#define LT_T0 ((int)(threadIdx.x & (LT_WARP - 1)))  // this thread's first item
#define LT_TSTEP LT_WARP
#define LT_SYNCWARP() __syncwarp()
#else
#define LT_T0 0
#define LT_TSTEP 1
#define LT_SYNCWARP() ((void)0)
static uint64_t lt_rounds;
extern "C" uint64_t lt_host_rounds(void) {
  const uint64_t c = lt_rounds;
  lt_rounds = 0;
  return c;
}
static uint64_t lt_gcd_steps;  // fp_inv_var's outer steps
extern "C" uint64_t lt_host_gcd_steps(void) {
  const uint64_t c = lt_gcd_steps;
  lt_gcd_steps = 0;
  return c;
}
#endif

// a warp's view of its block's shared memory
struct wmem {
  uint32_t *sm;
  int cols;   // columns of the block: LT_LPB * slots + constants
  int base;   // the warp's first column
  int slots;  // slots per lane: operand indices below it are the warp's own
  int cbase;  // the constants' first column
};

// The block's memory: 12 words per column, the slots of its `warps` warps
// and the constants.  Every thread loads its share of the program's
// constants; the block meets once.
LT_DEV wmem w_block(uint32_t *sm, int slots, int nconst, const uint32_t (*consts)[LT_NL], int warp,
                    int warps = LT_LPB) {
  wmem m;
  m.sm = sm;
  m.cols = warps * slots + nconst;
  m.base = warp * slots;
  m.slots = slots;
  m.cbase = warps * slots;
#ifdef __CUDACC__
  for (int i = threadIdx.x; i < nconst * LT_NL; i += blockDim.x)
    sm[(i % LT_NL) * m.cols + m.cbase + i / LT_NL] = consts[i / LT_NL][i % LT_NL];
  __syncthreads();
#else
  for (int i = 0; i < nconst * LT_NL; i++)
    sm[(i % LT_NL) * m.cols + m.cbase + i / LT_NL] = consts[i / LT_NL][i % LT_NL];
#endif
  return m;
}

// The column of an operand: the warp's slot idx, or constant idx - slots
LT_DEV int w_col(const wmem &m, uint32_t idx) {
  return (int)idx + ((int)idx < m.slots ? m.base : m.cbase - m.slots);
}

LT_DEV void w_get(fp &r, const wmem &m, uint32_t idx) {
  const uint32_t *p = m.sm + w_col(m, idx);
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = p[i * m.cols];
}

LT_DEV void w_put(const wmem &m, uint32_t idx, const fp &a) {
  uint32_t *p = m.sm + w_col(m, idx);
#pragma unroll
  for (int i = 0; i < LT_NL; i++) p[i * m.cols] = a.w[i];
}

// ---------------------------------------------------------------------------
// The programs' Fp inversion (LT_OP_INV: the final exponentiation's, the
// affine conversion's, the hash's two in one phase), each on one thread:
// Pornin's binary GCD ("Optimized Binary GCD for Modular Inversion", 2020)
// on the canonical
// integer, variable time (every value it sees derives from public pubkeys,
// signatures and signing roots).  Each outer step runs LT_GCD_STEPS
// binary-GCD steps on 62-bit approximations of a and b (their low 30 bits
// and the top 32 bits of the longer one's length) in 64-bit words, and
// gathers them into a 2x2 matrix of factors |f| + |g| <= 2^30; then it
// applies the matrix to the 384-bit a and b (an exact division by 2^30)
// and to u and v (mod p, the division by 2^30 a Montgomery reduction).
// Invariant: a = u y, b = v y (mod p); it stops at a = 0 with b = 1.  At
// most 26 outer steps (2 len(p) - 1 = 761 GCD steps), ~18.4 on random
// values.  The Fermat chain fp_inv is ~608 dependent products.  Returns
// the plain inverse of y's integer (0 for 0); the program multiplies it by
// R^3 to get y^-1 in Montgomery form.
// ---------------------------------------------------------------------------

#define LT_GCD_STEPS 30
#define LT_GCD_MASK ((1u << LT_GCD_STEPS) - 1u)

LT_DEV int w_clz(uint32_t x) {
#ifdef __CUDACC__
  return __clz((int)x);
#else
  return __builtin_clz(x);
#endif
}

// t = (x f + y g) / 2^30 as 13 limbs in two's complement, for x, y < 2^384
// and |f| + |g| <= 2^30, with `extra` times p added before the division
// (the caller's Montgomery quotient; 0 for a and b, whose sum the GCD
// steps made divisible by 2^30)
LT_DEV void w_gcd_lin(uint32_t *t, const uint32_t *x, int32_t f, const uint32_t *y, int32_t g, uint32_t extra) {
  uint32_t r[LT_NL + 1];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    // x[i] f as an unsigned 32 x 32 product less x[i] 2^32 for f < 0:
    // the true value is below 2^62 in magnitude
    const uint64_t px = (uint64_t)x[i] * (uint32_t)f - (f < 0 ? (uint64_t)x[i] << 32 : 0ull);
    const uint64_t py = (uint64_t)y[i] * (uint32_t)g - (g < 0 ? (uint64_t)y[i] << 32 : 0ull);
    // |acc| < 2^63: x[i] f + y[i] g and extra p[i] below 2^62 each, the carry below 2^33
    acc += (int64_t)(px + py) + (int64_t)((uint64_t)extra * LT_P[i]);
    r[i] = (uint32_t)acc;
    acc >>= 32;
  }
  r[LT_NL] = (uint32_t)acc;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) t[i] = (r[i] >> LT_GCD_STEPS) | (r[i + 1] << (32 - LT_GCD_STEPS));
  t[LT_NL] = (uint32_t)((int32_t)r[LT_NL] >> LT_GCD_STEPS);
}

// a 13-limb two's complement value -> its magnitude in 12 limbs; returns
// whether it was negative
LT_DEV bool w_gcd_abs(uint32_t *x, const uint32_t *t) {
  const bool neg = (int32_t)t[LT_NL] < 0;
  uint64_t c = neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    c += (uint64_t)(neg ? ~t[i] : t[i]);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
  return neg;
}

// u <- (u f + v g) / 2^30 mod p, canonical, for canonical u and v
LT_DEV void w_gcd_mod(uint32_t *out, const uint32_t *u, int32_t f, const uint32_t *v, int32_t g) {
  // the quotient m makes the sum divisible by 2^30: m = -(u f + v g) / p mod 2^30
  const uint32_t lo = u[0] * (uint32_t)f + v[0] * (uint32_t)g;
  uint32_t t[LT_NL + 1];
  w_gcd_lin(t, u, f, v, g, (lo * LT_N0) & LT_GCD_MASK);
  // t in (-p, 2p): add p if negative, subtract it if >= p
  const bool neg = (int32_t)t[LT_NL] < 0;
  uint32_t d[LT_NL + 1];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    c += (int64_t)t[i] + (neg ? (int64_t)LT_P[i] : -(int64_t)LT_P[i]);
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  d[LT_NL] = (uint32_t)(c + (int64_t)(int32_t)t[LT_NL]);
  const bool take = neg || (int32_t)d[LT_NL] >= 0;  // t + p, or t - p where it is not negative
#pragma unroll
  for (int i = 0; i < LT_NL; i++) out[i] = take ? d[i] : t[i];
}

// bits [s, s + 32) of a 12-limb value, for 0 <= s <= 352 (limbs past the
// top read as 0); the loop is unrolled, so the limbs stay in registers
LT_DEV uint32_t w_gcd_window(const uint32_t *x, int s) {
  const int q = s >> 5, k = s & 31;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    lo = i == q ? x[i] : lo;
    hi = i == q + 1 ? x[i] : hi;
  }
  return k ? (lo >> k) | (hi << (32 - k)) : lo;
}

LT_DEV void fp_inv_var(fp &r, const fp &y) {
  uint32_t a[LT_NL], b[LT_NL], u[LT_NL], v[LT_NL];
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    a[i] = y.w[i];
    b[i] = LT_P[i];
    u[i] = 0;
    v[i] = 0;
  }
  u[0] = 1;
  for (;;) {
    uint32_t ao = 0;
    int top = 0;  // the highest limb of a | b that is not 0 (b >= 1 throughout)
#pragma unroll
    for (int i = 0; i < LT_NL; i++) {
      ao |= a[i];
      top = (a[i] | b[i]) ? i : top;
    }
    if (ao == 0) break;
    const uint32_t tw = a[top] | b[top];
    int n = 32 * top + 32 - w_clz(tw);
    n = n < 2 * LT_GCD_STEPS + 2 ? 2 * LT_GCD_STEPS + 2 : n;
    uint64_t xa = (uint64_t)w_gcd_window(a, n - 32) << LT_GCD_STEPS | (a[0] & LT_GCD_MASK);
    uint64_t xb = (uint64_t)w_gcd_window(b, n - 32) << LT_GCD_STEPS | (b[0] & LT_GCD_MASK);
    // one step: xa odd -> (swap where xa < xb,) xa -= xb; then xa halved.
    // (Skipping a run of even xa by its trailing zeros measured slower on
    // the H100: the branch costs more than the steps it saves.)
    int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
    for (int j = 0; j < LT_GCD_STEPS; j++) {
      if (xa & 1u) {
        if (xa < xb) {
          const uint64_t x = xa;
          xa = xb;
          xb = x;
          int32_t z = f0;
          f0 = f1;
          f1 = z;
          z = g0;
          g0 = g1;
          g1 = z;
        }
        xa -= xb;
        f0 -= f1;
        g0 -= g1;
      }
      xa >>= 1;
      f1 += f1;  // |f1|, |g1| <= 2^j stay within 2^30
      g1 += g1;
    }
    uint32_t t[LT_NL + 1], na[LT_NL];
    w_gcd_lin(t, a, f0, b, g0, 0);
    if (w_gcd_abs(na, t)) {
      f0 = -f0;
      g0 = -g0;
    }
    w_gcd_lin(t, a, f1, b, g1, 0);
    if (w_gcd_abs(b, t)) {
      f1 = -f1;
      g1 = -g1;
    }
#ifndef __CUDACC__
    lt_gcd_steps++;
#endif
    uint32_t nu[LT_NL];
    w_gcd_mod(nu, u, f0, v, g0);
    w_gcd_mod(v, u, f1, v, g1);
#pragma unroll
    for (int i = 0; i < LT_NL; i++) {
      a[i] = na[i];
      u[i] = nu[i];
    }
  }
  // a = 0 and b = gcd = 1, or y = 0 (then v = 0)
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = v[i];
}

// ---------------------------------------------------------------------------
// The interpreter
// ---------------------------------------------------------------------------

#define LT_NOP 0xffffffffu  // an empty place in a phase's rows

// one instruction word: kind << 30 | dst << 20 | a << 10 | b.  The
// inversion is compiled only where a wanted program has one
// (warp_prog.cuh defines LT_WANT_INV) and the caller's program is one of
// them (INV, by default whether any is): it would take registers from the
// interpreter of every other program, also in a source that holds both
// kinds (csrc/ingest.cu runs g2_decompress with INV false).
#ifdef LT_WANT_INV
#define LT_INV_DEFAULT true
#else
#define LT_INV_DEFAULT false
#endif

template <bool INV = LT_INV_DEFAULT>
LT_DEV void w_exec(const wmem &m, uint32_t word) {
  const uint32_t kind = word >> 30;
  fp x, y, r;
  w_get(x, m, (word >> 10) & 1023u);
#ifdef LT_WANT_INV
  if (INV && kind == LT_OP_INV) {
    fp_inv_var(r, x);
    w_put(m, (word >> 20) & 1023u, r);
    return;
  }
#endif
  w_get(y, m, word & 1023u);
  if (kind == LT_OP_MUL)
    fp_mont_mul(r, x, y);
  else if (kind == LT_OP_ADD)
    fp_add(r, x, y);
  else
    fp_sub(r, x, y);
  w_put(m, (word >> 20) & 1023u, r);
}

// Run phase words [count << 21 | offset] over the instruction words: a
// phase's words are rows of 32, thread t running words t, t + 32, ...
template <bool INV = LT_INV_DEFAULT>
LT_DEV void w_run(const wmem &m, const uint32_t *phase, int nphase, const uint32_t *ins) {
#ifdef __CUDACC__
  // The next phase's word and this thread's first instruction of it are
  // loaded while the current phase runs: a phase then waits on no load.
  const int t = LT_T0;
  auto first = [&](uint32_t ph) {
    return t < (int)(ph >> 21) ? __ldg(ins + (ph & 0x1fffffu) + t) : LT_NOP;
  };
  uint32_t ph = __ldg(phase), ph1 = nphase > 1 ? __ldg(phase + 1) : 0u;
  uint32_t w = first(ph);
  for (int k = 0; k < nphase; k++) {
    const uint32_t ph2 = k + 2 < nphase ? __ldg(phase + k + 2) : 0u;
    const uint32_t w1 = first(ph1);
    const int cnt = (int)(ph >> 21), off = (int)(ph & 0x1fffffu);
    if (w != LT_NOP) w_exec<INV>(m, w);
    for (int i = t + LT_WARP; i < cnt; i += LT_WARP) {
      const uint32_t wi = __ldg(ins + off + i);
      if (wi != LT_NOP) w_exec<INV>(m, wi);
    }
    __syncwarp();
    ph = ph1;
    ph1 = ph2;
    w = w1;
  }
#else
  for (int k = 0; k < nphase; k++) {
    const int cnt = (int)(phase[k] >> 21), off = (int)(phase[k] & 0x1fffffu);
    bool round = false;
    for (int i = 0; i < cnt; i++) {
      const uint32_t kind = ins[off + i] >> 30;
      round |= ins[off + i] != LT_NOP && (kind == LT_OP_MUL || kind == LT_OP_INV);
    }
    lt_rounds += round;
    for (int j = 0; j < LT_WARP; j++) {  // virtual threads, forwards or reversed
      const int t = lt_host_rev ? LT_WARP - 1 - j : j;
      for (int i = t; i < cnt; i += LT_WARP)
        if (ins[off + i] != LT_NOP) w_exec<INV>(m, ins[off + i]);
    }
  }
#endif
}

// Load `count` Fp values of a lane from planes [count][12][n] into
// consecutive slots from `slot`, the warp's threads sharing the words.
LT_DEV void w_load_planes(const wmem &m, int slot, const int32_t *planes, int count, int n, int lane) {
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP)
    m.sm[(i % LT_NL) * m.cols + m.base + slot + i / LT_NL] = (uint32_t)planes[(size_t)i * n + lane];
}

// Store `count` consecutive slots from `slot` into planes [count][12][n].
LT_DEV void w_store_planes(const wmem &m, int slot, int32_t *planes, int count, int n, int lane) {
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP)
    planes[(size_t)i * n + lane] = (int32_t)m.sm[(i % LT_NL) * m.cols + m.base + slot + i / LT_NL];
}

// Copy `count` consecutive columns of the block from column `col` (another
// warp's slots, the constants) to the warp's slots from `dst` (ranges
// apart), the warp's threads sharing the words; the warp meets after it.
LT_DEV void w_copy_cols(const wmem &m, int dst, int col, int count) {
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP) {
    uint32_t *row = m.sm + (i % LT_NL) * m.cols;
    row[m.base + dst + i / LT_NL] = row[col + i / LT_NL];
  }
  LT_SYNCWARP();
}

// the same from the warp's own slots from `src`
LT_DEV void w_copy(const wmem &m, int dst, int src, int count) { w_copy_cols(m, dst, m.base + src, count); }

// Zero `count` consecutive slots from `dst`; the warp meets after it.
LT_DEV void w_zero(const wmem &m, int dst, int count) {
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP) m.sm[(i % LT_NL) * m.cols + m.base + dst + i / LT_NL] = 0;
  LT_SYNCWARP();
}

// Whether `count` consecutive slots from `a` equal those from `b` (b < 0:
// zero).  Values are canonical, so equal limbs are equal elements.  The
// threads share the words and vote: every thread of the warp gets the
// same answer, so a select on it never diverges.
LT_DEV bool w_eq(const wmem &m, int a, int b, int count) {
  uint32_t diff = 0;
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP) {
    const uint32_t *row = m.sm + (i % LT_NL) * m.cols + m.base;
    diff |= row[a + i / LT_NL] ^ (b < 0 ? 0u : row[b + i / LT_NL]);
  }
#ifdef __CUDACC__
  const bool eq = !__any_sync(0xffffffffu, diff != 0);
#else
  const bool eq = diff == 0;
#endif
  LT_SYNCWARP();  // every read is done before a select writes
  return eq;
}

// A program's tables, for the segment loops that run it a segment at a time:
// the phase starts of its segments in the order they run (LT_<name>_SEG),
// its phase words and its instruction words.
struct wprog {
  const uint32_t *seg, *phase, *ins;
};

// segment k of the program's order
template <bool INV = LT_INV_DEFAULT>
LT_DEV void w_segment(const wmem &m, const wprog &p, int k) {
  const uint32_t a = p.seg[k], b = p.seg[k + 1];
  w_run<INV>(m, p.phase + a, (int)(b - a), p.ins);
}

// The block's dynamic shared memory for `warps` warps of a program of
// `slots` and `nconst`.
static inline size_t w_smem_bytes(int slots, int nconst, int warps = LT_LPB) {
  return (size_t)LT_NL * (warps * slots + nconst) * sizeof(uint32_t);
}

// Launch shape of a warp-per-lane kernel over n lanes: LT_LPB lanes (one
// warp each) per block.  The library keeps each kernel's last launch
// (shape and program figures), by the kernel's name, for
// lt_warp_last_launch: a library may hold two warp kernels.
struct wlaunch {
  int blocks, threads;
  size_t smem;
};

#define LT_LAUNCH_KERNELS 4  // warp kernels one library may hold
static const char *lt_launch_name[LT_LAUNCH_KERNELS];
static int lt_launch_shape[LT_LAUNCH_KERNELS][8];

static inline void w_record(const char *name, const int shape[8]) {
  int k = 0;
  while (k < LT_LAUNCH_KERNELS - 1 && lt_launch_name[k] && strcmp(lt_launch_name[k], name)) k++;
  lt_launch_name[k] = name;
  for (int i = 0; i < 8; i++) lt_launch_shape[k][i] = shape[i];
}

static inline wlaunch w_launch(const char *name, int n, int slots, int nconst, int phases, int rounds) {
  const wlaunch l = {(n + LT_LPB - 1) / LT_LPB, LT_WARP * LT_LPB, w_smem_bytes(slots, nconst)};
  const int shape[8] = {n, l.blocks, l.threads, LT_LPB, (int)l.smem, slots, phases, rounds};
  w_record(name, shape);
  return l;
}

// out[8]: lanes, blocks, threads per block, lanes per block, dynamic shared
// bytes per block, slots per lane, phases and rounds per lane of the last
// launch of the library's warp kernel `name` (kernels/verify.py's name:
// "miller_loop", "g1_rpk", ...; for "sum_g2" the first launch of the last
// call, with its inputs per block and the phases and rounds of one
// addition); returns 1 and zeros if it has none
extern "C" int lt_warp_last_launch(const char *name, int *out) {
  for (int k = 0; k < LT_LAUNCH_KERNELS; k++)
    if (lt_launch_name[k] && !strcmp(lt_launch_name[k], name)) {
      for (int i = 0; i < 8; i++) out[i] = lt_launch_shape[k][i];
      return 0;
    }
  for (int i = 0; i < 8; i++) out[i] = 0;
  return 1;
}
