// The warp engine of the pairing kernels, r sig, r pk and the G2 decompression:
// one warp per lane.
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
// __syncwarp() nothing; lt_host_rounds() counts the rounds it ran.
#pragma once

#include <stddef.h>
#include <string.h>

#include "fp.cuh"

#ifdef __CUDACC__
#define LT_PROG static __device__ const
#else
#define LT_PROG static const
#endif

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
#endif

// a warp's view of its block's shared memory
struct wmem {
  uint32_t *sm;
  int cols;   // columns of the block: LT_LPB * slots + constants
  int base;   // the warp's first column
  int slots;  // slots per lane: operand indices below it are the warp's own
  int cbase;  // the constants' first column
};

// The block's memory: 12 words per column.  Every thread loads its share
// of the program's constants; the block meets once.
LT_DEV wmem w_block(uint32_t *sm, int slots, int nconst, const uint32_t (*consts)[LT_NL], int warp) {
  wmem m;
  m.sm = sm;
  m.cols = LT_LPB * slots + nconst;
  m.base = warp * slots;
  m.slots = slots;
  m.cbase = LT_LPB * slots;
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
// The one inversion of the final exponentiation: a binary extended Euclid
// on the canonical integer (variable time: every value it sees derives
// from public pubkeys, signatures and signing roots).  The Fermat chain
// fp_inv is ~608 dependent products; this is ~380 subtractions, each
// after a halving by the trailing zero bits, on one thread.  Returns the
// plain inverse of a's integer (0 for 0); the program multiplies it by
// R^3 to get a^-1 in Montgomery form.
// ---------------------------------------------------------------------------

LT_DEV int w_ctz(uint32_t x) {
#ifdef __CUDACC__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

LT_DEV bool w_is_one(const uint32_t *u) {
  uint32_t acc = u[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < LT_NL; i++) acc |= u[i];
  return acc == 0;
}

// u >>= k and x <- x / 2^k mod p, for 0 < k < 32: x + m p with m chosen so
// that the low k bits vanish (m = x N0 mod 2^k) stays below 2^k p, so the
// shifted sum is canonical
LT_DEV void w_halve(uint32_t *u, uint32_t *x, int k) {
#pragma unroll
  for (int i = 0; i < LT_NL - 1; i++) u[i] = (u[i] >> k) | (u[i + 1] << (32 - k));
  u[LT_NL - 1] >>= k;
  const uint32_t m = (x[0] * LT_N0) & ((1u << k) - 1u);
  uint32_t t[LT_NL + 1];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    c += (uint64_t)x[i] + (uint64_t)m * LT_P[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  t[LT_NL] = (uint32_t)c;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) x[i] = (t[i] >> k) | (t[i + 1] << (32 - k));
}

// u -= v when u >= v (returns whether it did); x -= y mod p alongside
LT_DEV bool w_sub_if_geq(uint32_t *u, const uint32_t *v, uint32_t *x, const uint32_t *y) {
  uint32_t d[LT_NL];
  uint64_t b = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    const uint64_t s = (uint64_t)u[i] - v[i] - b;
    d[i] = (uint32_t)s;
    b = (s >> 32) & 1u;
  }
  if (b) return false;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) u[i] = d[i];
  b = 0;
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    const uint64_t s = (uint64_t)x[i] - y[i] - b;
    x[i] = (uint32_t)s;
    b = (s >> 32) & 1u;
  }
  if (b) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < LT_NL; i++) {
      c += (uint64_t)x[i] + LT_P[i];
      x[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return true;
}

LT_DEV void fp_inv_euclid(fp &r, const fp &a) {
  uint32_t u[LT_NL], v[LT_NL], x1[LT_NL], x2[LT_NL];
#pragma unroll
  for (int i = 0; i < LT_NL; i++) {
    u[i] = a.w[i];
    v[i] = LT_P[i];
    x1[i] = 0;
    x2[i] = 0;
  }
  x1[0] = 1;
  if (fp_is_zero(a)) {
    fp_zero(r);
    return;
  }
  // invariant: x1 a = u, x2 a = v (mod p); u, v odd after the halvings
  while (!w_is_one(u) && !w_is_one(v)) {
    while ((u[0] & 1u) == 0) w_halve(u, x1, u[0] ? w_ctz(u[0]) : 31);
    while ((v[0] & 1u) == 0) w_halve(v, x2, v[0] ? w_ctz(v[0]) : 31);
    if (!w_sub_if_geq(u, v, x1, x2)) w_sub_if_geq(v, u, x2, x1);
  }
  const bool uo = w_is_one(u);
#pragma unroll
  for (int i = 0; i < LT_NL; i++) r.w[i] = uo ? x1[i] : x2[i];
}

// ---------------------------------------------------------------------------
// The interpreter
// ---------------------------------------------------------------------------

#define LT_NOP 0xffffffffu  // an empty place in a phase's rows

// one instruction word: kind << 30 | dst << 20 | a << 10 | b
LT_DEV void w_exec(const wmem &m, uint32_t word) {
  const uint32_t kind = word >> 30;
  fp x, y, r;
  w_get(x, m, (word >> 10) & 1023u);
  if (kind == LT_OP_INV) {
    fp_inv_euclid(r, x);
  } else {
    w_get(y, m, word & 1023u);
    if (kind == LT_OP_MUL)
      fp_mont_mul(r, x, y);
    else if (kind == LT_OP_ADD)
      fp_add(r, x, y);
    else
      fp_sub(r, x, y);
  }
  w_put(m, (word >> 20) & 1023u, r);
}

// Run phase words [count << 21 | offset] over the instruction words: a
// phase's words are rows of 32, thread t running words t, t + 32, ...
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
    if (w != LT_NOP) w_exec(m, w);
    for (int i = t + LT_WARP; i < cnt; i += LT_WARP) {
      const uint32_t wi = __ldg(ins + off + i);
      if (wi != LT_NOP) w_exec(m, wi);
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
        if (ins[off + i] != LT_NOP) w_exec(m, ins[off + i]);
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

// Copy `count` consecutive slots from `src` to `dst` (ranges apart), the
// warp's threads sharing the words; the warp meets after it.
LT_DEV void w_copy(const wmem &m, int dst, int src, int count) {
  for (int i = LT_T0; i < count * LT_NL; i += LT_TSTEP) {
    uint32_t *row = m.sm + (i % LT_NL) * m.cols + m.base;
    row[dst + i / LT_NL] = row[src + i / LT_NL];
  }
  LT_SYNCWARP();
}

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
LT_DEV void w_segment(const wmem &m, const wprog &p, int k) {
  const uint32_t a = p.seg[k], b = p.seg[k + 1];
  w_run(m, p.phase + a, (int)(b - a), p.ins);
}

// The block's dynamic shared memory for a program of `slots` and `nconst`.
static inline size_t w_smem_bytes(int slots, int nconst) {
  return (size_t)LT_NL * (LT_LPB * slots + nconst) * sizeof(uint32_t);
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

static inline wlaunch w_launch(const char *name, int n, int slots, int nconst, int phases, int rounds) {
  const wlaunch l = {(n + LT_LPB - 1) / LT_LPB, LT_WARP * LT_LPB, w_smem_bytes(slots, nconst)};
  const int shape[8] = {n, l.blocks, l.threads, LT_LPB, (int)l.smem, slots, phases, rounds};
  int k = 0;
  while (k < LT_LAUNCH_KERNELS - 1 && lt_launch_name[k] && strcmp(lt_launch_name[k], name)) k++;
  lt_launch_name[k] = name;
  for (int i = 0; i < 8; i++) lt_launch_shape[k][i] = shape[i];
  return l;
}

// out[8]: lanes, blocks, threads per block, lanes per block, dynamic shared
// bytes per block, slots per lane, phases and rounds per lane of the last
// launch of the library's warp kernel `name` (kernels/verify.py's name:
// "miller_loop", "g1_rpk", ...); returns 1 and zeros if it has none
extern "C" int lt_warp_last_launch(const char *name, int *out) {
  for (int k = 0; k < LT_LAUNCH_KERNELS; k++)
    if (lt_launch_name[k] && !strcmp(lt_launch_name[k], name)) {
      for (int i = 0; i < 8; i++) out[i] = lt_launch_shape[k][i];
      return 0;
    }
  for (int i = 0; i < 8; i++) out[i] = 0;
  return 1;
}
