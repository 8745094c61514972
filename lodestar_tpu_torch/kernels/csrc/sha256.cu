// The hash forest of the state root: SHA-256 of 64-byte blocks, three
// kernels over one device function.
//
//   lt_sha256_pairs       one tree level, one thread per pair
//                         (replaces lodestar_tpu/kernels/sha256.py
//                         hash_pairs_device, :166)
//   lt_sha256_sweep       K levels of a dirty batch, its live lanes only,
//                         over a cluster of up to 8 blocks
//                         (replaces forest_sweep_device, :184)
//   lt_sha256_validators  the validator leaves packed from the columns and
//                         hashed 8 -> 4 -> 2 -> 1, one thread per validator
//                         (replaces validator_roots_device, :293, with
//                         pack_validator_blocks_device, :250, as its first
//                         phase)
//
// Every message is exactly one 64-byte block, so the second compression's
// block is the constant padding block: its 64-word schedule, added to the
// round constants, is a table in constant memory (SHA_KPAD, from
// kernels/sha256.py _PAD_SCHEDULE), and the second compression computes no
// schedule.  The first keeps its schedule in a rolling 16-word window in
// registers.
//
// What bounds them: SHA-256's integer work.  A hash is ~2,300 integer
// instructions, ~2,030 of them on the ALU pipe (rotates as one funnel
// shift, Ch and Maj as one LOP3 each, IADD3) and the rest IMAD and VIADD on
// the FMA pipe beside it, against 96 bytes in and out, so at the ALU pipe's
// 64 lanes per SM and clock a million hashes need ~0.13 ms of integer issue
// and ~0.03 ms of memory traffic.  The designs keep every operand in registers: a thread
// reads its row with 16-byte loads, hashes it, and writes its digest; the
// validator kernel packs its 8 chunks in registers and keeps the subtree's
// inner levels out of device memory; the sweep keeps a level's pair plane
// in shared memory, one row a thread, so its K levels take one launch
// (its design is with kernel 2 below).
//
// Words are uint32 bit patterns (big-endian message words, as SHA-256
// reads them).  The same source compiles with a host C++ compiler, the
// threads of a kernel run one after another (the sweep's phase by phase,
// in either order), for the CPU tests (tests/test_torch_sha256.py).
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#define SHA_DEV __device__ __forceinline__
#define SHA_HOST_DEV __host__ __device__ __forceinline__
#define SHA_CONST static __constant__
#else
#define SHA_DEV static inline
#define SHA_HOST_DEV static inline
#define SHA_CONST static const
#endif

SHA_CONST uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

// SHA_K[t] + _PAD_SCHEDULE[t] mod 2^32: the padding block's rounds
SHA_CONST uint32_t SHA_KPAD[64] = {
    0xc28a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf374,
    0x649b69c1, 0xf0fe4786, 0x0fe1edc6, 0x240cf254, 0x4fe9346f, 0x6cc984be, 0x61b9411e, 0x16f988fa,
    0xf2c65152, 0xa88e5a6d, 0xb019fc65, 0xb9d99ec7, 0x9a1231c3, 0xe70eeaa0, 0xfdb1232b, 0xc7353eb0,
    0x3069bad5, 0xcb976d5f, 0x5a0f118f, 0xdc1eeefd, 0x0a35b689, 0xde0b7a04, 0x58f4ca9d, 0xe15d5b16,
    0x007f3e86, 0x37088980, 0xa507ea32, 0x6fab9537, 0x17406110, 0x0d8cd6f1, 0xcdaa3b6d, 0xc0bbbe37,
    0x83613bda, 0xdb48a363, 0x0b02e931, 0x6fd15ca7, 0x521afaca, 0x31338431, 0x6ed41a95, 0x6d437890,
    0xc39c91f2, 0x9eccabbd, 0xb5c9a0e6, 0x532fb63c, 0xd2c741c6, 0x07237ea3, 0xa4954b68, 0x4c191d76,
};

#define SHA_IV0 0x6a09e667u
#define SHA_IV1 0xbb67ae85u
#define SHA_IV2 0x3c6ef372u
#define SHA_IV3 0xa54ff53au
#define SHA_IV4 0x510e527fu
#define SHA_IV5 0x9b05688cu
#define SHA_IV6 0x1f83d9abu
#define SHA_IV7 0x5be0cd19u

SHA_DEV uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDACC__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

SHA_DEV uint32_t bswap32(uint32_t x) {
#ifdef __CUDACC__
  return __byte_perm(x, 0, 0x0123);
#else
  return (x << 24) | ((x & 0xff00u) << 8) | ((x >> 8) & 0xff00u) | (x >> 24);
#endif
}

// one round; the variables' roles rotate by renaming after unrolling
#define SHA_ROUND(a, b, c, d, e, f, g, h, kw)                                        \
  do {                                                                               \
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + (kw); \
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));  \
    d += t1;                                                                         \
    h = t1 + t2;                                                                     \
  } while (0)

// SHA-256 of one 64-byte message given as 16 big-endian words: the data
// block from the IV, then the constant padding block.
SHA_DEV void sha256_block64(const uint32_t in[16], uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = in[i];
  uint32_t a = SHA_IV0, b = SHA_IV1, c = SHA_IV2, d = SHA_IV3, e = SHA_IV4, f = SHA_IV5, g = SHA_IV6, h = SHA_IV7;
#pragma unroll
  for (int t = 0; t < 64; t += 8) {
    if (t >= 16) {
#pragma unroll
      for (int i = t; i < t + 8; i++) {
        const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
        w[i & 15] += (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(i - 7) & 15] + (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
      }
    }
    SHA_ROUND(a, b, c, d, e, f, g, h, SHA_K[t + 0] + w[(t + 0) & 15]);
    SHA_ROUND(h, a, b, c, d, e, f, g, SHA_K[t + 1] + w[(t + 1) & 15]);
    SHA_ROUND(g, h, a, b, c, d, e, f, SHA_K[t + 2] + w[(t + 2) & 15]);
    SHA_ROUND(f, g, h, a, b, c, d, e, SHA_K[t + 3] + w[(t + 3) & 15]);
    SHA_ROUND(e, f, g, h, a, b, c, d, SHA_K[t + 4] + w[(t + 4) & 15]);
    SHA_ROUND(d, e, f, g, h, a, b, c, SHA_K[t + 5] + w[(t + 5) & 15]);
    SHA_ROUND(c, d, e, f, g, h, a, b, SHA_K[t + 6] + w[(t + 6) & 15]);
    SHA_ROUND(b, c, d, e, f, g, h, a, SHA_K[t + 7] + w[(t + 7) & 15]);
  }
  const uint32_t s0 = SHA_IV0 + a, s1 = SHA_IV1 + b, s2 = SHA_IV2 + c, s3 = SHA_IV3 + d;
  const uint32_t s4 = SHA_IV4 + e, s5 = SHA_IV5 + f, s6 = SHA_IV6 + g, s7 = SHA_IV7 + h;
  a = s0, b = s1, c = s2, d = s3, e = s4, f = s5, g = s6, h = s7;
#pragma unroll
  for (int t = 0; t < 64; t += 8) {
    SHA_ROUND(a, b, c, d, e, f, g, h, SHA_KPAD[t + 0]);
    SHA_ROUND(h, a, b, c, d, e, f, g, SHA_KPAD[t + 1]);
    SHA_ROUND(g, h, a, b, c, d, e, f, SHA_KPAD[t + 2]);
    SHA_ROUND(f, g, h, a, b, c, d, e, SHA_KPAD[t + 3]);
    SHA_ROUND(e, f, g, h, a, b, c, d, SHA_KPAD[t + 4]);
    SHA_ROUND(d, e, f, g, h, a, b, c, SHA_KPAD[t + 5]);
    SHA_ROUND(c, d, e, f, g, h, a, b, SHA_KPAD[t + 6]);
    SHA_ROUND(b, c, d, e, f, g, h, a, SHA_KPAD[t + 7]);
  }
  out[0] = s0 + a, out[1] = s1 + b, out[2] = s2 + c, out[3] = s3 + d;
  out[4] = s4 + e, out[5] = s5 + f, out[6] = s6 + g, out[7] = s7 + h;
}

// n words from p into w (16-byte loads on the card; p 16-byte aligned)
SHA_DEV void load_words(const uint32_t *p, uint32_t *w, int n) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const uint4 v = *(const uint4 *)(p + i);
    w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
  }
#else
  for (int i = 0; i < n; i++) w[i] = p[i];
#endif
}

SHA_DEV void store8(uint32_t *p, const uint32_t d[8]) {
#ifdef __CUDACC__
  *(uint4 *)p = make_uint4(d[0], d[1], d[2], d[3]);
  *(uint4 *)(p + 4) = make_uint4(d[4], d[5], d[6], d[7]);
#else
  for (int i = 0; i < 8; i++) p[i] = d[i];
#endif
}

// ---------------------------------------------------------------------------
// Kernel 1: one tree level.  in [n, 16] -> out [n, 8], thread i row i.
// ---------------------------------------------------------------------------

SHA_DEV void pairs_lane(const uint32_t *in, uint32_t *out, size_t i) {
  uint32_t w[16], dg[8];
  load_words(in + 16 * i, w, 16);
  sha256_block64(w, dg);
  store8(out + 8 * i, dg);
}

// ---------------------------------------------------------------------------
// Kernel 2: the forest sweep.  pairs [k, b, 16], lane and half [k, b],
// live [k] (NULL: every lane live), out [k, b, 8].  Level l hashes its
// live lanes [0, live[l]) (clamped to [0, b]); a dead lane's output row is
// zeros.  Level l's digest of lane i (i live) goes into row lane[l, i],
// half half[l, i] of level l + 1's plane (dropped where that row is not
// live at l + 1 or the half is not 0 or 1) before that level hashes.
//
// What holds it back is the chain: level l + 1 reads level l's digests,
// so the K levels are K dependent hashes, and no design beats K times one
// hash's dependent critical path (chip_smoke.py reads it from the SASS:
// the chain floor); this build's lone warp also waits on its ALU-pipe
// instructions, 2 clocks a warp instruction on an SM sub-partition's
// 16-lane pipe, which chip_smoke.py prints beside the floor.  The plan's wide levels
// (~256 live lanes a level for the first ~12 of a slot's 40) are the part
// that throughput can shorten: one SM issues 256 hashes in ~4 us, eight
// SMs in about one hash's latency.  So the sweep runs on a thread-block
// cluster of C = min(8, ceil(b / 32)) blocks of S = ceil(b / C) threads;
// lane i is thread i % S of block i / S, and each block keeps its lanes'
// rows of two planes (levels l and l + 1) in its own shared memory.  A
// phase, one a level: each live thread starts the 16-byte loads of its
// row of level l + 2 and of its scatter map entry, hashes its row of
// level l (the body as
// hash_pairs': registers, the rolling schedule, SHA_KPAD), writes its
// digest to out, stores it into its destination row of level l + 1 in
// the owning block's shared memory (distributed shared memory,
// cluster.map_shared_rank), and stores the level l + 2 row into the plane
// it just hashed; then one barrier.  Two planes make one barrier a level
// enough: a phase writes the other plane's rows of other threads and its
// own rows of this one.  From the first level after which no level has
// more than S live lanes, block 0 runs alone (the others write their zero
// rows and exit after a cluster barrier), with a block barrier a level in
// place of the cluster's.  Dead lanes hash nothing.  One block of B
// threads over the live lanes, the other design, hashes a slot plan's
// wide levels on one SM and was slower on every plan measured (PERF.md);
// a rolled hash (a quarter of the code) made the lone warp slower too.
// ---------------------------------------------------------------------------

#define SHA_SWEEP_STRIDE 17  // words a shared row: 16, padded against bank conflicts
#define SHA_SWEEP_CTAS 8  // blocks of the cluster at most (the portable cluster size)

// blocks of a sweep's cluster for b lanes
SHA_HOST_DEV int sweep_ctas(int b) {
  const int c = (b + 31) / 32;
  return c < 1 ? 1 : (c > SHA_SWEEP_CTAS ? SHA_SWEEP_CTAS : c);
}

// the live lanes of level l, clamped to [0, b]
SHA_DEV int sweep_live(const int32_t *live, int level, int b) {
  if (!live) return b;
  const int n = live[level];
  return n < 0 ? 0 : (n > b ? b : n);
}

// the first level from which no level has more than `share` live lanes
SHA_DEV int sweep_narrow(const int32_t *lv, int k, int share) {
  int narrow = k;
  while (narrow > 0 && lv[narrow - 1] <= share) narrow--;
  return narrow;
}

SHA_DEV void sweep_store_row(uint32_t *row, const uint32_t w[16]) {
  for (int j = 0; j < 16; j++) row[j] = w[j];
}

// lane i's row of level `level` from pairs into registers
SHA_DEV void sweep_fetch(const uint32_t *pairs, uint32_t w[16], int level, int b, int i) {
  load_words(pairs + ((size_t)level * b + i) * 16, w, 16);
}

// lane i at level `level`: hash its row into dg and out if it is live,
// else write its output row as zeros
SHA_DEV void sweep_hash(const uint32_t *row, uint32_t *out, uint32_t dg[8], int level, int b, int i, int live_l) {
  if (i >= b) return;
  if (i < live_l) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; j++) w[j] = row[j];
    sha256_block64(w, dg);
    store8(out + ((size_t)level * b + i) * 8, dg);
  } else {
    const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    store8(out + ((size_t)level * b + i) * 8, zero);
  }
}

// lane i's scatter map entry at level `level`: its row in level + 1's
// plane and its half (read before the hash, so the loads are in flight
// across it)
SHA_DEV void sweep_map(const int32_t *lane, const int32_t *half, int level, int b, int i, int32_t *to, int32_t *hf) {
  *to = lane[(size_t)level * b + i];
  *hf = half[(size_t)level * b + i];
}

// whether that entry lands: a live row of the next level, half 0 or 1
SHA_DEV bool sweep_lands(int32_t to, int32_t hf, int live_next) {
  return to >= 0 && to < live_next && (hf == 0 || hf == 1);
}

SHA_DEV void sweep_put(uint32_t *row_half, const uint32_t dg[8]) {
  for (int j = 0; j < 8; j++) row_half[j] = dg[j];
}

// lane i's zero rows of levels [from, k)
SHA_DEV void sweep_zeros(uint32_t *out, int from, int k, int b, int i) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (i < b)
    for (int l = from; l < k; l++) store8(out + ((size_t)l * b + i) * 8, zero);
}

// ---------------------------------------------------------------------------
// Kernel 3: validator roots.  pk, cr [n, 8] words; eb, aee, ae, ee, we
// [n, 2] (lo, hi) words of the uint64 columns in host order; slashed [n];
// out [n, 8].  The chunks, as pack_validator_blocks_device lays them out:
// pubkey root, credentials, effective balance, slashed (byte 0),
// activation eligibility, activation, exit, withdrawable epochs; a uint64
// chunk's big-endian words are bswap32(lo), bswap32(hi), then zeros.
// ---------------------------------------------------------------------------

SHA_DEV void u64_chunk(const uint32_t *col, size_t i, uint32_t *w) {
  uint32_t v[2];
#ifdef __CUDACC__
  const uint2 x = *(const uint2 *)(col + 2 * i);
  v[0] = x.x, v[1] = x.y;
#else
  v[0] = col[2 * i], v[1] = col[2 * i + 1];
#endif
  w[0] = bswap32(v[0]), w[1] = bswap32(v[1]);
#pragma unroll
  for (int j = 2; j < 8; j++) w[j] = 0;
}

SHA_DEV void validator_lane(const uint32_t *pk, const uint32_t *cr, const uint32_t *eb, const uint32_t *aee,
                            const uint32_t *ae, const uint32_t *ee, const uint32_t *we, const uint32_t *slashed,
                            uint32_t *out, size_t i) {
  uint32_t w[16], x[8], y[8];
  // H(pubkey root | credentials) -> x
  load_words(pk + 8 * i, w, 8);
  load_words(cr + 8 * i, w + 8, 8);
  sha256_block64(w, x);
  // H(effective balance | slashed) -> y
  u64_chunk(eb, i, w);
  w[8] = slashed[i] << 24;
#pragma unroll
  for (int j = 9; j < 16; j++) w[j] = 0;
  sha256_block64(w, y);
  // H(x | y) -> x: the left half of the container
#pragma unroll
  for (int j = 0; j < 8; j++) w[j] = x[j], w[8 + j] = y[j];
  sha256_block64(w, x);
  // H(activation eligibility | activation) -> y
  u64_chunk(aee, i, w);
  u64_chunk(ae, i, w + 8);
  sha256_block64(w, y);
  // H(exit | withdrawable) -> w[8..15], then H(y | it) -> y: the right half
  u64_chunk(ee, i, w);
  u64_chunk(we, i, w + 8);
  uint32_t z[8];
  sha256_block64(w, z);
#pragma unroll
  for (int j = 0; j < 8; j++) w[j] = y[j], w[8 + j] = z[j];
  sha256_block64(w, y);
  // the root: H(left | right)
#pragma unroll
  for (int j = 0; j < 8; j++) w[j] = x[j], w[8 + j] = y[j];
  sha256_block64(w, z);
  store8(out + 8 * i, z);
}

#ifdef __CUDACC__

#define SHA_THREADS 256

__global__ void __launch_bounds__(SHA_THREADS) lt_sha256_pairs_kernel(const uint32_t *__restrict__ in,
                                                                     uint32_t *__restrict__ out, int n) {
  const size_t i = (size_t)blockIdx.x * SHA_THREADS + threadIdx.x;
  if (i < (size_t)n) pairs_lane(in, out, i);
}

__global__ void __launch_bounds__(1024) lt_sha256_sweep_kernel(const uint32_t *__restrict__ pairs,
                                                              const int32_t *__restrict__ lane,
                                                              const int32_t *__restrict__ half,
                                                              const int32_t *__restrict__ live,
                                                              uint32_t *__restrict__ out, int k, int b) {
  namespace cg = cooperative_groups;
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int share = blockDim.x, t = threadIdx.x, rank = (int)cluster.block_rank();
  const int i = rank * share + t;
  uint32_t *planes = smem;  // [2][share][SHA_SWEEP_STRIDE]: levels l and l + 1
  int32_t *lv = (int32_t *)(smem + 2 * share * SHA_SWEEP_STRIDE);
  for (int l = t; l < k; l += share) lv[l] = sweep_live(live, l, b);
  __syncthreads();
  const int narrow = sweep_narrow(lv, k, share);
  uint32_t w[16], dg[8];
  for (int l = 0; l < 2 && l < k; l++)
    if (i < lv[l]) {
      sweep_fetch(pairs, w, l, b, i);
      sweep_store_row(planes + (l * share + t) * SHA_SWEEP_STRIDE, w);
    }
  if (narrow > 0) cluster.sync();  // also: every block has started before any remote store
  else __syncthreads();
  for (int l = 0; l < k; l++) {
    const bool wide = l < narrow;
    if (!wide && rank != 0) {
      sweep_zeros(out, l, k, b, i);
      return;
    }
    uint32_t *row = planes + ((l & 1) * share + t) * SHA_SWEEP_STRIDE;
    const bool ahead = l + 2 < k && i < lv[l + 2];
    if (ahead) sweep_fetch(pairs, w, l + 2, b, i);
    const bool scatters = l + 1 < k && i < lv[l];
    int32_t to = -1, hf = 0;
    if (scatters) sweep_map(lane, half, l, b, i, &to, &hf);
    sweep_hash(row, out, dg, l, b, i, lv[l]);
    if (scatters && sweep_lands(to, hf, lv[l + 1])) {
      uint32_t *dst = planes + (((l + 1) & 1) * share + to % share) * SHA_SWEEP_STRIDE + hf * 8;
      sweep_put(wide ? cluster.map_shared_rank(dst, to / share) : dst, dg);
    }
    if (ahead) sweep_store_row(row, w);
    if (wide) cluster.sync();
    else __syncthreads();
  }
}

__global__ void __launch_bounds__(SHA_THREADS)
    lt_sha256_validators_kernel(const uint32_t *__restrict__ pk, const uint32_t *__restrict__ cr,
                                const uint32_t *__restrict__ eb, const uint32_t *__restrict__ aee,
                                const uint32_t *__restrict__ ae, const uint32_t *__restrict__ ee,
                                const uint32_t *__restrict__ we, const uint32_t *__restrict__ slashed,
                                uint32_t *__restrict__ out, int n) {
  const size_t i = (size_t)blockIdx.x * SHA_THREADS + threadIdx.x;
  if (i < (size_t)n) validator_lane(pk, cr, eb, aee, ae, ee, we, slashed, out, i);
}

extern "C" int lt_sha256_pairs(const void *in, void *out, int n, void *stream) {
  if (n > 0)
    lt_sha256_pairs_kernel<<<(n + SHA_THREADS - 1) / SHA_THREADS, SHA_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)in, (uint32_t *)out, n);
  return (int)cudaGetLastError();
}

// dynamic shared bytes a block of the sweep's cluster takes
static size_t sweep_smem(int k, int share) { return ((size_t)2 * share * SHA_SWEEP_STRIDE + k) * 4; }

extern "C" int lt_sha256_sweep(const void *pairs, const void *lane, const void *half, const void *live, void *out,
                               int k, int b, void *stream) {
  if (k > 0 && b > 0) {
    const int ctas = sweep_ctas(b), share = (b + ctas - 1) / ctas;
    const size_t smem = sweep_smem(k, share);
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(lt_sha256_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(share);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, lt_sha256_sweep_kernel, (const uint32_t *)pairs,
                                             (const int32_t *)lane, (const int32_t *)half, (const int32_t *)live,
                                             (uint32_t *)out, k, b);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int lt_sha256_validators(const void *pk, const void *cr, const void *eb, const void *aee,
                                    const void *ae, const void *ee, const void *we, const void *slashed,
                                    void *out, int n, void *stream) {
  if (n > 0)
    lt_sha256_validators_kernel<<<(n + SHA_THREADS - 1) / SHA_THREADS, SHA_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)pk, (const uint32_t *)cr, (const uint32_t *)eb, (const uint32_t *)aee,
        (const uint32_t *)ae, (const uint32_t *)ee, (const uint32_t *)we, (const uint32_t *)slashed,
        (uint32_t *)out, n);
  return (int)cudaGetLastError();
}

#else  // the host build: the kernels' threads one after another

#include <stdlib.h>

// The host hook every kernel library exports for the tests
// (kernels/build.py load_host): the sweep's threads run each phase forwards
// or (lt_host_warp_order(1)) reversed, so a phase in which one thread read
// what another writes would differ between the two orders.
static int sha_host_rev;
extern "C" void lt_host_warp_order(int reversed) { sha_host_rev = reversed; }

extern "C" int lt_sha256_pairs(const void *in, void *out, int n, void *stream) {
  (void)stream;
  for (size_t i = 0; i < (size_t)(n > 0 ? n : 0); i++) pairs_lane((const uint32_t *)in, (uint32_t *)out, i);
  return 0;
}

// The sweep's cluster: each phase runs block by block and, in each block,
// thread by thread, blocks and threads forwards or both reversed.  Each
// block's two planes are one slice of `planes`, as distributed shared
// memory addresses them.
extern "C" int lt_sha256_sweep(const void *pairs, const void *lane, const void *half, const void *live, void *out,
                               int k, int b, void *stream) {
  (void)stream;
  if (k <= 0 || b <= 0) return 0;
  const int ctas = sweep_ctas(b), share = (b + ctas - 1) / ctas;
  const size_t per_cta = (size_t)2 * share * SHA_SWEEP_STRIDE;
  uint32_t *planes = (uint32_t *)calloc((size_t)ctas * per_cta, 4);
  uint32_t *dg = (uint32_t *)calloc((size_t)ctas * share * 8, 4);
  uint32_t *w = (uint32_t *)calloc((size_t)ctas * share * 16, 4);
  int32_t *lv = (int32_t *)malloc((size_t)k * 4);
  for (int l = 0; l < k; l++) lv[l] = sweep_live((const int32_t *)live, l, b);
  const int narrow = sweep_narrow(lv, k, share);
  const uint32_t *pw = (const uint32_t *)pairs;
  const int32_t *ln = (const int32_t *)lane, *hv = (const int32_t *)half;
  uint32_t *ow = (uint32_t *)out;
  const int n = ctas * share;
  for (int x = 0; x < n; x++) {  // the prologue
    const int i = sha_host_rev ? n - 1 - x : x, rank = i / share, t = i % share;
    for (int l = 0; l < 2 && l < k; l++)
      if (i < lv[l]) {
        sweep_fetch(pw, w + 16 * i, l, b, i);
        sweep_store_row(planes + rank * per_cta + (l * share + t) * SHA_SWEEP_STRIDE, w + 16 * i);
      }
  }
  for (int l = 0; l < k; l++) {
    const bool wide = l < narrow;
    for (int x = 0; x < n; x++) {
      const int i = sha_host_rev ? n - 1 - x : x, rank = i / share, t = i % share;
      if (!wide && rank != 0) {
        if (l == narrow) sweep_zeros(ow, l, k, b, i);  // the block's exit
        continue;
      }
      uint32_t *row = planes + rank * per_cta + ((l & 1) * share + t) * SHA_SWEEP_STRIDE;
      const bool ahead = l + 2 < k && i < lv[l + 2];
      if (ahead) sweep_fetch(pw, w + 16 * i, l + 2, b, i);
      const bool scatters = l + 1 < k && i < lv[l];
      int32_t to = -1, hf = 0;
      if (scatters) sweep_map(ln, hv, l, b, i, &to, &hf);
      sweep_hash(row, ow, dg + 8 * i, l, b, i, lv[l]);
      if (scatters && sweep_lands(to, hf, lv[l + 1]))
        sweep_put(planes + (to / share) * per_cta + (((l + 1) & 1) * share + to % share) * SHA_SWEEP_STRIDE + hf * 8,
                  dg + 8 * i);
      if (ahead) sweep_store_row(row, w + 16 * i);
    }
  }
  free(lv);
  free(w);
  free(dg);
  free(planes);
  return 0;
}

extern "C" int lt_sha256_validators(const void *pk, const void *cr, const void *eb, const void *aee,
                                    const void *ae, const void *ee, const void *we, const void *slashed,
                                    void *out, int n, void *stream) {
  (void)stream;
  for (size_t i = 0; i < (size_t)(n > 0 ? n : 0); i++)
    validator_lane((const uint32_t *)pk, (const uint32_t *)cr, (const uint32_t *)eb, (const uint32_t *)aee,
                   (const uint32_t *)ae, (const uint32_t *)ee, (const uint32_t *)we, (const uint32_t *)slashed,
                   (uint32_t *)out, i);
  return 0;
}

#endif
