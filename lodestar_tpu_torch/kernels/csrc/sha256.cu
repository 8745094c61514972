// The hash forest of the state root: SHA-256 of 64-byte blocks, three
// kernels over one device function.
//
//   lt_sha256_pairs       one tree level, one thread per pair
//                         (replaces lodestar_tpu/kernels/sha256.py
//                         hash_pairs_device, :166)
//   lt_sha256_sweep       K levels of a dirty batch, one block of B threads
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
// in shared memory, one row a thread, and moves the previous level's
// digests into it between two barriers, so its K levels take one launch.
//
// Words are uint32 bit patterns (big-endian message words, as SHA-256
// reads them).  The same source compiles with a host C++ compiler, the
// threads of a kernel run one after another (the sweep's phase by phase,
// in either order), for the CPU tests (tests/test_torch_sha256.py).
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SHA_DEV __device__ __forceinline__
#define SHA_CONST static __constant__
#else
#define SHA_DEV static inline
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
// out [k, b, 8].  At level l each thread loads its row of pairs[l] into the
// shared plane (sweep_load); after a barrier it writes its level l - 1
// digest into row lane[l - 1], half half[l - 1] (sweep_scatter: a lane
// outside [0, b) or a half outside {0, 1} is dropped); after a second
// barrier it hashes its row (sweep_hash) into out[l] and keeps the digest
// for the next level.  Level 0 scatters nothing.
// ---------------------------------------------------------------------------

#define SHA_SWEEP_STRIDE 17  // words a shared row: 16, padded against bank conflicts

SHA_DEV void sweep_load(const uint32_t *pairs, uint32_t *plane, int level, int b, int t) {
  const uint32_t *src = pairs + ((size_t)level * b + t) * 16;
  uint32_t *row = plane + t * SHA_SWEEP_STRIDE;
  for (int i = 0; i < 16; i++) row[i] = src[i];
}

SHA_DEV void sweep_scatter(uint32_t *plane, const int32_t *lane, const int32_t *half, const uint32_t dg[8],
                           int level, int b, int t) {
  const int32_t dst = lane[(size_t)(level - 1) * b + t], hf = half[(size_t)(level - 1) * b + t];
  if (dst < 0 || dst >= b || (hf != 0 && hf != 1)) return;
  uint32_t *row = plane + dst * SHA_SWEEP_STRIDE + hf * 8;
  for (int i = 0; i < 8; i++) row[i] = dg[i];
}

SHA_DEV void sweep_hash(const uint32_t *plane, uint32_t *out, uint32_t dg[8], int level, int b, int t) {
  uint32_t w[16];
  const uint32_t *row = plane + t * SHA_SWEEP_STRIDE;
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = row[i];
  sha256_block64(w, dg);
  uint32_t *dst = out + ((size_t)level * b + t) * 8;
  for (int i = 0; i < 8; i++) dst[i] = dg[i];
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
                                                              uint32_t *__restrict__ out, int k, int b) {
  extern __shared__ uint32_t plane[];
  const int t = threadIdx.x;
  uint32_t dg[8];
  for (int level = 0; level < k; level++) {
    sweep_load(pairs, plane, level, b, t);
    __syncthreads();
    if (level > 0) sweep_scatter(plane, lane, half, dg, level, b, t);
    __syncthreads();
    sweep_hash(plane, out, dg, level, b, t);
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

extern "C" int lt_sha256_sweep(const void *pairs, const void *lane, const void *half, void *out, int k, int b,
                               void *stream) {
  if (k > 0 && b > 0) {
    const int smem = b * SHA_SWEEP_STRIDE * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(lt_sha256_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    lt_sha256_sweep_kernel<<<1, b, smem, (cudaStream_t)stream>>>(
        (const uint32_t *)pairs, (const int32_t *)lane, (const int32_t *)half, (uint32_t *)out, k, b);
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

extern "C" int lt_sha256_sweep(const void *pairs, const void *lane, const void *half, void *out, int k, int b,
                               void *stream) {
  (void)stream;
  if (k <= 0 || b <= 0) return 0;
  uint32_t *plane = (uint32_t *)malloc((size_t)b * SHA_SWEEP_STRIDE * 4);
  uint32_t *dg = (uint32_t *)malloc((size_t)b * 8 * 4);
  for (int level = 0; level < k; level++) {
    for (int i = 0; i < b; i++) {
      const int t = sha_host_rev ? b - 1 - i : i;
      sweep_load((const uint32_t *)pairs, plane, level, b, t);
    }
    if (level > 0)
      for (int i = 0; i < b; i++) {
        const int t = sha_host_rev ? b - 1 - i : i;
        sweep_scatter(plane, (const int32_t *)lane, (const int32_t *)half, dg + 8 * t, level, b, t);
      }
    for (int i = 0; i < b; i++) {
      const int t = sha_host_rev ? b - 1 - i : i;
      sweep_hash(plane, (uint32_t *)out, dg + 8 * t, level, b, t);
    }
  }
  free(dg);
  free(plane);
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
