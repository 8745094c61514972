// K1: Montgomery ingest.  Plain limb planes -> Montgomery form x * R mod p.
//
// Replaces lodestar_tpu/kernels/verify.py _k_mont8 (and serves _k_mont4:
// it takes any number of planes).  One thread per (plane, lane): a thread
// loads 12 limbs (coalesced across lanes, limb-major planes), does one
// Montgomery product with R^2 and stores 12 limbs.
//
// Bound on this card: 96 bytes and one 12-limb Montgomery product (588
// 32-bit multiply instructions) per element; at the per-set job sizes
// (8 planes x 128..512 lanes) both are well under a microsecond, so the
// launch itself is the cost.  Nothing in the design fights that; the next
// step is to fuse it into the kernel that consumes its output.
#include "fp.cuh"

LT_DEV void mont_convert_elem(const int32_t *x, int32_t *out, int n, int idx) {
  const int plane = idx / n, lane = idx - plane * n;
  fp a, r;
  fp_load(a, x + plane * LT_NL * n, n, lane);
  fp_mont_convert(r, a);
  fp_store(out + plane * LT_NL * n, n, lane, r);
}

#ifdef __CUDACC__

#define LT_MONT_BLOCK 64

__global__ void __launch_bounds__(LT_MONT_BLOCK)
    lt_mont_convert_kernel(const int32_t *__restrict__ x, int32_t *__restrict__ out,
                           int planes, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < planes * n) mont_convert_elem(x, out, n, idx);
}

extern "C" int lt_mont_convert(const void *x, void *out, int planes, int n, void *stream) {
  const int total = planes * n;
  if (total > 0)
    lt_mont_convert_kernel<<<(total + LT_MONT_BLOCK - 1) / LT_MONT_BLOCK, LT_MONT_BLOCK, 0,
                             (cudaStream_t)stream>>>((const int32_t *)x, (int32_t *)out, planes, n);
  return (int)cudaGetLastError();
}

#else  // host build: the same per-element function over every element

extern "C" int lt_mont_convert(const void *x, void *out, int planes, int n, void *stream) {
  (void)stream;
  for (int idx = 0; idx < planes * n; idx++)
    mont_convert_elem((const int32_t *)x, (int32_t *)out, n, idx);
  return 0;
}

#endif
