// K4: per-lane f1 * f2 -> (dead lanes -> 1) -> final exponentiation -> is-one.
//
// Replaces lodestar_tpu/kernels/verify.py _k_each_final (the per-set
// verdict).  One thread per lane runs the easy part (one Fp12 inversion,
// itself one Fp exponentiation by p - 2) and the hard part (five
// cyclotomic powers by |x|), keeping the JAX package's cube:
// f^(3 (p^12 - 1) / r).
//
// Bound on this card: 32-bit integer multiplies, 8,337 Fp
// multiplications per lane (588 multiply instructions each); its inputs
// are 1.2 KB per lane and its output one word.  The Fp12 temporaries
// live in the thread's stack frame in local memory.  One thread per lane,
// as in K3.
#include "pairing.cuh"

// live: [n] int32; f1, f2: [12, 12, n]; ok: [n] int32
LT_DEV void each_final_lane(const int32_t *live, const int32_t *f1, const int32_t *f2,
                            int32_t *ok, int n, int lane) {
  fp12 a, b, one;
  fp12_load(a, f1, n, lane);
  fp12_load(b, f2, n, lane);
  fp12_mul(a, a, b);
  fp12_one(one);
  fp12_select(a, live[lane] != 0, a, one);  // dead lanes -> 1 -> pass
  final_exponentiation(b, a);
  ok[lane] = fp12_is_one(b) ? 1 : 0;
}

#ifdef __CUDACC__

#define LT_LANE_BLOCK 32

__global__ void __launch_bounds__(LT_LANE_BLOCK)
    lt_each_final_kernel(const int32_t *__restrict__ live, const int32_t *__restrict__ f1,
                         const int32_t *__restrict__ f2, int32_t *__restrict__ ok, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) each_final_lane(live, f1, f2, ok, n, lane);
}

extern "C" int lt_each_final(const void *live, const void *f1, const void *f2, void *ok, int n,
                             void *stream) {
  if (n > 0)
    lt_each_final_kernel<<<(n + LT_LANE_BLOCK - 1) / LT_LANE_BLOCK, LT_LANE_BLOCK, 0,
                           (cudaStream_t)stream>>>((const int32_t *)live, (const int32_t *)f1,
                                                   (const int32_t *)f2, (int32_t *)ok, n);
  return (int)cudaGetLastError();
}

#else

extern "C" int lt_each_final(const void *live, const void *f1, const void *f2, void *ok, int n,
                             void *stream) {
  (void)stream;
  for (int lane = 0; lane < n; lane++)
    each_final_lane((const int32_t *)live, (const int32_t *)f1, (const int32_t *)f2,
                    (int32_t *)ok, n, lane);
  return 0;
}

#endif
