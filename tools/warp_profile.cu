// Cycle profile of the warp-per-lane programs on the card (built and run
// by warp_profile.py; not part of any kernel).
//
//   lt_prof_program  one lane of the Miller loop (which = 0), the final
//                    exponentiation (1), r sig with the subgroup check (2),
//                    r pk (3), the G2 decompression (4) (these three: their
//                    segments back to back, without the segment loops'
//                    copies and selects between them), one complete G2
//                    addition of the lane sum (5), the affine conversion
//                    (6), the hash to G2 (7; its segments back to back,
//                    without the segment loop's selects and copies), one
//                    Fp12 product of the lane product (8), the per-set G2
//                    subgroup check (9) or one complete G1 addition of the
//                    G1 scan (10), clock64() around every phase
//   lt_prof_op       256 dependent Fp operations on each thread of one warp
//                    (0 Montgomery product, 1 fp_add, 2 fp_sub, 3 an
//                    interpreter add from shared memory, 4 an interpreter
//                    product from shared memory, 5 the programs' inversion
//                    fp_inv_var followed by an fp_add, so each inversion
//                    sees another value)
#define LT_WANT_MILLER
#define LT_WANT_FINAL
#define LT_WANT_RSIG
#define LT_WANT_RPK
#define LT_WANT_DECOMP
#define LT_WANT_SUMG2
#define LT_WANT_AFFINE
#define LT_WANT_HASH
#define LT_WANT_PROD12
#define LT_WANT_SUB
#define LT_WANT_SUMG1
#include "pairing.cuh"

template <int SLOTS, int NCONST>
__device__ void prof_program(const uint32_t (*consts)[LT_NL], const uint32_t *phase, int nphase,
                             const uint32_t *ins, long long *cyc, const uint32_t *init, int ninit) {
  extern __shared__ uint32_t lt_sm[];
  const wmem m = w_block(lt_sm, SLOTS, NCONST, consts, 0);
  if (threadIdx.x >= LT_WARP) return;
  const int t = threadIdx.x;
  for (int i = t; i < ninit * LT_NL; i += LT_WARP) m.sm[(i % LT_NL) * m.cols + m.base + i / LT_NL] = init[i];
  __syncwarp();
  for (int k = 0; k < nphase; k++) {
    const long long c0 = clock64();
    w_run(m, phase + k, 1, ins);
    if (t == 0) cyc[k] = clock64() - c0;
  }
}

__global__ void lt_prof_miller(long long *cyc, const uint32_t *init) {
  prof_program<LT_MILLER_SLOTS, LT_MILLER_CONSTS>(LT_MILLER_CONST, LT_MILLER_PHASE, LT_MILLER_PHASES,
                                                  LT_MILLER_INS, cyc, init, 7);
}

__global__ void lt_prof_final(long long *cyc, const uint32_t *init) {
  prof_program<LT_FINAL_SLOTS, LT_FINAL_CONSTS>(LT_FINAL_CONST, LT_FINAL_PHASE, LT_FINAL_PHASES, LT_FINAL_INS,
                                                cyc, init, 24);
}

__global__ void lt_prof_rsig(long long *cyc, const uint32_t *init) {
  prof_program<LT_RSIG_SLOTS, LT_RSIG_CONSTS>(LT_RSIG_CONST, LT_RSIG_PHASE, LT_RSIG_PHASES, LT_RSIG_INS, cyc, init,
                                              LT_RSIG_EQ + 8);
}

__global__ void lt_prof_rpk(long long *cyc, const uint32_t *init) {
  prof_program<LT_RPK_SLOTS, LT_RPK_CONSTS>(LT_RPK_CONST, LT_RPK_PHASE, LT_RPK_PHASES, LT_RPK_INS, cyc, init,
                                            LT_RPK_DBL + 3);
}

__global__ void lt_prof_decomp(long long *cyc, const uint32_t *init) {
  prof_program<LT_DECOMP_SLOTS, LT_DECOMP_CONSTS>(LT_DECOMP_CONST, LT_DECOMP_PHASE, LT_DECOMP_PHASES,
                                                  LT_DECOMP_INS, cyc, init, LT_DECOMP_RAW + 2);
}

__global__ void lt_prof_sumg2(long long *cyc, const uint32_t *init) {
  prof_program<LT_SUMG2_SLOTS, LT_SUMG2_CONSTS>(LT_SUMG2_CONST, LT_SUMG2_PHASE, LT_SUMG2_PHASES, LT_SUMG2_INS,
                                                cyc, init, LT_SUMG2_RES1 + 6);
}

__global__ void lt_prof_affine(long long *cyc, const uint32_t *init) {
  prof_program<LT_AFFINE_SLOTS, LT_AFFINE_CONSTS>(LT_AFFINE_CONST, LT_AFFINE_PHASE, LT_AFFINE_PHASES,
                                                  LT_AFFINE_INS, cyc, init, LT_AFFINE_A + 4);
}

__global__ void lt_prof_hash(long long *cyc, const uint32_t *init) {
  prof_program<LT_HASH_SLOTS, LT_HASH_CONSTS>(LT_HASH_CONST, LT_HASH_PHASE, LT_HASH_PHASES, LT_HASH_INS, cyc, init,
                                              LT_HASH_OUT + 6);
}

__global__ void lt_prof_prod12(long long *cyc, const uint32_t *init) {
  prof_program<LT_PROD12_SLOTS, LT_PROD12_CONSTS>(LT_PROD12_CONST, LT_PROD12_PHASE, LT_PROD12_PHASES,
                                                  LT_PROD12_INS, cyc, init, LT_PROD12_RES1 + 12);
}

__global__ void lt_prof_sub(long long *cyc, const uint32_t *init) {
  prof_program<LT_SUB_SLOTS, LT_SUB_CONSTS>(LT_SUB_CONST, LT_SUB_PHASE, LT_SUB_PHASES, LT_SUB_INS, cyc, init,
                                            LT_SUB_EQ + 8);
}

__global__ void lt_prof_sumg1(long long *cyc, const uint32_t *init) {
  prof_program<LT_SUMG1_SLOTS, LT_SUMG1_CONSTS>(LT_SUMG1_CONST, LT_SUMG1_PHASE, LT_SUMG1_PHASES, LT_SUMG1_INS,
                                                cyc, init, LT_SUMG1_RES1 + 3);
}

__global__ void lt_prof_op_kernel(int which, const uint32_t *init, uint32_t *out, long long *cyc) {
  __shared__ uint32_t sm[LT_NL * 2 * LT_WARP];
  fp a, b;
  for (int i = 0; i < LT_NL; i++) {
    a.w[i] = init[i];
    b.w[i] = init[LT_NL + i];
  }
  for (int i = threadIdx.x; i < LT_NL * 2 * LT_WARP; i += blockDim.x) sm[i] = init[i % (2 * LT_NL)];
  wmem m;
  m.sm = sm;
  m.cols = m.slots = m.cbase = 2 * LT_WARP;
  m.base = 0;
  __syncwarp();
  const long long c0 = clock64();
  for (int k = 0; k < 256; k++) {
    // the interpreter's operations: slot t + 32 (k & 1) <- slot t + 32 (~k & 1) op slot 5
    const uint32_t dst = threadIdx.x + (k & 1) * LT_WARP, src = threadIdx.x + ((k + 1) & 1) * LT_WARP;
    if (which == 0)
      fp_mont_mul(a, a, b);
    else if (which == 1)
      fp_add(a, a, b);
    else if (which == 2)
      fp_sub(a, a, b);
    else if (which == 5) {
      fp_inv_var(a, a);
      fp_add(a, a, b);
    } else
      w_exec(m, (which == 3 ? LT_OP_ADD : LT_OP_MUL) << 30 | dst << 20 | src << 10 | 5u);
  }
  __syncwarp();
  if (threadIdx.x == 0) cyc[0] = clock64() - c0;
  for (int i = 0; i < LT_NL; i++) out[threadIdx.x * LT_NL + i] = a.w[i] ^ sm[i * 2 * LT_WARP + threadIdx.x];
}

extern "C" int lt_prof_program(int which, void *cyc, const void *init) {
  if (which == 0) {
    const size_t smem = w_smem_bytes(LT_MILLER_SLOTS, LT_MILLER_CONSTS);
    cudaFuncSetAttribute(lt_prof_miller, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_miller<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 1) {
    const size_t smem = w_smem_bytes(LT_FINAL_SLOTS, LT_FINAL_CONSTS);
    cudaFuncSetAttribute(lt_prof_final, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_final<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 2) {
    const size_t smem = w_smem_bytes(LT_RSIG_SLOTS, LT_RSIG_CONSTS);
    cudaFuncSetAttribute(lt_prof_rsig, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_rsig<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 3) {
    const size_t smem = w_smem_bytes(LT_RPK_SLOTS, LT_RPK_CONSTS);
    cudaFuncSetAttribute(lt_prof_rpk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_rpk<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 4) {
    const size_t smem = w_smem_bytes(LT_DECOMP_SLOTS, LT_DECOMP_CONSTS);
    cudaFuncSetAttribute(lt_prof_decomp, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_decomp<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 5) {
    const size_t smem = w_smem_bytes(LT_SUMG2_SLOTS, LT_SUMG2_CONSTS);
    cudaFuncSetAttribute(lt_prof_sumg2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_sumg2<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 6) {
    const size_t smem = w_smem_bytes(LT_AFFINE_SLOTS, LT_AFFINE_CONSTS);
    cudaFuncSetAttribute(lt_prof_affine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_affine<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 7) {
    const size_t smem = w_smem_bytes(LT_HASH_SLOTS, LT_HASH_CONSTS);
    cudaFuncSetAttribute(lt_prof_hash, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_hash<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 8) {
    const size_t smem = w_smem_bytes(LT_PROD12_SLOTS, LT_PROD12_CONSTS);
    cudaFuncSetAttribute(lt_prof_prod12, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_prod12<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else if (which == 9) {
    const size_t smem = w_smem_bytes(LT_SUB_SLOTS, LT_SUB_CONSTS);
    cudaFuncSetAttribute(lt_prof_sub, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_sub<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  } else {
    const size_t smem = w_smem_bytes(LT_SUMG1_SLOTS, LT_SUMG1_CONSTS);
    cudaFuncSetAttribute(lt_prof_sumg1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    lt_prof_sumg1<<<1, LT_WARP * LT_LPB, smem>>>((long long *)cyc, (const uint32_t *)init);
  }
  return (int)cudaDeviceSynchronize();
}

extern "C" int lt_prof_op(int which, const void *init, void *out, void *cyc) {
  lt_prof_op_kernel<<<1, LT_WARP>>>(which, (const uint32_t *)init, (uint32_t *)out, (long long *)cyc);
  return (int)cudaDeviceSynchronize();
}
