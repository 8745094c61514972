// Shared definitions of the port's CUDA field engine.
//
// Every header of the engine compiles two ways:
//   * by nvcc for sm_90a: device functions, with the multi-precision carry
//     chains written as PTX (add.cc / addc / mad.lo.cc / madc.hi ...), and
//   * by a plain C++ compiler for the host: the same functions, with each
//     PTX instruction emulated on a carry flag (lt_cf below).  The host build
//     runs the identical instruction sequences, so the engine's arithmetic
//     can be checked on a machine without a GPU (tests/test_torch_csrc_host.py).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LT_DEV __device__ __forceinline__
#define LT_NOINL __device__ __noinline__
#define LT_CONST static __constant__
#define LT_PROG static __device__ const  // the generated programs' tables
#else
#define LT_DEV static inline
#define LT_NOINL static
#define LT_CONST static const
#define LT_PROG static const
#endif

#include "constants.cuh"

#define LT_NL 12  // 32-bit limbs per field element

// ---------------------------------------------------------------------------
// Carry-chain primitives: one PTX instruction each.  A chain is a sequence
// of calls with no other carry-writing call between them; nvcc emits none
// of its own .cc instructions, so the flag survives between asm statements.
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

LT_DEV uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
LT_DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
LT_DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
LT_DEV uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
LT_DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
LT_DEV uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

#else  // host emulation of the same instructions

static uint32_t lt_cf;  // the carry (or borrow) flag

// The kernels' cooperating threads (a warp's, a block's) run as virtual
// threads one after another, forwards or (lt_host_warp_order(1))
// reversed: a phase in which one thread read what another one writes
// would differ between the two orders.
static int lt_host_rev;
extern "C" void lt_host_warp_order(int reversed) { lt_host_rev = reversed; }

LT_DEV uint32_t lt_sum(uint64_t s, bool write) {
  if (write) lt_cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
LT_DEV uint32_t add_cc(uint32_t a, uint32_t b) { return lt_sum((uint64_t)a + b, true); }
LT_DEV uint32_t addc_cc(uint32_t a, uint32_t b) { return lt_sum((uint64_t)a + b + lt_cf, true); }
LT_DEV uint32_t addc(uint32_t a, uint32_t b) { return lt_sum((uint64_t)a + b + lt_cf, false); }
LT_DEV uint32_t sub_cc(uint32_t a, uint32_t b) {
  lt_cf = a < b;
  return a - b;
}
LT_DEV uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)b + lt_cf;
  lt_cf = (uint64_t)a < t;
  return (uint32_t)((uint64_t)a - t);
}
LT_DEV uint32_t subc(uint32_t a, uint32_t b) { return a - b - lt_cf; }
LT_DEV uint32_t lt_lo(uint32_t a, uint32_t b) { return a * b; }
LT_DEV uint32_t lt_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
LT_DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return lt_sum((uint64_t)lt_lo(a, b) + c, true);
}
LT_DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return lt_sum((uint64_t)lt_lo(a, b) + c + lt_cf, true);
}
LT_DEV uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return lt_sum((uint64_t)lt_hi(a, b) + c, true);
}
LT_DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return lt_sum((uint64_t)lt_hi(a, b) + c + lt_cf, true);
}
LT_DEV uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return lt_sum((uint64_t)lt_hi(a, b) + c + lt_cf, false);
}

#endif
