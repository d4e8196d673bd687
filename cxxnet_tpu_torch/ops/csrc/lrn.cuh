// Pieces shared by the LRN forward (lrn.cu) and backward (lrn_bwd.cu)
// kernels: the power norm^-beta with few instructions and the 16-byte and
// 4-byte asynchronous copies.
//
// Both kernels take a row (an NHWC pixel of C channels) in items of four
// consecutive channels: a thread owns whole items, reads and writes them
// with one 16-byte access where C % 4 == 0 and every pointer is 16-byte
// aligned (VEC), or with four masked 4-byte accesses otherwise (the last
// item of a row then holds 1-3 channels).  Both take any C up to
// LRN_MAX_C, the same limit in both directions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int LRN_MAX_C = 8192;
// the window size with an unrolled path (local_size of every AlexNet conf);
// any other size runs the same kernels with a summing loop
constexpr int LRN_FAST_N = 5;

__device__ __forceinline__ float lrn_lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lrn_ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lrn_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// norm^-beta.  beta = 0.75 (every AlexNet conf): r^2 * rsqrt(r) with
// r = rsqrt(norm), two MUFU operations and two products; any other beta:
// 2^(-beta * log2(norm)) on the approximate MUFU log and exponent.  Both
// stay within a few ulp of the correctly rounded power for the norms an
// LRN sees (knorm + alpha/n * sum x^2 >= knorm > 0).
__device__ __forceinline__ float lrn_pow(float nrm, float beta, bool b075) {
  if (b075) {
    const float r = rsqrtf(nrm);
    return r * r * rsqrtf(r);
  }
  return lrn_ex2(-beta * lrn_lg2(nrm));
}

__device__ __forceinline__ void lrn_cp16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void lrn_cp4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void lrn_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void lrn_cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

static inline bool lrn_aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
