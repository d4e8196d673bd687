// Pieces shared by the LRN forward (lrn.cu) and backward (lrn_bwd.cu)
// kernels: the power norm^-beta with few instructions and the 16-byte and
// 4-byte asynchronous copies.
//
// Both kernels take a row (an NHWC pixel of C channels) in items of 16
// bytes of x: four consecutive f32 channels, or eight 16-bit ones in the
// bf16 and f16 builds (compute_type=bfloat16 / float16: x, y, g and dx
// 16-bit, norm f32, everything computed in f32 (x squared in f32, so an
// f16 x never overflows on the way) and rounded once on the store, as the
// Pallas kernels do).  The element type T is float, unsigned short (bf16
// bits) or __half (f16): the two 16-bit formats are distinct types, so
// an overload can never read one as the other.  A thread owns whole items, reads and writes them
// with one 16-byte access where C is a multiple of the item and every
// pointer is 16-byte aligned (VEC), or with masked element accesses
// otherwise (the last item of a row then holds fewer channels).  Both
// take any C up to LRN_MAX_C, the same limit in both directions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// channels of a 16-byte item of T (float; unsigned short: bf16 bits; or
// __half)
template <class T>
__host__ __device__ constexpr int lrn_ci() {
  return 16 / (int)sizeof(T);
}

// one element widened to f32
__device__ __forceinline__ float lrn_f32(float v) { return v; }
__device__ __forceinline__ float lrn_f32(unsigned short h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ float lrn_f32(__half h) { return __half2float(h); }

// one f32 stored as T (bf16, f16: round to nearest even)
__device__ __forceinline__ void lrn_put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void lrn_put(unsigned short* p, float v) {
  __stcs(p, __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void lrn_put(__half* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __half_as_ushort(__float2half_rn(v)));
}

// one element loaded by a streaming load, widened to f32
__device__ __forceinline__ float lrn_ld(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float lrn_ld(const unsigned short* p) {
  return lrn_f32(__ldcs(p));
}
__device__ __forceinline__ float lrn_ld(const __half* p) {
  return __half2float(
      __ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// a 16-byte item's CI channels, widened to f32
__device__ __forceinline__ void lrn_unpack(uint4 u, const float*, float* v) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void lrn_unpack(uint4 u, const unsigned short*,
                                           float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void lrn_unpack(uint4 u, const __half*, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// CI f32 values as one 16-byte item of T
__device__ __forceinline__ uint4 lrn_pack(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 lrn_pack(const float* v,
                                          const unsigned short*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 lrn_pack(const float* v, const __half*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void lrn_cp16(void* dst, const void* src) {
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
