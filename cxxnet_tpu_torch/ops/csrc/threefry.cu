// JAX's uniform random stream for Hopper (sm_90a): the Threefry-2x32 hash
// (Salmon et al., SC'11; 20 rounds) over JAX's partitionable counter
// layout, one thread an element.  It replaces no Pallas kernel: the JAX
// package draws its initial weights and its dropout, insanity and prelu
// noise with jax.random.uniform / normal (cxxnet_tpu/layers/base.py:
// 189-209, common.py:180,284,326,335, pooling.py:142), which XLA
// compiles.  The port draws the same numbers on the card with this kernel
// so that a net trains from JAX's seed.  Its plain version is
// uniform_plain in cxxnet_tpu_torch/utils/prng.py.
//
// What it computes: for a key (k0, k1) and a count n, element i of
// jax.random.uniform(key, (n,), dtype, lo, hi): the hash of the 64-bit
// counter i (high word, low word) gives words (x0, x1), b = x0 ^ x1;
//   * f32: f = bits (b >> 9 | 0x3F800000) as a float in [1, 2);
//   * bf16: JAX draws 8 bits (nmant 7 < 8): f = bf16 bits
//     ((b & 0xFF) >> 1 | 0x3F80);
//   * f16: JAX draws 16 bits (nmant 10): f = f16 bits
//     ((b & 0xFFFF) >> 6 | 0x3C00);
// then u = max(lo, (f - 1) * span + lo) with span = hi - lo taken in the
// element type, as XLA's CPU backend computes it: in f32 one fused
// multiply-add (it contracts the product and the sum); in bf16 a bf16
// product, then a bf16 sum, each rounded; in f16 the product (exact) and
// the sum in f32, rounded once to f16 (a sum that rounds to zero from
// below is -0); mode 1 writes (u < thresh) as 1 or 0 in the element type
// (a dropout mask).
//
// What bounds it on an H100: per element 4 bytes (f32) or 2 (bf16, f16) of
// output and no input, and about 80 integer operations (20 rounds of add,
// rotate and xor, five key injections of two adds, the conversion).  At
// 256 x 4096 elements that is 4.2 MB, 1.3 us at 3.35 TB/s, and 84 M
// operations, 1.3 us even at the 67 TFLOP/s f32 rate the integer pipes
// do not reach (they issue half as many operations a clock).
//
// Design: a grid-stride loop, one element a thread a pass, the key
// schedule in registers; rotations by the funnel shifter; consecutive
// threads write consecutive elements, so each warp's store is whole
// sectors.  The 64-bit counter keeps any n exact.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = tf_rotl(x1, r) ^ x0;

// b0 ^ b1 of the hash of the counter (hi, lo) under (k0, k1, k2)
__device__ __forceinline__ uint32_t tf_bits(uint32_t k0, uint32_t k1,
                                            uint32_t k2, uint32_t hi,
                                            uint32_t lo) {
  uint32_t x0 = hi + k0, x1 = lo + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// f - 1 of the element type T's draw from the hash bits b (exact in f32)
__device__ __forceinline__ float tf_unit(uint32_t b, const float*) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}
__device__ __forceinline__ float tf_unit(uint32_t b, const __nv_bfloat16*) {
  return __uint_as_float((((b & 0xFFu) >> 1) | 0x3F80u) << 16) - 1.0f;
}
__device__ __forceinline__ float tf_unit(uint32_t b, const __half*) {
  return __half2float(
             __ushort_as_half((unsigned short)(((b & 0xFFFFu) >> 6) |
                                               0x3C00u))) - 1.0f;
}

// an f32 value rounded to T (nearest even) and back
__device__ __forceinline__ float tf_round(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float tf_round(float v, const __half*) {
  return __half2float(__float2half_rn(v));
}

// v stored as T (a value T holds exactly)
__device__ __forceinline__ void tf_put(float* p, float v) { *p = v; }
__device__ __forceinline__ void tf_put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void tf_put(__half* p, float v) {
  *p = __float2half_rn(v);
}

// T: float, __nv_bfloat16 or __half, the draw's element type
template <class T>
__global__ void __launch_bounds__(256)
threefry_uniform_kernel(T* __restrict__ out, uint32_t k0, uint32_t k1,
                        long long n, int mode, float lo, float span,
                        float thresh) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t b =
        tf_bits(k0, k1, k2, (uint32_t)((unsigned long long)i >> 32),
                (uint32_t)i);
    const float f = tf_unit(b, out);
    float v;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // f - 1 is exact; a product of two bf16 values is exact in f32, so
      // one rounding gives bf16's product, and the sum rounds as an f32
      // sum rounded to bf16, as XLA and torch compute a bf16 add
      v = fmaxf(lo, tf_round(tf_round(__fmul_rn(f, span), out) + lo, out));
    } else if constexpr (std::is_same<T, __half>::value) {
      // f (10 bits) x span (11) is exact in f32; the f32 sum rounded to
      // f16 is the sum's direct rounding (f32's 24 bits >= 2 x 11 + 2),
      // subnormals included
      v = fmaxf(lo, tf_round(__fadd_rn(__fmul_rn(f, span), lo), out));
    } else {
      v = fmaxf(lo, __fmaf_rn(f, span, lo));
    }
    if (mode == 1) v = v < thresh ? 1.0f : 0.0f;
    tf_put(out + i, v);
  }
}

template <class T>
static int tf_launch(void* out, unsigned k0, unsigned k1, long long n,
                     int mode, float lo, float span, float thresh,
                     void* stream) {
  if (n <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  threefry_uniform_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<T*>(out), k0, k1, n, mode, lo, span, thresh);
  return (int)cudaGetLastError();
}

// out (n,) f32, bf16 or f16 = JAX's uniform of key (k0, k1) over [lo, lo +
// span) (mode 0), or its compare with thresh (mode 1); lo, span and
// thresh already rounded to the element type by the wrapper
extern "C" int threefry_uniform_f32(void* out, unsigned k0, unsigned k1,
                                    long long n, int mode, float lo,
                                    float span, float thresh, void* stream) {
  return tf_launch<float>(out, k0, k1, n, mode, lo, span, thresh, stream);
}

extern "C" int threefry_uniform_bf16(void* out, unsigned k0, unsigned k1,
                                     long long n, int mode, float lo,
                                     float span, float thresh, void* stream) {
  return tf_launch<__nv_bfloat16>(out, k0, k1, n, mode, lo, span, thresh,
                                  stream);
}

extern "C" int threefry_uniform_f16(void* out, unsigned k0, unsigned k1,
                                    long long n, int mode, float lo,
                                    float span, float thresh, void* stream) {
  return tf_launch<__half>(out, k0, k1, n, mode, lo, span, thresh, stream);
}
