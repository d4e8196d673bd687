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
// then u = max(lo, (f - 1) * span + lo) with span = hi - lo taken in the
// element type: in f32 one fused multiply-add, as XLA's CPU backend
// contracts the product and the sum; in bf16 a bf16 product, then a bf16
// sum, each rounded, as XLA computes them; mode 1 writes (u < thresh) as
// 1 or 0 in the element type (a dropout mask).
//
// What bounds it on an H100: per element 4 bytes (f32) or 2 (bf16) of
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
#include <cuda_runtime.h>
#include <stdint.h>

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

// an f32 value rounded to bf16 (nearest even) and back
__device__ __forceinline__ float tf_bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__global__ void __launch_bounds__(256)
threefry_uniform_kernel(void* __restrict__ out, uint32_t k0, uint32_t k1,
                        long long n, int mode, float lo, float span,
                        float thresh) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t b =
        tf_bits(k0, k1, k2, (uint32_t)((unsigned long long)i >> 32),
                (uint32_t)i);
    float v;
    if (BF16) {
      // f - 1 is exact; a bf16 product of two bf16 values is exact in
      // f32, so one rounding gives bf16's product, and the sum rounds as
      // an f32 sum rounded to bf16, as XLA and torch compute a bf16 add
      const float f = __uint_as_float((((b & 0xFFu) >> 1) | 0x3F80u) << 16)
                      - 1.0f;
      v = fmaxf(lo, tf_bf16r(tf_bf16r(__fmul_rn(f, span)) + lo));
    } else {
      const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
      v = fmaxf(lo, __fmaf_rn(f, span, lo));
    }
    if (mode == 1) v = v < thresh ? 1.0f : 0.0f;
    if (BF16)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[i] = v;
  }
}

template <bool BF16>
static int tf_launch(void* out, unsigned k0, unsigned k1, long long n,
                     int mode, float lo, float span, float thresh,
                     void* stream) {
  if (n <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  threefry_uniform_kernel<BF16><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      out, k0, k1, n, mode, lo, span, thresh);
  return (int)cudaGetLastError();
}

// out (n,) f32 or bf16 = JAX's uniform of key (k0, k1) over [lo, lo +
// span) (mode 0), or its compare with thresh (mode 1); lo, span and
// thresh already rounded to the element type by the wrapper
extern "C" int threefry_uniform_f32(void* out, unsigned k0, unsigned k1,
                                    long long n, int mode, float lo,
                                    float span, float thresh, void* stream) {
  return tf_launch<false>(out, k0, k1, n, mode, lo, span, thresh, stream);
}

extern "C" int threefry_uniform_bf16(void* out, unsigned k0, unsigned k1,
                                     long long n, int mode, float lo,
                                     float span, float thresh, void* stream) {
  return tf_launch<true>(out, k0, k1, n, mode, lo, span, thresh, stream);
}
