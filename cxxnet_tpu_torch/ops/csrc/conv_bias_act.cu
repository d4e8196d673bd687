// Fused convolution + bias + activation (relu or identity), f32, for
// Hopper (sm_90a).  Replaces the Pallas block `_conv_act_kernel` /
// `_fused_call` of cxxnet_tpu/ops/pallas_cnn.py:103,149.
//
// What it computes: NHWC input x (n, h, w, cin), HWIO weight
// (kh, kw, cin/g, cout), optional bias (cout), strides (sy, sx), top/left
// padding (the bottom/right padding is implied by the output size oh/ow
// the caller passes), `groups` channel groups:
//   z[p, co] = sum_{u,v,c} x[n, oy*sy-pad_t+u, ox*sx-pad_l+v, g*cin_g+c]
//                          * w[u, v, c, co] + bias[co]
//   y = relu(z) or z,
// with p = (n, oy, ox) and zero for taps outside the input.  z is written
// only when `z` is non-null (the caller asks for it only when a backward
// will need the relu mask).
//
// Design: an implicit GEMM per group, M = n*oh*ow output pixels,
// N = cout/g channels, K = kh*kw*cin/g in (u, v, c) order — exactly the
// row order of the HWIO weight viewed as a (K, cout) matrix.  Each block
// gathers its 64-pixel x 16-deep patch slice straight from the input into
// shared memory, so the im2col matrix never exists in device memory (the
// point of the Pallas block), multiplies it with the matching weight
// slice in registers (sgemm_tile.cuh), and applies bias and activation in
// the epilogue before the one store.  Padding, the ragged tail of the
// contraction (conv1: K = 363) and the ragged pixel/channel edges are
// masked per element; no load reaches past the input.
//
// What bounds it on an H100: at AlexNet's shapes these are
// operation-bound (conv2: ~115 GFLOP at batch 256 against ~0.2 GB moved),
// and f32 FMA outside the tensor cores peaks at 67 TFLOP/s.  This first
// version is a plain shared-memory tile without double buffering, TMA or
// tensor cores; the patch gather's index arithmetic (one division chain
// per staged element) and the unpipelined loads are its known costs.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
conv_bias_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ z, int n, int h, int wd, int cin,
                     int kh, int kw, int cout, int groups, int sy, int sx,
                     int pad_t, int pad_l, int oh, int ow, int relu) {
  __shared__ float As[TILE_K][TILE_M + 1];
  __shared__ float Bs[TILE_K][TILE_N];

  const int cin_g = cin / groups;
  const int cout_g = cout / groups;
  const int g = blockIdx.z;
  const long long M = (long long)n * oh * ow;
  const int K = kh * kw * cin_g;
  const long long m0 = (long long)blockIdx.x * TILE_M;
  const int j0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  // This thread stages column a_k of the patch slice for the four pixel
  // rows t/16 + 16 i: decode each pixel once.
  const int a_k = t % 16;
  long long a_base[4];
  int a_iy[4], a_ix[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + t / 16 + 16 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const long long ni = mm / ((long long)oh * ow);
    const int r = (int)(mm - ni * oh * ow);
    const int oy = r / ow, ox = r % ow;
    a_iy[i] = oy * sy - pad_t;
    a_ix[i] = ox * sx - pad_l;
    a_base[i] = ni * h * wd * cin + (long long)g * cin_g;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TILE_K) {
    const int k = k0 + a_k;
    if (k < K) {
      const int c = k % cin_g;
      const int tap = k / cin_g;
      const int u = tap / kw, v = tap % kw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = a_iy[i] + u, ix = a_ix[i] + v;
        float val = 0.f;
        if (a_ok[i] && iy >= 0 && iy < h && ix >= 0 && ix < wd)
          val = x[a_base[i] + ((long long)iy * wd + ix) * cin + c];
        As[a_k][t / 16 + 16 * i] = val;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) As[a_k][t / 16 + 16 * i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + TILE_THREADS * i;
      const int kb = e / TILE_N, jb = e % TILE_N;
      const int kk = k0 + kb, jj = j0 + jb;
      Bs[kb][jb] = (kk < K && jj < cout_g)
                       ? w[(long long)kk * cout + g * cout_g + jj]
                       : 0.f;
    }
    __syncthreads();
    tile_fma<TILE_N>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx + 16 * j;
      if (jj >= cout_g) continue;
      const int co = g * cout_g + jj;
      const float v = acc[i][j] + (bias != nullptr ? bias[co] : 0.f);
      const long long off = m * cout + co;
      if (z != nullptr) z[off] = v;
      // NaN propagates like torch.relu / jnp.maximum
      y[off] = (relu && v < 0.f) ? 0.f : v;
    }
  }
}

extern "C" int conv_bias_act_f32(const void* x, const void* w,
                                 const void* bias, void* y, void* z, int n,
                                 int h, int wd, int cin, int kh, int kw,
                                 int cout, int groups, int sy, int sx,
                                 int pad_t, int pad_l, int oh, int ow,
                                 int relu, void* stream) {
  const long long M = (long long)n * oh * ow;
  const int cout_g = cout / groups;
  dim3 grid((unsigned)((M + TILE_M - 1) / TILE_M),
            (unsigned)((cout_g + TILE_N - 1) / TILE_N), (unsigned)groups);
  conv_bias_act_kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y,
      (float*)z, n, h, wd, cin, kh, kw, cout, groups, sy, sx, pad_t, pad_l,
      oh, ow, relu);
  return (int)cudaGetLastError();
}
