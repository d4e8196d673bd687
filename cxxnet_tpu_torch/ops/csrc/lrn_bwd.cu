// Cross-channel LRN backward, f32, for Hopper (sm_90a).  Replaces the
// Pallas `_lrn_bwd_kernel` of cxxnet_tpu/ops/pallas_kernels.py:242
// (launched by `_lrn_call` :258 from `_lrn_vjp_bwd` :306, the backward
// of `lrn_pallas`).  CUDA C++ rather than Triton, like the forward in
// lrn.cu: the same row-staged layout, built by the same nvcc pass.
//
// What it computes, per row of C channels (an NHWC pixel), from the
// forward's input x, the upstream gradient g and the forward's saved
// f32 norm:
//   p[j]  = norm[j]^(-beta)
//   t[i]  = g[i] * x[i] * p[i] / norm[i]
//   dx[j] = g[j] * p[j] - coef * x[j] * sum_{i = j-hi}^{j+lo} t[i]
// with coef = 2 * beta * alpha / n.  The forward's channel i summed the
// window [i - lo, i + hi] (lo = (n-1)/2, hi = n-1-lo); channel j's
// gradient sums the windows that contain j, the TRANSPOSED window
// [j - hi, j + lo] — for even n that swaps lo and hi
// (`_band_matrix(c, nsize).T` in `_lrn_vjp_bwd`, the swapped pad widths
// of `_lrn_hybrid_bwd` :364).  Channels outside [0, C) are left out.
//
// Design: the TPU kernel contracts t with a (C, C) band matrix on its
// matrix unit.  Here each block stages a run of whole rows in shared
// memory in one coalesced pass — t, g * p and x for every element, so
// each input element is read from device memory once — then every
// thread sums its channel's short transposed window (n values) from
// shared memory and writes dx once.  The band matrix and its C^2
// multiply-adds per pixel are gone.
//
// What bounds it on an H100: the bytes.  It reads x, g and norm and
// writes dx, 16 bytes per element, against ~2n+12 flops: at AlexNet's
// norm1 (256 x 27 x 27 x 96, 17.9 M elements) that is 287 MB, 86 us at
// 3.35 TB/s.  One pass over device memory is what the design keeps to.

#include <cuda_runtime.h>

constexpr int LRN_BWD_THREADS = 256;
// each of the three staged arrays holds at most this many floats (3 x 16
// KB of shared memory, within the 48 KB a block gets without opting in)
constexpr int LRN_BWD_SMEM_FLOATS = 4096;

__global__ void __launch_bounds__(LRN_BWD_THREADS)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ norm, float* __restrict__ dx,
               long long rows, int c, int rows_per_block, int lo, int hi,
               float beta, float coef) {
  extern __shared__ float smem[];
  const int stride = rows_per_block * c;
  float* st = smem;               // t = g * x * norm^-beta / norm
  float* sgp = smem + stride;     // g * norm^-beta
  float* sx = smem + 2 * stride;  // x
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long left = rows - r0;
  const int nrows = left < rows_per_block ? (int)left : rows_per_block;
  const int cnt = nrows * c;
  const long long base = r0 * c;
  for (int i = threadIdx.x; i < cnt; i += LRN_BWD_THREADS) {
    const float xv = x[base + i];
    const float gv = g[base + i];
    const float nv = norm[base + i];
    const float p = powf(nv, -beta);
    st[i] = gv * xv * p / nv;
    sgp[i] = gv * p;
    sx[i] = xv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += LRN_BWD_THREADS) {
    const int j = i % c;
    const int row = i - j;
    const int q0 = j - hi < 0 ? 0 : j - hi;
    const int q1 = j + lo > c - 1 ? c - 1 : j + lo;
    float win = 0.f;
    for (int q = q0; q <= q1; ++q) win += st[row + q];
    dx[base + i] = sgp[i] - coef * sx[i] * win;
  }
}

extern "C" int lrn_bwd_f32(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  if (c <= 0 || c > LRN_BWD_SMEM_FLOATS) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const int rows_per_block = LRN_BWD_SMEM_FLOATS / c;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)3 * rows_per_block * c * sizeof(float);
  lrn_bwd_kernel<<<(unsigned)blocks, LRN_BWD_THREADS, smem,
                   (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)norm, (float*)dx, rows,
      c, rows_per_block, lo, hi, beta, coef);
  return (int)cudaGetLastError();
}
