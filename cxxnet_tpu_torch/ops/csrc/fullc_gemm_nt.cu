// Transpose-free f32 GEMM for the fullc backward's input gradient, for
// Hopper (sm_90a).  Replaces the Pallas `_matmul_nt_kernel` /
// `_matmul_nt_impl` of cxxnet_tpu/ops/pallas_kernels.py:433,480 (the
// `da = g @ b^T` half of `_matmul_vjp_bwd` :419).
//
// What it computes: c (m, k) = g (m, n) @ b (k, n)^T, all row-major f32:
// g is the upstream gradient of the fullc output, b the weight in its
// stored (nin, nhidden) layout, c the gradient of the fullc input.  The
// contraction runs over n, the trailing (contiguous) axis of BOTH
// operands, so neither is transposed in device memory.
//
// Design: one block per 64 x 64 output tile, the contraction loop inside
// the block in 16-deep slices (sgemm_tile.cuh), full f32 FMA (no TF32).
// Both operand tiles are read along n: each 16-wide slice of a row is one
// contiguous 64-byte segment, so consecutive threads read consecutive
// addresses; both are staged transposed into shared memory, padded by
// one column against bank conflicts.  The ragged contraction of fc8
// (n = 1000) and the ragged output edges are masked on load and store.
//
// What bounds it on an H100: AlexNet's fc layers at batch 256 are
// operation-bound (fc6: 19.3 GFLOP against 0.16 GB, 0.29 ms at the
// 67 TFLOP/s f32 peak).  The 64 x 64 tiles give fc6 (256 x 9216) 576
// blocks and fc7/fc8 (256 x 4096) 256 blocks, so every shape fills the
// 132 SMs; the unpipelined load -> sync -> compute loop is the known cost.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
fullc_gemm_nt_kernel(const float* __restrict__ g, const float* __restrict__ b,
                     float* __restrict__ c, int m, int n, int k) {
  __shared__ float As[TILE_K][TILE_M + 1];
  __shared__ float Bs[TILE_K][TILE_N + 1];

  const int m0 = blockIdx.x * TILE_M;
  const int k0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < n; n0 += TILE_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + TILE_THREADS * i;
      const int kk = e % TILE_K, r = e / TILE_K;
      const int col = n0 + kk;
      const int grow = m0 + r, brow = k0 + r;
      As[kk][r] = (grow < m && col < n) ? g[(long long)grow * n + col] : 0.f;
      Bs[kk][r] = (brow < k && col < n) ? b[(long long)brow * n + col] : 0.f;
    }
    __syncthreads();
    tile_fma<TILE_N + 1>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < k) c[(long long)row * k + col] = acc[i][j];
    }
  }
}

extern "C" int fullc_gemm_nt_f32(const void* g, const void* b, void* c,
                                 int m, int n, int k, void* stream) {
  dim3 grid((unsigned)((m + TILE_M - 1) / TILE_M),
            (unsigned)((k + TILE_N - 1) / TILE_N));
  fullc_gemm_nt_kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)b, (float*)c, m, n, k);
  return (int)cudaGetLastError();
}
