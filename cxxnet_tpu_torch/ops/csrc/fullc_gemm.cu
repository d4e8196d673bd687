// Tiled f32 GEMM for the fullc forward, for Hopper (sm_90a).  Replaces
// the Pallas `_matmul_kernel` / `_matmul_impl` of
// cxxnet_tpu/ops/pallas_kernels.py:383,532 (and its whole-K variant
// `_matmul_kernel_wholek` :376, the same function).
//
// What it computes: c (m, n) = a (m, k) @ b (k, n), all row-major f32,
// with b the fullc weight in its stored (nin, nhidden) layout — no
// transpose anywhere.
//
// Design: one block per 64 x 64 output tile; the contraction loop runs
// inside the block (the TPU kernel's sequential K grid axis and its VMEM
// accumulator become a register accumulator here), 16-deep slices of a
// and b staged through shared memory (sgemm_tile.cuh), full f32 FMA.
// The ragged edges (fc8's n = 1000) are masked on load and store instead
// of padding the operands in device memory as the Pallas kernel does.
//
// What bounds it on an H100: fc8 at batch 256 (256 x 4096 x 1000) does
// 2.1 GFLOP on 21 MB, so it is operation-bound at the 67 TFLOP/s f32
// peak (31 us).  With 64 x 64 tiles that shape gives only 4 x 16 = 64
// blocks for 132 SMs, so this first version leaves half the card idle;
// split-K or smaller tiles are the next step.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
fullc_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ float As[TILE_K][TILE_M + 1];
  __shared__ float Bs[TILE_K][TILE_N];

  const int m0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TILE_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + TILE_THREADS * i;
      const int ak = e % TILE_K, am = e / TILE_K;
      const int row = m0 + am, col = k0 + ak;
      As[ak][am] = (row < m && col < k) ? a[(long long)row * k + col] : 0.f;
      const int bk = e / TILE_N, bn = e % TILE_N;
      const int brow = k0 + bk, bcol = n0 + bn;
      Bs[bk][bn] =
          (brow < k && bcol < n) ? b[(long long)brow * n + bcol] : 0.f;
    }
    __syncthreads();
    tile_fma<TILE_N>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) c[(long long)row * n + col] = acc[i][j];
    }
  }
}

extern "C" int fullc_gemm_f32(const void* a, const void* b, void* c, int m,
                              int n, int k, void* stream) {
  dim3 grid((unsigned)((m + TILE_M - 1) / TILE_M),
            (unsigned)((n + TILE_N - 1) / TILE_N));
  fullc_gemm_kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, m, n, k);
  return (int)cudaGetLastError();
}
