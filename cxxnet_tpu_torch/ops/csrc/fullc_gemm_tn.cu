// Transpose-free f32 GEMM for the fullc backward's weight gradient, for
// Hopper (sm_90a).  Replaces the Pallas `_matmul_tn_kernel` /
// `_matmul_tn_impl` of cxxnet_tpu/ops/pallas_kernels.py:449,506 (the
// `db = a^T @ g` half of `_matmul_vjp_bwd` :419).
//
// What it computes: c (k, n) = a (m, k)^T @ g (m, n), all row-major f32:
// a is the fullc input, g the upstream gradient of its output, c the
// gradient of the weight in its stored (nin, nhidden) layout.  The
// contraction runs over m — the batch, the leading axis of BOTH
// operands — so neither is transposed in device memory.
//
// Design: one block per 64 x 64 output tile, the batch loop inside the
// block in 16-deep slices (sgemm_tile.cuh), full f32 FMA (no TF32).  A
// slice of a is 16 rows x 64 contiguous columns and lands in shared
// memory as As[m][k] without any transpose; the slice of g likewise as
// Bs[m][n].  Each block writes its output tile exactly once, with no
// atomics and no split of the contraction, so the result does not
// depend on scheduling.  The ragged n of fc8 (1000) and a batch that is
// not a multiple of 16 are masked.
//
// What bounds it on an H100: operations.  fc6's weight gradient at batch
// 256 (9216 x 4096, contracting 256) is 19.3 GFLOP, 0.29 ms at the
// 67 TFLOP/s f32 peak, against a 151 MB output write (0.045 ms at
// 3.35 TB/s).  The grid is large (9216 blocks at fc6), so the card
// fills; the contraction is short, so each block runs only 16 slices and
// its epilogue store is a visible share of its time.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
fullc_gemm_tn_kernel(const float* __restrict__ a, const float* __restrict__ g,
                     float* __restrict__ c, int m, int n, int k) {
  __shared__ float As[TILE_K][TILE_M + 1];
  __shared__ float Bs[TILE_K][TILE_N];

  const int k0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int mb = 0; mb < m; mb += TILE_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + TILE_THREADS * i;
      const int r = e / TILE_M, col = e % TILE_M;
      const int row = mb + r;
      const int acol = k0 + col, gcol = n0 + col;
      As[r][col] = (row < m && acol < k) ? a[(long long)row * k + acol] : 0.f;
      Bs[r][col] = (row < m && gcol < n) ? g[(long long)row * n + gcol] : 0.f;
    }
    __syncthreads();
    tile_fma<TILE_N>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) c[(long long)row * n + col] = acc[i][j];
    }
  }
}

extern "C" int fullc_gemm_tn_f32(const void* a, const void* g, void* c,
                                 int m, int n, int k, void* stream) {
  dim3 grid((unsigned)((k + TILE_M - 1) / TILE_M),
            (unsigned)((n + TILE_N - 1) / TILE_N));
  fullc_gemm_tn_kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)g, (float*)c, m, n, k);
  return (int)cudaGetLastError();
}
