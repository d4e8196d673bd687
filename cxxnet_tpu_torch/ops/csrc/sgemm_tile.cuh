// Shared register-tile core of the port's f32 GEMM-shaped kernels
// (conv_bias_act.cu, fullc_gemm.cu, fullc_gemm_nt.cu, fullc_gemm_tn.cu).
//
// A block of 256 threads owns a 64 x 64 output tile and walks the
// contraction in 16-deep slices staged in shared memory: As[k][m] (the
// left operand, stored transposed and padded by one column so the
// staging stores do not collide on a bank) and Bs[k][n] (row stride LDB:
// TILE_N, or TILE_N + 1 where the right operand is staged transposed
// too).  Thread
// (ty, tx) = (t / 16, t % 16) accumulates the 4 x 4 outputs at rows
// ty + 16 i and columns tx + 16 j in registers, with full-precision f32
// FMA (no TF32): neighbouring threads own neighbouring output columns,
// so the epilogue's stores coalesce along the contiguous channel axis.
#pragma once

constexpr int TILE_M = 64;
constexpr int TILE_N = 64;
constexpr int TILE_K = 16;
constexpr int TILE_THREADS = 256;

template <int LDB>
__device__ __forceinline__ void tile_fma(const float (*As)[TILE_M + 1],
                                         const float (*Bs)[LDB],
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}
