// Pieces of the f32 flash-attention forward (flash_fwd.cu's
// flash_fwd_kernel), for Hopper (sm_90a): FMA tiles on f32 inputs.
//
// Layout: every operand is a contiguous (bh, rows, d) array (batch x heads
// flattened, as flash_attention's to_bhsd gives it); lse is (bh, sq)
// f32.  A block of 256 threads works on 64 x 64 tiles: thread
// (ty, tx) = (t / 16, t % 16) owns rows ty + 16 i (i < 4) of a tile and
// columns tx + 16 j (j < 4) of a score tile, or tx + 16 c (c < DPAD / 16)
// of a (64, d) accumulator.  The 16 threads of one row are one half-warp,
// so a row's max and sum are four xor shuffles.
//
// Operand tiles are staged in shared memory TRANSPOSED, t[dd * FA_LD + r]
// (DPAD x 65 floats, zero beyond the valid rows and beyond d), so that
// both products of a kernel read conflict-free: a score tile
// S = A B^T walks dd with one broadcast read of A and 16 consecutive
// reads of B per half-warp (fa_qk); an accumulator X W walks the tile's
// 64 rows with a broadcast read of X and reads of W at stride 65 (fa_pv).
// DPAD is d rounded up to 32, 64 or 128; the zero columns add 0 * 0 to a
// dot and are never stored.  Rows past the valid length are zero too, and
// the kernels mask them: ragged lengths are masked in-kernel, not padded
// in memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int FA_TILE = 64;            // query and key rows per tile
constexpr int FA_THREADS = 256;        // 16 x 16 threads, 4 x 4 each
constexpr int FA_LD = FA_TILE + 1;     // padded row of a staged tile

// Stage rows [r0, r0 + 64) of the (nrows, d) matrix src, times mul,
// transposed into dst (DPAD x FA_LD); zero past nrows and past d.
// Neighbouring threads read neighbouring elements of a row.
template <int DPAD>
__device__ __forceinline__ void fa_stage(float* dst,
                                         const float* __restrict__ src,
                                         int r0, int nrows, int d,
                                         float mul) {
  for (int idx = threadIdx.x; idx < FA_TILE * DPAD; idx += FA_THREADS) {
    const int r = idx / DPAD;
    const int c = idx - r * DPAD;
    float x = 0.f;
    if (r0 + r < nrows && c < d)
      x = src[(long long)(r0 + r) * d + c] * mul;
    dst[c * FA_LD + r] = x;
  }
}

// acc[i][j] += sum_dd A[dd][ty + 16 i] * B[dd][tx + 16 j]: the 4 x 4
// sub-tile of A B^T for two staged (transposed) tiles.
template <int DPAD>
__device__ __forceinline__ void fa_qk(const float* A, const float* B, int ty,
                                      int tx, float acc[4][4]) {
#pragma unroll 8
  for (int dd = 0; dd < DPAD; ++dd) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[dd * FA_LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[dd * FA_LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_r X[ty + 16 i][r] * W[r][tx + 16 c]: a (64, 64) tile X
// stored row-major (FA_TILE x FA_LD) times a staged tile W (W[c * FA_LD +
// r] holds row r, column c).
template <int DPAD>
__device__ __forceinline__ void fa_pv(const float* X, const float* W, int ty,
                                      int tx, float acc[4][DPAD / 16]) {
#pragma unroll 4
  for (int r = 0; r < FA_TILE; ++r) {
    float x[4], w[DPAD / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = X[(ty + 16 * i) * FA_LD + r];
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) w[c] = W[(tx + 16 * c) * FA_LD + r];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DPAD / 16; ++c)
        acc[i][c] = fmaf(x[i], w[c], acc[i][c]);
  }
}

// max / sum over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float fa_row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float fa_row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// whether query row `row` attends key `col` (top-left causal alignment)
__device__ __forceinline__ bool fa_live(int row, int col, int nq, int nk,
                                        int causal) {
  return row < nq && col < nk && (!causal || row >= col);
}
