// Tensor-core pieces of the port's f32 kernels on the TF32 tensor cores
// (the flash-attention forward, dq and dk/dv of flash_fwd.cu, flash_dq.cu
// and flash_dkv.cu; the split and tf_mma3 also in fullc_gemm_tn.cu), for
// Hopper (sm_90a): mma.sync m16n8k8 on TF32 operands with the 3xTF32
// split, and cp.async staging of f32 tiles.
//
// 3xTF32.  The tensor cores read a raw f32 register as TF32 by
// truncation, dropping its low 13 mantissa bits (tools/
// flash_bwd_variants.py tf32_probe).  So each f32 operand x is split
// into x_hi = x itself (read as trunc(x)) and x_lo = x - trunc(x), exact
// in f32 (read truncated again), and a product is taken as
//   A B ~= A_lo B_hi + A_hi B_lo + A_hi B_hi
// with f32 accumulators.  The dropped A_lo B_lo and the truncation of
// the lo parts are ~2^-20 of each term, so the sum keeps f32 accuracy
// (within 4e-6 of the plain version at the path's shape); one TF32
// product alone is ~2^-11 off, which the backward's cancelling ds (a row
// of p (dp - delta) sums to ~0) turns into several times the kernels'
// 1e-4 tolerance.  The split costs two instructions a value (a mask and
// a subtract); rounding both parts to nearest with cvt.rna.tf32.f32
// costs more and makes the kernels 25-32 % slower (variant f32_*_rn).
//
// Sums.  The tensor cores round each product's sum into its
// accumulator toward zero, so a chain of L products into one
// accumulator drifts by ~L 2^-24 of its value, always the same way: over
// the 1000 queries of a key at d = 128 that is ~2e-5, over 8192 ~2e-4.
// The kernels therefore sum each tile's products (a dozen or two) in a
// fresh accumulator and add it to the running result (a gradient, the
// forward's O, a GEMM tile) with an ordinary f32 add, which rounds to
// nearest (tf_grad).
//
// mma.m16n8k8 (.tf32) is a warp's product; lane = 4 g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, col-major):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// An accumulator is the A operand of the next product (the contraction
// running over its columns) once the contraction index is relabelled
// inside each 8-block: k = t stands for column 2t and k = t + 4 for
// column 2t + 1.  Then a = (c0, c2, c1, c3), straight from registers, and
// the B operand is read at rows 2t and 2t + 1 instead of t and t + 4.
//
// Tiles sit row-major in shared memory with rows of DP + 4 floats (LD).
// Since LD = 4 (mod 32), both ways of reading a fragment hit 32 distinct
// banks: rows g, columns t (and t + 4) at 4g + t, and rows 2t, 2t + 1,
// column g at 8t + g and 8t + 4 + g.  One staged copy of each operand
// serves every product: no transposed copy is written.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

constexpr int TF_WARPS = 8;
constexpr int TF_THREADS = 32 * TF_WARPS;

// x as hi + lo TF32 operands: x itself, and x - trunc(x)
__device__ __forceinline__ void tf_split(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a b, one m16n8k8 product of TF32 operands
__device__ __forceinline__ void tf_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split B operand: hi parts of b0, b1, then their lo parts
struct TfB {
  uint32_t h0, h1, l0, l1;
};

// d += a b by 3xTF32, the small terms first
__device__ __forceinline__ void tf_mma3(float (&d)[4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const TfB& b) {
  tf_mma(d, al, b.h0, b.h1);
  tf_mma(d, ah, b.l0, b.l1);
  tf_mma(d, ah, b.h0, b.h1);
}

// The A fragment at rows r, r + 8 and columns c, c + 4 of a row-major
// tile (rows of LD floats), split: r = first row + g, c = first column + t
template <int LD>
__device__ __forceinline__ void tf_load_a(const float* tile, int r, int c,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  tf_split(tile[r * LD + c], hi[0], lo[0]);
  tf_split(tile[(r + 8) * LD + c], hi[1], lo[1]);
  tf_split(tile[r * LD + c + 4], hi[2], lo[2]);
  tf_split(tile[(r + 8) * LD + c + 4], hi[3], lo[3]);
}

// The B fragment of a product against a tile's rows (A B^T, the tile's
// columns contracted): n = tile row + g, k = column c + t and c + t + 4
template <int LD>
__device__ __forceinline__ TfB tf_load_bt(const float* tile, int n, int c) {
  TfB b;
  tf_split(tile[n * LD + c], b.h0, b.l0);
  tf_split(tile[n * LD + c + 4], b.h1, b.l1);
  return b;
}

// The B fragment of a product that contracts the tile's rows, with the
// accumulator relabelling above: k = rows r and r + 1 (r = first row +
// 2t), n = column c (first column + g)
template <int LD>
__device__ __forceinline__ TfB tf_load_bn(const float* tile, int r, int c) {
  TfB b;
  tf_split(tile[r * LD + c], b.h0, b.l0);
  tf_split(tile[(r + 1) * LD + c], b.h1, b.l1);
  return b;
}

// An accumulator's 8-column block as the split A operand of the next
// product (a = (c0, c2, c1, c3), the relabelling above)
__device__ __forceinline__ void tf_acc_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  tf_split(c[0], hi[0], lo[0]);
  tf_split(c[2], hi[1], lo[1]);
  tf_split(c[1], hi[2], lo[2]);
  tf_split(c[3], hi[3], lo[3]);
}

// acc[m] (16 x 8 ND) += c[m] W for MT row fragments: c[m] a 16 x 8 NJ
// accumulator (the A operand, split here), W the row-major staged tile
// whose 8 NJ rows the product contracts.  Each 8-column block of acc
// sums the tile's products in a fresh accumulator, which an ordinary f32
// add puts into acc: the tensor cores round a sum toward zero, so one
// chain over a whole row would drift
template <int LD, int MT, int NJ, int ND>
__device__ __forceinline__ void tf_grad(float (&acc)[MT][ND][4],
                                        const float (&c)[MT][NJ][4],
                                        const float* W, int t, int g) {
  uint32_t ah[MT][NJ][4], al[MT][NJ][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) tf_acc_a(c[m][j], ah[m][j], al[m][j]);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float part[MT][4] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const TfB b = tf_load_bn<LD>(W, 8 * j + 2 * t, 8 * n + g);
#pragma unroll
      for (int m = 0; m < MT; ++m) tf_mma3(part[m], ah[m][j], al[m][j], b);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][e];
  }
}

// Stage rows [r0, r0 + ROWS) of the (nrows, d) f32 matrix src into the
// row-major tile dst (ROWS x (DP + 4) floats), zero past nrows and past
// d, asynchronously with TF_THREADS threads.  VEC 4: 16-byte copies (d %
// 4 == 0, src 16-byte aligned); VEC 1: 4-byte copies, any d.
template <int ROWS, int DP, int VEC>
__device__ __forceinline__ void tf_stage(float* dst,
                                         const float* __restrict__ src,
                                         int r0, int nrows, int d) {
  constexpr int CPR = DP / VEC;         // copies per row
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CPR; i += TF_THREADS) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    const bool ok = r0 + r < nrows && c < d;
    const float* s = ok ? src + (long long)(r0 + r) * d + c : src;
    const uint32_t a = fw_smem(dst + r * (DP + 4) + c);
    if constexpr (VEC == 4)
      fw_cp16(a, s, ok ? 16 : 0);
    else
      fw_cp4(a, s, ok ? 4 : 0);
  }
}

// wait until at most N of this thread's copy groups are in flight (the
// tiles are read by ordinary loads: no proxy fence)
template <int N>
__device__ __forceinline__ void tf_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's rows r and r + 8 of a 16 x DP accumulator (ND = DP / 8 blocks
// of four, the C layout), times mul, into the row-major (nrows, d) f32
// matrix at base.  VEC 4: d % 4 == 0 and base 16-byte aligned, so a
// column pair stores as one float2
template <int ND, int VEC>
__device__ __forceinline__ void tf_store(float* __restrict__ base,
                                         const float (&acc)[ND][4],
                                         float mul, int r, int nrows, int d,
                                         int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= nrows) continue;
    float* drow = base + (long long)row * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * t;
      const float x = acc[n][2 * h] * mul, y = acc[n][2 * h + 1] * mul;
      if (VEC == 4) {
        if (col < d) *reinterpret_cast<float2*>(drow + col) = make_float2(x, y);
      } else {
        if (col < d) drow[col] = x;
        if (col + 1 < d) drow[col + 1] = y;
      }
    }
  }
}
