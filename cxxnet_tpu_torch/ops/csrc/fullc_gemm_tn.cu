// Transpose-free f32 GEMM for the fullc backward's weight gradient, for
// Hopper (sm_90a), on the TF32 tensor cores with the 3xTF32 split.
// Replaces the Pallas `_matmul_tn_kernel` / `_matmul_tn_impl` of
// cxxnet_tpu/ops/pallas_kernels.py:449,506 (the `db = a^T @ g` half of
// `_matmul_vjp_bwd` :419).
//
// What it computes: c (k, n) = a (m, k)^T @ g (m, n), all row-major f32:
// a is the fullc input, g the upstream gradient of its output, c the
// gradient of the weight in its stored (nin, nhidden) layout.  The
// contraction runs over m — the batch, the leading axis of BOTH
// operands — so neither is transposed in device memory.
//
// What bounds it on an H100: at batch 256 fc6's weight gradient (9216 x
// 4096, contracting 256) does 19.3 GFLOP, 0.039 ms at the dense TF32
// rate of 495 TFLOP/s, against 165 MB of bytes (the 151 MB output
// written once), 0.049 ms at 3.35 TB/s: the bytes, by a little.  The
// split's three products a term need 0.12 ms at that rate, and mma.sync
// reaches ~311 TFLOP/s on TF32 (tools/flash_bwd_variants.py mma_peak),
// so the products set the kernel's pace: 0.19 ms at fc6 (0.29 ms on the
// FMA pipes' 67 TFLOP/s).
//
// Design:
//   * a block of four warps owns a 128 x 64 tile of c (rows index a's
//     columns, columns g's); warp w owns its 64 x 32 piece at rows 64 (w
//     / 2), columns 32 (w % 2): 4 x 4 fragments of mma.sync m16n8k8.  Two
//     blocks share an SM, so one block's first copies and last stores
//     run under the other's products (one block of eight warps on a
//     128 x 128 tile was 5 % slower, tools/sgemm_variants.py tn_n128);
//   * the batch runs in 32-deep slices through sgemm_pipe.cuh's
//     three-stage cp.async ring: a slice of either operand is 32 batch
//     rows x 128 (a) or 64 (g) contiguous columns, staged as it lies
//     (rows padded by 8 floats; 16-deep slices were 6 % slower,
//     tn_bk16).  A fragment of the row-major A (row = output row, k =
//     batch) is then As[k][row] and one of the col-major B Bs[k][col]:
//     lane 4 g + t reads bank (8 t + g) mod 32, no conflict, and no
//     operand is transposed anywhere.  16-byte copies where k and n are
//     multiples of 4 and the bases 16-byte aligned, else 4-byte ones;
//     both zero-filled past m, k and n by the copy itself;
//   * 3xTF32 (flash_tf32.cuh): each fragment value is split once into hi
//     + lo, each B fragment's split serves the warp's four row fragments
//     and each A fragment's its four column fragments, and a term is
//     three TF32 products.  The tensor cores round a product's sum toward
//     zero, so each slice's products sum in a fresh accumulator that an
//     f32 add puts into the tile's: FMA-level accuracy;
//   * no split of the batch and no atomics: 72 x 64 = 4608 tiles at fc6,
//     2048 at fc7, 512 at fc8 for 132 SMs; each block writes its tile
//     once, so two launches give bitwise-equal outputs.  The ragged n of
//     fc8 (1000) and a batch that is not a multiple of 32 are masked.
//
// The bf16 build (fullc_gemm_tn_bf16, on wgmma) is fullc_gemm_tn_bf16.cu.

#include "flash_tf32.cuh"
#include "sgemm_pipe.cuh"

constexpr int TN_BM = 128, TN_BN = 64;    // output tile: rows x columns
constexpr int TN_BK = 32;                 // batch rows a staged slice
constexpr int TN_MT = 4, TN_NT = 4;       // a warp's 16-row, 8-col frags
constexpr int TN_WN = TN_BN / (8 * TN_NT);   // warps across the columns
constexpr int TN_THREADS = 32 * TN_WN * TN_BM / (16 * TN_MT);
constexpr int TN_LDA = TN_BM + 8, TN_LDB = TN_BN + 8;  // staged rows
constexpr int TN_KK = TN_BK / 8;          // k8 steps a slice
constexpr int TN_STAGE_FLOATS = TN_BK * (TN_LDA + TN_LDB);
constexpr size_t TN_SMEM = SP_STAGES * TN_STAGE_FLOATS * sizeof(float);

// Stage batch rows [mb, mb + TN_BK) of columns [c0, c0 + W) of the
// (m, ncols) matrix src into dst (rows of LD floats), zero past m and
// ncols.  VEC: floats a copy (4: 16 bytes, 1: 4 bytes).
template <int W, int LD, int VEC>
__device__ __forceinline__ void tn_stage_one(float* dst,
                                             const float* __restrict__ src,
                                             int m, int ncols, int mb,
                                             int c0) {
  constexpr int CPR = W / VEC;                 // copies a staged row
  auto copy = [&](int c) {
    const int i = threadIdx.x + c * TN_THREADS;
    const int r = i / CPR, col = (i % CPR) * VEC;
    const bool ok = mb + r < m && c0 + col < ncols;
    sp_cp(dst + r * LD + col,
          ok ? src + (long long)(mb + r) * ncols + c0 + col : src, ok,
          4 * VEC);
  };
  if constexpr (VEC == 4) {
#pragma unroll
    for (int c = 0; c < TN_BK * CPR / TN_THREADS; ++c) copy(c);
  } else {     // four times the copies: unrolled fully, they spill
#pragma unroll 4
    for (int c = 0; c < TN_BK * CPR / TN_THREADS; ++c) copy(c);
  }
}

// a's columns [k0, k0 + TN_BM) into As, g's [n0, n0 + TN_BN) into Bs
template <int VEC>
__device__ __forceinline__ void tn_stage(float* As, float* Bs,
                                         const float* __restrict__ a,
                                         const float* __restrict__ g, int m,
                                         int n, int k, int mb, int k0,
                                         int n0) {
  tn_stage_one<TN_BM, TN_LDA, VEC>(As, a, m, k, mb, k0);
  tn_stage_one<TN_BN, TN_LDB, VEC>(Bs, g, m, n, mb, n0);
}

// acc += As^T Bs over one staged slice for the warp's piece at rows wr,
// columns wc (lane 4 gi + t): the slice's products of each row fragment
// sum in a fresh accumulator, added to acc in f32.
__device__ __forceinline__ void tn_slice(const float* As, const float* Bs,
                                         int wr, int wc, int gi, int t,
                                         float (&acc)[TN_MT][TN_NT][4]) {
  // B fragments (k = t, t + 4; n = gi) of the slice, split once
  TfB b[TN_KK][TN_NT];
#pragma unroll
  for (int kk = 0; kk < TN_KK; ++kk)
#pragma unroll
    for (int j = 0; j < TN_NT; ++j) {
      const float* p = Bs + (8 * kk + t) * TN_LDB + wc + 8 * j + gi;
      tf_split(p[0], b[kk][j].h0, b[kk][j].l0);
      tf_split(p[4 * TN_LDB], b[kk][j].h1, b[kk][j].l1);
    }
#pragma unroll
  for (int i = 0; i < TN_MT; ++i) {
    float part[TN_NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < TN_KK; ++kk) {
      // A fragment: rows gi, gi + 8 and k = t, t + 4
      const float* p = As + (8 * kk + t) * TN_LDA + wr + 16 * i + gi;
      uint32_t ah[4], al[4];
      tf_split(p[0], ah[0], al[0]);
      tf_split(p[8], ah[1], al[1]);
      tf_split(p[4 * TN_LDA], ah[2], al[2]);
      tf_split(p[4 * TN_LDA + 8], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < TN_NT; ++j) tf_mma3(part[j], ah, al, b[kk][j]);
    }
#pragma unroll
    for (int j = 0; j < TN_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
  }
}

// One TN_BM x TN_BN tile of c a block: grid (k tiles, n tiles).  VEC 4:
// k and n multiples of 4, a, g and c 16-byte aligned (16-byte copies and
// float2 stores); VEC 1: any shape.
template <int VEC>
__global__ void __launch_bounds__(TN_THREADS, 2)
fullc_gemm_tn_kernel(const float* __restrict__ a, const float* __restrict__ g,
                     float* __restrict__ c, int m, int n, int k) {
  extern __shared__ __align__(16) float tn_buf[];
  const int k0 = blockIdx.x * TN_BM, n0 = blockIdx.y * TN_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int wr = (warp / TN_WN) * 16 * TN_MT;
  const int wc = (warp % TN_WN) * 8 * TN_NT;

  float acc[TN_MT][TN_NT][4];
#pragma unroll
  for (int i = 0; i < TN_MT; ++i)
#pragma unroll
    for (int j = 0; j < TN_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  sp_mainloop(
      tn_buf, TN_STAGE_FLOATS, (m + TN_BK - 1) / TN_BK,
      [&](float* st, int s) {
        tn_stage<VEC>(st, st + TN_BK * TN_LDA, a, g, m, n, k, s * TN_BK,
                      k0, n0);
      },
      [&](const float* st) {
        tn_slice(st, st + TN_BK * TN_LDA, wr, wc, gi, t, acc);
      });
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives

  // lane (gi, t) holds rows gi and gi + 8 of each fragment, columns 2 t
  // and 2 t + 1: a warp's store of one (i, h, j) is eight rows of 32
  // contiguous bytes, whole sectors
#pragma unroll
  for (int i = 0; i < TN_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + wr + 16 * i + 8 * h + gi;
      if (row >= k) continue;
      float* crow = c + (long long)row * n;
#pragma unroll
      for (int j = 0; j < TN_NT; ++j) {
        const int col = n0 + wc + 8 * j + 2 * t;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (VEC == 4) {
          if (col < n)
            *reinterpret_cast<float2*>(crow + col) = make_float2(x, y);
        } else {
          if (col < n) crow[col] = x;
          if (col + 1 < n) crow[col + 1] = y;
        }
      }
    }
}

extern "C" int fullc_gemm_tn_f32(const void* a, const void* g, void* c,
                                 int m, int n, int k, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const dim3 grid((unsigned)((k + TN_BM - 1) / TN_BM),
                  (unsigned)((n + TN_BN - 1) / TN_BN));
  const uintptr_t addr = (uintptr_t)a | (uintptr_t)g | (uintptr_t)c;
  if (k % 4 == 0 && n % 4 == 0 && addr % 16 == 0)
    return fw_launch<TN_THREADS>(fullc_gemm_tn_kernel<4>, grid, TN_SMEM,
                                 stream, (const float*)a, (const float*)g,
                                 (float*)c, m, n, k);
  return fw_launch<TN_THREADS>(fullc_gemm_tn_kernel<1>, grid, TN_SMEM, stream,
                               (const float*)a, (const float*)g, (float*)c, m,
                               n, k);
}
