// The 16-bit tensor-core tile of the port's bf16 and f16 forward GEMMs and
// convs (fullc_gemm_bf16.cu and conv_bias_act_bf16.cu, each exporting a
// bf16 and an f16 entry), for Hopper (sm_90a): mma.sync.m16n8k16 on bf16 or
// f16 operands with f32 accumulators.  A product of two bf16 (8-bit
// significand) or two f16 (11-bit) values is exact in f32, so the sums keep
// f32 accuracy, and each output is rounded to the 16-bit type once, as the
// Pallas kernels' f32 scratch accumulator and final astype do
// (pallas_kernels.py:433-462).  One body serves both types: the element type
// T is gm_bf16 (bf16 bits) or gm_f16 (__half), two distinct types, and only
// the mma instruction and the rounding store depend on it; the copies, the
// ldmatrix reads and the fragment layouts move the same 2-byte elements.
//
// A warp owns a 64 x 32 piece of the output tile: 4 x 4 fragments of
// m16n8k16; the forward GEMM's and the conv's blocks are two warps tall
// and WN wide (128 x 32 WN).  The contraction runs in slices staged into
// shared memory by sgemm_pipe.cuh's three-stage ring (sp_mainloop): 16-byte
// cp.async copies (zero-filled past the operands' edges) where the rows
// are multiples of 8 elements and the bases 16-byte aligned, else 2-byte
// loads and stores.  Fragments come out of shared memory by ldmatrix
// (.trans where the staged operand is not contraction-major); every staged
// row is a multiple of 16 bytes plus 16, so the eight rows of one 8 x 8
// matrix fall on eight different 16-byte bank groups.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane = 4 g + t): A a0 = (row
// g, k 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8,
// 2t + 8..); B b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8.., g); C c0, c1 =
// (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, the same cols).
#pragma once

#include <type_traits>

#include "sgemm_pipe.cuh"

constexpr int GM_BM = 128;
constexpr int GM_MT = 4, GM_NT = 4;     // a warp's 16-row, 8-col fragments

typedef unsigned short gm_bf16;         // bf16 bits
typedef __half gm_f16;                  // f16

// a zero element of T
template <class T>
__device__ __forceinline__ T gm_0();
template <>
__device__ __forceinline__ gm_bf16 gm_0<gm_bf16>() {
  return 0;
}
template <>
__device__ __forceinline__ gm_f16 gm_0<gm_f16>() {
  return __ushort_as_half(0);
}

// four 8 x 8 b16 matrices: lanes 8 q .. 8 q + 7 give matrix q's rows
template <class T>
__device__ __forceinline__ void gm_ldsm(uint32_t (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// the same, each matrix transposed on the way
template <class T>
__device__ __forceinline__ void gm_ldsm_t(uint32_t (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// d += a b, one m16n8k16 product of T (bf16 or f16) with f32 accumulators
#define GM_MMA(TY)                                                        \
  asm volatile(                                                           \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "          \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <class T>
__device__ __forceinline__ void gm_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  static_assert(std::is_same<T, gm_bf16>::value ||
                    std::is_same<T, gm_f16>::value,
                "a bf16 or f16 product");
  if constexpr (std::is_same<T, gm_f16>::value)
    GM_MMA("f16");
  else
    GM_MMA("bf16");
}
#undef GM_MMA

// 8 elements (16 bytes) by cp.async; ok == false zero-fills the
// destination (src must still be a valid address)
template <class T>
__device__ __forceinline__ void gm_cp16(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void gm_zero(float (&acc)[GM_MT][GM_NT][4]) {
#pragma unroll
  for (int i = 0; i < GM_MT; ++i)
#pragma unroll
    for (int j = 0; j < GM_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += one BK-deep slice of products for the warp's piece at rows wr,
// cols wc, both operands as a GEMM in its natural (NN) layout: the left
// operand staged As[row][kk] (lda elements a row), read by ldmatrix; the
// right one Bs[kk][col] (ldb a row), read by ldmatrix.trans
template <int BK, class T>
__device__ __forceinline__ void gm_slice_nn(const T* As, int lda,
                                            const T* Bs, int ldb,
                                            int wr, int wc, int lane,
                                            float (&acc)[GM_MT][GM_NT][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[GM_MT][4], b[GM_NT][2];
#pragma unroll
    for (int i = 0; i < GM_MT; ++i)
      gm_ldsm(a[i], As + (wr + 16 * i + (lane & 15)) * lda + kk +
                        (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < GM_NT / 2; ++jp) {
      uint32_t r[4];
      gm_ldsm_t(r, Bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + wc
                       + 16 * jp + (lane >> 4) * 8);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < GM_MT; ++i)
#pragma unroll
      for (int j = 0; j < GM_NT; ++j)
        gm_mma<T>(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// two neighbouring outputs in one store: a float2, two bf16 bits or two
// f16 values
__device__ __forceinline__ void gm_put2(float* c, float x, float y) {
  *reinterpret_cast<float2*>(c) = make_float2(x, y);
}
__device__ __forceinline__ void gm_put2(gm_bf16* c, float x, float y) {
  *reinterpret_cast<uint32_t*>(c) =
      (uint32_t)sp_to_bf16(x) | ((uint32_t)sp_to_bf16(y) << 16);
}
__device__ __forceinline__ void gm_put2(gm_f16* c, float x, float y) {
  *reinterpret_cast<__half2*>(c) = __floats2half2_rn(x, y);
}

// The warp's piece of the tile at (r0, c0) into c (rows x cols, row
// major): f32 (a split-K partial), or bf16 bits or f16 (one rounding).
// pair: cols even and c 8-byte (f32) / 4-byte (16-bit) aligned, so the
// lane's two neighbouring columns go in one store.
template <class OUT>
__device__ __forceinline__ void gm_store(const float (&acc)[GM_MT][GM_NT][4],
                                         OUT* __restrict__ c, int rows,
                                         int cols, int r0, int c0,
                                         bool pair) {
  const int lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < GM_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * i + 8 * h + gi;
      if (row >= rows) continue;
      OUT* crow = c + (long long)row * cols;
#pragma unroll
      for (int j = 0; j < GM_NT; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (pair) {
          if (col < cols) gm_put2(crow + col, x, y);
        } else {
          if (col < cols) sp_put(crow + col, x);
          if (col + 1 < cols) sp_put(crow + col + 1, y);
        }
      }
    }
}
