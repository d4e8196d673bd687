// Tensor-core pieces of the bf16 flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu), for Hopper (sm_90a): cp.async staging of
// bf16 tiles into the layout wgmma reads, wgmma descriptors, the
// warpgroup products and their fences, and the f32 -> hi + lo bf16
// split of a register operand (softmax weights, score cotangents).
//
// wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply") is
// issued by a warpgroup of 4 warps over a 64-row tile: warp w of the
// group owns rows 16w .. 16w+15, and each lane (g = lane / 4, t = lane % 4)
// holds the f32 accumulator of a 64 x N product as N / 8 blocks of four:
// d[4j], d[4j+1] = (row g, columns 8j+2t, 8j+2t+1), d[4j+2], d[4j+3] =
// (row g+8, the same columns) -- the mma.m16n8k16 C layout, block by
// block.  A 64 x 16 bf16 operand held in registers takes the mma.m16n8k16
// A layout on each warp's rows: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
// a2 = (g, 2t+8..), a3 = (g+8, 2t+8..), two bf16 a register, the lower
// column in the low half.  So the accumulator of S = Q K^T over two
// neighbouring 8-key blocks is the A operand of P V as it stands: P never
// goes through shared memory.
//
// Shared-memory operands use wgmma's interleaved (unswizzled) layout:
// "core matrices" of 8 rows x 16 bytes (8 bf16), each 128 contiguous
// bytes.  A tile of R rows x DP columns keeps core matrix (r / 8, c / 8)
// at byte (r / 8 * DP / 8 + c / 8) * 128, row r % 8 of it at + 16 (r % 8):
// every wgmma read is one whole 128-byte core matrix, so there are no
// bank conflicts to pad away.  Read K-major (Q, K: rows are M / N, the
// contraction runs along c) the descriptor's leading offset (next 8
// columns) is 128 bytes and its stride offset (next 8 rows) DP * 16; read
// N-major (V for P V: rows are the contraction, c the output column) the
// two swap: stride offset 128 (next 8 output columns), leading offset
// DP * 16 (next 8 keys).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t fw_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (r, c) of a tile of DP columns in the
// interleaved layout
template <int DP>
__device__ __forceinline__ int fw_off(int r, int c) {
  return (((r >> 3) * (DP / 8) + (c >> 3)) << 7) + ((r & 7) << 4) +
         ((c & 7) << 1);
}

// the wgmma descriptor of an operand at shared byte address `addr`:
// start address, leading and stride byte offsets (all / 16), no swizzle
__device__ __forceinline__ uint64_t fw_desc(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32);
}

// 16 bytes global -> shared, asynchronously; bytes past `src_bytes` (0
// or 16) are zero-filled and not read
__device__ __forceinline__ void fw_cp16(uint32_t dst, const void* src,
                                        int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronously, zero-filled past `src_bytes`
__device__ __forceinline__ void fw_cp4(uint32_t dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void fw_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight, then
// make what landed visible to wgmma's reads (the async proxy)
template <int N>
__device__ __forceinline__ void fw_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [r0, r0 + ROWS) of the (nrows, d) bf16 matrix src into the
// interleaved tile at dst (ROWS x DP), zero past nrows and past d, with NT
// threads, for rows that 16-byte copies cannot take (FwTilePlan takes
// the rest).  VEC is the copy width in elements: 2 (4-byte cp.async; d
// even, src 4-byte aligned) or 1 (plain loads and stores, any d).
template <int ROWS, int DP, int VEC, int NT>
__device__ __forceinline__ void fw_stage(unsigned char* dst,
                                         const __nv_bfloat16* __restrict__ src,
                                         int r0, int nrows, int d) {
  static_assert(VEC == 1 || VEC == 2, "16-byte copies go through FwTilePlan");
  if constexpr (VEC == 1) {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - (i / DP) * DP;
      *reinterpret_cast<__nv_bfloat16*>(dst + fw_off<DP>(r, c)) =
          (r0 + r < nrows && c < d) ? src[(long long)(r0 + r) * d + c]
                                    : __float2bfloat16(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP / 2; i += NT) {
      const int r = i / (DP / 2), c = (i - r * (DP / 2)) * 2;
      const bool ok = r0 + r < nrows && c < d;
      fw_cp4(fw_smem(dst + fw_off<DP>(r, c)),
             ok ? src + (long long)(r0 + r) * d + c : src, ok ? 4 : 0);
    }
  }
}

// This thread's share of the 16-byte copies of a ROWS-row tile of DP
// columns (the VEC = 8 path), planned once per kernel: per copy, its
// offset in the interleaved tile, its offset in a row-major source, its
// row and whether its columns lie inside d.  A tile's copies then cost a
// compare, an add and the cp.async each.
template <int DP, int NT, int ROWS = 64>
struct FwTilePlan {
  static constexpr int CH = DP / 8;                 // copies per row
  static constexpr int CPT = ROWS * CH / NT;        // copies per thread
  static_assert(CPT * NT == ROWS * CH, "a tile's copies split evenly");
  uint32_t off[CPT];
  int src[CPT], row[CPT];
  bool col_ok[CPT];

  // copy i is row i % 8 + 8 (i / (8 CH)) and column block (i / 8) % CH:
  // the 8 lanes of a quarter-warp write one whole 128-byte core matrix
  __device__ __forceinline__ explicit FwTilePlan(int d) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i % 8 + 8 * (i / (8 * CH)), c = (i / 8) % CH * 8;
      off[j] = fw_off<DP>(r, c);
      src[j] = r * d + c;
      row[j] = r;
      col_ok[j] = c < d;
    }
  }

  // rows [r0, r0 + ROWS) of the (nrows, d) matrix base into dst
  __device__ __forceinline__ void copy(uint32_t dst,
                                       const __nv_bfloat16* base, int r0,
                                       int nrows, int d) const {
    const __nv_bfloat16* b = base + (long long)r0 * d;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const bool ok = col_ok[j] && r0 + row[j] < nrows;
      fw_cp16(dst + off[j], ok ? b + src[j] : base, ok ? 16 : 0);
    }
  }
};

// wgmma ordering.  fw_fence: registers written by ordinary instructions
// (accumulators, A operands) are ready for the next products;
// fw_commit / fw_wait<N>: close a batch of products, wait until at most N
// batches are in flight.  fw_pin(x): the compiler may neither move an
// access of x across it nor reuse x's register: the products read and
// write their registers asynchronously, between issue and fw_wait.
__device__ __forceinline__ void fw_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fw_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fw_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fw_pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fw_pin(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x 64) = (scale_d ? d : 0) + a b, with a (64 x 16) and b (16 x 64)
// read from shared memory by their descriptors (K-major)
__device__ __forceinline__ void fw_mma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) = (scale_d ? d : 0) + a b, with a (64 x 16) and b (16 x 32)
// read from shared memory by their descriptors (K-major)
__device__ __forceinline__ void fw_mma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) += a b, with a (64 x 16) from registers (each warp's 16
// rows as the mma.m16n8k16 A fragment) and b (16 x 32) read from shared
// memory by its descriptor, N-major (transposed)
__device__ __forceinline__ void fw_mma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += a b, with a (64 x 16) from registers (each warp's 16
// rows as the mma.m16n8k16 A fragment) and b (16 x 64) read from shared
// memory by its descriptor, N-major (transposed)
__device__ __forceinline__ void fw_mma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += a b, with a (64 x 16) from registers (each warp's 16
// rows as the mma.m16n8k16 A fragment) and b (16 x 128) read from shared
// memory by its descriptor, N-major (transposed)
__device__ __forceinline__ void fw_mma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU (ex2.approx: ~2 ulp; 2^-inf = 0; results below 2^-126
// flush to 0, where they add nothing to a sum that is at least 1)
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t fw_pack(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x - (x rounded to bf16), for the pair packed in h
__device__ __forceinline__ uint32_t fw_pack_rest(float x, float y,
                                                 uint32_t h) {
  const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h);
  return fw_pack(x - __low2float(hv), y - __high2float(hv));
}

// d (64 x N) = (scale_d ? d : 0) + a b, both from shared memory (K-major)
template <int N>
__device__ __forceinline__ void fw_mma_ss(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "score tiles are 32 or 64 wide");
  if constexpr (N == 32)
    fw_mma_ss_n32(d, da, db, scale_d);
  else
    fw_mma_ss_n64(d, da, db, scale_d);
}

// O (64 x DP) += P (64 x 16) V (16 x DP) for one warpgroup, V N-major
template <int DP>
__device__ __forceinline__ void fw_pv(float (&o)[DP / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 32)
    fw_mma_rs_n32(o, a, db);
  else if constexpr (DP == 64)
    fw_mma_rs_n64(o, a, db);
  else
    fw_mma_rs_n128(o, a, db);
}

// An f32 accumulator of a 64 x (NS * 2) product as hi + lo bf16 A
// operands of the next product, straight from its registers: columns
// 16 kb .. 16 kb + 15 are its 8-column blocks 2 kb and 2 kb + 1
template <int NS>
__device__ __forceinline__ void fw_split(const float (&p)[NS],
                                         uint32_t (&hi)[NS / 8][4],
                                         uint32_t (&lo)[NS / 8][4]) {
#pragma unroll
  for (int kb = 0; kb < NS / 8; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kb + 4 * (r >> 1) + 2 * (r & 1);
      hi[kb][r] = fw_pack(p[i], p[i + 1]);
      lo[kb][r] = fw_pack_rest(p[i], p[i + 1], hi[kb][r]);
    }
}

// A lane's two rows, r and r + 8, of a 64 x DP f32 accumulator (the
// layout above), times mul, rounded once to bf16 into the row-major
// (nrows, d) matrix at base.  VEC > 1: d is even and base 4-byte aligned,
// so a column pair stores as one bf16x2
template <int DP, int VEC>
__device__ __forceinline__ void fw_store(__nv_bfloat16* __restrict__ base,
                                         const float (&acc)[DP / 2],
                                         float mul, int r, int nrows, int d,
                                         int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= nrows) continue;
    __nv_bfloat16* drow = base + (long long)row * d;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      const float x = acc[4 * nd + 2 * h] * mul;
      const float y = acc[4 * nd + 2 * h + 1] * mul;
      if (VEC > 1 && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        if (col < d) drow[col] = __float2bfloat16(x);
        if (col + 1 < d) drow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

// the launch of one instantiation with THREADS threads a block: opt in
// to the dynamic shared memory above 48 KB, launch, and return the
// launch's error (the f32 builds of flash_fwd.cu, flash_dq.cu and
// flash_dkv.cu, and fullc_gemm_tn.cu)
template <int THREADS, typename Kernel, typename... Args>
static int fw_launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
                     Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
