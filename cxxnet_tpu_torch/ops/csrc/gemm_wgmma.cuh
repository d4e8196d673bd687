// The wgmma core of the bf16 and f16 builds of the fullc backward GEMMs
// (fullc_gemm_nt_bf16.cu, the input gradient; fullc_gemm_tn_bf16.cu, the
// weight gradient; each exports a bf16 and an f16 entry), for Hopper
// (sm_90a): 64-row warpgroup products with both operands in shared memory,
// f32 accumulators in registers, the staging of slices into the layout
// wgmma reads, and the coalesced store of a finished 16-bit tile.  One
// body serves both types: the element type T is gw_bf16 (__nv_bfloat16)
// or gw_f16 (__half), and only the wgmma instruction's operand type and
// the rounding store depend on it; wgmma reads f16 operands, transposed or
// not, from the same layouts as bf16 ones.  The descriptors, the
// interleaved layout, the cp.async copies and the wgmma fences are
// flash_mma.cuh's.
//
// Layout.  A slice of ROWS rows x COLS columns of a row-major 16-bit
// matrix
// is staged into wgmma's 128-byte swizzle layout (what a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes): atoms of ROWS rows x 64 columns, a
// row 128 bytes, atom c / 64 at byte ROWS * 128 (c / 64), and the 16-byte
// chunk c / 8 % 8 of row r at chunk (c / 8 % 8) ^ (r % 8) of its row
// (gw_off).  Every tile starts on a 1024-byte boundary, as the swizzle is
// reckoned on the address.  8 lanes copy the 128 bytes of one row (one
// global line, eight different bank groups).  The interleaved layout of
// flash_mma.cuh, in which 8 lanes copy 64 bytes of each of 8 rows, ran
// these kernels' copies at half the L2 rate (tools/sgemm_variants.py).
// Staged K-major (the contraction along c: the NT's g rows and b rows, 64
// deep), a descriptor's stride offset (the next 8 rows of M or N) is 1024
// bytes and a k16 step 32 bytes on.  Staged MN-major (the contraction
// along r: the TN's batch rows of a and g), read through wgmma's
// transpose bits: leading offset ROWS * 128 (the next 64 of M or N, an
// atom), stride offset 1024 (the next 8 of the contraction), a k16 step
// 2048 bytes, and a warpgroup's 64 rows of M one atom further along the
// tile.  Nothing is transposed in device memory.
//
// The accumulator of a 64 x N product (PTX ISA, wgmma D fragments): warp
// w of the group owns rows 16 w .. 16 w + 15; lane (g = lane / 4, t =
// lane % 4) holds d[4 j], d[4 j + 1] = (row g, columns 8 j + 2 t, + 1) and
// d[4 j + 2], d[4 j + 3] = (row g + 8, the same columns).
#pragma once

#include "flash_mma.cuh"

#include <cuda_fp16.h>

#include <atomic>
#include <type_traits>

typedef __nv_bfloat16 gw_bf16;
typedef __half gw_f16;

// a zero element of T
template <class T>
__device__ __forceinline__ T gw_0();
template <>
__device__ __forceinline__ gw_bf16 gw_0<gw_bf16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ gw_f16 gw_0<gw_f16>() {
  return __ushort_as_half(0);
}

// two f32 values rounded to T (nearest even) as one 4-byte pair, x in the
// low half
__device__ __forceinline__ uint32_t gw_pack(const gw_bf16*, float x,
                                            float y) {
  return fw_pack(x, y);
}
__device__ __forceinline__ uint32_t gw_pack(const gw_f16*, float x,
                                            float y) {
  const __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one f32 value rounded to T (nearest even)
__device__ __forceinline__ void gw_round(gw_bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void gw_round(gw_f16* p, float v) {
  *p = __float2half_rn(v);
}

constexpr int GW_MAX_DEVICES = 64;

// cudaFuncSetAttribute(KERNEL, MaxDynamicSharedMemorySize, smem) once a
// device: a kernel above 48 KB of shared memory runs only once opted in.
// flash_mma.cuh's fw_launch opts in at every launch, under kernels long
// enough to hide it; here the host call would cost more than fc8's
// products, so the opt-in is remembered a device
template <auto KERNEL>
static cudaError_t gw_opt_in(size_t smem) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= GW_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done.load() >> dev & 1) return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

// Byte offset of element (r, c) of a staged ROWS x COLS tile
template <int ROWS>
__device__ __forceinline__ int gw_off(int r, int c) {
  return (((c >> 6) * ROWS + r) << 7) + ((((c >> 3) ^ r) & 7) << 4) +
         ((c & 7) << 1);
}

// Stage rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the row-major
// matrix src (ld elements a row) into the tile at dst (shared memory),
// zero where a row is >= rlim or a column >= clim, with THREADS threads.
// VEC: 16-byte cp.async copies (ld, c0 and clim multiples of 8, src
// 16-byte aligned), copy i taking row i / (COLS / 8) and column block i %
// (COLS / 8): a warp copies whole 128-byte lines, and every 8 lanes write
// one row's eight chunks to eight bank groups.  Otherwise 2-byte loads
// and stores, any shape and alignment.
template <int ROWS, int COLS, int THREADS, bool VEC, class T>
__device__ __forceinline__ void gw_stage(unsigned char* dst,
                                         const T* __restrict__ src,
                                         long long ld, int r0, int rlim,
                                         int c0, int clim) {
  constexpr int CH = COLS / 8;
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < (ROWS * CH + THREADS - 1) / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
      const int r = i / CH, c = 8 * (i % CH);
      const bool ok = r0 + r < rlim && c0 + c < clim;
      fw_cp16(fw_smem(dst + gw_off<ROWS>(r, c)),
              ok ? src + (r0 + r) * ld + c0 + c : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      *reinterpret_cast<T*>(dst + gw_off<ROWS>(r, c)) =
          r0 + r < rlim && c0 + c < clim ? src[(r0 + r) * ld + c0 + c]
                                         : gw_0<T>();
    }
  }
}

// The descriptor of a K-major operand at shared address addr (rows of 64
// columns) and a k16 step in descriptor units (16 bytes): layout type 1
// (128-byte swizzle) in bits 62-63; the leading offset is not read
constexpr int GW_KSTEP_K = 2;
__device__ __forceinline__ uint64_t gw_desc_k(uint32_t addr) {
  return fw_desc(addr, 16, 1024) | (1ull << 62);
}

// The descriptor of an MN-major operand (read transposed) at shared
// address addr in a staged tile of ROWS rows; a k16 step in descriptor
// units; the next 64 of M or N is ROWS * 128 bytes on
constexpr int GW_KSTEP_MN = 128;
template <int ROWS>
__device__ __forceinline__ uint64_t gw_desc_mn(uint32_t addr) {
  return fw_desc(addr, ROWS * 128, 1024) | (1ull << 62);
}

// dst rounded up to a 1024-byte boundary of shared memory (the swizzle
// layout's tiles start on one; the kernels ask for 1 KB more)
__device__ __forceinline__ unsigned char* gw_align1024(unsigned char* p) {
  return p + ((1024 - (fw_smem(p) & 1023)) & 1023);
}

// Eight f32 values rounded to T (round to nearest even) into
// dst[0 .. 8): one 16-byte store where VEC (dst 16-byte aligned and all
// eight inside the row), else the first `valid` of them one by one.
template <bool VEC, class T>
__device__ __forceinline__ void gw_put8(T* dst, const float (&v)[8],
                                        int valid) {
  if (VEC) {
    uint4 w;
    w.x = gw_pack(dst, v[0], v[1]);
    w.y = gw_pack(dst, v[2], v[3]);
    w.z = gw_pack(dst, v[4], v[5]);
    w.w = gw_pack(dst, v[6], v[7]);
    *reinterpret_cast<uint4*>(dst) = w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid) gw_round(dst + e, v[e]);
  }
}

// d (64 x 128) = (scale_d ? d : 0) + a (64 x 16) b (16 x 128), both read
// from shared memory by their descriptors
#define GW_MMA_N128(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <class T, int TA, int TB>
__device__ __forceinline__ void gw_mma_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, gw_f16>::value)
    GW_MMA_N128("f16");
  else
    GW_MMA_N128("bf16");
}
#undef GW_MMA_N128

// d (64 x 144) = (scale_d ? d : 0) + a (64 x 16) b (16 x 144), both read
// from shared memory by their descriptors
#define GW_MMA_N144(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n144k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
      "%64, %65, %66, %67, %68, %69, %70, %71"                                \
      "}, %72, %73, p, 1, 1, %75, %76;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                   \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                   \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <class T, int TA, int TB>
__device__ __forceinline__ void gw_mma_n144(float (&d)[72], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, gw_f16>::value)
    GW_MMA_N144("f16");
  else
    GW_MMA_N144("bf16");
}
#undef GW_MMA_N144

// d (64 x 256) = (scale_d ? d : 0) + a (64 x 16) b (16 x 256), both read
// from shared memory by their descriptors
#define GW_MMA_N256(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
      "%120, %121, %122, %123, %124, %125, %126, %127"                        \
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                   \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                   \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                   \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                   \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                   \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                   \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                   \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                   \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                   \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                   \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <class T, int TA, int TB>
__device__ __forceinline__ void gw_mma_n256(float (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, gw_f16>::value)
    GW_MMA_N256("f16");
  else
    GW_MMA_N256("bf16");
}
#undef GW_MMA_N256

// d (64 x N) = (scale_d ? d : 0) + a b for N = 128, 144 or 256, a and b
// of T (bf16 or f16); TA / TB: a / b staged MN-major (read through the
// transpose bits)
template <int N, int TA, int TB, class T>
__device__ __forceinline__ void gw_mma(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 128 || N == 144 || N == 256,
                "no wrapper for this N");
  static_assert(std::is_same<T, gw_bf16>::value ||
                    std::is_same<T, gw_f16>::value,
                "a bf16 or f16 product");
  if constexpr (N == 128)
    gw_mma_n128<T, TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 144)
    gw_mma_n144<T, TA, TB>(d, da, db, scale_d);
  else
    gw_mma_n256<T, TA, TB>(d, da, db, scale_d);
}
