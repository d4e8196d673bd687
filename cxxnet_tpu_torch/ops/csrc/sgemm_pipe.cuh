// Register-blocked, cp.async-pipelined f32 tile core of the port's
// GEMM-shaped kernels for Hopper (sm_90a): fullc_gemm.cu (the fullc
// forward), fullc_gemm_nt.cu (its input gradient) and conv_bias_act.cu
// (the fused convolution's implicit GEMM), full f32 FMA, no TF32; its
// three-stage ring (sp_mainloop, sp_cp) also stages fullc_gemm_tn.cu
// (the weight gradient, on the TF32 tensor cores: flash_tf32.cuh) and the
// 16-bit (bf16 and f16) builds on gemm_bf16.cuh's tensor-core tile, whose
// f32 split-K partials sp_splitk_sum rounds once to the 16-bit type.
//
// A block owns a 128-row output tile, BN (64 or 96) columns wide, with
// 2 * BN threads: thread (ty, tx) = (t / (BN / 8), t % (BN / 8))
// accumulates the 8 x 8 outputs at rows ty * 8 .. ty * 8 + 7 and eight
// columns in registers, so every 128-bit shared load feeds 16 FMAs.  The
// contraction runs in 16-deep slices staged by cp.async into a
// three-stage ring (sp_mainloop): two slices' copies are in flight while
// one is multiplied.  Copies of 16 or 4 bytes are zero-filled past the
// operands' edges by the copy itself (src-size 0), so no load reaches
// past an operand.
//
// Staged layouts (floats):
//   * the left operand As[row][kk], contraction-major, 20 floats a row
//     (16-byte aligned): a quarter-warp (eight threads, one ty) reads one
//     address, a broadcast;
//   * the right operand either Bs[kk][col], BN floats a row (sp_mma_kn:
//     the thread's columns tx * 4 .. + 3 and BN / 2 + tx * 4 .. + 3, one
//     float4 each), or Bs[col][kk], 20 floats a row (sp_mma_nk: the
//     thread's columns tx + 8 j, so the eight rows a quarter-warp reads
//     start on eight different bank quads).
// Every output's sum runs over the contraction in ascending order, one
// fmaf at a time, so a launch is bitwise repeatable.
//
// What bounds the tile (the ablations of tools/sgemm_variants.py): a
// 128-bit shared load is served a quarter-warp at a time, so each
// thread's 16 float4 loads per 256 FMAs (four k steps) ask as many bytes
// of the SM's shared memory per clock (128) as its FMA pipes do FMAs:
// with the FMAs alone the tile stops near 70 % of the f32 peak, and the
// copies' shared-memory writes come on top.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SP_BM = 128, SP_BK = 16, SP_STAGES = 3;
constexpr int SP_LDA = SP_BK + 4;            // staged row: 80 bytes
constexpr int SP_AFLOATS = SP_BM * SP_LDA;
constexpr int SP_MIN_SLICES = 16;            // k-slices per split-K range

// One cp.async of 16 or 4 bytes; ok == false copies nothing and zero-fills
// the destination (src must still be a valid address).
__device__ __forceinline__ void sp_cp(float* dst, const float* src, bool ok,
                                      int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
}

// The three-stage ring over nk slices: stage(buf, s) issues slice s's
// copies into stage buffer buf; mma(buf) multiplies the slice there.
template <class Stage, class Mma>
__device__ __forceinline__ void sp_mainloop(float* smem, int stage_floats,
                                            int nk, Stage stage, Mma mma) {
#pragma unroll
  for (int s = 0; s < SP_STAGES - 1; ++s) {
    if (s < nk) stage(smem + s * stage_floats, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SP_STAGES - 2)
                 : "memory");
    __syncthreads();     // slice kt landed; slice kt - 1's readers are done
    if (kt + SP_STAGES - 1 < nk)
      stage(smem + ((kt + SP_STAGES - 1) % SP_STAGES) * stage_floats,
            kt + SP_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    mma(smem + (kt % SP_STAGES) * stage_floats);
  }
}

// f32 -> bf16 bits, round to nearest even (torch's and JAX's astype)
__device__ __forceinline__ unsigned short sp_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// acc += As (rows ty * 8 + i) x Bs[kk][col] over one slice.
template <int BN>
__device__ __forceinline__ void sp_mma_kn(const float* As, const float* Bs,
                                          int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < SP_BK; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(As + (ty * 8 + i) * SP_LDA +
                                               kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 = *reinterpret_cast<const float4*>(
          Bs + (kk + q) * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          Bs + (kk + q) * BN + BN / 2 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                      : q == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

// acc += As (rows ty * 8 + i) x Bs[col][kk] (columns tx + 8 j) over one
// slice: both operands contraction-major, read as float4 along it.
__device__ __forceinline__ void sp_mma_nk(const float* As, const float* Bs,
                                          int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < SP_BK; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(As + (ty * 8 + i) * SP_LDA +
                                               kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + (tx + 8 * j) * SP_LDA + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(av[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, b.w, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void sp_zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// an f32 value stored as OUT: itself, its bf16 bits or its f16 value
// (one rounding, to nearest even)
__device__ __forceinline__ void sp_put(float* c, float v) { *c = v; }
__device__ __forceinline__ void sp_put(unsigned short* c, float v) {
  *c = sp_to_bf16(v);
}
__device__ __forceinline__ void sp_put(__half* c, float v) {
  *c = __float2half_rn(v);
}

// c[i] = sum over z = 0 .. splits - 1, in that order, of ws[z * mn + i]:
// f32, or rounded once to bf16 or f16 (the 16-bit GEMMs' outputs)
template <class OUT>
__global__ void sp_splitk_sum(const float* __restrict__ ws,
                              OUT* __restrict__ c, long long mn,
                              int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    sp_put(c + i, s);
  }
}

static inline int sp_ceil(long long x, long long y) {
  return (int)((x + y - 1) / y);
}

// The number of split-K ranges for `tiles` output tiles over `slices`
// k-slices of `kernel` (launched with `threads` and `smem` bytes of
// dynamic shared memory), each range at least SP_MIN_SLICES slices:
//   * fewer tiles than half the card's resident blocks (fc7, fc8): enough
//     (tile, range) blocks to occupy every resident slot once;
//   * more (fc6's input gradient: 288 tiles for 396 slots, so some SMs
//     run three blocks and others two): the fewest ranges, at most
//     SP_MAX_BALANCE, that minimize the waves of resident blocks per
//     range, ceil(tiles * s / slots) / s, so the SMs' shares even out.
constexpr int SP_MAX_BALANCE = 4;
static inline int sp_splits(const void* kernel, int threads, long long tiles,
                            int slices, size_t smem = 0) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // above 48 KB a kernel runs, and counts as resident, only once opted in
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long room = slots / tiles;
  const int deep = slices / SP_MIN_SLICES;
  if (room >= 2) {
    const int splits = (int)(room < deep ? room : deep);
    return splits < 1 ? 1 : splits;
  }
  int best = 1;
  long long best_waves = (tiles + slots - 1) / slots;   // of `best` ranges
  for (int s = 2; s <= deep && s <= SP_MAX_BALANCE; ++s) {
    const long long waves = (tiles * s + slots - 1) / slots;
    if (waves * best < best_waves * s) {   // waves / s < best_waves / best
      best = s;
      best_waves = waves;
    }
  }
  return best;
}

// After a split-K product into ws (splits, mn): the fixed-order sum into
// c (f32, bf16 where OUT is unsigned short, f16 where it is __half);
// nothing for one range
// (the tiles went to c directly).
template <class OUT = float>
static inline cudaError_t sp_finish(const float* ws, OUT* c, long long mn,
                                    int splits, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int blocks = sp_ceil(mn, 256) < 4096 ? sp_ceil(mn, 256) : 4096;
  sp_splitk_sum<OUT><<<blocks, 256, 0, st>>>(ws, c, mn, splits);
  return cudaGetLastError();
}
