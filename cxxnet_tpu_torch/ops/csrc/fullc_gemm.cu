// Tiled f32 GEMM for the fullc forward, for Hopper (sm_90a).  Replaces
// the Pallas `_matmul_kernel` / `_matmul_impl` of
// cxxnet_tpu/ops/pallas_kernels.py:383,532 (and its whole-K variant
// `_matmul_kernel_wholek` :376, the same function).
//
// What it computes: c (m, n) = a (m, k) @ b (k, n), all row-major f32,
// with b the fullc weight in its stored (nin, nhidden) layout — no
// transpose anywhere.  Full f32 FMA: no TF32.
//
// What bounds it on an H100: the operations.  fc8 at batch 256 (256 x
// 4096 x 1000) does 2.1 GFLOP on 21 MB: 31 us at the 67 TFLOP/s f32 peak
// against 6 us of bytes; fc6 (9216 -> 4096) and fc7 (4096 -> 4096) of a
// use_pallas=1 step 19.3 and 8.6 GFLOP.
//
// Design:
//   * a block of 128 threads owns a 128 x 64 output tile; each thread
//     accumulates an 8 x 8 sub-tile in registers (rows ty*8 .. ty*8+7,
//     columns tx*4 .. +3 and 32 + tx*4 .. +3), so every 128-bit shared
//     load feeds 16 FMAs (the earlier 4 x 4 tile fed 2 per scalar load);
//   * 16-deep k-slices of a (As[m][k], rows padded to 20 floats) and b
//     (Bs[k][n]) are staged by cp.async in a three-stage ring, so two
//     slices' copies are in flight while one is multiplied.  Rows whose
//     starts are 16-byte aligned (k and n multiples of 4, aligned bases)
//     copy 16 bytes a thread; ragged or unaligned shapes (n = 129, 5)
//     copy 4 bytes a thread.  Edges are zero-filled by the copy itself;
//   * deterministic split-K to fill the card: fc8 has only 2 x 16 = 32
//     output tiles for 132 SMs, so the contraction is cut into `splits`
//     equal ranges of k-slices (as many as keep every SM's resident blocks
//     busy, each at least FG_MIN_SLICES deep), one block per (tile,
//     range).  Each range writes its partial tile into its own slice of a
//     workspace the wrapper allocates; a second kernel sums the slices in
//     a fixed order (range 0, 1, ...).  No atomics: two launches on the
//     same inputs give bitwise-equal outputs.  With one range the tile is
//     written to c directly.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int FG_BM = 128, FG_BN = 64, FG_BK = 16;
constexpr int FG_THREADS = 128, FG_STAGES = 3;
constexpr int FG_LDA = FG_BK + 4;        // As row: 80 bytes, 16-aligned
constexpr int FG_MIN_SLICES = 16;        // k-slices per split-K range
constexpr int FG_STAGE_FLOATS = FG_BM * FG_LDA + FG_BK * FG_BN;

__device__ __forceinline__ void fg_cp(float* dst, const float* src, bool ok,
                                      int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
}

// Stage k-slice [k0, k0 + FG_BK) of the block's a rows and b columns,
// zero past m, n and kend.
template <bool VEC>
__device__ __forceinline__ void fg_stage(float* As, float* Bs,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int m,
                                         int n, int k, int m0, int n0, int k0,
                                         int kend) {
  const int t = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < FG_BM * FG_BK / 4 / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / (FG_BK / 4), kc = (i % (FG_BK / 4)) * 4;
      const bool ok = m0 + r < m && k0 + kc < kend;
      fg_cp(As + r * FG_LDA + kc,
            ok ? a + (long long)(m0 + r) * k + k0 + kc : a, ok, 16);
    }
#pragma unroll
    for (int c = 0; c < FG_BK * FG_BN / 4 / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / (FG_BN / 4), nc = (i % (FG_BN / 4)) * 4;
      const bool ok = k0 + r < kend && n0 + nc < n;
      fg_cp(Bs + r * FG_BN + nc,
            ok ? b + (long long)(k0 + r) * n + n0 + nc : b, ok, 16);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < FG_BM * FG_BK / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / FG_BK, kc = i % FG_BK;
      const bool ok = m0 + r < m && k0 + kc < kend;
      fg_cp(As + r * FG_LDA + kc,
            ok ? a + (long long)(m0 + r) * k + k0 + kc : a, ok, 4);
    }
#pragma unroll 4
    for (int c = 0; c < FG_BK * FG_BN / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / FG_BN, nc = i % FG_BN;
      const bool ok = k0 + r < kend && n0 + nc < n;
      fg_cp(Bs + r * FG_BN + nc,
            ok ? b + (long long)(k0 + r) * n + n0 + nc : b, ok, 4);
    }
  }
}

// One (output tile, k range) block: grid (n tiles, m tiles, splits).
// Range z covers k-slices [z * per, (z + 1) * per); its tile goes to c
// (one range) or to out + z * m * n.
template <bool VEC>
__global__ void __launch_bounds__(FG_THREADS, 3)
fullc_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int m, int n, int k, int per) {
  __shared__ __align__(16) float smem[FG_STAGES * FG_STAGE_FLOATS];
  const int n0 = blockIdx.x * FG_BN, m0 = blockIdx.y * FG_BM;
  const int kbeg = blockIdx.z * per * FG_BK;
  const int kend = min(k, kbeg + per * FG_BK);
  const int nk = kend > kbeg ? (kend - kbeg + FG_BK - 1) / FG_BK : 0;
  float* c = out + (long long)blockIdx.z * m * n;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FG_STAGES - 1; ++s) {
    if (s < nk) {
      float* st = smem + s * FG_STAGE_FLOATS;
      fg_stage<VEC>(st, st + FG_BM * FG_LDA, a, b, m, n, k, m0, n0,
                    kbeg + s * FG_BK, kend);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FG_STAGES - 2)
                 : "memory");
    __syncthreads();     // slice kt landed; slice kt - 1's readers are done
    if (kt + FG_STAGES - 1 < nk) {
      float* st = smem + ((kt + FG_STAGES - 1) % FG_STAGES) * FG_STAGE_FLOATS;
      fg_stage<VEC>(st, st + FG_BM * FG_LDA, a, b, m, n, k, m0, n0,
                    kbeg + (kt + FG_STAGES - 1) * FG_BK, kend);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* As = smem + (kt % FG_STAGES) * FG_STAGE_FLOATS;
    const float* Bs = As + FG_BM * FG_LDA;
#pragma unroll
    for (int kk = 0; kk < FG_BK; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            As + (ty * 8 + i) * FG_LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            Bs + (kk + q) * FG_BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            Bs + (kk + q) * FG_BN + 32 + tx * 4);
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) continue;
    float* crow = c + (long long)row * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 32 * h + tx * 4;
      if (VEC && col < n) {            // n % 4 == 0: all four or none
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) crow[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

// c[i] = sum over z = 0 .. splits - 1, in that order, of ws[z * mn + i]
__global__ void fullc_splitk_sum(const float* __restrict__ ws,
                                 float* __restrict__ c, long long mn,
                                 int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    c[i] = s;
  }
}

static int fg_ceil(long long x, long long y) { return (int)((x + y - 1) / y); }

// The number of split-K ranges for an (m, n, k) product on the current
// device: enough (tile, range) blocks to occupy every SM's resident
// blocks, each range at least FG_MIN_SLICES k-slices; 1 for products
// whose tiles already fill the card or whose k is short.  The wrapper
// sizes the workspace (splits, m, n) from it.
extern "C" int fullc_gemm_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fullc_gemm_kernel<true>, FG_THREADS, 0);
  const long long tiles = (long long)fg_ceil(m, FG_BM) * fg_ceil(n, FG_BN);
  const int slices = fg_ceil(k, FG_BK);
  const long long room = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  int splits = (int)(room < slices / FG_MIN_SLICES ? room
                                                    : slices / FG_MIN_SLICES);
  return splits < 1 ? 1 : splits;
}

// c = a @ b.  `splits` from fullc_gemm_splits; with splits > 1, `ws` is
// a (splits, m, n) f32 scratch buffer (unused, may be null, otherwise).
extern "C" int fullc_gemm_f32(const void* a, const void* b, void* c, void* ws,
                              int m, int n, int k, int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slices = fg_ceil(k > 0 ? k : 1, FG_BK);
  const int per = fg_ceil(slices, splits);
  splits = fg_ceil(slices, per);       // no empty range
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                     (uintptr_t)ws) % 16) == 0;
  float* out = splits > 1 ? (float*)ws : (float*)c;
  const dim3 grid(fg_ceil(n, FG_BN), fg_ceil(m, FG_BM), splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    fullc_gemm_kernel<true><<<grid, FG_THREADS, 0, st>>>(
        (const float*)a, (const float*)b, out, m, n, k, per);
  else
    fullc_gemm_kernel<false><<<grid, FG_THREADS, 0, st>>>(
        (const float*)a, (const float*)b, out, m, n, k, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)m * n;
  const int blocks = (int)(fg_ceil(mn, 256) < 4096 ? fg_ceil(mn, 256) : 4096);
  fullc_splitk_sum<<<blocks, 256, 0, st>>>((const float*)ws, (float*)c, mn,
                                           splits);
  return (int)cudaGetLastError();
}
