// Transpose-free f32 GEMM for the fullc backward's input gradient, for
// Hopper (sm_90a).  Replaces the Pallas `_matmul_nt_kernel` /
// `_matmul_nt_impl` of cxxnet_tpu/ops/pallas_kernels.py:433,480 (the
// `da = g @ b^T` half of `_matmul_vjp_bwd` :419).
//
// What it computes: c (m, k) = g (m, n) @ b (k, n)^T, all row-major f32:
// g is the upstream gradient of the fullc output, b the weight in its
// stored (nin, nhidden) layout, c the gradient of the fullc input.  The
// contraction runs over n, the trailing (contiguous) axis of BOTH
// operands, so neither is transposed in device memory.  Full f32 FMA: no
// TF32.
//
// What bounds it on an H100: the operations.  At batch 256 fc6's input
// gradient (256 x 4096 -> 9216) does 19.3 GFLOP on 0.16 GB, 0.29 ms at
// the 67 TFLOP/s f32 peak; fc7 8.6 GFLOP, fc8 (contraction 1000) 2.1.
//
// Design (the tile core of sgemm_pipe.cuh, as fullc_gemm.cu's forward):
//   * a block of 128 threads owns a 128 x 64 tile of c; each thread
//     accumulates 8 rows x 8 columns (tx + 8 j) in registers;
//   * both operands are contraction-major, so both are staged the same
//     way, 16-deep slices of n as As[row][kk] and Bs[col][kk] rows, by
//     cp.async in a three-stage ring, and both are read back as float4
//     along the contraction.  Where n % 4 == 0 and the bases are 16-byte
//     aligned a thread copies 16 bytes at a time, otherwise 4; the edges
//     (fc8's n = 1000, ragged m and k) are zero-filled by the copy;
//   * deterministic split-K: fc7 and fc8 have only 2 x 64 = 128 output
//     tiles for 132 SMs, so the contraction is cut into `splits` equal
//     ranges of slices (sp_splits), one block per (tile, range), each
//     range's partial tile in its own slice of a workspace the wrapper
//     allocates, summed by sp_splitk_sum in a fixed order.  No atomics:
//     two launches on the same inputs give bitwise-equal outputs.
//
// The bf16 build (fullc_gemm_nt_bf16, use_pallas=1 training under
// compute_type=bfloat16): g, b and c bf16, as the Pallas kernel's bf16
// operands and output, on the tensor cores (gemm_bf16.cuh: mma.sync
// m16n8k16, f32 accumulators, one rounding to bf16).  What bounds it: fc6
// at batch 256 does 19.3 GFLOP on 81 MB, 0.020 ms at the dense bf16 rate
// of 989 TFLOP/s, 0.024 ms of bytes at 3.35 TB/s: the bytes, by a little.
// Both operands are contraction-major, staged as they lie (rows of 32
// bf16 of n, padded to 40) and read by plain ldmatrix; a 128 x 64 tile a
// block of four warps, and the same deterministic split-K as the f32
// build, its ranges' f32 partial tiles summed in a fixed order and
// rounded once to bf16 by sp_splitk_sum.

#include "gemm_bf16.cuh"
#include "sgemm_pipe.cuh"

constexpr int NT_BN = 64, NT_THREADS = 128;
constexpr int NT_STAGE_FLOATS = SP_AFLOATS + NT_BN * SP_LDA;

// Stage slice [n0, n0 + SP_BK) of the block's g rows and b rows, zero
// past m, k and nend.
template <bool VEC>
__device__ __forceinline__ void nt_stage(float* As, float* Bs,
                                         const float* __restrict__ g,
                                         const float* __restrict__ b, int m,
                                         int n, int k, int m0, int k0, int n0,
                                         int nend) {
  const int t = threadIdx.x;
  constexpr int W = VEC ? 4 : 1;              // floats a copy
  for (int c = 0; c < SP_BM * SP_BK / W / NT_THREADS; ++c) {
    const int i = t + c * NT_THREADS;
    const int r = i / (SP_BK / W), kc = (i % (SP_BK / W)) * W;
    const bool ok = m0 + r < m && n0 + kc < nend;
    sp_cp(As + r * SP_LDA + kc,
          ok ? g + (long long)(m0 + r) * n + n0 + kc : g, ok, 4 * W);
  }
  for (int c = 0; c < NT_BN * SP_BK / W / NT_THREADS; ++c) {
    const int i = t + c * NT_THREADS;
    const int r = i / (SP_BK / W), kc = (i % (SP_BK / W)) * W;
    const bool ok = k0 + r < k && n0 + kc < nend;
    sp_cp(Bs + r * SP_LDA + kc,
          ok ? b + (long long)(k0 + r) * n + n0 + kc : b, ok, 4 * W);
  }
}

// One (output tile, n range) block: grid (k tiles, m tiles, splits).
// Range z covers slices [z * per, (z + 1) * per); its tile goes to c
// (one range) or to out + z * m * k.
template <bool VEC>
__global__ void __launch_bounds__(NT_THREADS, 3)
fullc_gemm_nt_kernel(const float* __restrict__ g, const float* __restrict__ b,
                     float* __restrict__ out, int m, int n, int k, int per) {
  __shared__ __align__(16) float smem[SP_STAGES * NT_STAGE_FLOATS];
  const int k0 = blockIdx.x * NT_BN, m0 = blockIdx.y * SP_BM;
  const int nbeg = blockIdx.z * per * SP_BK;
  const int nend = min(n, nbeg + per * SP_BK);
  const int nk = nend > nbeg ? (nend - nbeg + SP_BK - 1) / SP_BK : 0;
  float* c = out + (long long)blockIdx.z * m * k;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  float acc[8][8];
  sp_zero(acc);
  sp_mainloop(
      smem, NT_STAGE_FLOATS, nk,
      [&](float* st, int s) {
        nt_stage<VEC>(st, st + SP_AFLOATS, g, b, m, n, k, m0, k0,
                      nbeg + s * SP_BK, nend);
      },
      [&](const float* st) { sp_mma_nk(st, st + SP_AFLOATS, ty, tx, acc); });

  // a warp's store of (i, j) covers 8 consecutive columns of 4 rows: four
  // whole 32-byte sectors
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) continue;
    float* crow = c + (long long)row * k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + tx + 8 * j;
      if (col < k) crow[col] = acc[i][j];
    }
  }
}

// The number of split-K ranges for g (m, n) @ b (k, n)^T on the current
// device (sp_splits); the wrapper sizes the workspace (splits, m, k) from
// it.
extern "C" int fullc_gemm_nt_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  return sp_splits((const void*)fullc_gemm_nt_kernel<true>, NT_THREADS,
                   (long long)sp_ceil(m, SP_BM) * sp_ceil(k, NT_BN),
                   sp_ceil(n, SP_BK));
}

// c = g @ b^T.  `splits` from fullc_gemm_nt_splits; with splits > 1, `ws`
// is a (splits, m, k) f32 scratch buffer (unused, may be null,
// otherwise).
extern "C" int fullc_gemm_nt_f32(const void* g, const void* b, void* c,
                                 void* ws, int m, int n, int k, int splits,
                                 void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slices = sp_ceil(n > 0 ? n : 1, SP_BK);
  const int per = sp_ceil(slices, splits);
  splits = sp_ceil(slices, per);       // no empty range
  const bool vec = n % 4 == 0 && (((uintptr_t)g | (uintptr_t)b) % 16) == 0;
  float* out = splits > 1 ? (float*)ws : (float*)c;
  const dim3 grid(sp_ceil(k, NT_BN), sp_ceil(m, SP_BM), splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    fullc_gemm_nt_kernel<true><<<grid, NT_THREADS, 0, st>>>(
        (const float*)g, (const float*)b, out, m, n, k, per);
  else
    fullc_gemm_nt_kernel<false><<<grid, NT_THREADS, 0, st>>>(
        (const float*)g, (const float*)b, out, m, n, k, per);
  return (int)sp_finish((const float*)ws, (float*)c, (long long)m * k,
                        splits, st);
}

// --- the bf16 build -----------------------------------------------------------

constexpr int NB_BK = 32;                  // n a staged slice
constexpr int NB_LDS = NB_BK + 8;          // staged row: 80 bytes
constexpr int NB_STAGE = (GM_BM + GM_BN) * NB_LDS;   // bf16 a stage
constexpr int NB_STAGE_FLOATS = NB_STAGE / 2;

// Stage slice [n0, n0 + NB_BK) of the block's g rows and b rows, zero past
// m, k and nend.  VEC: n a multiple of 8 and g, b 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void nb_stage(gm_bf16* As, gm_bf16* Bs,
                                         const gm_bf16* __restrict__ g,
                                         const gm_bf16* __restrict__ b,
                                         int m, int n, int k, int m0, int k0,
                                         int n0, int nend) {
  const int t = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < GM_BM * NB_BK / 8 / GM_THREADS; ++c) {
      const int i = t + c * GM_THREADS;
      const int r = i / (NB_BK / 8), kc = (i % (NB_BK / 8)) * 8;
      const bool ok = m0 + r < m && n0 + kc < nend;
      gm_cp16(As + r * NB_LDS + kc,
              ok ? g + (long long)(m0 + r) * n + n0 + kc : g, ok);
    }
#pragma unroll
    for (int c = 0; c < GM_BN * NB_BK / 8 / GM_THREADS; ++c) {
      const int i = t + c * GM_THREADS;
      const int r = i / (NB_BK / 8), kc = (i % (NB_BK / 8)) * 8;
      const bool ok = k0 + r < k && n0 + kc < nend;
      gm_cp16(Bs + r * NB_LDS + kc,
              ok ? b + (long long)(k0 + r) * n + n0 + kc : b, ok);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < GM_BM * NB_BK / GM_THREADS; ++c) {
      const int i = t + c * GM_THREADS;
      const int r = i / NB_BK, kc = i % NB_BK;
      As[r * NB_LDS + kc] = m0 + r < m && n0 + kc < nend
                                ? g[(long long)(m0 + r) * n + n0 + kc]
                                : (gm_bf16)0;
    }
#pragma unroll 4
    for (int c = 0; c < GM_BN * NB_BK / GM_THREADS; ++c) {
      const int i = t + c * GM_THREADS;
      const int r = i / NB_BK, kc = i % NB_BK;
      Bs[r * NB_LDS + kc] = k0 + r < k && n0 + kc < nend
                                ? b[(long long)(k0 + r) * n + n0 + kc]
                                : (gm_bf16)0;
    }
  }
}

// acc += the slice's products for the warp's piece at rows wr, cols wc:
// A fragments As[row][kk] and B fragments Bs[col][kk], both plain ldmatrix
__device__ __forceinline__ void nb_slice(const gm_bf16* As, const gm_bf16* Bs,
                                         int wr, int wc, int lane,
                                         float (&acc)[GM_MT][GM_NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NB_BK; kk += 16) {
    uint32_t a[GM_MT][4], b[GM_NT][2];
#pragma unroll
    for (int i = 0; i < GM_MT; ++i)
      gm_ldsm(a[i], As + (wr + 16 * i + (lane & 15)) * NB_LDS + kk +
                        (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < GM_NT / 2; ++jp) {
      uint32_t r[4];
      gm_ldsm(r, Bs + (wc + 16 * jp + (lane >> 4) * 8 + (lane & 7)) * NB_LDS
                     + kk + ((lane >> 3) & 1) * 8);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < GM_MT; ++i)
#pragma unroll
      for (int j = 0; j < GM_NT; ++j) gm_mma(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// One (output tile, n range) block: grid (k tiles, m tiles, splits); OUT
// float: range z's partial tile into out + z * m * k; OUT bf16: the tile,
// rounded, into c (one range)
template <bool VEC, class OUT>
__global__ void __launch_bounds__(GM_THREADS, 3)
fullc_gemm_nt_bf16_kernel(const gm_bf16* __restrict__ g,
                          const gm_bf16* __restrict__ b,
                          OUT* __restrict__ out, int m, int n, int k, int per,
                          bool pair) {
  __shared__ __align__(16) float smem[SP_STAGES * NB_STAGE_FLOATS];
  const int k0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
  const int nbeg = blockIdx.z * per * NB_BK;
  const int nend = min(n, nbeg + per * NB_BK);
  const int nk = nend > nbeg ? (nend - nbeg + NB_BK - 1) / NB_BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp / 2) * 16 * GM_MT, wc = (warp % 2) * 8 * GM_NT;

  float acc[GM_MT][GM_NT][4];
  gm_zero(acc);
  sp_mainloop(
      smem, NB_STAGE_FLOATS, nk,
      [&](float* st, int s) {
        gm_bf16* As = reinterpret_cast<gm_bf16*>(st);
        nb_stage<VEC>(As, As + GM_BM * NB_LDS, g, b, m, n, k, m0, k0,
                      nbeg + s * NB_BK, nend);
      },
      [&](const float* st) {
        const gm_bf16* As = reinterpret_cast<const gm_bf16*>(st);
        nb_slice(As, As + GM_BM * NB_LDS, wr, wc, lane, acc);
      });
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives
  gm_store(acc, out + (long long)blockIdx.z * m * k, m, k, m0 + wr, k0 + wc,
           pair);
}

extern "C" int fullc_gemm_nt_bf16_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  return sp_splits((const void*)fullc_gemm_nt_bf16_kernel<true, float>,
                   GM_THREADS, (long long)sp_ceil(m, GM_BM) * sp_ceil(k, GM_BN),
                   sp_ceil(n, NB_BK));
}

template <bool VEC>
static void nb_launch(dim3 grid, cudaStream_t st, const gm_bf16* g,
                      const gm_bf16* b, void* out, bool partial, int m, int n,
                      int k, int per, bool pair) {
  if (partial)
    fullc_gemm_nt_bf16_kernel<VEC, float><<<grid, GM_THREADS, 0, st>>>(
        g, b, (float*)out, m, n, k, per, pair);
  else
    fullc_gemm_nt_bf16_kernel<VEC, gm_bf16><<<grid, GM_THREADS, 0, st>>>(
        g, b, (gm_bf16*)out, m, n, k, per, pair);
}

// c = g @ b^T in bf16, f32 sums, one rounding.  `splits` from
// fullc_gemm_nt_bf16_splits; with splits > 1, `ws` is a (splits, m, k) f32
// scratch buffer.
extern "C" int fullc_gemm_nt_bf16(const void* g, const void* b, void* c,
                                  void* ws, int m, int n, int k, int splits,
                                  void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slices = sp_ceil(n > 0 ? n : 1, NB_BK);
  const int per = sp_ceil(slices, splits);
  splits = sp_ceil(slices, per);       // no empty range
  const bool vec = n % 8 == 0 && (((uintptr_t)g | (uintptr_t)b) % 16) == 0;
  const bool partial = splits > 1;
  void* out = partial ? ws : c;
  const bool pair = k % 2 == 0 && ((uintptr_t)out % 8) == 0;
  const dim3 grid(sp_ceil(k, GM_BN), sp_ceil(m, GM_BM), splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    nb_launch<true>(grid, st, (const gm_bf16*)g, (const gm_bf16*)b, out,
                    partial, m, n, k, per, pair);
  else
    nb_launch<false>(grid, st, (const gm_bf16*)g, (const gm_bf16*)b, out,
                     partial, m, n, k, per, pair);
  return (int)sp_finish((const float*)ws, (gm_bf16*)c, (long long)m * k,
                        splits, st);
}
