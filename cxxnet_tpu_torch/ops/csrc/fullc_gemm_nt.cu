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
// The bf16 build (fullc_gemm_nt_bf16, on wgmma) is fullc_gemm_nt_bf16.cu.

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
