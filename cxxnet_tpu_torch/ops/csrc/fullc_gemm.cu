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
// Design (the tile core is sgemm_pipe.cuh's, shared with fullc_gemm_nt.cu
// and conv_bias_act.cu):
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
//     busy, each at least SP_MIN_SLICES deep), one block per (tile,
//     range).  Each range writes its partial tile into its own slice of a
//     workspace the wrapper allocates; a second kernel sums the slices in
//     a fixed order (range 0, 1, ...).  No atomics: two launches on the
//     same inputs give bitwise-equal outputs.  With one range the tile is
//     written to c directly.
//
// The bf16 build (fullc_gemm_bf16, compute_type=bfloat16) is its own
// source, fullc_gemm_bf16.cu, on the bf16 tensor cores.

#include "sgemm_pipe.cuh"

constexpr int FG_BN = 64, FG_THREADS = 128;
constexpr int FG_STAGE_FLOATS = SP_AFLOATS + SP_BK * FG_BN;

// Stage k-slice [k0, k0 + SP_BK) of the block's a rows and b columns,
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
    for (int c = 0; c < SP_BM * SP_BK / 4 / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / (SP_BK / 4), kc = (i % (SP_BK / 4)) * 4;
      const bool ok = m0 + r < m && k0 + kc < kend;
      sp_cp(As + r * SP_LDA + kc,
            ok ? a + (long long)(m0 + r) * k + k0 + kc : a, ok, 16);
    }
#pragma unroll
    for (int c = 0; c < SP_BK * FG_BN / 4 / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / (FG_BN / 4), nc = (i % (FG_BN / 4)) * 4;
      const bool ok = k0 + r < kend && n0 + nc < n;
      sp_cp(Bs + r * FG_BN + nc,
            ok ? b + (long long)(k0 + r) * n + n0 + nc : b, ok, 16);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < SP_BM * SP_BK / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / SP_BK, kc = i % SP_BK;
      const bool ok = m0 + r < m && k0 + kc < kend;
      sp_cp(As + r * SP_LDA + kc,
            ok ? a + (long long)(m0 + r) * k + k0 + kc : a, ok, 4);
    }
#pragma unroll 4
    for (int c = 0; c < SP_BK * FG_BN / FG_THREADS; ++c) {
      const int i = t + c * FG_THREADS;
      const int r = i / FG_BN, nc = i % FG_BN;
      const bool ok = k0 + r < kend && n0 + nc < n;
      sp_cp(Bs + r * FG_BN + nc,
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
  __shared__ __align__(16) float smem[SP_STAGES * FG_STAGE_FLOATS];
  const int n0 = blockIdx.x * FG_BN, m0 = blockIdx.y * SP_BM;
  const int kbeg = blockIdx.z * per * SP_BK;
  const int kend = min(k, kbeg + per * SP_BK);
  const int nk = kend > kbeg ? (kend - kbeg + SP_BK - 1) / SP_BK : 0;
  float* c = out + (long long)blockIdx.z * m * n;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  float acc[8][8];
  sp_zero(acc);
  sp_mainloop(
      smem, FG_STAGE_FLOATS, nk,
      [&](float* st, int s) {
        fg_stage<VEC>(st, st + SP_AFLOATS, a, b, m, n, k, m0, n0,
                      kbeg + s * SP_BK, kend);
      },
      [&](const float* st) {
        sp_mma_kn<FG_BN>(st, st + SP_AFLOATS, ty, tx, acc);
      });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) continue;
    float* crow = c + (long long)row * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 32 * h + tx * 4;
      const float* v = &acc[i][4 * h];
      if (VEC && col < n) {    // n a multiple of 4: all or none
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) crow[col + j] = v[j];
      }
    }
  }
}

// The number of split-K ranges for an (m, n, k) product on the current
// device (sp_splits); the wrapper sizes the workspace (splits, m, n) from
// it.
extern "C" int fullc_gemm_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  return sp_splits((const void*)fullc_gemm_kernel<true>, FG_THREADS,
                   (long long)sp_ceil(m, SP_BM) * sp_ceil(n, FG_BN),
                   sp_ceil(k, SP_BK));
}

template <bool VEC>
static cudaError_t fg_launch(const float* a, const float* b, float* c,
                             float* ws, int m, int n, int k, int per,
                             int splits, cudaStream_t st) {
  const dim3 grid(sp_ceil(n, FG_BN), sp_ceil(m, SP_BM), splits);
  fullc_gemm_kernel<VEC><<<grid, FG_THREADS, 0, st>>>(
      a, b, splits > 1 ? ws : c, m, n, k, per);
  return sp_finish(ws, c, (long long)m * n, splits, st);
}

// c = a @ b.  `splits` from fullc_gemm_splits; with splits > 1, `ws` is a
// (splits, m, n) f32 scratch buffer (unused, may be null, otherwise).
extern "C" int fullc_gemm_f32(const void* a, const void* b, void* c, void* ws,
                              int m, int n, int k, int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slices = sp_ceil(k > 0 ? k : 1, SP_BK);
  const int per = sp_ceil(slices, splits);
  splits = sp_ceil(slices, per);       // no empty range
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                     (uintptr_t)ws) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *af = (const float*)a, *bf = (const float*)b;
  float *cf = (float*)c, *wf = (float*)ws;
  return (int)(vec ? fg_launch<true>(af, bf, cf, wf, m, n, k, per, splits, st)
                   : fg_launch<false>(af, bf, cf, wf, m, n, k, per, splits,
                                      st));
}
