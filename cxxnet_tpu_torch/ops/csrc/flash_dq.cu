// Flash-attention backward, dq, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_dq_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:661 (launched by `_flash_bhsd_bwd`
// :808, the backward of `flash_attention` :867).
//
// For one (b*h) slice, from the forward's lse and delta = sum(do * out)
// (computed by the caller, outside any kernel), with scale applied AFTER
// the dots, as the TPU kernel does:
//   p[r][c]  = exp(q[r] . k[c] * scale - lse[r])      over live (r, c)
//   ds[r][c] = p[r][c] * (do[r] . v[c] - delta[r])
//   dq[r]    = scale * sum_c ds[r][c] k[c]
// Live pairs as in flash_fwd.cu (c < sk, causal: r >= c).
//
// Design: the forward's grid, one block per (64-row query tile, b*h
// slice), heaviest causal tiles first.  The query and do tiles stay in
// shared memory; for each key tile the block stages K and V, recomputes
// the score and do.v^T tiles in registers (4 x 4 per thread), forms ds,
// writes it to shared memory and accumulates ds K into a (64, d) register
// tile.  Each block owns its rows of dq outright: no atomics, no second
// pass, and no (sq, sk) matrix in device memory.
//
// What bounds it on an H100: the operations, 6 d flops per live pair
// (q.k, do.v, ds.k): 206 GFLOP at the slice path's b1 h16 s8192 d64
// causal, 3.08 ms at 67 TFLOP/s f32, against ~0.05 ms of bytes.  As the
// forward, the products run on FMA pipes from conflict-free shared
// memory; tensor-core tiles come later.

#include "flash_attn.cuh"

template <typename T, int DPAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq,
                int sk, int d, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                    // DPAD x FA_LD each
  float* dOt = Qt + DPAD * FA_LD;
  float* Kt = dOt + DPAD * FA_LD;
  float* Vt = Kt + DPAD * FA_LD;
  float* DS = Vt + DPAD * FA_LD;       // FA_TILE x FA_LD, row-major
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const long long bh = blockIdx.y;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  fa_stage<T, DPAD>(Qt, q + bh * sq * d, q0, sq, d, 1.f);
  fa_stage<T, DPAD>(dOt, dout + bh * sq * d, q0, sq, d, 1.f);
  float lse_r[4], delta_r[4], acc[4][DPAD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < sq ? lse[bh * sq + row] : 0.f;
    delta_r[i] = row < sq ? delta[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) acc[i][c] = 0.f;
  }
  const int kend = causal ? min(sk, q0 + FA_TILE) : sk;
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();
    fa_stage<T, DPAD>(Kt, kb, k0, sk, d, 1.f);
    fa_stage<T, DPAD>(Vt, vb, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    fa_qk<DPAD>(Qt, Kt, ty, tx, s);
    fa_qk<DPAD>(dOt, Vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fa_live(row, k0 + tx + 16 * j, sq, sk, causal)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        DS[(ty + 16 * i) * FA_LD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    fa_pv<DPAD>(DS, Kt, ty, tx, acc);
  }

  T* db = dq + bh * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        FaElem<T>::store(db + (long long)row * d + col, acc[i][c] * scale);
    }
  }
}

template <typename T, int DPAD>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, int causal,
                     float scale, void* stream) {
  const size_t smem = (size_t)(4 * DPAD + FA_TILE) * FA_LD * sizeof(float);
  return fa_launch(flash_dq_kernel<T, DPAD>,
                   dim3((sq + FA_TILE - 1) / FA_TILE, bh), smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   (const float*)lse, (const float*)delta, (T*)dq, sq, sk, d,
                   causal, scale);
}

template <typename T>
static int dispatch_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int sq, int sk, int d, int causal,
                       float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, stream);
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, stream);
  return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                           causal, scale, stream);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int causal, float scale,
                            void* stream) {
  return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, stream);
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int sq,
                             int sk, int d, int causal, float scale,
                             void* stream) {
  return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, sq,
                                    sk, d, causal, scale, stream);
}
