// Flash-attention backward, dk and dv, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_dkv_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:699 (launched by `_flash_bhsd_bwd`
// :808, the backward of `flash_attention` :867).
//
// For one (b*h) slice, from the forward's lse and delta = sum(do * out),
// scale applied AFTER the dots as the TPU kernel does:
//   p[r][c]  = exp(q[r] . k[c] * scale - lse[r])      over live (r, c)
//   ds[r][c] = p[r][c] * (do[r] . v[c] - delta[r])
//   dv[c]    = sum_r p[r][c] do[r]
//   dk[c]    = scale * sum_r ds[r][c] q[r]
// Live pairs as in flash_fwd.cu (r < sq, c < sk, causal: r >= c).
//
// Design: one block per (64-row key tile, b*h slice); the transposed
// problem of flash_dq.cu.  The K and V tiles stay in shared memory; the
// block walks the query tiles that see its keys (for causal, from the
// diagonal tile down), staging q, do, lse and delta, computing the
// transposed score and v.do^T tiles in registers (keys on rows), writing
// p^T and ds^T to shared memory and accumulating p^T do and ds^T q into
// two (64, d) register tiles.  Each block owns its rows of dk and dv:
// no atomics, and no (sq, sk) matrix in device memory.
//
// What bounds it on an H100: the operations, 8 d flops per live pair
// (k.q, v.do, p^T do, ds^T q): 275 GFLOP at the slice path's b1 h16
// s8192 d64 causal, 4.10 ms at 67 TFLOP/s f32, against ~0.06 ms of
// bytes.  The design's answer is as the forward's: FMA pipes fed from
// conflict-free shared memory, enough blocks to fill the card.

#include "flash_attn.cuh"

template <typename T, int DPAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Kt = smem;                    // DPAD x FA_LD each
  float* Vt = Kt + DPAD * FA_LD;
  float* Qt = Vt + DPAD * FA_LD;
  float* dOt = Qt + DPAD * FA_LD;
  float* PT = dOt + DPAD * FA_LD;      // FA_TILE x FA_LD, keys on rows
  float* DST = PT + FA_TILE * FA_LD;
  float* lse_s = DST + FA_TILE * FA_LD;   // FA_TILE each
  float* delta_s = lse_s + FA_TILE;
  const int k0 = blockIdx.x * FA_TILE;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * sq * d;
  const T* ob = dout + bh * sq * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  fa_stage<T, DPAD>(Kt, k + bh * sk * d, k0, sk, d, 1.f);
  fa_stage<T, DPAD>(Vt, v + bh * sk * d, k0, sk, d, 1.f);
  float dka[4][DPAD / 16], dva[4][DPAD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) dka[i][c] = dva[i][c] = 0.f;
  // the first query tile that sees key k0 (tiles are aligned)
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += FA_TILE) {
    __syncthreads();
    fa_stage<T, DPAD>(Qt, qb, q0, sq, d, 1.f);
    fa_stage<T, DPAD>(dOt, ob, q0, sq, d, 1.f);
    if (threadIdx.x < FA_TILE) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[bh * sq + row] : 0.f;
      delta_s[threadIdx.x] = row < sq ? delta[bh * sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    fa_qk<DPAD>(Kt, Qt, ty, tx, s);    // s[i][j]: key ty+16i, query tx+16j
    fa_qk<DPAD>(Vt, dOt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float p = fa_live(q0 + r, col, sq, sk, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        PT[(ty + 16 * i) * FA_LD + r] = p;
        DST[(ty + 16 * i) * FA_LD + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    fa_pv<DPAD>(PT, dOt, ty, tx, dva);
    fa_pv<DPAD>(DST, Qt, ty, tx, dka);
  }

  T* kd = dk + bh * sk * d;
  T* vd = dv + bh * sk * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        FaElem<T>::store(kd + (long long)row * d + col, dka[i][c] * scale);
        FaElem<T>::store(vd + (long long)row * d + col, dva[i][c]);
      }
    }
  }
}

template <typename T, int DPAD>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      int causal, float scale, void* stream) {
  const size_t smem = (size_t)(4 * DPAD + 2 * FA_TILE) * FA_LD * sizeof(float)
                      + 2 * FA_TILE * sizeof(float);
  return fa_launch(flash_dkv_kernel<T, DPAD>,
                   dim3((sk + FA_TILE - 1) / FA_TILE, bh), smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                   sq, sk, d, causal, scale);
}

template <typename T>
static int dispatch_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
  return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                            causal, scale, stream);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             void* stream) {
  return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                             causal, scale, stream);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int sq, int sk, int d, int causal, float scale,
                              void* stream) {
  return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     sq, sk, d, causal, scale, stream);
}
