// Flash-attention forward, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_fwd_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:612 (launched by `_flash_fwd_impl`
// :768, the forward of `flash_attention` :867, which
// parallel/sequence.py's Ulysses attention takes as its local attention
// when the dense score matrix would not fit).
//
// For one (b*h) slice, with scale = 1 / sqrt(d) applied to q BEFORE the
// dot, as the TPU kernel does:
//   s[r][c]  = (q[r] * scale) . k[c]          over live (r, c)
//   out[r]   = sum_c exp(s[r][c] - m_r) v[c] / l_r
//   lse[r]   = m_r + log(l_r)                  (f32; the backward's input)
// with m_r, l_r the running max and denominator of row r.  A pair (r, c)
// is live when c < sk and, for causal, r >= c (top-left alignment).
//
// Design: one block per (64-row query tile, b*h slice), tiles issued
// from the last (for causal the heaviest) to the first.  The query tile,
// pre-scaled, stays in shared memory; the block walks the key tiles,
// staging K and V, computing the 64 x 64 score tile in registers (4 x 4
// per thread), updating each row's max and denominator in registers
// (half-warp shuffles), writing the tile's weights to shared memory and
// accumulating P V into a (64, d) register tile.  Key tiles wholly above
// the causal diagonal or past sk are never visited.  The (sq, sk) scores
// never touch device memory: per slice it reads q once and k, v once per
// query tile, and writes out and lse.
//
// What bounds it on an H100: the operations.  4 d flops per live pair
// (two d-deep dots) against 4 d bytes of q, k, v, out per row: at the
// slice path's b1 h16 s8192 d64 causal, 137 GFLOP against ~135 MB, 2.05
// ms at 67 TFLOP/s f32 and 0.04 ms at 3.35 TB/s.  The design keeps the
// products on FMA pipes fed from conflict-free shared memory (two or
// three shared loads per four FMAs) with enough blocks (128 tiles x 16
// slices) to fill 132 SMs; the tensor cores (wgmma, with q and the
// weights in bf16 or tf32) are where a faster version starts.

#include "flash_attn.cuh"

template <typename T, int DPAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                    // DPAD x FA_LD each
  float* Kt = Qt + DPAD * FA_LD;
  float* Vt = Kt + DPAD * FA_LD;
  float* P = Vt + DPAD * FA_LD;        // FA_TILE x FA_LD, row-major
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  fa_stage<T, DPAD>(Qt, qb, q0, sq, d, scale);
  float m[4], l[4], o[4][DPAD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) o[i][c] = 0.f;
  }
  const int kend = causal ? min(sk, q0 + FA_TILE) : sk;
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();                   // the last tile's readers are done
    fa_stage<T, DPAD>(Kt, kb, k0, sk, d, 1.f);
    fa_stage<T, DPAD>(Vt, vb, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4] = {};
    fa_qk<DPAD>(Qt, Kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fa_live(row, k0 + tx + 16 * j, sq, sk, causal))
          s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], fa_row_max(mx));
      // a row with nothing live yet keeps a finite reference point
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_use);
        P[(ty + 16 * i) * FA_LD + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + fa_row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPAD / 16; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    fa_pv<DPAD>(P, Vt, ty, tx, o);
  }

  T* ob = out + bh * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        FaElem<T>::store(ob + (long long)row * d + col, o[i][c] / l_safe);
    }
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int DPAD>
static int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int bh, int sq, int sk, int d, int causal,
                      float scale, void* stream) {
  const size_t smem = (size_t)(3 * DPAD + FA_TILE) * FA_LD * sizeof(float);
  return fa_launch(flash_fwd_kernel<T, DPAD>,
                   dim3((sq + FA_TILE - 1) / FA_TILE, bh), smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (T*)out,
                   (float*)lse, sq, sk, d, causal, scale);
}

template <typename T>
static int dispatch_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int sq, int sk, int d,
                        int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_fwd<T, 32>(q, k, v, out, lse, bh, sq, sk, d, causal,
                             scale, stream);
  if (d <= 64)
    return launch_fwd<T, 64>(q, k, v, out, lse, bh, sq, sk, d, causal,
                             scale, stream);
  return launch_fwd<T, 128>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                            stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int d, int causal, float scale, void* stream) {
  return dispatch_fwd<float>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                             stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int sq, int sk,
                              int d, int causal, float scale, void* stream) {
  return dispatch_fwd<__nv_bfloat16>(q, k, v, out, lse, bh, sq, sk, d,
                                     causal, scale, stream);
}
