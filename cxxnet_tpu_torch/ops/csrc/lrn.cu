// Cross-channel LRN forward, f32, bf16 and f16, for Hopper (sm_90a).
// Replaces the Pallas `_lrn_fwd_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:233
// (launched by `_lrn_call` :258 from `_lrn_fwd_impl` :286, behind both
// `lrn_pallas` and `lrn_hybrid`).
//
// What it computes, per row of C channels (an NHWC pixel):
//   norm[j] = knorm + alpha_n * sum_{q = j-lo}^{j+hi} x[q]^2
//   y[j]    = x[j] * norm[j]^(-beta)
// with lo = (n-1)/2, hi = n-1-lo — the window of `_band_matrix`, which is
// asymmetric for even n — and channels outside [0, C) left out.  `norm`
// is written only when the caller passes a buffer for it (training).
// Each window is summed in ascending channel order, x[q]^2 by one fma a
// term from 0; norm = fma(alpha_n, win, knorm); the power as lrn.cuh's
// lrn_pow.
//
// What bounds it on an H100: the bytes.  One read of x and one write of
// y (and of norm when asked), 8 or 12 bytes an element, against some 20
// instructions an element: at AlexNet's norm1 + norm2 (29 M elements)
// 0.069 ms at 3.35 TB/s, about 70 lane-instructions an element of budget.
//
// Design.  The TPU kernel multiplies x^2 by a (C, C) 0/1 band matrix on
// its matrix unit; here the band is a short sum over neighbours.
// * A block takes one tile of whole rows, one contiguous byte range of
//   about 8 KB, staged in shared memory by 16-byte cp.async copies; the
//   hardware keeps several blocks an SM in flight (six at 40 registers a
//   thread), so one block's loads overlap another's compute.  (A
//   persistent grid walking tiles through a 1-3 deep cp.async ring
//   measured 7 % slower on an H100 at AlexNet's shapes, its last round
//   of tiles leaving SMs idle: `tools/lrn_variants.py`, PERF.md §6.)
// * A thread owns items of 4 channels; its (row, item) walk through a
//   tile is fixed by its thread index, found once by one division and
//   then stepped (no modulo an element).  With the fast window (n = 5)
//   an item reads its 4 channels and the two neighbouring items as three
//   16-byte shared loads, sums the windows in registers and writes y
//   (and norm) with one 16-byte streaming store each.
// * The power takes two MUFU operations (lrn.cuh), not a general powf.
// * The bf16 and f16 builds (lrn_fwd_bf16, lrn_fwd_f16; one body, the
//   element type a template parameter): x and y 16-bit, norm f32; an item
//   is 8 channels (16 bytes of x), a tile 8 KB of x as in f32, so twice
//   the rows; the squares, the sums and the power in f32, y rounded once.
//   Their bytes, 4 an element (8 with norm), halve the f32 build's bound.

#include "lrn.cuh"

constexpr int LRN_THREADS = 256;
// f32 elements a tile holds (whole rows; one row where C is larger); a
// 16-bit tile holds the same bytes
constexpr int LRN_TILE_FLOATS = 2048;
constexpr int LRN_TILE_BYTES = LRN_TILE_FLOATS * (int)sizeof(float);

// One item: CI channels from ch of a staged row sr (C channels), its
// output at y + off.  VEC && NS > 0: the unrolled window of NS; else the
// loop over [ch - lo, ch + hi] clipped to the row, masked past C.
template <class T, bool VEC, int NS>
__device__ __forceinline__ void lrn_fwd_item(
    const T* sr, int ch, int c, int lo, int hi, float alpha_n, float beta,
    bool b075, float knorm, T* __restrict__ y, float* __restrict__ norm_out,
    long long off) {
  constexpr int CI = lrn_ci<T>();
  float xv[CI], nv[CI];
  if constexpr (VEC && NS > 0) {
    static_assert((NS - 1) / 2 <= CI && NS - 1 - (NS - 1) / 2 <= CI,
                  "the window must fit the neighbouring items");
    constexpr int LO = (NS - 1) / 2;
    const uint4 z = make_uint4(0, 0, 0, 0);
    float v[3 * CI];
    lrn_unpack(ch > 0 ? *reinterpret_cast<const uint4*>(sr + ch - CI) : z,
               sr, v);
    lrn_unpack(*reinterpret_cast<const uint4*>(sr + ch), sr, v + CI);
    lrn_unpack(ch + CI < c ? *reinterpret_cast<const uint4*>(sr + ch + CI)
                           : z,
               sr, v + 2 * CI);
#pragma unroll
    for (int e = 0; e < CI; ++e) {
      float win = 0.f;
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        const float q = v[CI + e - LO + u];
        win = fmaf(q, q, win);
      }
      xv[e] = v[CI + e];
      nv[e] = fmaf(alpha_n, win, knorm);
    }
  } else {
#pragma unroll
    for (int e = 0; e < CI; ++e) {
      const int j = ch + e;
      xv[e] = 0.f;
      nv[e] = 1.f;
      if (!VEC && j >= c) continue;
      const int q0 = j - lo < 0 ? 0 : j - lo;
      const int q1 = j + hi > c - 1 ? c - 1 : j + hi;
      float win = 0.f;
      for (int q = q0; q <= q1; ++q) {
        const float xq = lrn_f32(sr[q]);
        win = fmaf(xq, xq, win);
      }
      xv[e] = lrn_f32(sr[j]);
      nv[e] = fmaf(alpha_n, win, knorm);
    }
  }
  float yv[CI];
#pragma unroll
  for (int e = 0; e < CI; ++e) yv[e] = xv[e] * lrn_pow(nv[e], beta, b075);
  if constexpr (VEC) {
    __stcs(reinterpret_cast<uint4*>(y + off), lrn_pack(yv, y));
    if (norm_out != nullptr) {
#pragma unroll
      for (int e = 0; e < CI; e += 4)
        __stcs(reinterpret_cast<float4*>(norm_out + off + e),
               make_float4(nv[e], nv[e + 1], nv[e + 2], nv[e + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < CI; ++e) {
      if (ch + e >= c) break;
      lrn_put(y + off + e, yv[e]);
      if (norm_out != nullptr) __stcs(norm_out + off + e, nv[e]);
    }
  }
}

template <class T, bool VEC, int NS>
__global__ void __launch_bounds__(LRN_THREADS)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               float* __restrict__ norm_out, long long rows, int c,
               int tile_rows, int lo, int hi, float alpha_n, float beta,
               float knorm) {
  constexpr int CI = lrn_ci<T>();
  extern __shared__ __align__(16) unsigned char lrn_smem[];
  T* tile = reinterpret_cast<T*>(lrn_smem);
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const long long left = rows - r0;
  const int nrows = left < tile_rows ? (int)left : tile_rows;
  const int n = nrows * c;
  const T* src = x + r0 * c;
  if constexpr (VEC) {
    for (int k = threadIdx.x * CI; k < n; k += LRN_THREADS * CI)
      lrn_cp16(tile + k, src + k);
  } else if constexpr (sizeof(T) == 4) {
    for (int k = threadIdx.x; k < n; k += LRN_THREADS)
      lrn_cp4(tile + k, src + k);
  } else {
    // no 2-byte cp.async: the masked 16-bit path stages through registers
    for (int k = threadIdx.x; k < n; k += LRN_THREADS) tile[k] = src[k];
  }
  lrn_cp_commit();
  lrn_cp_wait_all();
  __syncthreads();

  const bool b075 = beta == 0.75f;
  const int cq = (c + CI - 1) / CI;
  // this thread's first item of the tile and its stride, as (row, item)
  int r = threadIdx.x / cq, j = threadIdx.x % cq;
  const int dr = LRN_THREADS / cq, dj = LRN_THREADS % cq;
  while (r < nrows) {
    lrn_fwd_item<T, VEC, NS>(tile + r * c, CI * j, c, lo, hi, alpha_n, beta,
                             b075, knorm, y, norm_out,
                             (r0 + r) * c + CI * j);
    j += dj;
    r += dr;
    if (j >= cq) {
      j -= cq;
      ++r;
    }
  }
}

template <class T, bool VEC, int NS>
static int lrn_fwd_launch(const void* x, void* y, void* norm, long long rows,
                          int c, int lo, int hi, float alpha_n, float beta,
                          float knorm, void* stream) {
  const int row_bytes = c * (int)sizeof(T);
  const int tile_rows = row_bytes >= LRN_TILE_BYTES
                            ? 1 : LRN_TILE_BYTES / row_bytes;
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)tile_rows * row_bytes;
  auto kern = lrn_fwd_kernel<T, VEC, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)ntiles, LRN_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, (float*)norm, rows, c, tile_rows, lo, hi, alpha_n,
      beta, knorm);
  return (int)cudaGetLastError();
}

template <class T>
static int lrn_fwd(const void* x, void* y, void* norm, long long rows, int c,
                   int lo, int hi, float alpha_n, float beta, float knorm,
                   void* stream) {
  if (c <= 0 || c > LRN_MAX_C || lo < 0 || hi < 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const bool vec = c % lrn_ci<T>() == 0 && lrn_aligned16(x) &&
                   lrn_aligned16(y) &&
                   (norm == nullptr || lrn_aligned16(norm));
  if (vec && lo + hi + 1 == LRN_FAST_N && lo == (LRN_FAST_N - 1) / 2)
    return lrn_fwd_launch<T, true, LRN_FAST_N>(x, y, norm, rows, c, lo, hi,
                                               alpha_n, beta, knorm, stream);
  if (vec)
    return lrn_fwd_launch<T, true, 0>(x, y, norm, rows, c, lo, hi, alpha_n,
                                      beta, knorm, stream);
  return lrn_fwd_launch<T, false, 0>(x, y, norm, rows, c, lo, hi, alpha_n,
                                     beta, knorm, stream);
}

extern "C" int lrn_fwd_f32(const void* x, void* y, void* norm,
                           long long rows, int c, int lo, int hi,
                           float alpha_n, float beta, float knorm,
                           void* stream) {
  return lrn_fwd<float>(x, y, norm, rows, c, lo, hi, alpha_n, beta, knorm,
                        stream);
}

// x and y bf16, norm f32
extern "C" int lrn_fwd_bf16(const void* x, void* y, void* norm,
                            long long rows, int c, int lo, int hi,
                            float alpha_n, float beta, float knorm,
                            void* stream) {
  return lrn_fwd<unsigned short>(x, y, norm, rows, c, lo, hi, alpha_n, beta,
                                 knorm, stream);
}

// x and y f16, norm f32
extern "C" int lrn_fwd_f16(const void* x, void* y, void* norm,
                           long long rows, int c, int lo, int hi,
                           float alpha_n, float beta, float knorm,
                           void* stream) {
  return lrn_fwd<__half>(x, y, norm, rows, c, lo, hi, alpha_n, beta, knorm,
                         stream);
}
