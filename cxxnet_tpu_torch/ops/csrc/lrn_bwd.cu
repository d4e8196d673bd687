// Cross-channel LRN backward, f32, bf16 and f16, for Hopper (sm_90a).
// Replaces the Pallas `_lrn_bwd_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:242
// (launched by `_lrn_call` :258 from `_lrn_vjp_bwd` :306, the backward
// of `lrn_pallas`).  CUDA C++ rather than Triton, like the forward in
// lrn.cu, with which it shares lrn.cuh.
//
// What it computes, per row of C channels (an NHWC pixel), from the
// forward's input x, the upstream gradient g and the forward's saved
// f32 norm:
//   p[j]  = norm[j]^(-beta)
//   t[i]  = g[i] * x[i] * p[i] / norm[i]
//   dx[j] = g[j] * p[j] - coef * x[j] * sum_{i = j-hi}^{j+lo} t[i]
// with coef = 2 * beta * alpha / n.  The forward's channel i summed the
// window [i - lo, i + hi] (lo = (n-1)/2, hi = n-1-lo); channel j's
// gradient sums the windows that contain j, the TRANSPOSED window
// [j - hi, j + lo] — for even n that swaps lo and hi
// (`_band_matrix(c, nsize).T` in `_lrn_vjp_bwd`, the swapped pad widths
// of `_lrn_hybrid_bwd` :364).  Channels outside [0, C) are left out.
// In the kernel's order: p as lrn.cuh's lrn_pow, t = (g * x) * (p *
// rcp(norm)) (norm^(-beta-1) from p and one approximate reciprocal, no
// second power and no division), each window summed in ascending channel
// order from 0, dx = fma(-(coef * x), win, g * p).
//
// What bounds it on an H100: the bytes.  It reads x, g and norm and
// writes dx, 16 bytes per element: at AlexNet's norm1 + norm2 (29 M
// elements) 0.139 ms at 3.35 TB/s.
//
// Design.  The TPU kernel contracts t with a (C, C) band matrix on its
// matrix unit; here the band is a short sum over neighbours.
// * A block takes one tile of whole rows (about 512 items of 4 channels;
//   one row of up to 1024 threads where C is larger), the hardware
//   keeping several blocks an SM in flight.  (A persistent grid walking
//   tiles measured 3 % slower on an H100 at AlexNet's shapes:
//   `tools/lrn_variants.py`, PERF.md §6.)
// * A thread owns two items of the tile (one division each): it loads x,
//   g and norm of both with 16-byte streaming loads, six in flight,
//   computes t into the tile — the one array in shared memory — and
//   keeps x and g * p in registers.
// * After the barrier each item sums its channels' transposed windows
//   from the staged t (with the fast window, its own and the two
//   neighbouring items' t as three 16-byte shared loads) and writes dx
//   with one 16-byte streaming store.
// * The bf16 and f16 builds (lrn_bwd_bf16, lrn_bwd_f16; one body, the
//   element type a template parameter): x, g and dx 16-bit, norm f32, an
//   item 8 channels; a thread holds one item (8 channels, as two f32
//   items), so its registers stay within the 1024-thread launch bound; t
//   is staged in f32, dx rounded once.  10 bytes an element against
//   f32's 16.

#include "lrn.cuh"

// threads of a block where a row's items fit ITEMS a thread in 256; a
// larger row takes up to LRN_BWD_MAX_THREADS
constexpr int LRN_BWD_THREADS = 256;
constexpr int LRN_BWD_MAX_THREADS = 1024;

// f32 items a thread holds in a tile
constexpr int LRN_BWD_ITEMS = 2;

// items of T a thread holds: the channels of LRN_BWD_ITEMS f32 items (one
// 16-bit item)
template <class T>
__host__ __device__ constexpr int lrn_bwd_items() {
  return LRN_BWD_ITEMS * lrn_ci<float>() / lrn_ci<T>();
}

template <class T, bool VEC, int NS>
__global__ void __launch_bounds__(LRN_BWD_MAX_THREADS)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               const float* __restrict__ norm, T* __restrict__ dx,
               long long rows, int c, int tile_rows, int lo, int hi,
               float beta, float coef) {
  constexpr int CI = lrn_ci<T>(), ITEMS = lrn_bwd_items<T>();
  extern __shared__ __align__(16) float st[];   // t of the tile
  const int cq = (c + CI - 1) / CI;
  const int cs = CI * cq;               // a staged row, padded to items
  const bool b075 = beta == 0.75f;
  int ir[ITEMS], ich[ITEMS];
#pragma unroll
  for (int p = 0; p < ITEMS; ++p) {
    const int k = threadIdx.x + p * blockDim.x;
    ir[p] = k / cq;                     // >= tile_rows: no item
    ich[p] = CI * (k - ir[p] * cq);
  }
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const long long left = rows - r0;
  const int nrows = left < tile_rows ? (int)left : tile_rows;
  float xv[ITEMS][CI], gv[ITEMS][CI], nv[ITEMS][CI];
#pragma unroll
  for (int p = 0; p < ITEMS; ++p) {
    const long long off = (r0 + ir[p]) * c + ich[p];
    if (ir[p] >= nrows) continue;
    if constexpr (VEC) {
      lrn_unpack(__ldcs(reinterpret_cast<const uint4*>(x + off)), x, xv[p]);
      lrn_unpack(__ldcs(reinterpret_cast<const uint4*>(g + off)), g, gv[p]);
#pragma unroll
      for (int e = 0; e < CI; e += 4) {
        const float4 d =
            __ldcs(reinterpret_cast<const float4*>(norm + off + e));
        nv[p][e] = d.x; nv[p][e + 1] = d.y;
        nv[p][e + 2] = d.z; nv[p][e + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < CI; ++e) {
        const bool in = ich[p] + e < c;
        xv[p][e] = in ? lrn_ld(x + off + e) : 0.f;
        gv[p][e] = in ? lrn_ld(g + off + e) : 0.f;
        nv[p][e] = in ? __ldcs(norm + off + e) : 1.f;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < ITEMS; ++p) {
    if (ir[p] >= nrows) continue;
    float t[CI];
#pragma unroll
    for (int e = 0; e < CI; ++e) {
      const float pw = lrn_pow(nv[p][e], beta, b075);
      t[e] = (gv[p][e] * xv[p][e]) * (pw * lrn_rcp(nv[p][e]));
      gv[p][e] *= pw;                 // g * p from here on
    }
#pragma unroll
    for (int e = 0; e < CI; e += 4)
      *reinterpret_cast<float4*>(st + ir[p] * cs + ich[p] + e) =
          make_float4(t[e], t[e + 1], t[e + 2], t[e + 3]);
  }
  __syncthreads();   // t staged
#pragma unroll
  for (int p = 0; p < ITEMS; ++p) {
    if (ir[p] >= nrows) continue;
    const float* sr = st + ir[p] * cs;
    const int ch = ich[p];
    float win[CI];
    if constexpr (VEC && NS > 0) {
      static_assert((NS - 1) / 2 <= CI && NS - 1 - (NS - 1) / 2 <= CI,
                    "the window must fit the neighbouring items");
      constexpr int HI = NS - 1 - (NS - 1) / 2;
      float v[3 * CI];
#pragma unroll
      for (int e = 0; e < CI; e += 4) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a =
            ch > 0 ? *reinterpret_cast<const float4*>(sr + ch - CI + e) : z;
        const float4 b = *reinterpret_cast<const float4*>(sr + ch + e);
        const float4 d =
            ch + CI < cs ? *reinterpret_cast<const float4*>(sr + ch + CI + e)
                         : z;
        v[e] = a.x; v[e + 1] = a.y; v[e + 2] = a.z; v[e + 3] = a.w;
        v[CI + e] = b.x; v[CI + e + 1] = b.y;
        v[CI + e + 2] = b.z; v[CI + e + 3] = b.w;
        v[2 * CI + e] = d.x; v[2 * CI + e + 1] = d.y;
        v[2 * CI + e + 2] = d.z; v[2 * CI + e + 3] = d.w;
      }
#pragma unroll
      for (int e = 0; e < CI; ++e) {
        float w = 0.f;
#pragma unroll
        for (int u = 0; u < NS; ++u) w += v[CI + e - HI + u];
        win[e] = w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < CI; ++e) {
        const int j = ch + e;
        const int q0 = j - hi < 0 ? 0 : j - hi;
        const int q1 = j + lo > c - 1 ? c - 1 : j + lo;
        float w = 0.f;
        for (int q = q0; q <= q1; ++q) w += sr[q];
        win[e] = w;
      }
    }
    float d[CI];
#pragma unroll
    for (int e = 0; e < CI; ++e)
      d[e] = fmaf(-(coef * xv[p][e]), win[e], gv[p][e]);
    const long long off = (r0 + ir[p]) * c + ch;
    if constexpr (VEC) {
      __stcs(reinterpret_cast<uint4*>(dx + off), lrn_pack(d, dx));
    } else {
#pragma unroll
      for (int e = 0; e < CI; ++e)
        if (ch + e < c) lrn_put(dx + off + e, d[e]);
    }
  }
}

template <class T, bool VEC, int NS>
static int lrn_bwd_launch(const void* x, const void* g, const void* norm,
                          void* dx, long long rows, int c, int lo, int hi,
                          float beta, float coef, void* stream) {
  constexpr int CI = lrn_ci<T>(), ITEMS = lrn_bwd_items<T>();
  const int cq = (c + CI - 1) / CI;
  int threads = LRN_BWD_THREADS;
  if (cq > ITEMS * threads)
    threads = (cq + ITEMS * 32 - 1) / (ITEMS * 32) * 32;
  const int tile_rows = ITEMS * threads / cq;   // >= 1
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)tile_rows * CI * cq * sizeof(float);
  auto kern = lrn_bwd_kernel<T, VEC, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)ntiles, threads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const float*)norm, (T*)dx, rows, c,
      tile_rows, lo, hi, beta, coef);
  return (int)cudaGetLastError();
}

template <class T>
static int lrn_bwd(const void* x, const void* g, const void* norm, void* dx,
                   long long rows, int c, int lo, int hi, float beta,
                   float coef, void* stream) {
  if (c <= 0 || c > LRN_MAX_C || lo < 0 || hi < 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const bool vec = c % lrn_ci<T>() == 0 && lrn_aligned16(x) &&
                   lrn_aligned16(g) && lrn_aligned16(norm) &&
                   lrn_aligned16(dx);
  if (vec && lo + hi + 1 == LRN_FAST_N && lo == (LRN_FAST_N - 1) / 2)
    return lrn_bwd_launch<T, true, LRN_FAST_N>(x, g, norm, dx, rows, c, lo,
                                               hi, beta, coef, stream);
  if (vec)
    return lrn_bwd_launch<T, true, 0>(x, g, norm, dx, rows, c, lo, hi, beta,
                                      coef, stream);
  return lrn_bwd_launch<T, false, 0>(x, g, norm, dx, rows, c, lo, hi, beta,
                                     coef, stream);
}

extern "C" int lrn_bwd_f32(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  return lrn_bwd<float>(x, g, norm, dx, rows, c, lo, hi, beta, coef, stream);
}

// x, g and dx bf16, norm f32
extern "C" int lrn_bwd_bf16(const void* x, const void* g, const void* norm,
                            void* dx, long long rows, int c, int lo, int hi,
                            float beta, float coef, void* stream) {
  return lrn_bwd<unsigned short>(x, g, norm, dx, rows, c, lo, hi, beta, coef,
                                 stream);
}

// x, g and dx f16, norm f32
extern "C" int lrn_bwd_f16(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  return lrn_bwd<__half>(x, g, norm, dx, rows, c, lo, hi, beta, coef, stream);
}
