// One query's attention over a slot's paged KV rows, for Hopper (sm_90a):
// the shared body of paged_decode.cu (one query per slot) and
// paged_verify.cu (a K-query window per slot), built for f32 and for
// bf16 q / pools / output (the quantized serving tiers' compute dtype).
//
// What it computes, for one (slot, head, query) whose live cache range
// is [w, last] (positions outside it are masked out, as the -inf mask of
// transformer.decode_step / verify_step does):
//   s_t = (q . k_t) * scale                    t in [w, last]
//   p_t = exp(s_t - max s) / sum_t exp(s_t - max s)
//   out = sum_t p_t v_t
// where row t of the slot lives in physical page table[t / ps] at offset
// t % ps of the (P, ps, H, hd) pool of one stage.
//
// Design (one block of 8 warps, one pass over the rows, two phases in
// shared memory):
// * The block reads the slot's row of page ids into shared memory once,
//   while w and last are still on their way; a row's address is then one
//   shared-memory load, its page a multiply-shift (no division).
// * Warp v owns the contiguous run of live rows [v R, v R + R), R =
//   ceil(n / 8), n = last - w + 1.  A row is cut into chunks of 16 bytes
//   (4 f32 or 8 bf16; 1 element where hd * size or an address does not
//   allow 16-byte loads), a lane holds two chunks of a row (LPR = the
//   power of two >= chunks / 2, at most 32, lanes share a row), so one
//   pass of the warp covers 32 / LPR rows.  A lane keeps 8 chunks of
//   loads in flight (8 / CPL passes, CPL the chunks it holds of a row),
//   and the first passes of V are in flight while the block reduces the
//   max and the denominator.
// * Scores: each lane's fma chain over its chunks (d ascending), then an
//   xor butterfly over the row's LPR lanes; the max rides along in
//   registers, then a shuffle and 8 shared-memory values.  The
//   denominator: thread i's sum over rows i, i + 256, ..., a 32-lane xor
//   butterfly, then warps 0..7 added in order.  Each weight p = e / l
//   is divided once, by the thread that summed its e.
// * Output: in the same row layout, each lane's fma chain over its
//   group's rows (position order) with 16-byte loads of V, an xor
//   butterfly over the warp's row groups, then warps 0..7 added in order.
//
// So every sum's order depends only on n and hd: never on the page size,
// the table, the cache length T or the neighbouring slots.  A stream
// decoded in the engine's shared pool and the same stream decoded alone
// (transformer.generate) see bitwise the same attention, a verify-window
// query equals the decode step at its position, and a second launch
// equals the first.  (An xor butterfly leaves every lane with the same
// bits: each level adds the same two values in either order.)
//
// The bf16 build reads bf16 rows and accumulates in f32, and rounds to
// bf16 where the dense bf16 path does (ops/attention.py dense_attend on
// bf16 tensors, i.e. transformer.decode_step's einsum / scale / softmax /
// einsum): the score to bf16, the scaled score to bf16, the f32 softmax
// weight to bf16 (after the max and the sum are known: the scores wait
// in shared memory), the output to bf16.  The f32 build rounds nowhere.
//
// Shared memory per block: the live scores (at most pp*ps floats), the
// pp page ids, 8 warp partials of the output (8 hd floats) and 16 floats
// of reductions: it grows with pp*ps as the first design's did.
//
// tests/test_torch_paged_order.py models this order in torch on the CPU;
// tools/lm_kernel_variants.py builds the constants below at other values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_UNROLL = 8;       // 16-byte chunks of loads in flight a lane
constexpr int PA_LANE_CHUNKS = 2;  // 16-byte chunks of a row a lane holds
constexpr int PA_MAX_HD = 256;
static_assert(PA_LANE_CHUNKS >= 1 && PA_LANE_CHUNKS <= 4,
              "PA_DISPATCH holds a lane to at most 4 chunks of 16 bytes");

// The element type's stores and rounding points.
template <typename T>
struct PaElem;

template <>
struct PaElem<float> {
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct PaElem<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// A chunk of VEC elements of T: its raw load and element e as f32.
template <typename T, int VEC>
struct PaVec;

template <>
struct PaVec<float, 1> {
  using raw = float;
  static __device__ __forceinline__ raw load(const float* p) { return *p; }
  static __device__ __forceinline__ float get(const raw& r, int) { return r; }
};

template <>
struct PaVec<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float get(const raw& r, int e) {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
};

template <>
struct PaVec<__nv_bfloat16, 1> {
  using raw = __nv_bfloat16;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return *p;
  }
  static __device__ __forceinline__ float get(const raw& r, int) {
    return __bfloat162float(r);
  }
};

template <>
struct PaVec<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ float get(const raw& r, int e) {
    const unsigned w = (e >> 1) == 0   ? r.x
                       : (e >> 1) == 1 ? r.y
                       : (e >> 1) == 2 ? r.z
                                       : r.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// whether rows of hd elements (row_bytes) take 16-byte loads
inline bool pa_vec_ok(const void* q, const void* kpool, const void* vpool,
                      size_t row_bytes) {
  return row_bytes % 16 == 0 && (uintptr_t)q % 16 == 0 &&
         (uintptr_t)kpool % 16 == 0 && (uintptr_t)vpool % 16 == 0;
}

// lanes that share a row of C chunks: the power of two >= C /
// PA_LANE_CHUNKS, at most 32 (the host dispatches on the chunks a lane
// then holds, CPL = ceil(C / lanes))
__host__ __device__ inline int pa_lanes(int C) {
  const int want = (C + PA_LANE_CHUNKS - 1) / PA_LANE_CHUNKS;
  int lpr = 1;
  while (lpr < want && lpr < 32) lpr <<= 1;
  return lpr;
}

// t / d for 0 <= t < 2^31 by a multiply (Granlund and Montgomery's
// round-up method): s = ceil(log2 d), m = floor(2^32 (2^s - d) / d) + 1,
// t / d = (umulhi(t, m) + t) >> s
struct PaDiv {
  unsigned m;
  int s;
};

__device__ __forceinline__ PaDiv pa_div(int d) {
  int s = 0;
  while ((1 << s) < d) ++s;
  return {(unsigned)((((1ull << 32) * ((1ull << s) - d)) / d) + 1), s};
}

__device__ __forceinline__ int pa_quot(int t, PaDiv dv) {
  return (int)((__umulhi((unsigned)t, dv.m) + (unsigned)t) >> dv.s);
}

// dynamic shared memory of one block: scores, page ids, warp partials of
// the output, reductions
inline size_t pa_smem_bytes(int cache_len, int pp, int hd) {
  return (size_t)(cache_len + pp + PA_WARPS * hd + 2 * PA_WARPS) * 4;
}

// One (slot, head, query): q and out point at this query's hd elements;
// table_row at the slot's pp page ids; kpool / vpool at one stage's pool.
// VEC elements a chunk (16 bytes, or 1 on the scalar path), at most CPL
// chunks a lane (ceil(hd / VEC / 32), rounded up to a power of two).
template <typename T, int VEC, int CPL>
__device__ void paged_attend_one(const T* __restrict__ q,
                                 const T* __restrict__ kpool,
                                 const T* __restrict__ vpool,
                                 const int* __restrict__ table_row, int pp,
                                 int ps, int H, int hd, int h, int w,
                                 int last, float scale, T* __restrict__ out,
                                 float* smem) {
  using E = PaElem<T>;
  using V = PaVec<T, VEC>;
  using Raw = typename V::raw;
  constexpr int U = PA_UNROLL / CPL > 0 ? PA_UNROLL / CPL : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = last - w + 1;  // live rows, >= 1

  float* s_sc = smem;                             // n scores, then weights
  int* s_tab = reinterpret_cast<int*>(s_sc + n);  // pp page ids
  float* s_wo = reinterpret_cast<float*>(s_tab + pp);  // 8 x hd
  float* s_red = s_wo + PA_WARPS * hd;            // 2 x 8

  // the whole row of page ids: its load needs neither w nor last
  for (int i = tid; i < pp; i += PA_THREADS) s_tab[i] = table_row[i];
  const PaDiv by_ps = pa_div(ps);

  // the row layout: chunks per row, lanes per row, rows per warp pass
  const int C = hd / VEC;
  const int lpr = pa_lanes(C);
  const int rpw = 32 / lpr;
  const int grp = lane / lpr, sub = lane % lpr;
  const int R = (n + PA_WARPS - 1) / PA_WARPS;
  const int r0 = min(n, warp * R), r1 = min(n, r0 + R);

  // this lane's chunks of the U passes of rows from `base`, of one pool
  auto load_rows = [&](Raw (&dst)[U][CPL], const T* __restrict__ pool,
                       int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * rpw + grp;
      if (idx < r1) {
        const int t = w + idx;
        const int pg = pa_quot(t, by_ps);
        const long long row = (long long)s_tab[pg] * ps + (t - pg * ps);
        const T* pr = pool + (row * H + h) * hd;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int ch = sub + cc * lpr;
          if (ch < C) dst[u][cc] = V::load(pr + ch * VEC);
        }
      }
    }
  };

  float qr[CPL][VEC];
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc) {
    const int ch = sub + cc * lpr;
    if (ch < C) {
      const Raw x = V::load(q + ch * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[cc][e] = V::get(x, e);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[cc][e] = 0.f;
    }
  }
  __syncthreads();  // s_tab

  // scores, and this lane's running max
  float mx = -INFINITY;
  for (int base = r0; base < r1; base += rpw * U) {
    Raw kv[U][CPL];
    load_rows(kv, kpool, base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * rpw + grp;
      float part = 0.f;
      if (idx < r1) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          if (sub + cc * lpr < C) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part = fmaf(qr[cc][e], V::get(kv[u][cc], e), part);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)  // offsets lpr / 2 .. 1
        if (off < lpr) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (idx < r1 && sub == 0) {
        const float s = E::round(E::round(part) * scale);
        s_sc[idx] = s;
        mx = fmaxf(mx, s);
      }
    }
  }

  // the first pass of V rows, in flight across the two reductions
  Raw vv[U][CPL];
  load_rows(vv, vpool, r0);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) s_red[warp] = mx;
  __syncthreads();
  float m = s_red[0];
#pragma unroll
  for (int v = 1; v < PA_WARPS; ++v) m = fmaxf(m, s_red[v]);

  float l = 0.f;
  for (int idx = tid; idx < n; idx += PA_THREADS) {
    const float e = expf(s_sc[idx] - m);
    s_sc[idx] = e;
    l += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) s_red[PA_WARPS + warp] = l;
  __syncthreads();
  l = s_red[PA_WARPS];
#pragma unroll
  for (int v = 1; v < PA_WARPS; ++v) l += s_red[PA_WARPS + v];
  for (int idx = tid; idx < n; idx += PA_THREADS)
    s_sc[idx] = E::round(s_sc[idx] / l);
  __syncthreads();

  // out = sum_t p_t v_t over the same row layout
  float acc[CPL][VEC];
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[cc][e] = 0.f;
  for (int base = r0; base < r1; base += rpw * U) {
    if (base != r0) load_rows(vv, vpool, base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * rpw + grp;
      if (idx < r1) {
        const float p = s_sc[idx];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          if (sub + cc * lpr < C) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[cc][e] = fmaf(p, V::get(vv[u][cc], e), acc[cc][e]);
          }
        }
      }
    }
  }
  // the warp's row groups, then the warps in order
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)  // offsets 16 .. lpr
        if (off >= lpr)
          acc[cc][e] += __shfl_xor_sync(0xffffffffu, acc[cc][e], off);
  if (grp == 0) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int ch = sub + cc * lpr;
      if (ch < C) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s_wo[warp * hd + ch * VEC + e] = acc[cc][e];
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < hd; d += PA_THREADS) {
    float o = s_wo[d];
#pragma unroll
    for (int v = 1; v < PA_WARPS; ++v) o += s_wo[v * hd + d];
    E::store(out + d, o);
  }
}

// Launch `kernel<T, VEC, CPL>` for the row layout hd allows: VEC = 16
// bytes of T where hd * size and the addresses allow, else 1; CPL =
// ceil(chunks / pa_lanes(chunks)) rounded up to 1, 2, 4 or 8.
#define PA_DISPATCH(T, vec_ok, hd, LAUNCH)                          \
  do {                                                              \
    constexpr int VV = 16 / (int)sizeof(T);                         \
    const bool vec_ = (vec_ok);                                     \
    const int c_ = vec_ ? (hd) / VV : (hd);                         \
    const int cpl_ = (c_ + pa_lanes(c_) - 1) / pa_lanes(c_);        \
    if (vec_ && cpl_ <= 1) return LAUNCH(T, VV, 1);                 \
    if (vec_ && cpl_ <= 2) return LAUNCH(T, VV, 2);                 \
    if (vec_) return LAUNCH(T, VV, 4);                              \
    if (cpl_ <= 1) return LAUNCH(T, 1, 1);                          \
    if (cpl_ <= 2) return LAUNCH(T, 1, 2);                          \
    if (cpl_ <= 4) return LAUNCH(T, 1, 4);                          \
    return LAUNCH(T, 1, 8);                                         \
  } while (0)
