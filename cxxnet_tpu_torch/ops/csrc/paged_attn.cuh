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
// The arithmetic depends only on q and the live rows, taken in position
// order: each score is one warp's dot over hd (lanes stride hd, then a
// fixed shuffle tree, lane 0's sum kept); the max is exact; the
// denominator is thread i's sequential sum over live indices i, i+256,
// ... followed by a fixed shared-memory tree; the output is group g's
// sequential FMA chain over live indices g, g+G, ... (G = 256 / hd
// groups of hd threads) followed by a fixed sum over the groups.  Nothing
// depends on the page size, the table, the cache length T or the
// neighbouring slots, so a stream decoded in the engine's shared pool and
// the same stream decoded alone (transformer.generate) see bitwise the
// same attention, and a verify-window query equals the decode step at
// its position.
//
// The bf16 build reads bf16 rows and accumulates in f32, and rounds to
// bf16 where the dense bf16 path does (ops/attention.py dense_attend on
// bf16 tensors, i.e. transformer.decode_step's einsum / scale / softmax /
// einsum): the score to bf16, the scaled score to bf16, the f32 softmax
// weight to bf16, the output to bf16.  The f32 build rounds nowhere.
// Either way the invariants above hold.
//
// Shared memory per block: the live scores (at most pp*ps floats), the
// query (hd floats) and a 256-float reduction buffer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;

__device__ __forceinline__ float pa_block_reduce(float v, float* red,
                                                 bool is_max) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = PA_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
      red[tid] = is_max ? fmaxf(red[tid], red[tid + s]) : red[tid] + red[tid + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// The element type's loads, stores and rounding points.
template <typename T>
struct PaElem;

template <>
struct PaElem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct PaElem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// One (slot, head, query): q and out point at this query's hd elements;
// table_row at the slot's pp page ids; kpool / vpool at one stage's pool.
template <typename T>
__device__ void paged_attend_one(const T* __restrict__ q,
                                 const T* __restrict__ kpool,
                                 const T* __restrict__ vpool,
                                 const int* __restrict__ table_row, int ps,
                                 int H, int hd, int h, int w, int last,
                                 float scale, T* __restrict__ out,
                                 float* s_sc, float* s_q, float* s_red) {
  using E = PaElem<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = last - w + 1;  // live rows, >= 1
  for (int d = tid; d < hd; d += PA_THREADS) s_q[d] = E::load(q + d);
  __syncthreads();

  // scores: one warp per live row, rows read in place through the table
  for (int idx = warp; idx < n; idx += PA_WARPS) {
    const int t = w + idx;
    const long long row = (long long)table_row[t / ps] * ps + t % ps;
    const T* kr = kpool + (row * H + h) * hd;
    float part = 0.f;
    for (int d = lane; d < hd; d += 32)
      part = fmaf(s_q[d], E::load(kr + d), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) s_sc[idx] = E::round(E::round(part) * scale);
  }
  __syncthreads();

  float m = -INFINITY;
  for (int idx = tid; idx < n; idx += PA_THREADS) m = fmaxf(m, s_sc[idx]);
  m = pa_block_reduce(m, s_red, true);

  float l = 0.f;
  for (int idx = tid; idx < n; idx += PA_THREADS) {
    const float e = expf(s_sc[idx] - m);
    s_sc[idx] = e;
    l += e;
  }
  l = pa_block_reduce(l, s_red, false);
  for (int idx = tid; idx < n; idx += PA_THREADS)
    s_sc[idx] = E::round(s_sc[idx] / l);
  __syncthreads();

  // out[d] = sum_t p_t v_t[d]: G groups of hd threads, each a sequential
  // chain over every G-th live row, then the groups summed in order
  const int G = PA_THREADS / hd;
  const int g = tid / hd;
  const int d = tid - g * hd;
  if (g < G) {
    float acc = 0.f;
    for (int idx = g; idx < n; idx += G) {
      const int t = w + idx;
      const long long row = (long long)table_row[t / ps] * ps + t % ps;
      acc = fmaf(s_sc[idx], E::load(vpool + (row * H + h) * hd + d),
                 acc);
    }
    s_red[g * hd + d] = acc;
  }
  __syncthreads();
  if (tid < hd) {
    float o = s_red[tid];
    for (int g2 = 1; g2 < G; ++g2) o += s_red[g2 * hd + tid];
    E::store(out + tid, o);
  }
}

// dynamic shared memory of one block: scores, query, reduction buffer
inline size_t pa_smem_bytes(int cache_len, int hd) {
  return (size_t)(cache_len + hd + PA_THREADS) * sizeof(float);
}
