#!/usr/bin/env python3
"""Ablate the LRN forward and backward kernels on one NVIDIA card.

    python3 tools/lrn_variants.py [NAME ...]

Each NAME (default: all of VARIANTS) is one build beside the package's
own ``ops/csrc/lrn.cu`` / ``lrn_bwd.cu`` (with ``lrn.cuh``), compiled with
the package's nvcc flags into ``ops/_build/variants/NAME/``:

* checked text edits of the package's sources (an edit that no longer
  applies raises): the timing-only ablations that drop work (no power,
  no window sum, no stores, the loads alone);
* sources held here: the persistent grid (``persistent``: a grid sized
  to the card's occupancy, each block walking its tiles, the forward
  through a ``cp.async`` ring 1, 2 or 3 tiles deep, the backward with two
  t buffers; the package's arithmetic, so its outputs are bitwise the
  package's), the parent's scalar layout (``old``: one thread an
  element, 4-byte accesses, a modulo and ``powf`` an element, three
  staged arrays in the backward), the register-resident layout
  (``regs``: a lane holds one item of 4 channels and takes its
  neighbours' from the lanes beside it by warp shuffles, the warp's end
  lanes from memory), and the copy ceiling (``copy``: a 16-byte
  streaming copy moving the kernels' bytes — 1 read + 1 write for the
  forward, 1 read + 2 writes for its training form, 3 reads + 1 write
  for the backward).

Each build runs at ``chip_smoke.py``'s AlexNet shapes (``norm1`` 256 x 27
x 27 x 96, ``norm2`` 256 x 13 x 13 x 256; local_size 5, alpha 1e-3, beta
0.75, knorm 1) in three forms: the forward without ``norm`` (inference),
the forward writing ``norm`` (training) and the backward.  Checks: the
persistent grids must equal the package's build bitwise, ``old`` and
``regs`` the plain versions within ``chip_smoke.TOL`` (1e-5 of the largest
value); ablations and the copy are timing-only.  Times are device
milliseconds by CUDA-graph replay (``graph_ms``) and by CUDA events over
back-to-back calls (``events_ms``), both over input / output sets rotated
so that a set is reused only after twice the 50 MB L2 has been moved:
each launch reads its inputs from device memory.  Two rounds (package,
variants, package; then reversed).  One JSON line per build: ptxas
registers, stack frame and spills of each kernel, the checks, each
round's times and the bound (bytes at 3.35 TB/s).

Needs a CUDA device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (LRN_ARGS, LRN_SHAPES, TOL, graph_ms,  # noqa: E402
                        ptxas_summary, rotating, time_ms)

FWD, BWD = 'lrn.cu', 'lrn_bwd.cu'


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f'edit does not apply ({src.count(old)} matches, '
                         f'want {count}): {old[:70]!r}')
    return src.replace(old, new)


def _const(fn, name, value):
    """A text edit setting ``constexpr int NAME = ...;`` of source fn."""
    def edit(files):
        pat = re.compile(r'constexpr int ' + name + r' = \d+;')
        if len(pat.findall(files[fn])) != 1:
            raise ValueError(f'constant {name} not found once')
        files[fn] = pat.sub(f'constexpr int {name} = {value};', files[fn])
    return edit


def _both(*edits):
    def edit(files):
        for e in edits:
            e(files)
    return edit


def _edit(fn, *pairs):
    """A text edit replacing each (old, new) of source fn once."""
    def edit(files):
        for old, new in pairs:
            files[fn] = _sub(files[fn], old, new)
    return edit


_FWD_STORE = '    __stcs(reinterpret_cast<uint4*>(y + off), lrn_pack(yv, y));\n'
_BWD_STORE = ('      __stcs(reinterpret_cast<uint4*>(dx + off), '
              'lrn_pack(d, dx));\n')

# the parent's kernels (one thread an element, the layout this PR replaced)
_OLD_FWD = r'''
#include <cuda_runtime.h>
constexpr int T = 256, SMEM_FLOATS = 8192;
__global__ void __launch_bounds__(T)
k(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ nout,
  long long rows, int c, int rpb, int lo, int hi, float an, float beta,
  float kn) {
  extern __shared__ float sx[];
  const long long r0 = (long long)blockIdx.x * rpb, left = rows - r0;
  const int cnt = (left < rpb ? (int)left : rpb) * c;
  const long long base = r0 * c;
  for (int i = threadIdx.x; i < cnt; i += T) sx[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += T) {
    const int j = i % c, row = i - j;
    const int q0 = j - lo < 0 ? 0 : j - lo, q1 = j + hi > c - 1 ? c - 1 : j + hi;
    float win = 0.f;
    for (int q = q0; q <= q1; ++q) win = fmaf(sx[row + q], sx[row + q], win);
    const float nrm = kn + an * win;
    if (nout != nullptr) nout[base + i] = nrm;
    y[base + i] = sx[i] * powf(nrm, -beta);
  }
}
extern "C" int lrn_fwd_f32(const void* x, void* y, void* norm, long long rows,
                           int c, int lo, int hi, float an, float beta,
                           float kn, void* stream) {
  if (c <= 0 || c > SMEM_FLOATS) return (int)cudaErrorInvalidValue;
  const int rpb = SMEM_FLOATS / c;
  k<<<(unsigned)((rows + rpb - 1) / rpb), T, (size_t)rpb * c * 4,
      (cudaStream_t)stream>>>((const float*)x, (float*)y, (float*)norm, rows,
                              c, rpb, lo, hi, an, beta, kn);
  return (int)cudaGetLastError();
}
'''
_OLD_BWD = r'''
#include <cuda_runtime.h>
constexpr int T = 256, SMEM_FLOATS = 4096;
__global__ void __launch_bounds__(T)
k(const float* __restrict__ x, const float* __restrict__ g,
  const float* __restrict__ norm, float* __restrict__ dx, long long rows, int c,
  int rpb, int lo, int hi, float beta, float coef) {
  extern __shared__ float smem[];
  const int stride = rpb * c;
  float *st = smem, *sgp = smem + stride, *sx = smem + 2 * stride;
  const long long r0 = (long long)blockIdx.x * rpb, left = rows - r0;
  const int cnt = (left < rpb ? (int)left : rpb) * c;
  const long long base = r0 * c;
  for (int i = threadIdx.x; i < cnt; i += T) {
    const float xv = x[base + i], gv = g[base + i], nv = norm[base + i];
    const float p = powf(nv, -beta);
    st[i] = gv * xv * p / nv;
    sgp[i] = gv * p;
    sx[i] = xv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += T) {
    const int j = i % c, row = i - j;
    const int q0 = j - hi < 0 ? 0 : j - hi, q1 = j + lo > c - 1 ? c - 1 : j + lo;
    float win = 0.f;
    for (int q = q0; q <= q1; ++q) win += st[row + q];
    dx[base + i] = sgp[i] - coef * sx[i] * win;
  }
}
extern "C" int lrn_bwd_f32(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  if (c <= 0 || c > SMEM_FLOATS) return (int)cudaErrorInvalidValue;
  const int rpb = SMEM_FLOATS / c;
  k<<<(unsigned)((rows + rpb - 1) / rpb), T, (size_t)3 * rpb * c * 4,
      (cudaStream_t)stream>>>((const float*)x, (const float*)g,
                              (const float*)norm, (float*)dx, rows, c, rpb, lo,
                              hi, beta, coef);
  return (int)cudaGetLastError();
}
'''
# the persistent grid (window 5, c % 4 == 0, c <= 2048, aligned pointers):
# the package's arithmetic in the package's order, so bitwise its outputs
_PERSISTENT = r'''
#include "lrn.cuh"
constexpr int T = 256, TILE_FLOATS = 2048, ITEMS = 2;
// the forward's ring: 1 (load, wait, compute), 2 or 3 tiles deep
constexpr int STAGES = 3;
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// as many blocks as fit on the card at once, never more than tiles
template <class Kernel>
static long long grid(Kernel kern, size_t smem, long long ntiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T, smem);
  const long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return g < ntiles ? g : ntiles;
}
__device__ __forceinline__ void unpack(float4 a, float4 b, float4 d,
                                       float* v) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = d.x; v[9] = d.y; v[10] = d.z; v[11] = d.w;
}
__global__ void __launch_bounds__(T)
fwd(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ no,
    long long rows, int c, int tile_rows, long long ntiles, float an,
    float beta, float kn) {
  extern __shared__ __align__(16) float ring[];
  const int tile_floats = tile_rows * c, cq = c >> 2;
  const bool b075 = beta == 0.75f;
  const int r_first = threadIdx.x / cq, j_first = threadIdx.x % cq;
  const int dr = T / cq, dj = T % cq;
  const long long mine =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto stage = [&](int buf, long long i) {
    const long long r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const long long left = rows - r0;
    const int n = (left < tile_rows ? (int)left : tile_rows) * c;
    for (int k = threadIdx.x * 4; k < n; k += T * 4)
      lrn_cp16(ring + buf * tile_floats + k, x + r0 * c + k);
  };
  auto compute = [&](int buf, long long i) {
    const long long r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const long long left = rows - r0;
    const int nrows = left < tile_rows ? (int)left : tile_rows;
    const float* s = ring + buf * tile_floats;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    int r = r_first, j = j_first;
    while (r < nrows) {
      const float* sr = s + r * c;
      const int ch = 4 * j;
      const float4 a =
          ch > 0 ? *reinterpret_cast<const float4*>(sr + ch - 4) : z;
      const float4 b = *reinterpret_cast<const float4*>(sr + ch);
      const float4 d =
          ch + 4 < c ? *reinterpret_cast<const float4*>(sr + ch + 4) : z;
      float v[12], yv[4], nv[4];
      unpack(a, b, d, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float win = 0.f;
#pragma unroll
        for (int u = 0; u < 5; ++u) {
          const float q = v[2 + e + u];
          win = fmaf(q, q, win);
        }
        nv[e] = fmaf(an, win, kn);
        yv[e] = v[4 + e] * lrn_pow(nv[e], beta, b075);
      }
      const long long off = (r0 + r) * c + ch;
      __stcs(reinterpret_cast<float4*>(y + off),
             make_float4(yv[0], yv[1], yv[2], yv[3]));
      if (no != nullptr)
        __stcs(reinterpret_cast<float4*>(no + off),
               make_float4(nv[0], nv[1], nv[2], nv[3]));
      j += dj;
      r += dr;
      if (j >= cq) {
        j -= cq;
        ++r;
      }
    }
  };
  if constexpr (STAGES == 1) {
    for (long long i = 0; i < mine; ++i) {
      stage(0, i);
      lrn_cp_commit();
      lrn_cp_wait_all();
      __syncthreads();
      compute(0, i);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < mine) stage(s, s);
      lrn_cp_commit();
    }
    for (long long i = 0; i < mine; ++i) {
      cp_wait<(STAGES > 1 ? STAGES - 2 : 0)>();
      __syncthreads();  // tile i landed; tile i - 1's readers are done
      const long long nxt = i + STAGES - 1;
      if (nxt < mine) stage((int)(nxt % STAGES), nxt);
      lrn_cp_commit();
      compute((int)(i % STAGES), i);
    }
  }
}
__global__ void __launch_bounds__(T)
bwd(const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ nm, float* __restrict__ dx, long long rows,
    int c, int tile_rows, long long ntiles, float beta, float coef) {
  extern __shared__ __align__(16) float tbuf[];   // t: two tiles
  const int cq = c >> 2, tile_floats = tile_rows * c;
  const bool b075 = beta == 0.75f;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  int ir[ITEMS], ich[ITEMS];
#pragma unroll
  for (int p = 0; p < ITEMS; ++p) {
    const int k = threadIdx.x + p * T;
    ir[p] = k / cq;
    ich[p] = 4 * (k - ir[p] * cq);
  }
  long long it = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long r0 = tile * tile_rows;
    const long long left = rows - r0;
    const int nrows = left < tile_rows ? (int)left : tile_rows;
    float* st = tbuf + (it & 1) * tile_floats;
    float xv[ITEMS][4], gv[ITEMS][4], nv[ITEMS][4];
#pragma unroll
    for (int p = 0; p < ITEMS; ++p) {
      if (ir[p] >= nrows) continue;
      const long long off = (r0 + ir[p]) * c + ich[p];
      const float4 a = __ldcs(reinterpret_cast<const float4*>(x + off));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(g + off));
      const float4 d = __ldcs(reinterpret_cast<const float4*>(nm + off));
      xv[p][0] = a.x; xv[p][1] = a.y; xv[p][2] = a.z; xv[p][3] = a.w;
      gv[p][0] = b.x; gv[p][1] = b.y; gv[p][2] = b.z; gv[p][3] = b.w;
      nv[p][0] = d.x; nv[p][1] = d.y; nv[p][2] = d.z; nv[p][3] = d.w;
    }
#pragma unroll
    for (int p = 0; p < ITEMS; ++p) {
      if (ir[p] >= nrows) continue;
      float t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pw = lrn_pow(nv[p][e], beta, b075);
        t[e] = (gv[p][e] * xv[p][e]) * (pw * lrn_rcp(nv[p][e]));
        gv[p][e] *= pw;
      }
      *reinterpret_cast<float4*>(st + ir[p] * c + ich[p]) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
    __syncthreads();   // t staged; the other buffer's readers are done
#pragma unroll
    for (int p = 0; p < ITEMS; ++p) {
      if (ir[p] >= nrows) continue;
      const float* sr = st + ir[p] * c;
      const int ch = ich[p];
      const float4 a =
          ch > 0 ? *reinterpret_cast<const float4*>(sr + ch - 4) : z;
      const float4 b = *reinterpret_cast<const float4*>(sr + ch);
      const float4 d =
          ch + 4 < c ? *reinterpret_cast<const float4*>(sr + ch + 4) : z;
      float v[12], o[4];
      unpack(a, b, d, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w = 0.f;
#pragma unroll
        for (int u = 0; u < 5; ++u) w += v[2 + e + u];
        o[e] = fmaf(-(coef * xv[p][e]), w, gv[p][e]);
      }
      __stcs(reinterpret_cast<float4*>(dx + (r0 + ir[p]) * c + ch),
             make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}
static bool fits(int c, int lo, int hi) {
  return c > 0 && c % 4 == 0 && c <= TILE_FLOATS && lo == 2 && hi == 2;
}
extern "C" int lrn_fwd_f32(const void* x, void* y, void* norm, long long rows,
                           int c, int lo, int hi, float an, float beta,
                           float kn, void* stream) {
  if (!fits(c, lo, hi)) return (int)cudaErrorInvalidValue;
  const int tile_rows = TILE_FLOATS / c;
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)STAGES * tile_rows * c * sizeof(float);
  const long long blocks = grid(fwd, smem, ntiles);
  fwd<<<(unsigned)blocks, T, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (float*)norm, rows, c, tile_rows, ntiles,
      an, beta, kn);
  return (int)cudaGetLastError();
}
extern "C" int lrn_bwd_f32(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  if (!fits(c, lo, hi)) return (int)cudaErrorInvalidValue;
  const int tile_rows = ITEMS * T / (c / 4);
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)2 * tile_rows * c * sizeof(float);
  const long long blocks = grid(bwd, smem, ntiles);
  bwd<<<(unsigned)blocks, T, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)norm, (float*)dx, rows,
      c, tile_rows, ntiles, beta, coef);
  return (int)cudaGetLastError();
}
'''
# the register-resident layout: window 5, c % 4 == 0, aligned pointers
_REGS = r'''
#include "lrn.cuh"
constexpr int T = 256, BLOCKS_PER_SM = 8;
__device__ __forceinline__ float4 shfl4(float4 v, int up) {
  float4 r;
  if (up) {
    r.x = __shfl_up_sync(~0u, v.x, 1); r.y = __shfl_up_sync(~0u, v.y, 1);
    r.z = __shfl_up_sync(~0u, v.z, 1); r.w = __shfl_up_sync(~0u, v.w, 1);
  } else {
    r.x = __shfl_down_sync(~0u, v.x, 1); r.y = __shfl_down_sync(~0u, v.y, 1);
    r.z = __shfl_down_sync(~0u, v.z, 1); r.w = __shfl_down_sync(~0u, v.w, 1);
  }
  return r;
}
__device__ __forceinline__ void unpack(float4 a, float4 b, float4 d,
                                       float* v) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = d.x; v[9] = d.y; v[10] = d.z; v[11] = d.w;
}
// each warp walks 32 consecutive items; j is the item's index in its row
#define WALK                                                                 \
  const int cq = c >> 2;                                                     \
  const long long items = rows * cq;                                         \
  const int lane = threadIdx.x & 31;                                         \
  const long long stride = (long long)gridDim.x * T;                         \
  long long k = (long long)blockIdx.x * T + threadIdx.x;                     \
  int j = (int)(k % cq);                                                     \
  const int sj = (int)(stride % cq);                                         \
  for (; k - lane < items; k += stride, j += sj, j -= j >= cq ? cq : 0)
__global__ void __launch_bounds__(T)
fwd(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ no,
    long long rows, int c, float an, float beta, float kn) {
  const bool b075 = beta == 0.75f;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  WALK {
    const bool ok = k < items;
    const float4 b = ok ? __ldcs(x4 + k) : z;
    float4 a = shfl4(b, 1), d = shfl4(b, 0);
    if (ok && lane == 0 && j > 0) a = __ldg(x4 + k - 1);
    if (ok && lane == 31 && j + 1 < cq) d = __ldg(x4 + k + 1);
    if (j == 0) a = z;
    if (j + 1 >= cq) d = z;
    float v[12], yv[4], nv[4];
    unpack(a, b, d, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float win = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u) win = fmaf(v[2 + e + u], v[2 + e + u], win);
      nv[e] = fmaf(an, win, kn);
      yv[e] = v[4 + e] * lrn_pow(nv[e], beta, b075);
    }
    if (!ok) continue;
    __stcs(reinterpret_cast<float4*>(y) + k, make_float4(yv[0], yv[1], yv[2], yv[3]));
    if (no != nullptr)
      __stcs(reinterpret_cast<float4*>(no) + k, make_float4(nv[0], nv[1], nv[2], nv[3]));
  }
}
__device__ __forceinline__ float4 tterm(float4 x, float4 g, float4 n,
                                        float beta, bool b075, float4* gp) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, gs[4] = {g.x, g.y, g.z, g.w};
  const float ns[4] = {n.x, n.y, n.z, n.w};
  float t[4], q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float pw = lrn_pow(ns[e], beta, b075);
    t[e] = (gs[e] * xs[e]) * (pw * lrn_rcp(ns[e]));
    q[e] = gs[e] * pw;
  }
  if (gp != nullptr) *gp = make_float4(q[0], q[1], q[2], q[3]);
  return make_float4(t[0], t[1], t[2], t[3]);
}
__global__ void __launch_bounds__(T)
bwd(const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ nm, float* __restrict__ dx, long long rows, int c,
    float beta, float coef) {
  const bool b075 = beta == 0.75f;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f), one = make_float4(1.f, 1.f, 1.f, 1.f);
  const float4 *x4 = reinterpret_cast<const float4*>(x),
               *g4 = reinterpret_cast<const float4*>(g),
               *n4 = reinterpret_cast<const float4*>(nm);
  WALK {
    const bool ok = k < items;
    const float4 xv = ok ? __ldcs(x4 + k) : z, gv = ok ? __ldcs(g4 + k) : z;
    const float4 nv = ok ? __ldcs(n4 + k) : one;
    float4 gp;
    const float4 b = tterm(xv, gv, nv, beta, b075, &gp);
    float4 a = shfl4(b, 1), d = shfl4(b, 0);
    if (ok && lane == 0 && j > 0)
      a = tterm(__ldg(x4 + k - 1), __ldg(g4 + k - 1), __ldg(n4 + k - 1), beta, b075, nullptr);
    if (ok && lane == 31 && j + 1 < cq)
      d = tterm(__ldg(x4 + k + 1), __ldg(g4 + k + 1), __ldg(n4 + k + 1), beta, b075, nullptr);
    if (j == 0) a = z;
    if (j + 1 >= cq) d = z;
    float v[12];
    unpack(a, b, d, v);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, gs[4] = {gp.x, gp.y, gp.z, gp.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float w = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u) w += v[2 + e + u];
      o[e] = fmaf(-(coef * xs[e]), w, gs[e]);
    }
    if (ok) __stcs(reinterpret_cast<float4*>(dx) + k, make_float4(o[0], o[1], o[2], o[3]));
  }
}
static int grid() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * BLOCKS_PER_SM;
}
extern "C" int lrn_fwd_f32(const void* x, void* y, void* norm, long long rows,
                           int c, int lo, int hi, float an, float beta,
                           float kn, void* stream) {
  if (c % 4 || lo != 2 || hi != 2) return (int)cudaErrorInvalidValue;
  fwd<<<grid(), T, 0, (cudaStream_t)stream>>>((const float*)x, (float*)y,
                                             (float*)norm, rows, c, an, beta, kn);
  return (int)cudaGetLastError();
}
extern "C" int lrn_bwd_f32(const void* x, const void* g, const void* norm,
                           void* dx, long long rows, int c, int lo, int hi,
                           float beta, float coef, void* stream) {
  if (c % 4 || lo != 2 || hi != 2) return (int)cudaErrorInvalidValue;
  bwd<<<grid(), T, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)g,
                                             (const float*)norm, (float*)dx,
                                             rows, c, beta, coef);
  return (int)cudaGetLastError();
}
'''
# the copy ceiling: nin 16-byte streaming reads, summed, written nout
# times, one float4 a thread (the kernels' one block a tile)
_COPY = r'''
#include <cuda_runtime.h>
constexpr int T = 256;
__global__ void __launch_bounds__(T)
k(const float4* __restrict__ a, const float4* __restrict__ b,
  const float4* __restrict__ c, float4* __restrict__ o1,
  float4* __restrict__ o2, long long n4, int nin, int nout) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i < n4) {
    float4 v = __ldcs(a + i);
    if (nin == 3) {
      const float4 p = __ldcs(b + i), q = __ldcs(c + i);
      v.x += p.x + q.x; v.y += p.y + q.y; v.z += p.z + q.z; v.w += p.w + q.w;
    }
    __stcs(o1 + i, v);
    if (nout == 2) __stcs(o2 + i, v);
  }
}
extern "C" int lrn_copy(const void* a, const void* b, const void* c, void* o1,
                        void* o2, long long n, int nin, int nout,
                        void* stream) {
  k<<<(unsigned)((n / 4 + T - 1) / T), T, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (const float4*)b, (const float4*)c, (float4*)o1,
      (float4*)o2, n / 4, nin, nout);
  return (int)cudaGetLastError();
}
'''

#: name -> (what it builds: a csrc source or ('text', source), text edit
#: of the sources or None, check, what it asks); check 'bitwise' (the
#: package's output), 'plain'
#: (the plain versions within TOL) or 'none' (timing only: drops work)
VARIANTS = {
    'persistent': (('text', _PERSISTENT), None, 'bitwise',
                   'a persistent grid; the forward through a ring of three '
                   'tiles, the backward with two t buffers'),
    'persistent_stages1': (
        ('text', _PERSISTENT), _const('variant.cu', 'STAGES', 1), 'bitwise',
        'a persistent grid, the forward through a ring of one tile (load, '
        'wait, compute); the backward as persistent'),
    'persistent_stages2': (
        ('text', _PERSISTENT), _const('variant.cu', 'STAGES', 2), 'bitwise',
        'a persistent grid, the forward through a ring of two tiles; the '
        'backward as persistent'),
    'fwd_nopow': (FWD, _edit(FWD, (
        'yv[e] = xv[e] * lrn_pow(nv[e], beta, b075);',
        'yv[e] = xv[e] * nv[e];')), 'none', 'no power'),
    'fwd_nowin': (FWD, _edit(FWD, (
        'for (int u = 0; u < NS; ++u) {', 'for (int u = 0; u < 1; ++u) {')),
        'none', 'one term a window, not five'),
    'fwd_nostore': (FWD, _edit(FWD, (
        _FWD_STORE, '    if (yv[0] + yv[1] + yv[2] + yv[3] == 1234.5f) y[off] = nv[0];\n')),
        'none', 'no stores of y or norm (one conditional store)'),
    'fwd_loads': (FWD, _edit(FWD, (
        '    lrn_fwd_item<T, VEC, NS>(tile + r * c',
        '    if (tile[r * c + CI * j] == 1234.5f) y[r0] = 1.f;\n'
        '    if (r < 0) lrn_fwd_item<T, VEC, NS>(tile + r * c')),
        'none', 'the staging copies alone, no compute or stores'),
    'bwd_nopow': (BWD, _edit(BWD, (
        'const float pw = lrn_pow(nv[p][e], beta, b075);',
        'const float pw = nv[p][e];')), 'none', 'no power'),
    'bwd_nowin': (BWD, _edit(BWD, (
        'for (int u = 0; u < NS; ++u) w += v[CI + e - HI + u];',
        'w += v[CI + e];')), 'none', 'one term a window, not five'),
    'bwd_nostore': (BWD, _edit(BWD, (
        _BWD_STORE,
        '      if (d[0] + d[1] + d[2] + d[3] == 1234.5f) dx[off] = 1.f;\n')),
        'none', 'no stores of dx (one conditional store)'),
    'bwd_loads': (BWD, _edit(BWD, (
        '    if (ir[p] >= nrows) continue;\n    float t[CI];',
        '    if (ir[p] >= nrows) continue;\n    float t[CI];\n'
        '    if (xv[p][0] + xv[p][1] + xv[p][2] + xv[p][3] + gv[p][0]\n'
        '        + gv[p][1] + gv[p][2] + gv[p][3] + nv[p][0] + nv[p][1]\n'
        '        + nv[p][2] + nv[p][3] == 1234.5f) dx[r0] = 1.f;\n'
        '    if (r0 >= 0) continue;'),
        ('  __syncthreads();   // t staged',
         '  if (r0 >= 0) return;\n  __syncthreads();   // t staged')),
        'none', 'the loads alone (no t, no barrier, no window, no stores)'),
    'old_fwd': (('text', _OLD_FWD), None, 'plain',
                "the parent's scalar forward"),
    'old_bwd': (('text', _OLD_BWD), None, 'plain',
                "the parent's scalar backward"),
    'regs': (('text', _REGS), None, 'plain',
             'the register-resident layout, halo by warp shuffles'),
    'copy': (('text', _COPY), None, 'none',
             "a 16-byte streaming copy of the kernels' bytes"),
}


def build(names):
    """{name: (CDLL, ptxas)} for the package's two libraries (keys
    ``lrn.cu``, ``lrn_bwd.cu``) and each variant."""
    from cxxnet_tpu_torch.ops import build as B
    B.build_all()
    libs = {src: (ctypes.CDLL(B._lib_path(lib)),
                  ptxas_summary(B.build_log(lib)))
            for lib, src in B.SOURCES.items() if src in (FWD, BWD)}
    out_dir = os.path.join(B.BUILD_DIR, 'variants')
    procs = {}
    for name in names:
        src, edit, _, _ = VARIANTS[name]
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {}
        for fn in (FWD, BWD, 'lrn.cuh'):
            with open(os.path.join(B.CSRC, fn)) as f:
                files[fn] = f.read()
        if isinstance(src, tuple):
            files['variant.cu'], src = src[1], 'variant.cu'
        if edit is not None:
            edit(files)
        for fn, text in files.items():
            with open(os.path.join(vdir, fn), 'w') as f:
                f.write(text)
        so = os.path.join(vdir, f'lib{name}.so')
        cmd = [B.find_nvcc(), *B.NVCC_FLAGS, '-I', vdir, '-o', so,
               os.path.join(vdir, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name} failed to build:\n{log}')
        libs[name] = (ctypes.CDLL(so), ptxas_summary(log))
    return libs


def _bind(lib, name):
    from cxxnet_tpu_torch.ops import build as B
    key = {'lrn_fwd_f32': 'lrn', 'lrn_bwd_f32': 'lrn_bwd'}.get(name)
    fn = getattr(lib, name, None)
    if fn is None:
        return None
    fn.argtypes = (B.SIGNATURES[key][2] if key else
                   [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _inputs(shape, gen):
    """x (scaled as the smoke's), g, the plain forward's y and f32 norm,
    and the plain backward, for one shape."""
    import torch
    from cxxnet_tpu_torch.ops.kernels import (lrn_backward_plain,
                                              lrn_forward_plain)
    nsize, alpha, beta, knorm = LRN_ARGS
    x = torch.randn(shape, device='cuda', generator=gen) * 4.0
    g = torch.randn(shape, device='cuda', generator=gen)
    y, norm = lrn_forward_plain(x, nsize, alpha, beta, knorm)
    dx = lrn_backward_plain(x, g, norm, nsize, alpha, beta)
    return {'x': x, 'g': g, 'norm': norm, 'y': y, 'dx': dx}


def _run(lib, ins):
    """{form: {graph_ms, events_ms, out}} of one build at one shape: the
    forms its library has (fwd, fwd_train, bwd; or the copy's three)."""
    import torch
    nsize, alpha, beta, knorm = LRN_ARGS
    lo = (nsize - 1) // 2
    hi = nsize - 1 - lo
    x = ins['x']
    c, rows, n = x.shape[-1], x.numel() // x.shape[-1], x.numel()
    fwd, bwd = _bind(lib, 'lrn_fwd_f32'), _bind(lib, 'lrn_bwd_f32')
    cp = _bind(lib, 'lrn_copy')
    forms = {}

    def launcher(fn, nin, nout, args):
        """(call cycling over rotated sets, the first set's outputs)."""
        sets = []
        per_call = 4 * n * (nin + nout)
        first = [ins['x'], ins['g'], ins['norm']][:nin]
        for i in range(rotating(per_call)):
            srcs = first if i == 0 else [t.clone() for t in first]
            outs = [torch.empty_like(x) for _ in range(nout)]
            sets.append((srcs, outs))

        def call_set(srcs, outs):
            err = fn(*args(srcs, outs),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'launch failed: {err}')
        calls = [lambda s=s: call_set(*s) for s in sets]
        return calls, sets[0][1]

    def measure(form, calls, outs):
        import itertools
        it = itertools.cycle(calls)
        forms[form] = {'graph_ms': graph_ms(lambda: next(it)(), 20),
                       'events_ms': time_ms(lambda: next(it)(), 20)}
        # the outputs of the first set's first launch, for the checks
        calls[0]()
        torch.cuda.synchronize()
        forms[form]['out'] = [o.clone() for o in outs]

    if fwd is not None:
        for form, nout in (('fwd', 1), ('fwd_train', 2)):
            calls, outs = launcher(fwd, 1, nout, lambda s, o: (
                s[0].data_ptr(), o[0].data_ptr(),
                o[1].data_ptr() if len(o) > 1 else None, rows, c, lo, hi,
                alpha / nsize, beta, knorm))
            measure(form, calls, outs)
    if bwd is not None:
        calls, outs = launcher(bwd, 3, 1, lambda s, o: (
            s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(),
            o[0].data_ptr(), rows, c, lo, hi, beta,
            2.0 * beta * alpha / nsize))
        measure('bwd', calls, outs)
    if cp is not None:
        for form, nin, nout in (('fwd', 1, 1), ('fwd_train', 1, 2),
                                ('bwd', 3, 1)):
            calls, outs = launcher(cp, nin, nout, lambda s, o, nin=nin: (
                s[0].data_ptr(), s[min(1, nin - 1)].data_ptr(),
                s[min(2, nin - 1)].data_ptr(), o[0].data_ptr(),
                o[-1].data_ptr(), n, nin, len(o)))
            measure(form, calls, outs)
    return forms


def _rel(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30)


def main(argv) -> int:
    import torch
    names = argv or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f'unknown variant {name}; known: '
                             f'{", ".join(VARIANTS)}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = build(names)
    gen = torch.Generator(device='cuda').manual_seed(12)
    shapes = {name: _inputs(shape, gen) for name, shape in LRN_SHAPES}
    builds = [FWD, BWD] + names
    rows = {b: {'build': b, 'nvidia_smi': smi, 'ptxas': libs[b][1],
                'check': VARIANTS[b][2] if b in VARIANTS else 'plain',
                'asks': VARIANTS[b][3] if b in VARIANTS else 'the package',
                'rounds': [], 'errors': {}, 'ok': True} for b in builds}
    bytes_per = {'fwd': 8, 'fwd_train': 12, 'bwd': 16}
    rows[FWD]['bound_ms'] = {
        f: {s: bytes_per[f] * ins['x'].numel() / 3.35e9
            for s, ins in shapes.items()} for f in bytes_per}
    ref = {}
    with torch.inference_mode():
        for rnd in range(2):
            order = builds if rnd == 0 else builds[::-1]
            for b in order:
                times = {}
                for sname, ins in shapes.items():
                    got = _run(libs[b][0], ins)
                    for form, res in got.items():
                        times.setdefault(form, {})[sname] = {
                            'graph_ms': res['graph_ms'],
                            'events_ms': res['events_ms']}
                        if rnd:
                            continue
                        key = (form, sname)
                        if b in (FWD, BWD):
                            ref[key] = res['out']
                        check = rows[b]['check']
                        want = ([ins['dx']] if form == 'bwd' else
                                [ins['y'], ins['norm']][:len(res['out'])])
                        if check == 'plain':
                            errs = [_rel(o, w) for o, w in
                                    zip(res['out'], want)]
                            tol = TOL['lrn_backward' if form == 'bwd'
                                      else 'lrn_forward']
                            rows[b]['errors'][f'{form} {sname}'] = errs
                            rows[b]['ok'] &= all(e <= tol for e in errs)
                        elif check == 'bitwise':
                            eq = all(torch.equal(o, r) for o, r in
                                     zip(res['out'], ref[key]))
                            rows[b]['errors'][f'{form} {sname}'] = eq
                            rows[b]['ok'] &= eq
                for form in times:
                    times[form]['sum'] = {
                        k: sum(times[form][s][k] for s in shapes)
                        for k in ('graph_ms', 'events_ms')}
                rows[b]['rounds'].append(times)
                torch.cuda.empty_cache()
    rc = 0
    for b in builds:
        rc |= 0 if rows[b]['ok'] else 1
        print(json.dumps(rows[b]), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
