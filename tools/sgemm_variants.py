#!/usr/bin/env python3
"""Ablate the GEMM-shaped kernels of ``ops/csrc`` on one NVIDIA card: the
f32 tiles of ``sgemm_pipe.cuh`` and the weight-gradient GEMM, the bf16
builds of the forward GEMM and the conv on ``gemm_bf16.cuh``'s
tensor-core tile, and the bf16 builds of the backward GEMMs on
``gemm_wgmma.cuh``'s wgmma core.

    python3 tools/sgemm_variants.py [NAME ...]

Each NAME (default: all of VARIANTS) is a variant of this checkout's
``ops/csrc/fullc_gemm_nt.cu``, ``conv_bias_act.cu``, ``fullc_gemm_tn.cu``,
``fullc_gemm_bf16.cu``, ``conv_bias_act_bf16.cu``,
``fullc_gemm_nt_bf16.cu`` or ``fullc_gemm_tn_bf16.cu`` (and, where it
says so, of ``sgemm_pipe.cuh``) made by a few checked text edits (an edit that
no longer applies raises), or for ``tn_fma`` a whole other source.  All variants build in parallel
with the package's nvcc flags into ``ops/_build/variants/``; each is
then held to the plain version (max |err| / max |plain|, the smoke's
``TOL`` of 1e-4) and timed (CUDA events, two rounds) beside the
package's own kernel at AlexNet's batch-256 shapes: the input- and
weight-gradient GEMMs at fc6, fc7 and fc8, the conv (relu, bias) at
conv1-conv5; the bf16 variants in bf16 at the forward GEMM's fc6-fc8,
the conv's conv1-conv5 and the backward GEMMs' fc6-fc8 (input gradient
g @ w^T, weight gradient a^T @ g), held to one bf16 step of the plain
version (``bf16_excess`` <= 1, as ``chip_smoke.py``'s).  Variants marked
timing-only drop
part of the work (the FMAs, the copies or the stores) and are not
expected to agree.  One JSON line per variant: registers, stack frame
and spills of each compiled kernel from ``-Xptxas -v``, the errors, and
the milliseconds of each round per shape.

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

GEMMS = [('fc6', 256, 9216, 4096), ('fc7', 256, 4096, 4096),
         ('fc8', 256, 4096, 1000)]
# (name, x shape NHWC, kh, kw, cin_g, cout, stride, pad, groups)
CONVS = [('conv1', (256, 227, 227, 3), 11, 11, 3, 96, 4, 0, 1),
         ('conv2', (256, 27, 27, 96), 5, 5, 48, 256, 1, 2, 2),
         ('conv3', (256, 13, 13, 256), 3, 3, 256, 384, 1, 1, 1),
         ('conv4', (256, 13, 13, 384), 3, 3, 192, 384, 1, 1, 2),
         ('conv5', (256, 13, 13, 384), 3, 3, 192, 256, 1, 1, 2)]
TOL = 1e-4


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f'edit does not apply ({src.count(old)} matches, '
                         f'want {count}): {old[:70]!r}')
    return src.replace(old, new)


# ---- the input-gradient GEMM ------------------------------------------------

def nt_nobalance(files):
    """Split-K only to fill the resident slots (fc6's 288 tiles run
    unsplit, three blocks on some SMs and two on others)."""
    return {'sgemm_pipe.cuh': _sub(files['sgemm_pipe.cuh'],
                                   'SP_MAX_BALANCE = 4;',
                                   'SP_MAX_BALANCE = 1;')}


def _skew(files, cu, copies):
    """The staged left tile with 4 floats of skew every eight rows, so the
    four row groups a warp reads start on four bank quads (no gain if a
    128-bit load is served a quarter-warp at a time)."""
    pipe = _sub(files['sgemm_pipe.cuh'], 'SP_AFLOATS = SP_BM * SP_LDA;',
                'SP_AFLOATS = SP_BM * SP_LDA + (SP_BM / 8) * 4;')
    pipe = _sub(pipe, 'As + (ty * 8 + i) * SP_LDA +',
                'As + (ty * 8 + i) * SP_LDA + ty * 4 +', 2)
    return {'sgemm_pipe.cuh': pipe,
            cu: _sub(files[cu], 'As + r * SP_LDA',
                     'As + r * SP_LDA + (r >> 3) * 4', copies)}


def nt_skew(files):
    """The staged g tile skewed (see _skew)."""
    return _skew(files, 'fullc_gemm_nt.cu', 1)


def nt_lb2(files):
    """Launch bounds of two blocks an SM instead of three."""
    return {'fullc_gemm_nt.cu': _sub(
        files['fullc_gemm_nt.cu'], '__launch_bounds__(NT_THREADS, 3)',
        '__launch_bounds__(NT_THREADS, 2)')}


def nt_rolled(files):
    """The staging loops kept rolled (one copy an iteration)."""
    src = _sub(files['fullc_gemm_nt.cu'],
               '  for (int c = 0; c < SP_BM * SP_BK / W',
               '#pragma unroll 1\n  for (int c = 0; c < SP_BM * SP_BK / W')
    return {'fullc_gemm_nt.cu': _sub(
        src, '  for (int c = 0; c < NT_BN * SP_BK / W',
        '#pragma unroll 1\n  for (int c = 0; c < NT_BN * SP_BK / W')}


def nt_base(files):
    """The staging loops unrolled over one base pointer a thread and
    operand, each copy a constant number of rows further."""
    src = files['fullc_gemm_nt.cu']
    a = src.index('  const int t = threadIdx.x;\n  constexpr int W')
    b = src.index('// One (output tile, n range) block')
    return {'fullc_gemm_nt.cu': src[:a] + '''\
  const int t = threadIdx.x;
  constexpr int W = VEC ? 4 : 1;              // floats a copy
  constexpr int RSTEP = NT_THREADS / (SP_BK / W);
  const int r0 = t / (SP_BK / W), kc = (t % (SP_BK / W)) * W;
  const bool kok = n0 + kc < nend;
  const float* gp = g + (long long)(m0 + r0) * n + n0 + kc;
  const float* bp = b + (long long)(k0 + r0) * n + n0 + kc;
#pragma unroll
  for (int c = 0; c < SP_BM / RSTEP; ++c) {
    const bool ok = kok && m0 + r0 + c * RSTEP < m;
    sp_cp(As + (r0 + c * RSTEP) * SP_LDA + kc,
          ok ? gp + (long long)c * RSTEP * n : g, ok, 4 * W);
  }
#pragma unroll
  for (int c = 0; c < NT_BN / RSTEP; ++c) {
    const bool ok = kok && k0 + r0 + c * RSTEP < k;
    sp_cp(Bs + (r0 + c * RSTEP) * SP_LDA + kc,
          ok ? bp + (long long)c * RSTEP * n : b, ok, 4 * W);
  }
}

''' + src[b:]}


def nt_f2(files):
    """The slice product over pairs of the contraction (float2 loads, half
    the operand registers of float4)."""
    src = files['sgemm_pipe.cuh']
    a = src.index('__device__ __forceinline__ void sp_mma_nk(')
    b = src.index('__device__ __forceinline__ void sp_zero(')
    return {'sgemm_pipe.cuh': src[:a] + '''\
__device__ __forceinline__ void sp_mma_nk(const float* As, const float* Bs,
                                          int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < SP_BK; kk += 2) {
    float2 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float2*>(As + (ty * 8 + i) * SP_LDA +
                                               kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(
          Bs + (tx + 8 * j) * SP_LDA + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(av[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, b.y, acc[i][j]);
      }
    }
  }
}

''' + src[b:]}


# ---- the weight-gradient GEMM ----------------------------------------------

def tn_bk16(files):
    """16-deep slices of the batch (twice the barriers, half the staged
    bytes and of the B fragments held a slice)."""
    return {'fullc_gemm_tn.cu': _sub(files['fullc_gemm_tn.cu'],
                                     'TN_BK = 32;', 'TN_BK = 16;')}


def tn_n128(files):
    """128 x 128 tiles of eight warps, one block an SM: two thirds of the
    staged bytes a product, but no other block's products under a
    block's first copies and last stores."""
    src = _sub(files['fullc_gemm_tn.cu'], 'TN_BN = 64;', 'TN_BN = 128;')
    return {'fullc_gemm_tn.cu': _sub(src, '__launch_bounds__(TN_THREADS, 2)',
                                     '__launch_bounds__(TN_THREADS, 1)')}


_TN_FMA = r'''// The weight-gradient GEMM c (k, n) = a (m, k)^T g (m, n)
// on the FMA pipes: sgemm_pipe.cuh's ring and 8 x 8 thread tile, both
// operands staged batch-major as they lie (As[kk][row], Bs[kk][col]),
// as fullc_gemm.cu stages its b.  Full f32: no TF32.
#include "sgemm_pipe.cuh"

constexpr int TF_BN = 64, TF_NT = 128;
constexpr int TF_STAGE = SP_BK * (SP_BM + TF_BN);

template <int VEC>
__device__ __forceinline__ void tf_fma_stage(float* As, float* Bs,
                                             const float* __restrict__ a,
                                             const float* __restrict__ g,
                                             int m, int n, int k, int mb,
                                             int k0, int n0) {
#pragma unroll
  for (int c = 0; c < SP_BK * SP_BM / VEC / TF_NT; ++c) {
    const int i = threadIdx.x + c * TF_NT;
    const int r = i / (SP_BM / VEC), col = (i % (SP_BM / VEC)) * VEC;
    const bool ok = mb + r < m && k0 + col < k;
    sp_cp(As + r * SP_BM + col,
          ok ? a + (long long)(mb + r) * k + k0 + col : a, ok, 4 * VEC);
  }
#pragma unroll
  for (int c = 0; c < SP_BK * TF_BN / VEC / TF_NT; ++c) {
    const int i = threadIdx.x + c * TF_NT;
    const int r = i / (TF_BN / VEC), col = (i % (TF_BN / VEC)) * VEC;
    const bool ok = mb + r < m && n0 + col < n;
    sp_cp(Bs + r * TF_BN + col,
          ok ? g + (long long)(mb + r) * n + n0 + col : g, ok, 4 * VEC);
  }
}

template <int VEC>
__global__ void __launch_bounds__(TF_NT, 3)
tn_fma_kernel(const float* __restrict__ a, const float* __restrict__ g,
              float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float smem[SP_STAGES * TF_STAGE];
  const int k0 = blockIdx.x * SP_BM, n0 = blockIdx.y * TF_BN;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[8][8];
  sp_zero(acc);
  sp_mainloop(
      smem, TF_STAGE, (m + SP_BK - 1) / SP_BK,
      [&](float* st, int s) {
        tf_fma_stage<VEC>(st, st + SP_BK * SP_BM, a, g, m, n, k, s * SP_BK,
                          k0, n0);
      },
      [&](const float* st) {
        const float* Bs = st + SP_BK * SP_BM;
#pragma unroll
        for (int kk = 0; kk < SP_BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              st + kk * SP_BM + ty * 8);
          const float4 a1 = *reinterpret_cast<const float4*>(
              st + kk * SP_BM + ty * 8 + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(
              Bs + kk * TF_BN + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(
              Bs + kk * TF_BN + TF_BN / 2 + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      });
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + ty * 8 + i;
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : TF_BN / 2 + tx * 4 + j - 4);
      if (col < n) c[(long long)row * n + col] = acc[i][j];
    }
  }
}

extern "C" int fullc_gemm_tn_f32(const void* a, const void* g, void* c,
                                 int m, int n, int k, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const dim3 grid(sp_ceil(k, SP_BM), sp_ceil(n, TF_BN));
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   (((uintptr_t)a | (uintptr_t)g) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    tn_fma_kernel<4><<<grid, TF_NT, 0, st>>>((const float*)a,
                                             (const float*)g, (float*)c, m,
                                             n, k);
  else
    tn_fma_kernel<1><<<grid, TF_NT, 0, st>>>((const float*)a,
                                             (const float*)g, (float*)c, m,
                                             n, k);
  return (int)cudaGetLastError();
}
'''


def tn_fma(files):
    """The weight-gradient GEMM on the FMA pipes: sgemm_pipe.cuh's 8 x 8
    thread tile (128 x 64 a block of 128 threads), both operands staged
    batch-major as the forward GEMM stages its b, full f32 (the design
    the FMA pipes allow, and the yardstick for the tensor-core build)."""
    del files
    return {'fullc_gemm_tn.cu': _TN_FMA}


# ---- the conv ---------------------------------------------------------------

def conv_skew(files):
    """The staged patch tile skewed (see _skew)."""
    return _skew(files, 'conv_bias_act.cu', 2)


def conv_chunk4(files):
    """cin/g % 16 == 0 copied as 4-channel chunks, each thread decoding
    its own chunk's tap, instead of 16-deep tap runs decoded from the
    slice's start alone."""
    return {'conv_bias_act.cu': _sub(
        files['conv_bias_act.cu'],
        ': p.cin_g % 16 == 0 ? A_TAP16 : A_CHUNK4;', ': A_CHUNK4;')}


def conv_rowdecode(files):
    """Each patch element's offset from the pixel's image base and its
    input position, (iy * w + ix) * cin + c, instead of the row's
    top-left tap offset plus the slice column's tap offset."""
    src = files['conv_bias_act.cu']
    src = _sub(src, 'base = (ni * p.h * p.wd + (long long)iy0 * p.wd + ix0)'
               ' * p.cin +\n             (long long)g * p.cin_g;',
               'base = ni * p.h * p.wd * p.cin + (long long)g * p.cin_g;')
    src = _sub(src, """ok ? x + rbase[r] + off : x""",
               """ok ? x + rbase[r] + ((pos.x + u) * p.wd + pos.y + v) * p.cin
                + c : x""", 2)
    return {'conv_bias_act.cu': src}


def conv_lb2(files):
    """The 64-wide tile's launch bounds at two blocks an SM, not three."""
    return {'conv_bias_act.cu': _sub(files['conv_bias_act.cu'],
                                     'BN == 64 ? 3 : 2', '2')}


def conv_n64(files):
    """Always the 64-wide tile (conv1's 96 channels in a full and a
    half-empty tile)."""
    return {'conv_bias_act.cu': _sub(files['conv_bias_act.cu'],
                                     'return sp_ceil(p.cout_g, 96) * 96 <',
                                     'return false && sp_ceil(p.cout_g, 96) '
                                     '* 96 <')}


def conv_nofma(files):
    """Timing only: the copies, barriers and epilogue without the FMAs
    (the slice product sits behind a test that never passes)."""
    return {'conv_bias_act.cu': _sub(
        files['conv_bias_act.cu'],
        'sp_mma_kn<BN>(st, st + SP_AFLOATS, ty, tx, acc);',
        'if (acc[0][0] == 1234.5f)\n'
        '          sp_mma_kn<BN>(st, st + SP_AFLOATS, ty, tx, acc);')}


def conv_noepi(files):
    """Timing only: no output stores (the epilogue skips every row behind
    a test that always passes)."""
    return {'conv_bias_act.cu': _sub(
        files['conv_bias_act.cu'],
        '    if (m >= p.M) continue;\n#pragma unroll\n    for (int hf',
        '    if (m >= p.M || p.relu != 12345) continue;\n#pragma unroll\n'
        '    for (int hf')}


# ---- the bf16 builds (gemm_bf16.cuh's tensor-core tile) ---------------------

def _stages4(files, cu):
    """A four-stage ring: three slices' copies in flight, not two."""
    return {'sgemm_pipe.cuh': _sub(files['sgemm_pipe.cuh'], 'SP_STAGES = 3;',
                                   'SP_STAGES = 4;'),
            cu: files[cu]}


def cb_bk32(files):
    """The conv's K slices 32 deep, not 64."""
    return {'conv_bias_act_bf16.cu': _sub(files['conv_bias_act_bf16.cu'],
                                          'CB_BK = 64;', 'CB_BK = 32;')}


def cb_lb1(files):
    """The 128-wide conv tile at one block an SM (its registers
    unbounded), not two."""
    return {'conv_bias_act_bf16.cu': _sub(
        files['conv_bias_act_bf16.cu'], 'WN == 4 ? 2 : 6 / WN', '6 / WN')}


def cb_bk32_lb1(files):
    """cb_bk32 and cb_lb1: the first tensor-core build."""
    return cb_lb1(cb_bk32(files))


def cb_lb3(files):
    """The 96-wide conv tile at three blocks an SM (at most 113
    registers), not two."""
    return {'conv_bias_act_bf16.cu': _sub(
        files['conv_bias_act_bf16.cu'], 'WN == 4 ? 2 : 6 / WN',
        'WN == 4 ? 2 : WN == 3 ? 3 : 6 / WN')}


def cb_st4(files):
    """The conv's ring four slices deep."""
    return _stages4(files, 'conv_bias_act_bf16.cu')


def cb_sb1(files):
    """The 2-byte patch copies (conv1) one load before its store, not
    eight: each load waits for the store before it."""
    return {'conv_bias_act_bf16.cu': _sub(
        files['conv_bias_act_bf16.cu'], 'CB_SB = 8;', 'CB_SB = 1;')}


def cb_sb16(files):
    """The 2-byte patch copies sixteen loads before their stores."""
    return {'conv_bias_act_bf16.cu': _sub(
        files['conv_bias_act_bf16.cu'], 'CB_SB = 8;', 'CB_SB = 16;')}


def fb_st4(files):
    """The forward GEMM's ring four slices deep."""
    return _stages4(files, 'fullc_gemm_bf16.cu')


def fb_bk32(files):
    """The forward GEMM's k slices 32 deep, not 64."""
    return {'fullc_gemm_bf16.cu': _sub(files['fullc_gemm_bf16.cu'],
                                       'FB_BK = 64;', 'FB_BK = 32;')}


def fb_wn2(files):
    """A 128 x 64 tile of four warps, not 128 x 128 of eight."""
    return {'fullc_gemm_bf16.cu': _sub(files['fullc_gemm_bf16.cu'],
                                       'FB_WN = 4;', 'FB_WN = 2;')}


def fb_wn2_bk32(files):
    """fb_wn2 and fb_bk32: the first tensor-core build."""
    return fb_bk32(fb_wn2(files))


def fb_lb2(files):
    """Two blocks an SM (at most 128 registers), not one."""
    return {'fullc_gemm_bf16.cu': _sub(
        files['fullc_gemm_bf16.cu'],
        '__launch_bounds__(FB_THREADS, 6 / FB_WN)',
        '__launch_bounds__(FB_THREADS, 2)')}


def fb_minsl8(files):
    """Split-K ranges at least 8 slices deep, not 16 (more ranges)."""
    return {'sgemm_pipe.cuh': _sub(files['sgemm_pipe.cuh'],
                                   'SP_MIN_SLICES = 16;',
                                   'SP_MIN_SLICES = 8;')}


# ---- the bf16 backward GEMMs on wgmma ----------------------------------------

def _nb(files, old, new):
    return {'fullc_gemm_nt_bf16.cu': _sub(files['fullc_gemm_nt_bf16.cu'],
                                          old, new)}


def _tb(files, old, new):
    return {'fullc_gemm_tn_bf16.cu': _sub(files['fullc_gemm_tn_bf16.cu'],
                                          old, new)}


def nb_only128(files):
    """The input gradient's tile 128 x 128 at every shape (its best split
    for that tile), not the plan's choice of 128 or 144 columns."""
    return _nb(files, 'for (int bn : {128, 144})', 'for (int bn : {128})')


def nb_st3(files):
    """A three-stage ring (one slice copied ahead), not five."""
    return _nb(files, 'NB_STAGES = 5;', 'NB_STAGES = 3;')


def nb_st4(files):
    """A four-stage ring (two slices copied ahead)."""
    return _nb(files, 'NB_STAGES = 5;', 'NB_STAGES = 4;')


def _nb_splits(files, count):
    return _nb(files, 'for (int S = 1; S <= NB_MAX_SPLITS && S <= slices; '
               '++S) {', f'for (int S = min({count}, slices); S <= '
               f'min({count}, slices); ++S) {{')


def nb_s1(files):
    """The input gradient unsplit (one range a tile)."""
    return _nb_splits(files, 1)


def nb_s2(files):
    """Two ranges a tile, whatever the cost model says."""
    return _nb_splits(files, 2)


def nb_s3(files):
    """Three ranges a tile."""
    return _nb_splits(files, 3)


def nb_s4(files):
    """Four ranges a tile."""
    return _nb_splits(files, 4)


def nb_s8(files):
    """Eight ranges a tile."""
    return _nb_splits(files, 8)


def tb_bn128(files):
    """The weight gradient's tile 128 x 128 (m64n128k16), not 128 x 256."""
    return _tb(files, 'TB_BN = 256;', 'TB_BN = 128;')


def tb_bk64(files):
    """The weight gradient's slices 64 batch rows deep, three stages."""
    src = _tb(files, 'TB_BK = 32;', 'TB_BK = 64;')
    return _tb(src, 'TB_STAGES = 6;', 'TB_STAGES = 3;')


def tb_st4(files):
    """A four-stage ring (two slices copied ahead), not six."""
    return _tb(files, 'TB_STAGES = 6;', 'TB_STAGES = 4;')


def tb_bn128_2blk(files):
    """The weight gradient's tile 128 x 128 in a four-stage ring, two
    blocks an SM: one block's epilogue runs under the other's products."""
    src = _tb(files, 'TB_BN = 256;', 'TB_BN = 128;')
    src = _tb(src, 'TB_STAGES = 6;', 'TB_STAGES = 4;')
    src = _tb(src, '__launch_bounds__(TB_THREADS, 1)',
              '__launch_bounds__(TB_THREADS, 2)')
    return _tb(src, 'tiles < sms[dev].load() ? tiles : sms[dev].load()',
               'tiles < 2 * sms[dev].load() ? tiles : 2 * sms[dev].load()')


def tb_onetile(files):
    """One tile a block (grid = tiles), not a persistent walk."""
    return _tb(files, 'tiles < sms[dev].load() ? tiles : sms[dev].load()',
               'tiles')


def nb_nocopy(files):
    """Timing only: the input gradient's products, barriers and epilogue
    without the main loop's copies (the prologue's slices are reused)."""
    return _nb(files, 'if (j + NB_AHEAD < nk) stage(j + NB_AHEAD);',
               'if (j < 0) stage(j + NB_AHEAD);')


def nb_nomma(files):
    """Timing only: the input gradient's copies and barriers without the
    products."""
    return _nb(files, 'for (int kk = 0; kk < NB_BK / 16; ++kk)',
               'for (int kk = 0; kk < 0; ++kk)')


def tb_nocopy(files):
    """Timing only: the weight gradient without the main loop's copies."""
    return _tb(files, 'if (q + TB_AHEAD < total) stage(q + TB_AHEAD);',
               'if (q < 0) stage(q + TB_AHEAD);')


def tb_nomma(files):
    """Timing only: the weight gradient without the products."""
    return _tb(files, 'for (int kk = 0; kk < TB_BK / 16; ++kk)',
               'for (int kk = 0; kk < 0; ++kk)')


def tb_noepi(files):
    """Timing only: the weight gradient without its epilogue (no
    rounding, staging or stores)."""
    return _tb(tb_nostore(files), 'for (int h = 0; h < 2; ++h) {\n'
               '      gw_bf16* crow', 'for (int h = 0; h < 0; ++h) {\n'
               '      gw_bf16* crow')


def tb_mmaonly(files):
    """Timing only: the weight gradient's products and barriers, without
    a's copies or the epilogue."""
    return tb_noepi(tb_nocopy(files))


def tb_mmaonly_nobar(files):
    """Timing only: the products alone (tb_mmaonly without the ring's
    waits and barriers)."""
    src = _tb(tb_mmaonly(files), '      fw_cp_wait<TB_AHEAD - 1>();', '')
    return _tb(src, "      __syncthreads();             // everyone's; slice "
               "q - 2's products done\n", '')


def tb_nostore(files):
    """Timing only: the weight gradient without its global stores."""
    return _tb(files, 'if (row >= k || col >= n) continue;',
               'if (row >= 0) continue;')


def conv_nocopy(files):
    """Timing only: the FMAs, barriers and epilogue without the copies
    (the staging sits behind a test that never passes)."""
    return {'conv_bias_act.cu': _sub(
        files['conv_bias_act.cu'],
        'conv_stage<BN, AMODE>(st, st + SP_AFLOATS',
        'if (s < 0) conv_stage<BN, AMODE>(st, st + SP_AFLOATS')}


#: name -> (library, edit, timing only)
VARIANTS = {
    'nt_rolled': ('fullc_gemm_nt', nt_rolled, False),
    'nt_lb2': ('fullc_gemm_nt', nt_lb2, False),
    'nt_base': ('fullc_gemm_nt', nt_base, False),
    'nt_f2': ('fullc_gemm_nt', nt_f2, False),
    'nt_nobalance': ('fullc_gemm_nt', nt_nobalance, False),
    'nt_skew': ('fullc_gemm_nt', nt_skew, False),
    'tn_fma': ('fullc_gemm_tn', tn_fma, False),
    'tn_bk16': ('fullc_gemm_tn', tn_bk16, False),
    'tn_n128': ('fullc_gemm_tn', tn_n128, False),
    'conv_n64': ('conv_bias_act', conv_n64, False),
    'conv_lb2': ('conv_bias_act', conv_lb2, False),
    'conv_skew': ('conv_bias_act', conv_skew, False),
    'conv_chunk4': ('conv_bias_act', conv_chunk4, False),
    'conv_rowdecode': ('conv_bias_act', conv_rowdecode, False),
    'conv_nofma': ('conv_bias_act', conv_nofma, True),
    'conv_nocopy': ('conv_bias_act', conv_nocopy, True),
    'conv_noepi': ('conv_bias_act', conv_noepi, True),
    'cb_bk32': ('conv_bias_act_bf16', cb_bk32, False),
    'cb_lb1': ('conv_bias_act_bf16', cb_lb1, False),
    'cb_bk32_lb1': ('conv_bias_act_bf16', cb_bk32_lb1, False),
    'cb_lb3': ('conv_bias_act_bf16', cb_lb3, False),
    'cb_sb1': ('conv_bias_act_bf16', cb_sb1, False),
    'cb_sb16': ('conv_bias_act_bf16', cb_sb16, False),
    'cb_st4': ('conv_bias_act_bf16', cb_st4, False),
    'fb_st4': ('fullc_gemm_bf16', fb_st4, False),
    'fb_bk32': ('fullc_gemm_bf16', fb_bk32, False),
    'fb_wn2': ('fullc_gemm_bf16', fb_wn2, False),
    'fb_wn2_bk32': ('fullc_gemm_bf16', fb_wn2_bk32, False),
    'fb_lb2': ('fullc_gemm_bf16', fb_lb2, False),
    'fb_minsl8': ('fullc_gemm_bf16', fb_minsl8, False),
    'nb_only128': ('fullc_gemm_nt_bf16', nb_only128, False),
    'nb_st3': ('fullc_gemm_nt_bf16', nb_st3, False),
    'nb_st4': ('fullc_gemm_nt_bf16', nb_st4, False),
    'nb_s1': ('fullc_gemm_nt_bf16', nb_s1, False),
    'nb_s2': ('fullc_gemm_nt_bf16', nb_s2, False),
    'nb_s3': ('fullc_gemm_nt_bf16', nb_s3, False),
    'nb_s4': ('fullc_gemm_nt_bf16', nb_s4, False),
    'nb_s8': ('fullc_gemm_nt_bf16', nb_s8, False),
    'tb_bn128': ('fullc_gemm_tn_bf16', tb_bn128, False),
    'tb_bk64': ('fullc_gemm_tn_bf16', tb_bk64, False),
    'tb_st4': ('fullc_gemm_tn_bf16', tb_st4, False),
    'tb_bn128_2blk': ('fullc_gemm_tn_bf16', tb_bn128_2blk, False),
    'tb_onetile': ('fullc_gemm_tn_bf16', tb_onetile, False),
    'nb_nocopy': ('fullc_gemm_nt_bf16', nb_nocopy, True),
    'nb_nomma': ('fullc_gemm_nt_bf16', nb_nomma, True),
    'tb_nocopy': ('fullc_gemm_tn_bf16', tb_nocopy, True),
    'tb_nomma': ('fullc_gemm_tn_bf16', tb_nomma, True),
    'tb_nostore': ('fullc_gemm_tn_bf16', tb_nostore, True),
    'tb_noepi': ('fullc_gemm_tn_bf16', tb_noepi, True),
    'tb_mmaonly': ('fullc_gemm_tn_bf16', tb_mmaonly, True),
    'tb_mmaonly_nobar': ('fullc_gemm_tn_bf16', tb_mmaonly_nobar, True),
}
#: the libraries the variants are of, each timed beside the package's own
LIBS = ('fullc_gemm_nt', 'fullc_gemm_tn', 'conv_bias_act', 'fullc_gemm_bf16',
        'conv_bias_act_bf16', 'fullc_gemm_nt_bf16', 'fullc_gemm_tn_bf16')


def _ptxas(log: str):
    """{kernel: [registers, stack frame, spill stores]} of every entry."""
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, None, None]
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores',
                      line)
        if m and fn:
            out[fn][1:] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


def build(names):
    """Generate and compile the variants; {name: (library, ptxas)} with
    the package's own libraries as ``<lib>_package``."""
    from cxxnet_tpu_torch.ops import build as B
    procs = {}
    for name in names:
        lib, edit, _ = VARIANTS[name]
        files = {}
        for fn in (B.SOURCES[lib], 'sgemm_pipe.cuh', 'gemm_bf16.cuh',
                   'gemm_wgmma.cuh'):
            with open(os.path.join(B.CSRC, fn)) as f:
                files[fn] = f.read()
        out_dir = os.path.join(B.BUILD_DIR, 'variants', name)
        os.makedirs(out_dir, exist_ok=True)
        files.update(edit(files))
        for fn, text in files.items():
            with open(os.path.join(out_dir, fn), 'w') as f:
                f.write(text)
        so = os.path.join(out_dir, f'lib{name}.so')
        cmd = [B.find_nvcc(), *B.NVCC_FLAGS, '-I', B.CSRC, '-o', so,
               os.path.join(out_dir, B.SOURCES[lib])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    B.build_all()
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name} failed to build:\n{log[-4000:]}')
        libs[name] = (ctypes.CDLL(so), _ptxas(log))
    for lib in LIBS:
        libs[f'{lib}_package'] = (
            ctypes.CDLL(B._lib_path(lib)), _ptxas(B.build_log(lib)))
    return libs


def _bind(lib, key):
    """The C entry ``key`` of :data:`build.SIGNATURES` in ``lib``."""
    from cxxnet_tpu_torch.ops import build as B
    fn = getattr(lib, B.SIGNATURES[key][1])
    fn.argtypes, fn.restype = B.SIGNATURES[key][2], ctypes.c_int
    return fn


def _time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _bf16_excess(got, ref):
    """max |got - ref| / (2^-7 |ref| + 1e-3 mean |ref|): one bf16 step."""
    got, ref = got.float(), ref.float()
    lim = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().mean()
    return ((got - ref).abs() / lim).max().item()


def _gemm_bf16_runs(libs, gen, res):
    import torch
    from cxxnet_tpu_torch.ops.kernels import fullc_gemm_plain
    stream = torch.cuda.current_stream().cuda_stream
    for shape, m, nin, nout in GEMMS:
        a = torch.randn((m, nin), device='cuda', generator=gen).bfloat16()
        w = (torch.randn((nin, nout), device='cuda', generator=gen)
             * nin ** -0.5).bfloat16()
        ref = fullc_gemm_plain(a, w)
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                fn = _bind(lib, 'fullc_gemm_bf16')
                splits = _bind(lib, 'fullc_gemm_bf16_splits')(m, nout, nin)
                c = torch.empty((m, nout), device='cuda',
                                dtype=torch.bfloat16)
                ws = torch.empty((splits, m, nout), device='cuda')

                def run():
                    err = fn(a.data_ptr(), w.data_ptr(), c.data_ptr(),
                             ws.data_ptr(), m, nout, nin, splits, stream)
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(run, 20))
                if rnd == 0:
                    run()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_bf16_excess'] = _bf16_excess(c, ref)
                    res[name][f'{shape}_splits'] = splits
        del a, w, ref


def _conv_bf16_runs(libs, gen, res):
    import torch
    from cxxnet_tpu_torch.ops.cnn import _out_size, conv_bias_act_plain
    stream = torch.cuda.current_stream().cuda_stream
    for shape, xs, kh, kw, cin_g, cout, s, p, groups in CONVS:
        x = torch.randn(xs, device='cuda', generator=gen).bfloat16()
        w = (torch.randn((kh, kw, cin_g, cout), device='cuda', generator=gen)
             * (kh * kw * cin_g) ** -0.5).bfloat16()
        b = (torch.randn((cout,), device='cuda', generator=gen)
             * 0.1).bfloat16()
        pad = ((p, p), (p, p))
        ref = conv_bias_act_plain(x, w, b, (s, s), pad, groups, 'relu')[0]
        n, h, wd, cin = xs
        oy, ox = _out_size(h, wd, kh, kw, (s, s), pad)
        y = torch.empty((n, oy, ox, cout), device='cuda',
                        dtype=torch.bfloat16)
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                fn = _bind(lib, 'conv_bias_act_bf16')

                def run():
                    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), None, n, h, wd, cin, kh, kw,
                             cout, groups, s, s, p, p, oy, ox, 1, stream)
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(run, 10))
                if rnd == 0:
                    run()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_bf16_excess'] = _bf16_excess(y, ref)
        del x, w, b, ref, y
        torch.cuda.empty_cache()


def _bwd_bf16_runs(libs, gen, res):
    """The input gradient (leg ``nt``) or the weight gradient (``tn``) in
    bf16 at fc6-fc8, by the C entries of each library in ``libs``."""
    import torch
    from cxxnet_tpu_torch.ops.kernels import (fullc_gemm_nt_plain,
                                              fullc_gemm_tn_plain)
    stream = torch.cuda.current_stream().cuda_stream
    nt = 'fullc_gemm_nt_bf16_package' in libs
    for shape, m, nin, nout in GEMMS:
        a = torch.randn((m, nin), device='cuda', generator=gen).bfloat16()
        w = (torch.randn((nin, nout), device='cuda', generator=gen)
             * nout ** -0.5).bfloat16()
        g = torch.randn((m, nout), device='cuda', generator=gen).bfloat16()
        ref = fullc_gemm_nt_plain(g, w) if nt else fullc_gemm_tn_plain(a, g)
        c = torch.empty_like(ref)
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                if nt:
                    fn = _bind(lib, 'fullc_gemm_nt_bf16')
                    splits = _bind(lib, 'fullc_gemm_nt_bf16_splits')(
                        m, nout, nin)

                    def run():
                        return fn(g.data_ptr(), w.data_ptr(), c.data_ptr(),
                                  None, m, nout, nin, splits, stream)
                    res[name][f'{shape}_splits'] = splits
                else:
                    fn = _bind(lib, 'fullc_gemm_tn_bf16')

                    def run():
                        return fn(a.data_ptr(), g.data_ptr(), c.data_ptr(),
                                  m, nout, nin, stream)

                def checked():
                    err = run()
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(checked, 20))
                if rnd == 0:
                    checked()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_bf16_excess'] = _bf16_excess(c, ref)
        del a, w, g, ref, c
        torch.cuda.empty_cache()


def _nt_runs(libs, gen, res):
    import torch
    from cxxnet_tpu_torch.ops.kernels import fullc_gemm_nt_plain
    stream = torch.cuda.current_stream().cuda_stream
    for shape, m, nin, nout in GEMMS:
        g = torch.randn((m, nout), device='cuda', generator=gen)
        w = torch.randn((nin, nout), device='cuda', generator=gen)
        ref = fullc_gemm_nt_plain(g, w)
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                fn = _bind(lib, 'fullc_gemm_nt')
                splits = _bind(lib, 'fullc_gemm_nt_splits')(m, nout, nin)
                c = torch.empty((m, nin), device='cuda')
                ws = torch.empty((splits, m, nin), device='cuda')

                def run():
                    err = fn(g.data_ptr(), w.data_ptr(), c.data_ptr(),
                             ws.data_ptr(), m, nout, nin, splits, stream)
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(run, 20))
                if rnd == 0:
                    run()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_rel_err'] = _rel(c, ref)
                    res[name][f'{shape}_splits'] = splits
        del g, w, ref


def _tn_runs(libs, gen, res):
    import torch
    from cxxnet_tpu_torch.ops.kernels import fullc_gemm_tn_plain
    stream = torch.cuda.current_stream().cuda_stream
    for shape, m, nin, nout in GEMMS:
        a = torch.randn((m, nin), device='cuda', generator=gen)
        g = torch.randn((m, nout), device='cuda', generator=gen)
        ref = fullc_gemm_tn_plain(a, g)
        c = torch.empty((nin, nout), device='cuda')
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                fn = _bind(lib, 'fullc_gemm_tn')

                def run():
                    err = fn(a.data_ptr(), g.data_ptr(), c.data_ptr(), m,
                             nout, nin, stream)
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(run, 20))
                if rnd == 0:
                    run()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_rel_err'] = _rel(c, ref)
        del a, g, ref, c


def _conv_runs(libs, gen, res):
    import torch
    from cxxnet_tpu_torch.ops.cnn import _out_size, conv_bias_act_plain
    stream = torch.cuda.current_stream().cuda_stream
    for shape, xs, kh, kw, cin_g, cout, s, p, groups in CONVS:
        x = torch.randn(xs, device='cuda', generator=gen)
        w = torch.randn((kh, kw, cin_g, cout), device='cuda',
                        generator=gen) * (kh * kw * cin_g) ** -0.5
        b = torch.randn((cout,), device='cuda', generator=gen) * 0.1
        pad = ((p, p), (p, p))
        ref = conv_bias_act_plain(x, w, b, (s, s), pad, groups, 'relu')[0]
        n, h, wd, cin = xs
        oy, ox = _out_size(h, wd, kh, kw, (s, s), pad)
        y = torch.empty((n, oy, ox, cout), device='cuda')
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                fn = _bind(lib, 'conv_bias_act')

                def run():
                    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), None, n, h, wd, cin, kh, kw,
                             cout, groups, s, s, p, p, oy, ox, 1, stream)
                    if err:
                        raise RuntimeError(f'{name}: cudaError_t {err}')
                res[name].setdefault(f'{shape}_ms', []).append(
                    _time_ms(run, 5))
                if rnd == 0:
                    run()
                    torch.cuda.synchronize()
                    res[name][f'{shape}_rel_err'] = _rel(y, ref)
        del x, w, b, ref, y
        torch.cuda.empty_cache()


def main(argv) -> int:
    import torch
    names = argv or list(VARIANTS)
    libs = build(names)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(5)
    res = {name: {'ptxas': p} for name, (_, p) in libs.items()}
    with torch.no_grad():
        for lib, runs in (('fullc_gemm_nt', _nt_runs),
                          ('fullc_gemm_tn', _tn_runs),
                          ('conv_bias_act', _conv_runs),
                          ('fullc_gemm_bf16', _gemm_bf16_runs),
                          ('conv_bias_act_bf16', _conv_bf16_runs),
                          ('fullc_gemm_nt_bf16', _bwd_bf16_runs),
                          ('fullc_gemm_tn_bf16', _bwd_bf16_runs)):
            group = {name: v for name, v in libs.items()
                     if name == f'{lib}_package'
                     or VARIANTS.get(name, ('',))[0] == lib}
            if len(group) > 1:
                runs(group, gen, res)
    for name, r in res.items():
        timing_only = VARIANTS[name][2] if name in VARIANTS else False
        errs = [v for k, v in r.items() if k.endswith('_rel_err')]
        steps = [v for k, v in r.items() if k.endswith('_bf16_excess')]
        print(json.dumps({'variant': name, 'nvidia_smi': smi,
                          'timing_only': timing_only,
                          'within_tol': all(e <= TOL for e in errs)
                          and all(e <= 1.0 for e in steps),
                          **r}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
