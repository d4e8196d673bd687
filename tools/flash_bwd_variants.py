#!/usr/bin/env python3
"""Ablate the flash-attention backward kernels, and the f32 forward, on
one NVIDIA card.

    python3 tools/flash_bwd_variants.py [NAME ...]

Each NAME (default: all of VARIANTS and the three probes below) is a
variant of this checkout's ``ops/csrc/flash_dq.cu``, ``flash_dkv.cu`` or
(``f32_fwd_*``) ``flash_fwd.cu`` (and, for some f32 variants, of
``flash_tf32.cuh``) made by a few
checked text edits (an edit that no longer applies raises).  All
variants build in parallel with the package's nvcc flags into
``ops/_build/variants/``, one directory each, and run beside the
package's own kernels, two rounds:

* bf16 variants: held element by element to one bf16 step of the plain
  version at b1 h8 s2048 d64 causal and timed (CUDA events) at s2048 and
  s32768;
* f32 variants (``f32_*``): held to the plain version (max |err| / max
  |plain| of each output; the smoke's tolerance is 1e-4), launched twice
  (bitwise equal) and timed at the seqpar path's b1 h16 s8192 d64
  causal; the forward's beside the package's f32 forward.

Variants marked timing-only drop part of the arithmetic and are not
expected to pass.  ``tf32_probe`` runs one mma.sync on a raw f32
register whose low 13 bits are set and says whether the tensor cores
read it truncated or rounded; ``mma_peak`` times back-to-back mma.sync
m16n8k8 TF32 products alone and ``wgmma_peak`` wgmma m64n64k8 TF32
products alone, both operands from shared memory or A from registers
(TFLOP/s at 8 and 16 warps an SM).  One JSON line per variant: registers,
stack frame and spills from ``-Xptxas -v``, the error, and the
milliseconds of each round.

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


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f'edit does not apply ({src.count(old)} matches, '
                         f'want {count}): {old[:70]!r}')
    return src.replace(old, new)


def _between(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``new``."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


# ---- dq ---------------------------------------------------------------------

def dq_whole(src):
    """ds over the whole 64-key tile, then one batch of dQ products (the
    first design: no overlap of the products with the ds arithmetic)."""
    return _between(src, '    fw_pin(acc);\n#pragma unroll\n    for (int hf',
                    '    fw_wait<0>();\n    fw_pin(acc);', '''\
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (edge)
        dq_ds<true>(s, dp, hf, nl, dl, k0, sk, causal, ra, t, scale_log2);
      else
        dq_ds<false>(s, dp, hf, nl, dl, k0, sk, causal, ra, t, scale_log2);
    }
    fw_split(s, hi, lo);
    fw_pin(acc);
    fw_pin(hi);
    fw_pin(lo);
    fw_fence();
#pragma unroll
    for (int kb = 0; kb < NS / 8; ++kb) {
      fw_pv<DP>(acc, hi[kb], dkn + kb * 2 * DP);
      fw_pv<DP>(acc, lo[kb], dkn + kb * 2 * DP);
    }
    fw_commit();
''')


def dq_nolo(src):
    """Timing only: the lo halves of ds are not multiplied."""
    return _sub(src, '        fw_pv<DP>(acc, lo[kb], dkn + kb * 2 * DP);\n',
                '')


def _dq_groups(src, groups, stages, min_blocks):
    src = _sub(src, 'constexpr int DQ_GROUPS = 2;',
               f'constexpr int DQ_GROUPS = {groups};')
    src = _sub(src, 'constexpr int DQ_STAGES = 4;',
               f'constexpr int DQ_STAGES = {stages};')
    return _sub(src, '__launch_bounds__(DQ_THREADS, DP <= 64 ? 2 : 1)',
                f'__launch_bounds__(DQ_THREADS, DP <= 64 ? {min_blocks} : 1)')


def dq_wg1(src):
    """One warpgroup (64 query rows) a block, three blocks an SM."""
    return _dq_groups(src, 1, 3, 3)


def dq_g4(src):
    """Four warpgroups (256 query rows) a block, one block an SM: each K /
    V tile copied from L2 serves twice the rows (the first 256 threads
    copy)."""
    src = _dq_groups(src, 4, 4, 1)
    src = _sub(src, 'const FwTilePlan<DP, DQ_THREADS> plan(d);',
               'const FwTilePlan<DP, 256> plan(d);')
    src = _sub(src,
               '      plan.copy(ks_addr + nb * TBYTES, kb, j * DQ_KT, sk, d);\n'
               '      plan.copy(vs_addr + nb * TBYTES, vb, j * DQ_KT, sk, d);',
               '''      if (threadIdx.x < 256) {
        plan.copy(ks_addr + nb * TBYTES, kb, j * DQ_KT, sk, d);
        plan.copy(vs_addr + nb * TBYTES, vb, j * DQ_KT, sk, d);
      }''')
    return _sub(src, '    for (int h = 0; h < DQ_GROUPS; ++h) {',
                '    for (int h = 0; h < DQ_GROUPS; ++h)\n'
                '      if (threadIdx.x < 256) {')


# ---- dk / dv ----------------------------------------------------------------

_DKV_SERIAL = '''\
    fw_pin(s);
    fw_pin(dp);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss<NQ>(s, dka + kk * 16, dqk + kk * 16, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss<NQ>(dp, dva + kk * 16, dok + kk * 16, kk > 0);
    fw_commit();
    fw_wait<0>();
    fw_pin(s);
    fw_pin(dp);
    if (q0 + NQ > sq || (causal && q0 < kw + 63))
      dkv_p<true>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    else
      dkv_p<false>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    fw_split(s, ph, pl);
    fw_pin(dva_acc);
    fw_pin(ph);
    fw_pin(pl);
    fw_fence();
    const uint64_t dqn = fw_desc(qs_addr + buf * TBYTES, DP * 16, 128);
    const uint64_t don = fw_desc(os_addr + buf * TBYTES, DP * 16, 128);
#pragma unroll
    for (int kb = 0; kb < NS / 8; ++kb) {
      fw_pv<DP>(dva_acc, ph[kb], don + kb * 2 * DP);
      fw_pv<DP>(dva_acc, pl[kb], don + kb * 2 * DP);
    }
    fw_commit();
    dkv_ds(s, dp, lse_s + NQ, t);      // while dV's products run
    fw_split(dp, sh, sl);
    fw_pin(dka_acc);
    fw_pin(sh);
    fw_pin(sl);
    fw_fence();
#pragma unroll
    for (int kb = 0; kb < NS / 8; ++kb) {
      fw_pv<DP>(dka_acc, sh[kb], dqn + kb * 2 * DP);
      fw_pv<DP>(dka_acc, sl[kb], dqn + kb * 2 * DP);
    }
    fw_commit();
    fw_wait<0>();
    fw_pin(dva_acc);
    fw_pin(dka_acc);
    fw_pin(ph);
    fw_pin(pl);
    fw_pin(sh);
    fw_pin(sl);
  }
'''


def dkv_serial(src):
    """The first design: each tile's dV and dK products end within the
    tile (dV's run while ds is formed); no overlap across tiles."""
    return _between(src,
                    '    fw_pin(s);\n    fw_pin(dp);\n    fw_pin(dka_acc);',
                    '  fw_cp_wait<0>();', _DKV_SERIAL)


def dkv_noew(src):
    """Timing only: no p / ds arithmetic (products, splits and copies)."""
    src = _sub(src, '''    if (q0 + NQ > sq || (causal && q0 < kw + 63))
      dkv_p<true>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    else
      dkv_p<false>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    dkv_ds(s, dp, lse_s + NQ, t);
''', '')
    return src


def dkv_nolo(src):
    """Timing only: the lo halves of p and ds are not multiplied."""
    src = _sub(src, '    fw_pv<DP>(dv, pl[kb], don + kb * 2 * DP);\n', '')
    return _sub(src, '    fw_pv<DP>(dk, sl[kb], dqn + kb * 2 * DP);\n', '')


def _dkv_shape(src, groups, nq, min_blocks):
    src = _sub(src, 'constexpr int DKV_GROUPS = 2;',
               f'constexpr int DKV_GROUPS = {groups};')
    src = _sub(src, '__launch_bounds__(DKV_THREADS, 1)',
               f'__launch_bounds__(DKV_THREADS, {min_blocks})')
    if nq:
        src = _sub(src, 'constexpr int NQ = DP <= 64 ? 64 : 32;',
                   f'constexpr int NQ = DP <= 32 ? 64 : {nq};', 2)
    if groups == 3:            # copies by the first 256 threads
        src = _sub(src, 'const FwTilePlan<DP, DKV_THREADS, NQ> plan(d);',
                   'const FwTilePlan<DP, 256, NQ> plan(d);')
        src = _sub(src, 'const FwTilePlan<DP, DKV_THREADS> kplan(d);',
                   'const FwTilePlan<DP, 256> kplan(d);')
        src = _sub(src,
                   '      plan.copy(qs_addr + nb * TBYTES, qb, r0, sq, d);\n'
                   '      plan.copy(os_addr + nb * TBYTES, ob, r0, sq, d);',
                   '''      if (threadIdx.x < 256) {
        plan.copy(qs_addr + nb * TBYTES, qb, r0, sq, d);
        plan.copy(os_addr + nb * TBYTES, ob, r0, sq, d);
      }''')
        src = _sub(src, '    for (int h = 0; h < DKV_GROUPS; ++h) {',
                   '    for (int h = 0; h < DKV_GROUPS; ++h)\n'
                   '      if (threadIdx.x < 256) {')
    return src


def dkv_wg1(src):
    """One warpgroup (64 keys) a block, two blocks an SM."""
    return _dkv_shape(src, 1, None, 2)


def dkv_g3n32(src):
    """Three warpgroups (192 keys) a block, 32-query tiles."""
    return _dkv_shape(dkv_serial(src), 3, 32, 1)


def dkv_n32x2(src):
    """32-query tiles at two blocks an SM (128 registers: spills)."""
    return _dkv_shape(dkv_serial(src), 2, 32, 2)


# ---- f32 (3xTF32 on mma.sync) ------------------------------------------------

def hdr_1x(hdr):
    """Timing only: one TF32 product a term (hi x hi), no split terms."""
    return _sub(hdr, '''  tf_mma(d, al, b.h0, b.h1);
  tf_mma(d, ah, b.l0, b.l1);
  tf_mma(d, ah, b.h0, b.h1);''', '''  tf_mma(d, ah, b.h0, b.h1);''')


def hdr_rn(hdr):
    """hi = tf32_rn(x), lo = tf32_rn(x - hi) by cvt.rna.tf32.f32: both parts
    exact TF32 values, whatever the tensor cores do with low bits."""
    return _sub(hdr, '''  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));''', '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)
      : "f"(x - __uint_as_float(hi)));''')


def hdr_nolo(hdr):
    """Timing only: lo = 0 (the three products stay, the split's
    instructions go)."""
    return _sub(hdr, '''  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));''',
                '''  hi = __float_as_uint(x);
  lo = 0u;''')


def f32_dq_m1(src):
    """One 16-row fragment a warp at every d (128 rows a block)."""
    return _sub(src, 'static constexpr int MT = DP <= 64 ? 2 : 1;',
                'static constexpr int MT = 1;')


def f32_dq_kt64(src):
    """64-key K / V tiles in two buffers up to d = 64 (three would pass
    227 KB); dQ's split dS then takes 128 registers."""
    src = _sub(src, 'static constexpr int KT = 32;',
               'static constexpr int KT = DP <= 64 ? 64 : 32;')
    return _sub(src, 'static constexpr int STAGES = DP <= 64 ? 3 : 2;',
                'static constexpr int STAGES = 2;')


def f32_dq_dmajor(src):
    """A d-major copy of each K tile (keys contiguous, rows of KT + 8),
    written after the tile's barrier, behind a second barrier: dQ's B
    fragments become one 8-byte load each instead of two 4-byte ones
    (with hdr_dmajor)."""
    src = _sub(src, '''      (size_t)(2 * BM + 2 * STAGES * KT) * (DP + 4) * sizeof(float);''',
               '''      (size_t)(2 * BM + 2 * STAGES * KT) * (DP + 4) * sizeof(float) +
      (size_t)DP * (KT + 8) * sizeof(float);''')
    src = _sub(src, '''  float* Vs = Ks + NST * KT * LD;
''', '''  float* Vs = Ks + NST * KT * LD;
  float* KTs = Vs + NST * KT * LD;     // DP x (KT + 8), keys contiguous
''')
    src = _sub(src, '''    fw_cp_commit();
    if (causal && k0 > row_hi) continue;   // wholly above the diagonal
''', '''    fw_cp_commit();
    for (int i = threadIdx.x; i < KT * DP; i += TF_THREADS) {
      const int key = i / DP, c = i - key * DP;
      KTs[c * (KT + 8) + key] = Ks[buf * KT * LD + key * LD + c];
    }
    __syncthreads();
    if (causal && k0 > row_hi) continue;   // wholly above the diagonal
''')
    return _sub(src, 'tf_grad<LD>(acc, s, Kt, t, g);',
                'tf_grad<KT + 8>(acc, s, KTs, t, g);')


def hdr_dmajor(hdr):
    """tf_grad's B fragments from a d-major tile (rows of LD keys): one
    8-byte load a fragment."""
    return _sub(hdr, '''      const TfB b = tf_load_bn<LD>(W, 8 * j + 2 * t, 8 * n + g);''',
                '''      const float2 x = *reinterpret_cast<const float2*>(
          W + (8 * n + g) * LD + 8 * j + 2 * t);
      TfB b;
      tf_split(x.x, b.h0, b.l0);
      tf_split(x.y, b.h1, b.l1);''')


def f32_dkv_qt32(src):
    """32-query Q / dO tiles up to d = 64."""
    return _sub(src, 'static constexpr int QT = DP <= 64 ? 64 : 16;',
                'static constexpr int QT = DP <= 64 ? 32 : 16;')


def f32_fwd_kt32(src):
    """32-key K / V tiles in three buffers (the score tile and P's split
    take half the registers of 64-key ones)."""
    src = _sub(src, 'static constexpr int KT = 64;',
               'static constexpr int KT = 32;')
    return _sub(src, 'static constexpr int STAGES = 2;',
                'static constexpr int STAGES = 3;')



def f32_fwd_m1(src):
    """One 16-row fragment a warp at every d (128 query rows a block)."""
    return _sub(src, 'static constexpr int MT = DP <= 64 ? 2 : 1;',
                'static constexpr int MT = 1;')


def f32_dkv_x2(src):
    """32-query tiles in two buffers and two blocks an SM (<= 128
    registers)."""
    src = _sub(src, 'static constexpr int STAGES = 3;',
               'static constexpr int STAGES = 2;')
    src = f32_dkv_qt32(src)
    return _sub(src, '__launch_bounds__(TF_THREADS, 1)\nflash_dkv_kernel',
                '__launch_bounds__(TF_THREADS, DP <= 64 ? 2 : 1)\n'
                'flash_dkv_kernel')


#: name -> (kernel, dtype, edit of the .cu, edit of flash_tf32.cuh, timing
#: only)
VARIANTS = {
    'dq_whole': ('dq', 'bf16', dq_whole, None, False),
    'dq_nolo': ('dq', 'bf16', dq_nolo, None, True),
    'dq_wg1': ('dq', 'bf16', dq_wg1, None, False),
    'dq_g4': ('dq', 'bf16', dq_g4, None, False),
    'dkv_serial': ('dkv', 'bf16', dkv_serial, None, False),
    'dkv_noew': ('dkv', 'bf16', dkv_noew, None, True),
    'dkv_nolo': ('dkv', 'bf16', dkv_nolo, None, True),
    'dkv_wg1': ('dkv', 'bf16', dkv_wg1, None, False),
    'dkv_g3n32': ('dkv', 'bf16', dkv_g3n32, None, False),
    'dkv_n32x2': ('dkv', 'bf16', dkv_n32x2, None, False),
    'f32_dq_1x': ('dq', 'f32', None, hdr_1x, True),
    'f32_dkv_1x': ('dkv', 'f32', None, hdr_1x, True),
    'f32_dq_rn': ('dq', 'f32', None, hdr_rn, False),
    'f32_dkv_rn': ('dkv', 'f32', None, hdr_rn, False),
    'f32_dq_nolo': ('dq', 'f32', None, hdr_nolo, True),
    'f32_dkv_nolo': ('dkv', 'f32', None, hdr_nolo, True),
    'f32_dq_m1': ('dq', 'f32', f32_dq_m1, None, False),
    'f32_dq_kt64': ('dq', 'f32', f32_dq_kt64, None, False),
    'f32_dq_dmajor': ('dq', 'f32', f32_dq_dmajor, hdr_dmajor, False),
    'f32_dkv_qt32': ('dkv', 'f32', f32_dkv_qt32, None, False),
    'f32_dkv_x2': ('dkv', 'f32', f32_dkv_x2, None, False),
    'f32_fwd_kt32': ('fwd', 'f32', f32_fwd_kt32, None, False),
    'f32_fwd_m1': ('fwd', 'f32', f32_fwd_m1, None, False),
}

# The TF32 read probe: one m16n8k8 product whose only nonzero terms are
# a (0, 0) = x and b (0, 0) = 1, so d (0, 0) is x as the tensor cores read
# a raw f32 register
_PROBE_CU = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void tf32_probe_kernel(const float* x, float* out, int n) {
  const bool l0 = threadIdx.x == 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t a0 = l0 ? __float_as_uint(x[i]) : 0u;
    const uint32_t b0 = l0 ? __float_as_uint(1.f) : 0u;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
                 : "r"(a0), "r"(0u), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
    if (l0) out[i] = d0;
  }
}
extern "C" int tf32_probe(const float* x, float* out, int n) {
  tf32_probe_kernel<<<1, 32>>>(x, out, n);
  return (int)cudaDeviceSynchronize();
}
'''


# The mma.sync TF32 rate: each warp of 256-thread blocks keeps eight
# independent m16n8k8 accumulators busy for `iters` steps
_MMA_PEAK_CU = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_peak_kernel(const float* x,
                                                       float* out,
                                                       int iters) {
  const uint32_t a0 = __float_as_uint(x[threadIdx.x & 7]);
  const uint32_t a1 = __float_as_uint(x[(threadIdx.x + 1) & 7]);
  const uint32_t b0 = __float_as_uint(x[(threadIdx.x + 2) & 7]);
  const uint32_t b1 = __float_as_uint(x[(threadIdx.x + 3) & 7]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                   "{%0, %1, %2, %3};\n"
                   : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]),
                     "+f"(d[i][3])
                   : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  if (sum == 12345.f) out[0] = sum;
}
extern "C" int mma_peak(const float* x, float* out, int blocks, int iters,
                        void* stream) {
  mma_peak_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(x, out, iters);
  return (int)cudaGetLastError();
}
'''


# The wgmma TF32 rate, m64n64k8 with both operands from shared memory
# (ss, as S = Q K^T would take them) or A from registers (rs, as dS K
# would): each warpgroup of 256-thread blocks issues eight products a
# batch on one accumulator for `iters` batches
_WGMMA_PEAK_CU = r'''
#include "flash_mma.cuh"
template <bool RS>
__global__ void __launch_bounds__(256) wgmma_peak_kernel(float* out,
                                                         int iters) {
  __shared__ __align__(128) float tiles[2][64 * 8];
  for (int i = threadIdx.x; i < 2 * 64 * 8; i += 256)
    (&tiles[0][0])[i] = 1.f / (1 + i);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // K-major, no swizzle: core matrices of 8 rows x 16 bytes, the next 4
  // k 128 bytes on, the next 8 rows 256
  const uint64_t da = fw_desc(fw_smem(tiles[0]), 128, 256);
  const uint64_t db = fw_desc(fw_smem(tiles[1]), 128, 256);
  const uint32_t a[4] = {__float_as_uint(tiles[0][threadIdx.x & 63]), 0u,
                         0u, 0u};
  float d[32] = {};
  for (int it = 0; it < iters; ++it) {
    fw_pin(d);
    fw_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (RS)
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "REGS}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : OUTS
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(0), "r"(1));
      else
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "REGS}, %32, %33, p, 1, 1;\n}\n"
            : OUTS
            : "l"(da), "l"(db), "r"(1));
    }
    fw_commit();
    fw_wait<0>();
  }
  fw_pin(d);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sum += d[i];
  if (sum == 12345.f) out[0] = sum;
}
extern "C" int wgmma_peak(float* out, int blocks, int iters, int rs,
                          void* stream) {
  if (rs)
    wgmma_peak_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        out, iters);
  else
    wgmma_peak_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        out, iters);
  return (int)cudaGetLastError();
}
'''.replace('REGS', '%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31').replace('OUTS', '"+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),\n                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\n                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),\n                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\n                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\n                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\n                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),\n                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])')


def wgmma_peak():
    """TFLOP/s of wgmma m64n64k8 TF32 batches alone, ss and rs, at one and
    two 256-thread blocks an SM."""
    import torch
    from cxxnet_tpu_torch.ops import build as B
    pdir = os.path.join(B.BUILD_DIR, 'variants', 'wgmma_peak')
    os.makedirs(pdir, exist_ok=True)
    cu, lib = os.path.join(pdir, 'peak.cu'), os.path.join(pdir, 'peak.so')
    with open(cu, 'w') as f:
        f.write(_WGMMA_PEAK_CU)
    r = subprocess.run([B.find_nvcc(), *B.NVCC_FLAGS, '-I', B.CSRC, '-o',
                        lib, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f'wgmma_peak failed to build:\n{r.stdout[-3000:]}'
                           f'{r.stderr[-3000:]}')
    fn = ctypes.CDLL(lib).wgmma_peak
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.zeros(1, device='cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res, iters = {}, 2048
    for rs in (0, 1):
        for per_sm in (1, 2):
            blocks = sms * per_sm
            ms = _time_ms(lambda: fn(out.data_ptr(), blocks, iters, rs,
                                     stream), 5)
            flops = blocks * 2 * iters * 8 * 2.0 * 64 * 64 * 8
            res[f'{"rs" if rs else "ss"}_warps_per_sm_{8 * per_sm}_tflops'] = (
                flops / ms / 1e9)
    return res


def mma_peak():
    """TFLOP/s of back-to-back mma.sync m16n8k8 TF32 products at one and
    two 256-thread blocks an SM (8 and 16 warps), CUDA events."""
    import torch
    from cxxnet_tpu_torch.ops import build as B
    pdir = os.path.join(B.BUILD_DIR, 'variants', 'mma_peak')
    os.makedirs(pdir, exist_ok=True)
    cu, lib = os.path.join(pdir, 'peak.cu'), os.path.join(pdir, 'peak.so')
    with open(cu, 'w') as f:
        f.write(_MMA_PEAK_CU)
    subprocess.run([B.find_nvcc(), *B.NVCC_FLAGS, '-o', lib, cu], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).mma_peak
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    x = torch.rand(8, device='cuda')
    out = torch.zeros(1, device='cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res, iters = {}, 4096
    for per_sm in (1, 2):
        blocks = sms * per_sm
        ms = _time_ms(lambda: fn(x.data_ptr(), out.data_ptr(), blocks, iters,
                                 stream), 5)
        flops = blocks * 8 * iters * 8 * 2.0 * 16 * 8 * 8
        res[f'warps_per_sm_{8 * per_sm}_tflops'] = flops / ms / 1e9
    return res


def _ptxas(log: str, dtype: str):
    """(registers, stack frame, spill stores) of the d = 64, widest-copy
    instantiation."""
    tag = ('wgmma_kernelILi64ELi8E' if dtype == 'bf16'
           else 'flash_(?:fwd|dq|dkv)_kernelILi64ELi4E')
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        hit = fn and re.search(tag, fn)
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores',
                      line)
        if m and hit:
            out['stack_frame'], out['spill_stores'] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m and hit:
            out['registers'] = int(m.group(1))
        m = re.search(r"serialized due to (.*?) (?:in|for) the function "
                      r"'(\w+)'", line)
        if m and re.search(tag, m.group(2)):
            out['serialized'] = m.group(1)
    return out


def build(names):
    """Generate and compile the variants, each in its own directory (a
    header edit shadows the package's copy there); {name: (C entry,
    ptxas, dtype)}, the package's own builds as ``{kernel}_package`` and
    ``f32_{kernel}_package``."""
    from cxxnet_tpu_torch.ops import build as B
    out_dir = os.path.join(B.BUILD_DIR, 'variants')
    procs = {}
    for name in names:
        kernel, dtype, edit, hdr_edit, _ = VARIANTS[name]
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(B.CSRC, f'flash_{kernel}.cu')) as f:
            src = f.read()
        with open(os.path.join(vdir, f'flash_{kernel}.cu'), 'w') as f:
            f.write(edit(src) if edit else src)
        if hdr_edit:
            with open(os.path.join(B.CSRC, 'flash_tf32.cuh')) as f:
                hdr = hdr_edit(f.read())
            with open(os.path.join(vdir, 'flash_tf32.cuh'), 'w') as f:
                f.write(hdr)
        lib = os.path.join(vdir, f'lib{name}.so')
        cmd = [B.find_nvcc(), *B.NVCC_FLAGS, '-I', B.CSRC, '-o', lib,
               os.path.join(vdir, f'flash_{kernel}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    B.build_all()
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name} failed to build:\n{log[-4000:]}')
        kernel, dtype = VARIANTS[name][:2]
        key = f'flash_{kernel}' + ('_bf16' if dtype == 'bf16' else '')
        fn = getattr(ctypes.CDLL(lib), B.SIGNATURES[key][1])
        fn.argtypes, fn.restype = B.SIGNATURES[key][2], ctypes.c_int
        entries[name] = (fn, _ptxas(log, dtype), dtype)
    for dtype in {VARIANTS[n][1] for n in names}:
        for kernel in ('dq', 'dkv') + (('fwd',) if dtype == 'f32' else ()):
            key = f'flash_{kernel}' + ('_bf16' if dtype == 'bf16' else '')
            pkg = (f'{kernel}_package' if dtype == 'bf16'
                   else f'f32_{kernel}_package')
            entries[pkg] = (B.entry(key),
                            _ptxas(B.build_log(f'flash_{kernel}'), dtype),
                            dtype)
    return entries


def tf32_probe():
    """How mma.sync reads a raw f32 register as TF32: the product of x and
    1 for x with bits below TF32's 10-bit mantissa, beside x truncated and
    rounded to nearest (ties away, cvt.rna)."""
    import torch
    from cxxnet_tpu_torch.ops import build as B
    pdir = os.path.join(B.BUILD_DIR, 'variants', 'tf32_probe')
    os.makedirs(pdir, exist_ok=True)
    cu, lib = os.path.join(pdir, 'probe.cu'), os.path.join(pdir, 'probe.so')
    with open(cu, 'w') as f:
        f.write(_PROBE_CU)
    subprocess.run([B.find_nvcc(), *B.NVCC_FLAGS, '-o', lib, cu], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).tf32_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    xs = [1 + 2 ** -11 + 2 ** -12, -(1 + 2 ** -11 + 2 ** -12), 1 + 2 ** -11,
          1 + 2 ** -12, 1 + 2 ** -10 + 2 ** -11]
    x = torch.tensor(xs, dtype=torch.float32, device='cuda')
    out = torch.empty_like(x)
    if fn(x.data_ptr(), out.data_ptr(), len(xs)):
        raise RuntimeError('tf32_probe: launch failed')
    bits = x.cpu().view(torch.int32)
    trunc = (bits & ~0x1fff).view(torch.float32)
    rna = ((bits + 0x1000) & ~0x1fff).view(torch.float32)
    got = out.cpu()
    return {'x': x.cpu().tolist(), 'read': got.tolist(),
            'truncated': trunc.tolist(), 'nearest_ties_away': rna.tolist(),
            'reads_as': ('truncation' if torch.equal(got, trunc) else
                         'nearest' if torch.equal(got, rna) else 'other')}


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


def _runner(fn, name, kernel, q, k, v, do, lse, delta, s, bh, d):
    import torch
    if kernel == 'fwd':
        outs = (torch.empty_like(q), torch.empty_like(lse))
        ins = (q, k, v)
    else:
        outs = ((torch.empty_like(q),) if kernel == 'dq' else
                (torch.empty_like(k), torch.empty_like(v)))
        ins = (q, k, v, do, lse, delta)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*(x.data_ptr() for x in ins + outs), bh, s, s, d, 1,
                 d ** -0.5, stream)
        if err:
            raise RuntimeError(f'{name}: cudaError_t {err}')
    return run, outs


def _bf16_legs(entries, res, gen):
    """bf16 variants: one bf16 step against the plain version at b1 h8
    s2048 d64 causal, times at s2048 and s32768, two rounds."""
    import torch
    from cxxnet_tpu_torch.ops import flash as F
    for s in (2048, 32768):
        bh, d = 8, 64
        q, k, v, do = (torch.randn((bh, s, d), device='cuda', generator=gen)
                       .bfloat16() for _ in range(4))
        with torch.no_grad():
            out, lse = F.flash_fwd(q, k, v, True)
            delta = (do.float() * out.float()).sum(-1)
            ref = None
            if s == 2048:
                args = (q, k, v, do, lse, delta, True)
                ref = {'dq': (F.flash_dq_plain(*args),),
                       'dkv': F.flash_dkv_plain(*args)}
            for rnd in range(2):
                for name, (fn, _, dtype) in entries.items():
                    if dtype != 'bf16':
                        continue
                    kernel = name.split('_')[0]
                    run, outs = _runner(fn, name, kernel, q, k, v, do, lse,
                                        delta, s, bh, d)
                    res[name].setdefault(f's{s}_ms', []).append(
                        _time_ms(run, 20 if s == 2048 else 3))
                    if ref is not None and rnd == 0:
                        run()
                        torch.cuda.synchronize()
                        res[name]['bf16_step_excess'] = max(
                            ((g.float() - r.float()).abs()
                             / (2 ** -7 * r.float().abs()
                                + 1e-3 * r.float().abs().mean())).max().item()
                            for g, r in zip(outs, ref[kernel]))
        del q, k, v, do, out, lse, delta, ref
        torch.cuda.empty_cache()


def _f32_legs(entries, res, gen):
    """f32 variants at the seqpar path's b1 h16 s8192 d64 causal: max |err|
    / max |plain| (the smoke's TOL 1e-4), two launches bitwise equal, and
    the time of 10 launches, two rounds."""
    import torch
    from cxxnet_tpu_torch.ops import flash as F
    bh, s, d = 16, 8192, 64
    q, k, v, do = (torch.randn((bh, s, d), device='cuda', generator=gen)
                   for _ in range(4))
    with torch.no_grad():
        out, lse = F.flash_fwd_plain(q, k, v, True)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, True)
        ref = {'fwd': (out, lse), 'dq': (F.flash_dq_plain(*args),),
               'dkv': F.flash_dkv_plain(*args)}
        for rnd in range(2):
            for name, (fn, _, dtype) in entries.items():
                if dtype != 'f32':
                    continue
                kernel = name.split('_')[1]
                run, outs = _runner(fn, name, kernel, q, k, v, do, lse,
                                    delta, s, bh, d)
                res[name].setdefault('s8192_ms', []).append(_time_ms(run, 10))
                if rnd == 0:
                    first = [o.clone() for o in outs]
                    run()
                    torch.cuda.synchronize()
                    res[name]['bitwise_repeat'] = all(
                        torch.equal(a, b) for a, b in zip(first, outs))
                    res[name]['max_rel_err'] = max(
                        ((g - r).abs().max() / r.abs().max()).item()
                        for g, r in zip(outs, ref[kernel]))


def main(argv) -> int:
    import torch
    names = argv or list(VARIANTS)
    probe = 'tf32_probe' in names
    peak = 'mma_peak' in names
    wpeak = 'wgmma_peak' in names
    names = [n for n in names
             if n not in ('tf32_probe', 'mma_peak', 'wgmma_peak')]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if probe or not argv:
        print(json.dumps({'variant': 'tf32_probe', 'nvidia_smi': smi,
                          **tf32_probe()}), flush=True)
    if peak or not argv:
        print(json.dumps({'variant': 'mma_peak', 'nvidia_smi': smi,
                          **mma_peak()}), flush=True)
    if wpeak or not argv:
        try:
            res = wgmma_peak()
        except RuntimeError as e:    # reported; the variants still run
            res = {'error': str(e)[-2000:]}
        print(json.dumps({'variant': 'wgmma_peak', 'nvidia_smi': smi,
                          **res}), flush=True)
    if not names:
        return 0
    entries = build(names)
    gen = torch.Generator(device='cuda').manual_seed(3)
    res = {name: {'ptxas': p} for name, (_, p, _) in entries.items()}
    if any(dt == 'bf16' for _, _, dt in entries.values()):
        _bf16_legs(entries, res, gen)
    if any(dt == 'f32' for _, _, dt in entries.values()):
        _f32_legs(entries, res, gen)
    for name, r in res.items():
        timing_only = VARIANTS[name][4] if name in VARIANTS else False
        print(json.dumps({'variant': name, 'nvidia_smi': smi,
                          'timing_only': timing_only, **r}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
