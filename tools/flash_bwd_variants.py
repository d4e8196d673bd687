#!/usr/bin/env python3
"""Ablate the bf16 flash-attention backward kernels on one NVIDIA card.

    python3 tools/flash_bwd_variants.py [NAME ...]

Each NAME (default: all of VARIANTS) is a variant of this checkout's
``ops/csrc/flash_dq.cu`` or ``flash_dkv.cu`` made by a few checked text
edits (an edit that no longer applies raises).  All variants build in
parallel with the package's nvcc flags into ``ops/_build/variants/``;
each is then held element by element to one bf16 step of the plain
version at b1 h8 s2048 d64 causal and timed (CUDA events) at s2048 and
s32768, in two rounds, beside the package's own kernels.  Variants marked
timing-only drop part of the arithmetic and are not expected to pass.
One JSON line per variant: registers, stack frame and spills from
``-Xptxas -v``, the excess, and the milliseconds of each round.

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


#: name -> (kernel, edit, timing only)
VARIANTS = {
    'dq_whole': ('dq', dq_whole, False),
    'dq_nolo': ('dq', dq_nolo, True),
    'dq_wg1': ('dq', dq_wg1, False),
    'dq_g4': ('dq', dq_g4, False),
    'dkv_serial': ('dkv', dkv_serial, False),
    'dkv_noew': ('dkv', dkv_noew, True),
    'dkv_nolo': ('dkv', dkv_nolo, True),
    'dkv_wg1': ('dkv', dkv_wg1, False),
    'dkv_g3n32': ('dkv', dkv_g3n32, False),
    'dkv_n32x2': ('dkv', dkv_n32x2, False),
}


def _ptxas(log: str):
    """(registers, stack frame, spill stores) of the d = 64, 16-byte-copy
    instantiation."""
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores',
                      line)
        if m and fn and 'wgmma_kernelILi64ELi8E' in fn:
            out['stack_frame'], out['spill_stores'] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m and fn and 'wgmma_kernelILi64ELi8E' in fn:
            out['registers'] = int(m.group(1))
        m = re.search(r"serialized due to (.*?) (?:in|for) the function "
                      r"'(\w+)'", line)
        if m and 'wgmma_kernelILi64ELi8E' in m.group(2):
            out['serialized'] = m.group(1)
    return out


def build(names):
    """Generate and compile the variants; {name: (C entry, ptxas)}."""
    from cxxnet_tpu_torch.ops import build as B
    out_dir = os.path.join(B.BUILD_DIR, 'variants')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        kernel, edit, _ = VARIANTS[name]
        with open(os.path.join(B.CSRC, f'flash_{kernel}.cu')) as f:
            src = edit(f.read())
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(src)
        lib = os.path.join(out_dir, f'lib{name}.so')
        cmd = [B.find_nvcc(), *B.NVCC_FLAGS, '-I', B.CSRC, '-o', lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    B.build_all()
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name} failed to build:\n{log[-4000:]}')
        key = f'flash_{VARIANTS[name][0]}_bf16'
        fn = getattr(ctypes.CDLL(lib), key)
        fn.argtypes, fn.restype = B.SIGNATURES[key][2], ctypes.c_int
        entries[name] = (fn, _ptxas(log))
    for kernel in ('dq', 'dkv'):
        key = f'flash_{kernel}_bf16'
        entries[f'{kernel}_package'] = (B.entry(key),
                                        _ptxas(B.build_log(f'flash_{kernel}')))
    return entries


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


def main(argv) -> int:
    import torch
    from cxxnet_tpu_torch.ops import flash as F
    names = argv or list(VARIANTS)
    entries = build(names)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(3)
    res = {name: {'ptxas': p} for name, (_, p) in entries.items()}
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
            stream = torch.cuda.current_stream().cuda_stream
            for rnd in range(2):
                for name, (fn, _) in entries.items():
                    kernel = name.split('_')[0]
                    outs = ((torch.empty_like(q),) if kernel == 'dq' else
                            (torch.empty_like(k), torch.empty_like(v)))

                    def run():
                        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(),
                                 *(o.data_ptr() for o in outs), bh, s, s, d,
                                 1, d ** -0.5, stream)
                        if err:
                            raise RuntimeError(f'{name}: cudaError_t {err}')
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
    for name, r in res.items():
        timing_only = VARIANTS[name][2] if name in VARIANTS else False
        print(json.dumps({'variant': name, 'nvidia_smi': smi,
                          'timing_only': timing_only, **r}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
