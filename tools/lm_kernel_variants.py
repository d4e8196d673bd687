#!/usr/bin/env python3
"""Ablate the decode path's int8 GEMM and paged attention kernels on one
NVIDIA card.

    python3 tools/lm_kernel_variants.py [NAME ...]

Each NAME (default: all of VARIANTS) rebuilds one of this checkout's
``ops/csrc/int8_gemm.cu``, ``paged_decode.cu`` or ``paged_verify.cu``
(with ``paged_attn.cuh``) after a few checked text edits (other values
of their constants, or less work; an edit that no longer applies
raises) with the package's nvcc flags into ``ops/_build/variants/NAME/``.
Each variant is then run at ``chip_smoke.py``'s shapes beside the
package's own build, in two rounds (package, variants, package):

* int8 variants at the seven ``INT8_SHAPES``: bitwise the plain version,
  and the decode step's sum (32 projections, 8 of each FFN product, the
  head);
* paged variants at the smoke's ``paged_kernel_checks`` shapes (16 slots,
  16 heads of 64, 16 pages of 16 positions), f32 and bf16, decode and
  verify (K = 4): bitwise the package's build where the variant changes
  how many loads are in flight, within the smoke's tolerance of it where
  it changes the order of a sum (another block size).

Variants marked timing-only (``check`` 'none') are text edits that drop
part of the work (the loads, the products, the epilogue, everything but
the launch) to show where the time goes; they are not expected to agree.

Times are device milliseconds of each shape's calls captured in one CUDA
graph and replayed (no host work between launches).  One JSON line per
build: registers, stack frame and spills of each kernel from ``-Xptxas
-v``, the checks, and each round's times.

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

from chip_smoke import graph_ms, ptxas_summary  # noqa: E402


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f'edit does not apply ({src.count(old)} matches, '
                         f'want {count}): {old[:70]!r}')
    return src.replace(old, new)


def _const(src, name, value):
    """Set ``constexpr int NAME = ...;`` of one source (checked)."""
    pat = re.compile(r'constexpr int ' + name + r' = \d+;')
    if len(pat.findall(src)) != 1:
        raise ValueError(f'constant {name} not found once')
    return pat.sub(f'constexpr int {name} = {value};', src)


def _set(fn, **values):
    """A text edit setting constants of source ``fn``."""
    def edit(files):
        for name, value in values.items():
            files[fn] = _const(files[fn], name, value)
    return edit


def _i8_empty(files):
    files['int8_gemm.cu'] = _sub(
        files['int8_gemm.cu'], '  cg::cluster_group cluster = '
        'cg::this_cluster();\n', '  if (m > 0) return;\n'
        '  cg::cluster_group cluster = cg::this_cluster();\n')


def _i8_noepi(files):
    src = files['int8_gemm.cu']
    i = src.index('  // this split\'s partial, rows and columns in tile order')
    j = src.index('// the split count of an (m, n, k) product')
    files['int8_gemm.cu'] = src[:i] + (
        '  if (acc[0][0][0] == 0x7fffffff && acc[1][3][3] == 0x7fffffff)\n'
        '    c[0] = 1;\n}\n\n') + src[j:]


def _i8_nomma(files):
    files['int8_gemm.cu'] = _sub(
        files['int8_gemm.cu'],
        'mma_s8(acc[i][j], af[i], bf[0][j], bf[1][j]);',
        'acc[i][j][0] += (int)(af[i][0] ^ bf[0][j] ^ bf[1][j]);')


def _i8_nostore(files):
    files['int8_gemm.cu'] = _sub(
        files['int8_gemm.cu'],
        '      *reinterpret_cast<int4*>(dst) = sum;',
        '      if (sum.x == 0x7fffffff) *dst = 1;')


def _i8_nobar(files):
    src = _sub(files['int8_gemm.cu'],
               '  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.'
               'aligned;\\n" ::);', '')
    src = _sub(src, '    asm volatile("barrier.cluster.wait.aligned;\\n" ::);',
               '')
    src = _sub(src, '    cluster.sync();\n  }', '    __syncthreads();\n  }')
    files['int8_gemm.cu'] = _sub(src, 'cluster.map_shared_rank(recv, r)',
                                 'recv')


def _i8_nocs(files):
    files['int8_gemm.cu'] = _sub(
        files['int8_gemm.cu'], '        Cs[row * I8_CS + col] = acc[i][j][e];',
        '        if (acc[i][j][e] == 0x7fffffff) Cs[row * I8_CS + col] = 1;')


def _pa_noload(which):
    def edit(files):
        src = files['paged_attn.cuh']
        zero = ('for (int u_ = 0; u_ < U; ++u_) for (int c_ = 0; c_ < CPL; '
                '++c_) {0}[u_][c_] = Raw{{}};')
        if which == 'k':
            src = _sub(src, 'load_rows(kv, kpool, base);',
                       zero.format('kv'))
        else:
            src = _sub(src, 'load_rows(vv, vpool, r0);', zero.format('vv'))
            src = _sub(src, 'if (base != r0) load_rows(vv, vpool, base);',
                       '')
        files['paged_attn.cuh'] = src
    return edit


def _pa_empty(files):
    files['paged_attn.cuh'] = _sub(
        files['paged_attn.cuh'], '  float* s_sc = smem;  ',
        '  if (n > 0) return;\n  float* s_sc = smem;  ')


#: name -> (source, text edit, check, what it asks): check 'bitwise'
#: (the package's output, or the plain version for int8), 'close' (within
#: the smoke's TOL / BF16 rule of the package's output: another order of
#: sums) or 'none' (timing only: it drops work)
I8, PA = 'int8_gemm.cu', 'paged_attn.cuh'
VARIANTS = {
    'i8_stages3': ('int8_gemm.cu', _set(I8, I8_STAGES=3), 'bitwise',
                   'a three-stage ring (24 KB, two stages in flight)'),
    'i8_target264': ('int8_gemm.cu', _set(I8, I8_TARGET_BLOCKS=264),
                     'bitwise', 'split until two blocks an SM, not one'),
    'i8_empty': ('int8_gemm.cu', _i8_empty, 'none',
                 'the launch alone: same grid, clusters and shared memory'),
    'i8_noepi': ('int8_gemm.cu', _i8_noepi, 'none',
                 'no partial tile, cluster sum or store'),
    'i8_nomma': ('int8_gemm.cu', _i8_nomma, 'none',
                 'loads and fragment reads without the products'),
    'i8_nostore': ('int8_gemm.cu', _i8_nostore, 'none',
                   'the epilogue without its global stores'),
    'i8_nobar': ('int8_gemm.cu', _i8_nobar, 'none',
                 'the epilogue without cluster barriers (shares kept home)'),
    'i8_nocs': ('int8_gemm.cu', _i8_nocs, 'none',
                'the epilogue without writing the partial tile'),
    'pa_unroll4': ('paged_decode.cu', _set(PA, PA_UNROLL=4), 'bitwise',
                   'four chunks of loads in flight a lane, not eight'),
    'pa_warps16': ('paged_decode.cu', _set(PA, PA_THREADS=512), 'close',
                   'sixteen warps a block (runs of ceil(n / 16) rows)'),
    'pa_lc1': ('paged_decode.cu', _set(PA, PA_LANE_CHUNKS=1), 'close',
               'one 16-byte chunk a lane (twice the lanes a row)'),
    'pa_lc4': ('paged_decode.cu', _set(PA, PA_LANE_CHUNKS=4), 'close',
               'four chunks a lane'),
    'pv_lc1': ('paged_verify.cu', _set(PA, PA_LANE_CHUNKS=1), 'close',
               'the verify kernel with one chunk a lane'),
    'pa_empty': ('paged_decode.cu', _pa_empty, 'none',
                 'the launch alone: same grid and shared memory'),
    'pa_nok': ('paged_decode.cu', _pa_noload('k'), 'none', 'no K loads'),
    'pa_nov': ('paged_decode.cu', _pa_noload('v'), 'none', 'no V loads'),
    'pv_warps16': ('paged_verify.cu', _set(PA, PA_THREADS=512), 'close',
                   'the verify kernel with sixteen warps a block'),
}
INT8_SHAPES = [('decode_qkvo', 64, 1024, 1024), ('decode_w1', 64, 1024, 4096),
               ('decode_w2', 64, 4096, 1024),
               ('decode_head', 64, 1024, 32768),
               ('prefill128_qkvo', 128, 1024, 1024),
               ('prefill8_w2', 8, 4096, 1024),
               ('prefill_head_m1', 1, 1024, 32768)]
INT8_STEP_USES = {'decode_qkvo': 32, 'decode_w1': 8, 'decode_w2': 8,
                  'decode_head': 1}
PAGED = (16, 16, 64, 16, 16, 257)   # S, H, hd, ps, pp, P


def build(names):
    """{name: (CDLL, ptxas)} for the package's three libraries (keys
    ``int8_gemm.cu`` etc.) and each variant."""
    from cxxnet_tpu_torch.ops import build as B
    B.build_all()
    libs = {src: (ctypes.CDLL(B._lib_path(lib)),
                  ptxas_summary(B.build_log(lib)))
            for lib, src in B.SOURCES.items()
            if src in ('int8_gemm.cu', 'paged_decode.cu', 'paged_verify.cu')}
    out_dir = os.path.join(B.BUILD_DIR, 'variants')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src, edit, _, _ = VARIANTS[name]
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {}
        for fn in (src, 'paged_attn.cuh'):
            with open(os.path.join(B.CSRC, fn)) as f:
                files[fn] = f.read()
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


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def _int8_run(lib, operands):
    """Times (ms) and bitwise checks of one int8 build."""
    import torch
    from cxxnet_tpu_torch.ops.kernels import int8_matmul_plain
    fn = lib.int8_gemm_s8s32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = {}
    for (name, m, k, n), (a, b) in zip(INT8_SHAPES, operands):
        c = torch.empty((m, n), dtype=torch.int32, device='cuda')

        def call():
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                     _stream())
            if err:
                raise RuntimeError(f'int8 launch failed: {err}')
        call()
        torch.cuda.synchronize()
        equal = torch.equal(c, int8_matmul_plain(a, b))
        res[name] = {'graph_ms': graph_ms(call, 50), 'bitwise': equal}
    res['decode_step_graph_ms'] = sum(
        uses * res[name]['graph_ms'] for name, uses in INT8_STEP_USES.items())
    return res


def _paged_inputs():
    import numpy as np
    import torch
    S, H, hd, ps, pp, P = PAGED
    T = ps * pp
    rng = np.random.RandomState(20261016)
    pool = [torch.from_numpy(rng.randn(P, ps, H, hd).astype(np.float32))
            .cuda() for _ in range(2)]
    table = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(
        S, pp).astype(np.int32)).cuda()
    pos = rng.randint(0, T - 3, S).astype(np.int32)
    pos[1:6] = (15, 16, 31, 32, T - 4)
    w = np.minimum(rng.randint(0, 8, S), pos).astype(np.int32)
    q = torch.from_numpy(rng.randn(S, 4, H, hd).astype(np.float32)).cuda()
    return (q, pool, table, torch.from_numpy(pos).cuda(),
            torch.from_numpy(w).cuda())


def _paged_run(lib, verify, inputs):
    """{dtype: (graph ms, output)} of one decode or verify build."""
    import torch
    q, pool, table, pos, w = inputs
    S, H, hd, ps, pp, _ = PAGED
    res = {}
    for dtype, sfx in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        fn = getattr(lib, ('paged_verify_' if verify else 'paged_decode_')
                     + sfx)
        fn.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * (6 if verify else 5) + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        qq = (q if verify else q[:, 0].contiguous()).to(dtype)
        kp, vp = (p.to(dtype) for p in pool)
        out = torch.empty_like(qq)
        dims = (S, 4, H, hd, ps, pp) if verify else (S, H, hd, ps, pp)

        def call():
            err = fn(qq.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     table.data_ptr(), pos.data_ptr(), w.data_ptr(),
                     out.data_ptr(), *dims, hd ** -0.5, _stream())
            if err:
                raise RuntimeError(f'paged launch failed: {err}')
        call()
        torch.cuda.synchronize()
        res[sfx] = (graph_ms(call, 200), out.clone())
    return res


def _agrees(check, out, ref) -> bool:
    """A paged variant's output against the package's build."""
    import torch
    if check == 'none':
        return True
    if check == 'bitwise':
        return torch.equal(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err <= (1e-5 if out.dtype == torch.float32 else 1e-2) * scale


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
    gen = torch.Generator(device='cuda').manual_seed(5)
    operands = [(torch.randint(-127, 128, (m, k), device='cuda',
                               generator=gen, dtype=torch.int8),
                 torch.randint(-127, 128, (k, n), device='cuda',
                               generator=gen, dtype=torch.int8))
                for _, m, k, n in INT8_SHAPES]
    inputs = _paged_inputs()
    builds = ['int8_gemm.cu', 'paged_decode.cu', 'paged_verify.cu'] + names
    rows = {b: {'rounds': []} for b in builds}
    for b in builds:
        src = VARIANTS[b][0] if b in VARIANTS else b
        check = VARIANTS[b][2] if b in VARIANTS else 'bitwise'
        rows[b].update({'source': src, 'check': check,
                        'ptxas': libs[b][1]})
        if b in VARIANTS:
            rows[b]['asks'] = VARIANTS[b][3]
    ref = {}
    for rnd in range(2):
        order = builds if rnd == 0 else builds[::-1]
        for b in order:
            lib = libs[b][0]
            src = rows[b]['source']
            with torch.inference_mode():
                if src == 'int8_gemm.cu':
                    rows[b]['rounds'].append(_int8_run(lib, operands))
                    continue
                verify = src == 'paged_verify.cu'
                got = _paged_run(lib, verify, inputs)
            key = src
            if b == src:
                ref.setdefault(key, {k: v[1] for k, v in got.items()})
            rows[b]['rounds'].append({k: v[0] for k, v in got.items()})
            for k, (_, out) in got.items():
                agree = _agrees(rows[b]['check'], out, ref[key][k])
                rows[b]['agrees'] = rows[b].get('agrees', True) and agree
    rc = 0
    for b in builds:
        rows[b]['build'] = b
        rows[b]['nvidia_smi'] = smi
        ok = rows[b].get('agrees', True) and (
            rows[b]['check'] == 'none' or all(
                v['bitwise'] for r in rows[b]['rounds'] for v in r.values()
                if isinstance(v, dict)))
        rows[b]['ok'] = ok
        rc |= 0 if ok else 1
        print(json.dumps(rows[b]), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
