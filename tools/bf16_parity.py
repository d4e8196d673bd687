#!/usr/bin/env python3
"""Hold the bf16 CUDA builds of two source trees to each other on one
NVIDIA card: the same outputs, bit for bit, and the same ptxas resources.

    python3 tools/bf16_parity.py PARENT [CHANGE]

Each tree (CHANGE defaults to this checkout) runs in its own process: it
builds its kernels into its own ``cxxnet_tpu_torch/ops/_build``, draws
seeded inputs on the card at batch-256 AlexNet's shapes (the same numbers
in both processes), runs the bf16 build of kernel rows 1-7 on them — the
fused conv at conv1-conv5 (y and the f32 z), the LRN forward (y and the
f32 norm) and backward at norm1 and norm2, the fullc GEMM at fc6, fc7 and
fc8 and its two backward GEMMs at the same layers — and the threefry
kernel's bf16 dropout mask and bf16 uniform draw, and prints one JSON
line: the SHA-256 of each output's bytes, and ptxas's registers, spill
bytes and stack frame of every kernel of its libraries but the f16 ones
(``__half`` in the mangled name).  The calling process then prints one
JSON line with the card's name and power limit, each output equal or
not, and, per library, whether the two trees' (registers, spill stores,
spill loads, stack frame) multisets are equal; it exits 1 if anything
differs.

Needs a CUDA device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (CONV_SHAPES, FC_SHAPES, LRN_ARGS,  # noqa: E402
                        LRN_SHAPES, ptxas_summary)

#: the libraries that hold a bf16 build (and, in a tree with them, f16)
LIBS = ('conv_bias_act_bf16', 'fullc_gemm_bf16', 'fullc_gemm_nt_bf16',
        'fullc_gemm_tn_bf16', 'lrn', 'lrn_bwd', 'threefry')
SEED = 20261026


def _digest(t) -> str:
    import torch
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def run(tree: str) -> dict:
    """The digests of ``tree``'s bf16 outputs and its ptxas resources."""
    sys.path.insert(0, tree)
    import torch
    from cxxnet_tpu_torch.ops import build, cnn, kernels, threefry
    from cxxnet_tpu_torch.utils import prng
    assert os.path.dirname(os.path.dirname(build.__file__)).startswith(
        os.path.abspath(tree)), build.__file__
    build.build_all()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(torch.bfloat16)

    out = {}
    with torch.inference_mode():
        for name, xs, kh, kw, cin_g, cout, s, p, g in CONV_SHAPES:
            x = randn(xs)
            w = randn((kh, kw, cin_g, cout), (kh * kw * cin_g) ** -0.5)
            b = randn((cout,), 0.1)
            y, z = cnn._conv_call(x, w, b, (s, s), ((p, p), (p, p)), g,
                                  'relu', True)
            out[f'conv_bias_act_bf16 {name} y'] = _digest(y)
            out[f'conv_bias_act_bf16 {name} z'] = _digest(z)
            del x, w, b, y, z
        nsize, alpha, beta, knorm = LRN_ARGS
        for name, xs in LRN_SHAPES:
            x, g = randn(xs, 4.0), randn(xs)
            y, norm = kernels._lrn_call(x, nsize, alpha, beta, knorm, True)
            dx = kernels.lrn_backward(x, g, norm, nsize, alpha, beta)
            out[f'lrn_forward_bf16 {name} y'] = _digest(y)
            out[f'lrn_forward_bf16 {name} norm'] = _digest(norm)
            out[f'lrn_backward_bf16 {name} dx'] = _digest(dx)
            del x, g, y, norm, dx
        for name, m, nin, nout in FC_SHAPES:
            a = randn((m, nin))
            w = randn((nin, nout), nin ** -0.5)
            g = randn((m, nout))
            out[f'fullc_gemm_bf16 {name}'] = _digest(kernels.fullc_gemm(a, w))
            out[f'fullc_gemm_nt_bf16 {name}'] = _digest(
                kernels.fullc_gemm_nt(g, w))
            out[f'fullc_gemm_tn_bf16 {name}'] = _digest(
                kernels.fullc_gemm_tn(a, g))
            del a, w, g
        key = prng.fold_in(prng.prng_key(SEED), 7)
        out['threefry_uniform bf16 mask'] = _digest(threefry.keep_mask(
            key, (256, 4096), torch.bfloat16, dev, 0.5))
        out['threefry_uniform bf16 normal'] = _digest(threefry.uniform(
            key, (4097, 33), torch.bfloat16, dev,
            prng.normal_lo(torch.bfloat16), 1.0))
    ptxas = {}
    for lib in LIBS:
        ptxas[lib] = [k for k in ptxas_summary(build.build_log(lib))
                      if '__half' not in k['function']]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return {'tree': tree, 'nvidia_smi': smi, 'digests': out,
            'ptxas': ptxas}


def _resources(kernels):
    return sorted((k.get('registers'), k.get('spill_stores'),
                   k.get('spill_loads'), k.get('stack_frame'))
                  for k in kernels)


def main(argv) -> int:
    if argv[:1] == ['--one']:
        print(json.dumps(run(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    trees = [os.path.abspath(argv[0]), os.path.abspath(
        argv[1] if len(argv) > 1 else
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
    res = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return 1
        res.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    a, b = res
    outputs = {k: a['digests'][k] == b['digests'].get(k)
               for k in a['digests']}
    libs = {lib: {'equal': _resources(a['ptxas'][lib])
                  == _resources(b['ptxas'][lib]),
                  'parent': _resources(a['ptxas'][lib]),
                  'change': _resources(b['ptxas'][lib])}
            for lib in LIBS}
    ok = all(outputs.values()) and all(v['equal'] for v in libs.values())
    print(json.dumps({'nvidia_smi': a['nvidia_smi'], 'trees': trees,
                      'bitwise_equal': outputs, 'ptxas': libs,
                      'all_equal': ok}), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
