#!/usr/bin/env python3
"""Time the port's fullc GEMMs, fused conv and flash-attention kernels
of one or more source trees on one NVIDIA card, in turns.

    python3 tools/torch_kernel_ab.py [TREE ...]

Each TREE is the root of a checkout holding ``cxxnet_tpu_torch`` (default:
this checkout).  Every tree runs in its own process, in the order given,
so ``parent change change parent`` times two versions on one card in
turns; each process builds its tree's kernels into that tree's
``ops/_build``.  A process prints one JSON line: the card's name and
power limit, and device milliseconds (CUDA events, mean of back-to-back
launches after a warm-up) of

* ``fullc_gemm`` at fc6, fc7 and fc8 of batch-256 AlexNet (256 x 9216 x
  4096, 256 x 4096 x 4096, 256 x 4096 x 1000), ``fullc_gemm_nt`` at the
  same layers' input gradients (g (256, nhidden) @ w (nin, nhidden)^T)
  and ``fullc_gemm_tn`` at their weight gradients (a (256, nin)^T @ g
  (256, nhidden)), each beside ``torch.matmul``;
* ``conv_bias_act`` (relu) at AlexNet's conv1-conv5, batch 256, beside
  ``F.conv2d`` + ``relu_`` on the same NCHW views;
* ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` in bf16, causal, at b1 h8
  d64, s2048 and s32768, beside
  ``F.scaled_dot_product_attention(is_causal=True)`` (timed only): its
  forward, and its autograd backward (forward + backward less forward,
  dq, dk and dv together) beside dq + dk/dv.  The backward kernels take
  the tree's own forward's lse and ``delta = sum(do * out)``;
* ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` in f32 at the
  ``seqpar`` path's b1 h16 s8192 d64 causal (dq and dk/dv from the plain
  forward's lse and delta), beside SDPA's f32 forward and its autograd
  backward (forward + backward less forward).

The library calls run in full f32: TF32 off for cuBLAS and cuDNN.

Needs a CUDA device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

GEMMS = [('fc6', 256, 9216, 4096), ('fc7', 256, 4096, 4096),
         ('fc8', 256, 4096, 1000)]
# (name, x shape NHWC, kh, kw, cin_g, cout, stride, pad, groups)
CONVS = [('conv1', (256, 227, 227, 3), 11, 11, 3, 96, 4, 0, 1),
         ('conv2', (256, 27, 27, 96), 5, 5, 48, 256, 1, 2, 2),
         ('conv3', (256, 13, 13, 256), 3, 3, 256, 384, 1, 1, 1),
         ('conv4', (256, 13, 13, 384), 3, 3, 192, 384, 1, 1, 2),
         ('conv5', (256, 13, 13, 384), 3, 3, 192, 256, 1, 1, 2)]
FLASH = [('s2048', 1, 8, 2048, 64), ('s32768', 1, 8, 32768, 64)]
FLASH_F32 = ('s8192', 1, 16, 8192, 64)


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


def measure(tree: str) -> dict:
    """The timings of ``tree``'s kernels on card 0."""
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.cnn import conv_bias_act
    from cxxnet_tpu_torch.ops.flash import (flash_dkv, flash_dq, flash_fwd,
                                            flash_fwd_plain)
    from cxxnet_tpu_torch.ops.kernels import (fullc_gemm, fullc_gemm_nt,
                                              fullc_gemm_tn)
    assert os.path.dirname(os.path.dirname(build.__file__)).startswith(
        os.path.abspath(tree)), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.build_all()
    gen = torch.Generator(device='cuda').manual_seed(7)
    out = {'tree': tree, 'nvidia_smi': smi, 'gemm': {}, 'gemm_nt': {},
           'gemm_tn': {}, 'conv': {}, 'flash_bf16': {}, 'flash_f32': {}}
    with torch.no_grad():
        for name, m, k, n in GEMMS:
            a = torch.randn((m, k), device='cuda', generator=gen)
            b = torch.randn((k, n), device='cuda', generator=gen)
            g = torch.randn((m, n), device='cuda', generator=gen)
            out['gemm'][name] = {
                'kernel_ms': _time_ms(lambda: fullc_gemm(a, b), 50),
                'matmul_ms': _time_ms(lambda: torch.matmul(a, b), 50)}
            out['gemm_nt'][name] = {
                'kernel_ms': _time_ms(lambda: fullc_gemm_nt(g, b), 50),
                'matmul_ms': _time_ms(lambda: torch.matmul(g, b.t()), 50)}
            out['gemm_tn'][name] = {
                'kernel_ms': _time_ms(lambda: fullc_gemm_tn(a, g), 50),
                'matmul_ms': _time_ms(lambda: torch.matmul(a.t(), g), 50)}
            del a, b, g
        for key in ('gemm', 'gemm_nt', 'gemm_tn'):
            out[key]['sum'] = {f: sum(r[f] for r in list(out[key].values()))
                               for f in ('kernel_ms', 'matmul_ms')}
        for name, xs, kh, kw, cin_g, cout, s, p, groups in CONVS:
            x = torch.randn(xs, device='cuda', generator=gen)
            w = torch.randn((kh, kw, cin_g, cout), device='cuda',
                            generator=gen) * (kh * kw * cin_g) ** -0.5
            b = torch.randn((cout,), device='cuda', generator=gen) * 0.1
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            out['conv'][name] = {
                'kernel_ms': _time_ms(lambda: conv_bias_act(
                    x, w, b, (s, s), ((p, p), (p, p)), groups, 'relu'), 10),
                'conv2d_relu_ms': _time_ms(lambda: F.conv2d(
                    x_nchw, w_oihw, b, stride=s, padding=p,
                    groups=groups).relu_(), 10)}
            del x, w, b, x_nchw, w_oihw
        torch.cuda.empty_cache()
        for name, bs, h, s, d in FLASH:
            q, k, v, do = (torch.randn((bs * h, s, d), device='cuda',
                                       generator=gen).bfloat16()
                           for _ in range(4))
            qs, ks, vs, dos = (x.view(bs, h, s, d) for x in (q, k, v, do))
            o, lse = flash_fwd(q, k, v, True)
            delta = (do.float() * o.float()).sum(-1)
            iters = 20 if s <= 4096 else 3
            # SDPA over >= 20 launches: a few launches of its short s2048
            # kernels read anywhere from 0.04 to 0.09 ms
            sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), max(iters, 20))
            out['flash_bf16'][name] = {
                'kernel_ms': _time_ms(lambda: flash_fwd(q, k, v, True),
                                      iters),
                'sdpa_ms': sdpa_fwd,
                'dq_ms': _time_ms(lambda: flash_dq(q, k, v, do, lse, delta,
                                                   True), iters),
                'dkv_ms': _time_ms(lambda: flash_dkv(q, k, v, do, lse,
                                                     delta, True), iters)}
            leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]

            def sdpa_fwd_bwd():
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(*leaves,
                                                       is_causal=True)
                    return torch.autograd.grad(o, leaves, dos)
            out['flash_bf16'][name]['sdpa_bwd_ms'] = max(
                _time_ms(sdpa_fwd_bwd, max(iters, 20)) - sdpa_fwd, 0.0)
            del q, k, v, do, o, lse, delta, leaves
            torch.cuda.empty_cache()
        name, bs, h, s, d = FLASH_F32
        q, k, v, do = (torch.randn((bs * h, s, d), device='cuda',
                                   generator=gen) for _ in range(4))
        o, lse = flash_fwd_plain(q, k, v, True)
        delta = (do * o).sum(-1)
        qs, ks, vs, dos = (x.view(bs, h, s, d) for x in (q, k, v, do))
        sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20)
        leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, dos)
        out['flash_f32'][name] = {
            'fwd_ms': _time_ms(lambda: flash_fwd(q, k, v, True), 20),
            'sdpa_fwd_ms': sdpa_fwd,
            'dq_ms': _time_ms(lambda: flash_dq(q, k, v, do, lse, delta,
                                               True), 20),
            'dkv_ms': _time_ms(lambda: flash_dkv(q, k, v, do, lse, delta,
                                                 True), 20),
            'sdpa_bwd_ms': max(_time_ms(sdpa_fwd_bwd, 20) - sdpa_fwd, 0.0)}
        del q, k, v, do, o, lse, delta, leaves
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ['--one']:
        print(json.dumps(measure(os.path.abspath(argv[1]))), flush=True)
        return 0
    trees = argv or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--one', tree]).returncode
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
