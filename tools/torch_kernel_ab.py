#!/usr/bin/env python3
"""Time the port's fullc GEMMs, fused conv, flash-attention, int8 GEMM and
paged attention kernels of one or more source trees on one NVIDIA card,
in turns.

    python3 tools/torch_kernel_ab.py [--legs LEG,...] [TREE ...]

Each TREE is the root of a checkout holding ``cxxnet_tpu_torch`` (default:
this checkout); ``--legs`` times only the named legs of ``LEGS`` (default:
all).  Every tree runs in its own process, in the order given,
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
* the bf16 builds (``compute_type=bfloat16``) of ``fullc_gemm`` at fc6,
  fc7 and fc8 beside ``torch.matmul`` in bf16 (leg ``gemm_bf16``), of
  ``fullc_gemm_nt`` and ``fullc_gemm_tn`` at the same layers' input and
  weight gradients beside ``torch.matmul(g, w.t())`` and
  ``torch.matmul(a.t(), g)`` in bf16 (leg ``gemm_bwd_bf16``), and of
  ``conv_bias_act`` at conv1-conv5 beside ``F.conv2d`` in bf16 +
  ``relu_`` (leg ``conv_bf16``), each with its sum over the layers;
* ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` in bf16, causal, at b1 h8
  d64, s2048 and s32768, beside
  ``F.scaled_dot_product_attention(is_causal=True)`` (timed only): its
  forward, and its autograd backward (forward + backward less forward,
  dq, dk and dv together) beside dq + dk/dv.  The backward kernels take
  the tree's own forward's lse and ``delta = sum(do * out)``;
* ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` in f32 at the
  ``seqpar`` path's b1 h16 s8192 d64 causal (dq and dk/dv from the plain
  forward's lse and delta), beside SDPA's f32 forward and its autograd
  backward (forward + backward less forward);
* ``int8_matmul`` at ``chip_smoke.py``'s seven ``INT8_SHAPES`` (the
  quantized decode step's 64 rows through the projections, the FFN and
  the head; prefill at 128, 8 and 1 rows), beside ``torch._int_mm``
  where its shape rules allow (more than 16 rows), and the decode step's
  sum (32 projections, 8 of each FFN product, the head);
* ``paged_flash_decode`` and ``paged_flash_verify`` (K = 4), f32 and
  bf16, at the smoke's ``paged_kernel_checks`` shapes (16 slots, 16
  heads of 64, 16 pages of 16 positions a slot over a shuffled pool of
  257 pages), beside the page gather + SDPA over the dense cache;
* ``lrn_forward`` (inference form, and the training form that writes
  ``norm``) and ``lrn_backward`` at AlexNet's ``norm1`` (256 x 27 x 27 x
  96) and ``norm2`` (256 x 13 x 13 x 256), local_size 5, beside
  ``F.local_response_norm`` forward and forward + backward on the same
  NCHW views.

The int8, paged and LRN kernels are short, so each also reports
``graph_ms``: the calls captured in one CUDA graph and replayed, which
leaves out the wrapper's host time that back-to-back launches include.
The LRN legs cycle through input sets that a set reuses only after twice
the 50 MB L2 has been moved (``norm2``'s input alone fits the L2), so
every launch reads from device memory.

The library calls run in full f32: TF32 off for cuBLAS and cuDNN.

Needs a CUDA device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# chip_smoke.py of this tool's own tree, imported before a measured tree
# is put on sys.path (a parent's chip_smoke.py may lack these)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (LRN_ARGS, LRN_SHAPES, cycling,  # noqa: E402
                        graph_ms, rotating, time_ms)

#: the legs, in the order a process times them
LEGS = ('lrn', 'int8', 'paged', 'gemm', 'gemm_bf16', 'gemm_bwd_bf16',
        'conv', 'conv_bf16', 'flash_bf16', 'flash_f32')
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
# chip_smoke.py's INT8_SHAPES and INT8_STEP_USES
INT8 = [('decode_qkvo', 64, 1024, 1024), ('decode_w1', 64, 1024, 4096),
        ('decode_w2', 64, 4096, 1024), ('decode_head', 64, 1024, 32768),
        ('prefill128_qkvo', 128, 1024, 1024), ('prefill8_w2', 8, 4096, 1024),
        ('prefill_head_m1', 1, 1024, 32768)]
INT8_STEP_USES = {'decode_qkvo': 32, 'decode_w1': 8, 'decode_w2': 8,
                  'decode_head': 1}
# chip_smoke.py's paged_kernel_checks: S, H, hd, ps, pp, P
PAGED = (16, 16, 64, 16, 16, 257)


def _int8(gen) -> dict:
    import torch
    from cxxnet_tpu_torch.ops.kernels import int8_matmul
    out = {}
    for name, m, k, n in INT8:
        a = torch.randint(-127, 128, (m, k), device='cuda', generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), device='cuda', generator=gen,
                          dtype=torch.int8)
        lib = m > 16 and k % 8 == 0 and n % 8 == 0
        out[name] = {
            'kernel_ms': time_ms(lambda: int8_matmul(a, b), 50),
            'graph_ms': graph_ms(lambda: int8_matmul(a, b), 50),
            'int_mm_ms': time_ms(lambda: torch._int_mm(a, b), 50)
            if lib else None}
    out['decode_step'] = {
        key: sum(uses * out[name][key]
                 for name, uses in INT8_STEP_USES.items())
        for key in ('kernel_ms', 'graph_ms', 'int_mm_ms')}
    return out


def _paged() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.attention import (gather_pages, live_mask,
                                                paged_flash_decode,
                                                paged_flash_verify)
    S, H, hd, ps, pp, P = PAGED
    T = ps * pp
    rng = np.random.RandomState(11)
    pool = [torch.from_numpy(rng.randn(P, ps, H, hd).astype(np.float32))
            .cuda() for _ in range(2)]
    table = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(
        S, pp).astype(np.int32)).cuda()
    pos_np = rng.randint(0, T - 3, S).astype(np.int32)
    w_np = np.minimum(rng.randint(0, 8, S), pos_np).astype(np.int32)
    pos, w = (torch.from_numpy(x).cuda() for x in (pos_np, w_np))
    out = {}
    for dtype, sfx in ((torch.float32, ''), (torch.bfloat16, '_bf16')):
        kp, vp = (t.to(dtype) for t in pool)
        for name, K, fn in (('decode', 1, paged_flash_decode),
                            ('verify', 4, paged_flash_verify)):
            q = torch.from_numpy(rng.randn(S, K, H, hd).astype(
                np.float32)).cuda().to(dtype)
            qk = q[:, 0].contiguous() if K == 1 else q
            args = (qk, kp, vp, table, pos, w, hd ** -0.5)
            mask = live_mask(T, pos.long(), w.long(), K)
            qd = q.transpose(1, 2)

            def library():
                kd = gather_pages(kp, table).transpose(1, 2)
                vd = gather_pages(vp, table).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask, scale=hd ** -0.5)
            out[name + sfx] = {
                'kernel_ms': time_ms(lambda: fn(*args), 200),
                'graph_ms': graph_ms(lambda: fn(*args), 200),
                'gather_sdpa_ms': time_ms(library, 50)}
    return out


def _sets(tensors, nbytes):
    """``tensors`` and copies of them, ``rotating(nbytes)`` sets."""
    return [tensors] + [[t.clone() for t in tensors]
                        for _ in range(rotating(nbytes) - 1)]


def _lrn(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.kernels import (_lrn_call, lrn_backward,
                                              lrn_forward_plain)
    nsize, alpha, beta, knorm = LRN_ARGS
    out = {}
    for name, shape in LRN_SHAPES:
        x = torch.randn(shape, device='cuda', generator=gen) * 4.0
        g = torch.randn(shape, device='cuda', generator=gen)
        norm = lrn_forward_plain(x, nsize, alpha, beta, knorm)[1]
        n = x.numel()
        res = {}
        for form, nbytes, make in (
                ('fwd', 8, lambda s: lambda: _lrn_call(
                    s[0], nsize, alpha, beta, knorm, False)),
                ('fwd_train', 12, lambda s: lambda: _lrn_call(
                    s[0], nsize, alpha, beta, knorm, True)),
                ('bwd', 16, lambda s: lambda: lrn_backward(
                    *s, nsize, alpha, beta))):
            fn = cycling([make(s) for s in _sets(
                [x] if form != 'bwd' else [x, g, norm], nbytes * n)])
            res[form] = {'kernel_ms': time_ms(fn, 20),
                         'graph_ms': graph_ms(fn, 20)}
        leaves = [(s[0].permute(0, 3, 1, 2).detach().requires_grad_(),
                   s[1].permute(0, 3, 1, 2)) for s in _sets([x, g], 8 * n)]

        def lib_fwd(xr):
            return F.local_response_norm(xr, nsize, alpha, beta, knorm)

        def lib_fwd_bwd(xr, gr):
            with torch.enable_grad():
                return torch.autograd.grad(lib_fwd(xr), xr, gr)[0]
        res['local_response_norm'] = {
            'fwd_ms': time_ms(cycling([lambda a=a: lib_fwd(a[0])
                                       for a in leaves]), 20),
            'fwd_bwd_ms': time_ms(cycling([lambda a=a: lib_fwd_bwd(*a)
                                           for a in leaves]), 20)}
        out[name] = res
        del x, g, norm, leaves
        torch.cuda.empty_cache()
    out['sum'] = {form: {k: sum(out[s][form][k] for s, _ in LRN_SHAPES)
                         for k in ('kernel_ms', 'graph_ms')}
                  for form in ('fwd', 'fwd_train', 'bwd')}
    return out


def _gemm_bf16(gen) -> dict:
    import torch
    from cxxnet_tpu_torch.ops.kernels import fullc_gemm
    out = {}
    for name, m, k, n in GEMMS:
        a = torch.randn((m, k), device='cuda', generator=gen).bfloat16()
        b = (torch.randn((k, n), device='cuda', generator=gen)
             * k ** -0.5).bfloat16()
        out[name] = {'kernel_ms': time_ms(lambda: fullc_gemm(a, b), 50),
                     'matmul_ms': time_ms(lambda: torch.matmul(a, b), 50)}
        del a, b
    out['sum'] = {f: sum(r[f] for r in list(out.values()))
                  for f in ('kernel_ms', 'matmul_ms')}
    return out


def _gemm_bwd_bf16(gen) -> dict:
    import torch
    from cxxnet_tpu_torch.ops.kernels import fullc_gemm_nt, fullc_gemm_tn
    out = {'gemm_nt': {}, 'gemm_tn': {}}
    for name, m, k, n in GEMMS:
        a = torch.randn((m, k), device='cuda', generator=gen).bfloat16()
        w = (torch.randn((k, n), device='cuda', generator=gen)
             * n ** -0.5).bfloat16()
        g = torch.randn((m, n), device='cuda', generator=gen).bfloat16()
        out['gemm_nt'][name] = {
            'kernel_ms': time_ms(lambda: fullc_gemm_nt(g, w), 50),
            'matmul_ms': time_ms(lambda: torch.matmul(g, w.t()), 50)}
        out['gemm_tn'][name] = {
            'kernel_ms': time_ms(lambda: fullc_gemm_tn(a, g), 50),
            'matmul_ms': time_ms(lambda: torch.matmul(a.t(), g), 50)}
        del a, w, g
    for key in ('gemm_nt', 'gemm_tn'):
        out[key]['sum'] = {f: sum(r[f] for r in list(out[key].values()))
                           for f in ('kernel_ms', 'matmul_ms')}
    return out


def _conv(gen, dtype) -> dict:
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.cnn import conv_bias_act
    out = {}
    for name, xs, kh, kw, cin_g, cout, s, p, groups in CONVS:
        x = torch.randn(xs, device='cuda', generator=gen).to(dtype)
        w = (torch.randn((kh, kw, cin_g, cout), device='cuda', generator=gen)
             * (kh * kw * cin_g) ** -0.5).to(dtype)
        b = (torch.randn((cout,), device='cuda', generator=gen)
             * 0.1).to(dtype)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        out[name] = {
            'kernel_ms': time_ms(lambda: conv_bias_act(
                x, w, b, (s, s), ((p, p), (p, p)), groups, 'relu'), 10),
            'conv2d_relu_ms': time_ms(lambda: F.conv2d(
                x_nchw, w_oihw, b, stride=s, padding=p,
                groups=groups).relu_(), 10)}
        del x, w, b, x_nchw, w_oihw
    out['sum'] = {f: sum(r[f] for r in list(out.values()))
                  for f in ('kernel_ms', 'conv2d_relu_ms')}
    return out


def _gemm_f32(gen) -> dict:
    import torch
    from cxxnet_tpu_torch.ops.kernels import (fullc_gemm, fullc_gemm_nt,
                                              fullc_gemm_tn)
    out = {'gemm': {}, 'gemm_nt': {}, 'gemm_tn': {}}
    for name, m, k, n in GEMMS:
        a = torch.randn((m, k), device='cuda', generator=gen)
        b = torch.randn((k, n), device='cuda', generator=gen)
        g = torch.randn((m, n), device='cuda', generator=gen)
        out['gemm'][name] = {
            'kernel_ms': time_ms(lambda: fullc_gemm(a, b), 50),
            'matmul_ms': time_ms(lambda: torch.matmul(a, b), 50)}
        out['gemm_nt'][name] = {
            'kernel_ms': time_ms(lambda: fullc_gemm_nt(g, b), 50),
            'matmul_ms': time_ms(lambda: torch.matmul(g, b.t()), 50)}
        out['gemm_tn'][name] = {
            'kernel_ms': time_ms(lambda: fullc_gemm_tn(a, g), 50),
            'matmul_ms': time_ms(lambda: torch.matmul(a.t(), g), 50)}
        del a, b, g
    for key in ('gemm', 'gemm_nt', 'gemm_tn'):
        out[key]['sum'] = {f: sum(r[f] for r in list(out[key].values()))
                           for f in ('kernel_ms', 'matmul_ms')}
    return out


def _flash_bf16(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.flash import flash_dkv, flash_dq, flash_fwd
    out = {}
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
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), max(iters, 20))
        out[name] = {
            'kernel_ms': time_ms(lambda: flash_fwd(q, k, v, True), iters),
            'sdpa_ms': sdpa_fwd,
            'dq_ms': time_ms(lambda: flash_dq(q, k, v, do, lse, delta,
                                              True), iters),
            'dkv_ms': time_ms(lambda: flash_dkv(q, k, v, do, lse, delta,
                                                True), iters)}
        leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, dos)
        out[name]['sdpa_bwd_ms'] = max(
            time_ms(sdpa_fwd_bwd, max(iters, 20)) - sdpa_fwd, 0.0)
        del q, k, v, do, o, lse, delta, leaves
        torch.cuda.empty_cache()
    return out


def _flash_f32(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.flash import (flash_dkv, flash_dq, flash_fwd,
                                            flash_fwd_plain)
    name, bs, h, s, d = FLASH_F32
    q, k, v, do = (torch.randn((bs * h, s, d), device='cuda',
                               generator=gen) for _ in range(4))
    o, lse = flash_fwd_plain(q, k, v, True)
    delta = (do * o).sum(-1)
    qs, ks, vs, dos = (x.view(bs, h, s, d) for x in (q, k, v, do))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), 20)
    leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]

    def sdpa_fwd_bwd():
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            return torch.autograd.grad(o, leaves, dos)
    out = {name: {
        'fwd_ms': time_ms(lambda: flash_fwd(q, k, v, True), 20),
        'sdpa_fwd_ms': sdpa_fwd,
        'dq_ms': time_ms(lambda: flash_dq(q, k, v, do, lse, delta, True),
                         20),
        'dkv_ms': time_ms(lambda: flash_dkv(q, k, v, do, lse, delta, True),
                          20),
        'sdpa_bwd_ms': max(time_ms(sdpa_fwd_bwd, 20) - sdpa_fwd, 0.0)}}
    del q, k, v, do, o, lse, delta, leaves
    torch.cuda.empty_cache()
    return out


def measure(tree: str, legs=LEGS) -> dict:
    """The timings of ``tree``'s kernels on card 0, leg by leg."""
    sys.path.insert(0, tree)
    import torch
    from cxxnet_tpu_torch.ops import build
    assert os.path.dirname(os.path.dirname(build.__file__)).startswith(
        os.path.abspath(tree)), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.build_all()
    gen = torch.Generator(device='cuda').manual_seed(7)
    run = {'lrn': _lrn, 'int8': _int8, 'paged': lambda gen: _paged(),
           'gemm': _gemm_f32, 'gemm_bf16': _gemm_bf16,
           'gemm_bwd_bf16': _gemm_bwd_bf16,
           'conv': lambda gen: _conv(gen, torch.float32),
           'conv_bf16': lambda gen: _conv(gen, torch.bfloat16),
           'flash_bf16': _flash_bf16, 'flash_f32': _flash_f32}
    out = {'tree': tree, 'nvidia_smi': smi, 'legs': list(legs)}
    with torch.no_grad():
        for leg in LEGS:
            if leg not in legs:
                continue
            res = run[leg](gen)
            # the f32 GEMM leg times all three GEMMs
            out.update(res if leg == 'gemm' else {leg: res})
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ['--one']:
        legs = argv[2].split(',') if len(argv) > 2 else LEGS
        print(json.dumps(measure(os.path.abspath(argv[1]), legs)),
              flush=True)
        return 0
    legs = ','.join(LEGS)
    if argv[:1] == ['--legs']:
        legs, argv = argv[1], argv[2:]
        unknown = set(legs.split(',')) - set(LEGS)
        if unknown:
            raise SystemExit(f'unknown legs {sorted(unknown)}; legs: {LEGS}')
    trees = argv or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--one', tree, legs]).returncode
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
