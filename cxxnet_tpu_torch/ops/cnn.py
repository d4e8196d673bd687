"""Fused conv + bias + activation: the CUDA kernel, its wrapper, its plain
version and its gate.

Counterpart of ``cxxnet_tpu/ops/pallas_cnn.py``.  ``conv_bias_act`` takes
the JAX function's signature — NHWC input, HWIO weight, optional bias,
``strides=(sy, sx)``, ``padding=((top, bottom), (left, right))``,
``groups``, ``act in {'relu', 'identity'}`` — and computes the
convolution, the bias and the activation in one kernel
(``csrc/conv_bias_act.cu``, an implicit GEMM whose patch matrix never
reaches device memory).

* On a CUDA tensor the wrapper checks device, dtype, shapes and
  contiguity, launches the kernel on PyTorch's current stream, raises if
  the launch failed, and counts the launch (``ops/launches.py``).
* On a CPU tensor it runs :func:`conv_bias_act_plain`, the same function
  step by step on tensors (the im2col GEMM of ``_conv_act_kernel``).
  Nothing falls back: any other device raises.
* The pre-activation ``z`` is written only when autograd will need it.
* The backward mirrors ``_fused_bwd`` (pallas_cnn.py:220-236): the saved
  ``z`` masks the upstream gradient (0.5 at an exact ``z == 0`` tie, as
  ``jnp.maximum``'s gradient splits it), ``dx`` and ``dw`` are the
  convolution's transposes and ``db`` the masked gradient summed over
  (n, y, x).  The JAX package hands the transposes to XLA — the
  backward is not a Pallas kernel there — so the port computes them
  with library calls (no kernel of this repository; no launch counted),
  as the transposes of the plain forward's im2col GEMM, in NHWC/HWIO
  with no layout change: per group ``dw = patchesᵀ @ g`` (one cuBLAS
  GEMM contracting all n·oy·ox positions) and ``dx`` from ``g @ wᵀ``
  scattered back by kh·kw strided adds (col2im in a fixed order, no
  atomics), all in full f32 (TF32 off, ``ops/precision.py``).  Both
  stock routes fall short on an H100: cuDNN's f32 weight gradient of
  AlexNet's grouped 5x5 conv2 lies ~3e-2 of its largest value away from
  float64, and PyTorch's native convolution, accurate, loops over the
  batch sample by sample and doubled the train step.
  ``tests/test_torch_cuda.py`` holds this backward to float64.

Mixed precision (``compute_type=bfloat16`` or ``=float16``): ``x``,
``w`` and ``b`` arrive in the 16-bit compute dtype, as the net casts them
(JAX ``nnet/net.py:579-584``); the kernel's bf16 or f16 build
(``conv_bias_act_bf16`` / ``conv_bias_act_f16``, each its own launch
count, one templated body in ``csrc/conv_bias_act_bf16.cu``) widens them
to f32, sums in f32, and writes ``y`` in the 16-bit dtype (one rounding;
in f16 a sum past 65504 becomes inf, as JAX's ``astype`` makes it) and
``z`` in f32, as ``_fused_call`` does (pallas_cnn.py:190-192).  The
backward takes the masked gradient in the 16-bit dtype, as ``_fused_bwd``
does, and sums ``dx``'s col2im in f32 with one rounding at the end, as
XLA's conv transpose does (a 16-bit accumulator would round once per tap
covering an element: 25 times for a 5x5 stride-1 conv).

JAX's ``microbatched_conv`` (a ``lax.map`` split, not a Pallas kernel)
is ``ops/microbatch.py``; a microbatched conv, like a conv on another
lowering than native, never takes this kernel (``nnet/net.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build, launches
from .precision import full_f32


def conv_use_fused(explicit=None, mode: str = 'auto') -> bool:
    """Whether eligible conv(+bias)+relu pairs take the fused kernel.
    ``explicit`` is the ``fuse=`` net param: ``1``/``0`` force it on/off;
    anything else defers to the tri-state kernel ``mode`` (the
    ``use_pallas=`` net param): ``on``/``off`` force, ``auto`` takes the
    kernel — what the JAX package's ``auto`` does on one TPU chip
    (``cxxnet_tpu/ops/pallas_cnn.py:67-88``)."""
    if explicit is not None:
        text = str(explicit).strip().lower()
        if text in ('1', 'true', 'yes', 'on'):
            return True
        if text in ('0', 'false', 'no', 'off'):
            return False
    return mode != 'off'


def _out_size(h: int, w: int, kh: int, kw: int, strides, padding):
    (py_lo, py_hi), (px_lo, px_hi) = padding
    oy = (h + py_lo + py_hi - kh) // strides[0] + 1
    ox = (w + px_lo + px_hi - kw) // strides[1] + 1
    if oy <= 0 or ox <= 0:
        raise ValueError('fused conv: kernel larger than padded input')
    return oy, ox


def _patches(xp: torch.Tensor, kh, kw, sy, sx, oy, ox) -> torch.Tensor:
    """The patch matrix of a zero-padded NHWC input: one row per output
    position (n, y, x), columns in (u, v, c) order — the row order of an
    HWIO weight.  The windows are a strided view of ``xp``; the matrix is
    one copy of it."""
    n, c = xp.shape[0], xp.shape[3]
    windows = xp.unfold(1, kh, sy).unfold(2, kw, sx)[:, :oy, :ox]
    return windows.permute(0, 1, 2, 4, 5, 3).reshape(n * oy * ox,
                                                     kh * kw * c)


def conv_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor], strides, padding,
                        groups: int = 1, act: str = 'relu'
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: zero-pad, build each group's patch matrix from
    strided slices over the kernel taps (column order (u, v, c), the row
    order of the HWIO weight), one matmul per group, bias, activation.
    Returns ``(y, z)`` with ``z`` the f32 pre-activation."""
    if act not in ('relu', 'identity'):
        raise ValueError(f'fused conv: unknown act {act!r}')
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    sy, sx = strides
    (py_lo, py_hi), (px_lo, px_hi) = padding
    oy, ox = _out_size(h, wd, kh, kw, strides, padding)
    xp = F.pad(x.float(), (0, 0, px_lo, px_hi, py_lo, py_hi))
    w2 = w.float().reshape(kh * kw * cin_g, cout)
    cout_g = cout // groups
    outs = []
    for g in range(groups):
        patches = _patches(xp[..., g * cin_g:(g + 1) * cin_g], kh, kw, sy,
                           sx, oy, ox)
        outs.append(patches @ w2[:, g * cout_g:(g + 1) * cout_g])
    z = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    if b is not None:
        z = z + b.float()
    z = z.reshape(n, oy, ox, cout)
    y = torch.relu(z) if act == 'relu' else z
    return y.to(x.dtype), z


def _conv_call(x, w, b, strides, padding, groups, act, need_z):
    if act not in ('relu', 'identity'):
        raise ValueError(f'fused conv: unknown act {act!r}')
    if x.device.type == 'cpu':
        return conv_bias_act_plain(x, w, b, strides, padding, groups, act)
    if x.device.type != 'cuda':
        raise RuntimeError(f'conv_bias_act: no kernel for device {x.device}')
    kernel = 'conv_bias_act' + build.dtype_suffix('conv_bias_act', x.dtype)
    tensors = [('x', x, 4), ('w', w, 4)] + ([('b', b, 1)] if b is not None
                                             else [])
    for name, t, ndim in tensors:
        if t.device != x.device or t.dtype != x.dtype \
                or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f'conv_bias_act: {name} must be a contiguous {ndim}-d '
                f'{x.dtype} tensor on {x.device}, got {tuple(t.shape)} '
                f'{t.dtype} on {t.device}')
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    if groups < 1 or cin != cin_g * groups or cout % groups:
        raise ValueError(f'conv_bias_act: cin {cin} / cin_g {cin_g} / '
                         f'cout {cout} do not fit groups={groups}')
    if b is not None and b.shape[0] != cout:
        raise ValueError(f'conv_bias_act: bias {tuple(b.shape)} != ({cout},)')
    oy, ox = _out_size(h, wd, kh, kw, strides, padding)
    y = torch.empty((n, oy, ox, cout), device=x.device, dtype=x.dtype)
    z = torch.empty(y.shape, device=x.device, dtype=torch.float32) \
        if need_z else None
    err = build.entry(kernel)(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), None if z is None else z.data_ptr(),
        n, h, wd, cin, kh, kw, cout, groups, strides[0], strides[1],
        padding[0][0], padding[1][0], oy, ox, int(act == 'relu'),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, kernel)
    launches.add(kernel)
    return y, z


def conv_bias_act_backward(x: torch.Tensor, w: torch.Tensor,
                           z: torch.Tensor, gy: torch.Tensor, strides,
                           padding, groups: int, act: str,
                           needs=(True, True, True)):
    """Gradients ``(dx, dw, db)`` of :func:`conv_bias_act` from the saved
    f32 pre-activation ``z`` and the upstream gradient ``gy`` (NHWC);
    entries whose ``needs`` flag is False come back as None."""
    g = gy.float()
    if act == 'relu':
        g = torch.where(z > 0, g, torch.where(z == 0, 0.5 * g, 0.0))
    gx = g.to(x.dtype)
    dx = dw = db = None
    if needs[0] or needs[1]:
        dx, dw = conv_transposes(x, w, gx, strides, padding, groups,
                                 needs[0], needs[1])
    if needs[2]:
        db = gx.sum((0, 1, 2))
    return dx, dw, db


def conv_transposes(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    strides, padding, groups: int, need_dx: bool = True,
                    need_dw: bool = True):
    """``(dx, dw)`` of the convolution of NHWC ``x`` by HWIO ``w`` for the
    NHWC output gradient ``g``, each None unless asked: library GEMMs in
    full f32 (no TF32), col2im in a fixed order, so accurate to float64's
    ~1e-6 and deterministic.  The fused kernel's backward, and that of
    every conv the layers run off it on a card in f32
    (``layers/conv.py``)."""
    # the range lets a profiler attribute the transposes' device time
    with full_f32(), torch.profiler.record_function('conv_transposes'):
        return _conv_transposes(x, w, g, strides, padding, groups, need_dx,
                                need_dw)


def _conv_transposes(x, w, g, strides, padding, groups, need_dx, need_dw):
    """``(dx, dw)`` of the convolution for the masked NHWC gradient
    ``g``: the transposes of the plain forward's im2col GEMM, per group
    ``dw = patchesᵀ @ g`` and ``dx`` = col2im of ``g @ wᵀ``."""
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    sy, sx = strides
    (py_lo, py_hi), (px_lo, px_hi) = padding
    oy, ox = g.shape[1], g.shape[2]
    cout_g = cout // groups
    g2 = g.reshape(n * oy * ox, cout)
    xp = F.pad(x, (0, 0, px_lo, px_hi, py_lo, py_hi)) if need_dw else None
    # col2im sums in f32 whatever x's dtype and rounds once at the end
    dxp = x.new_zeros((n, h + py_lo + py_hi, wd + px_lo + px_hi, cin),
                      dtype=torch.float32) if need_dx else None
    dws = []
    for gi in range(groups):
        ci, co = slice(gi * cin_g, (gi + 1) * cin_g), \
            slice(gi * cout_g, (gi + 1) * cout_g)
        gg = g2[:, co]
        if need_dw:
            patches = _patches(xp[..., ci], kh, kw, sy, sx, oy, ox)
            dws.append(patches.t() @ gg)
            del patches
        if need_dx:
            cols = (gg.float() @ w[..., co].reshape(kh * kw * cin_g, cout_g)
                    .float().t()).view(n, oy, ox, kh * kw, cin_g)
            for t in range(kh * kw):
                u, v = divmod(t, kw)
                dxp[:, u:u + (oy - 1) * sy + 1:sy,
                    v:v + (ox - 1) * sx + 1:sx, ci] += cols[:, :, :, t, :]
            del cols
    dx = dxp[:, py_lo:py_lo + h, px_lo:px_lo + wd, :].to(x.dtype) \
        .contiguous() if need_dx else None
    dw = torch.cat(dws, dim=1).reshape(kh, kw, cin_g, cout) \
        if need_dw else None
    return dx, dw


class _ConvBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, strides, padding, groups, act):
        need_z = any(ctx.needs_input_grad[:3])
        y, z = _conv_call(x, w, b, strides, padding, groups, act, need_z)
        if need_z:
            ctx.save_for_backward(x, w, z)
            ctx.args = (strides, padding, groups, act)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, z = ctx.saved_tensors
        strides, padding, groups, act = ctx.args
        dx, dw, db = conv_bias_act_backward(
            x, w, z, gy, strides, padding, groups, act,
            ctx.needs_input_grad[:3])
        return dx, dw, db, None, None, None, None


def saved_preactivation(y: torch.Tensor) -> torch.Tensor:
    """The f32 pre-activation ``z`` that the launch which returned ``y``
    saved for its backward (a launch under autograd)."""
    if not isinstance(y.grad_fn, _ConvBiasAct._backward_cls):
        raise ValueError('saved_preactivation: y is not the output of a '
                         'conv_bias_act launch under autograd')
    return y.grad_fn.saved_tensors[2]


def conv_bias_act(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], strides: Sequence[int],
                  padding, groups: int = 1, act: str = 'relu'
                  ) -> torch.Tensor:
    """Fused conv + bias + activation over NHWC ``x`` / HWIO ``w``; the
    CUDA kernel on the card, :func:`conv_bias_act_plain` on the CPU."""
    padding = tuple(tuple(int(p) for p in pr) for pr in padding)
    return _ConvBiasAct.apply(x, w, b, tuple(int(s) for s in strides),
                              padding, int(groups), act)

