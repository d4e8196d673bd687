"""Flash attention: the forward, dq and dk/dv kernels, their plain
versions, the autograd function over them, and the gate that sends a
local attention to them.

Counterpart of the flash third of ``cxxnet_tpu/ops/pallas_kernels.py``
(``ops/attention.py`` holds the paged half).  Each wrapper checks its
inputs and launches its CUDA kernel on CUDA tensors (counting the
launch), runs the plain version on CPU tensors, and raises on anything
else; there is no fallback from the card to the plain version.

* ``flash_fwd`` (``csrc/flash_fwd.cu``) replaces ``_flash_fwd_kernel``
  (pallas_kernels.py:612, ``_flash_fwd_impl`` :768): out and the
  row-wise log-sum-exp over the live keys.
* ``flash_dq`` (``csrc/flash_dq.cu``) replaces ``_flash_dq_kernel``
  (:661) and ``flash_dkv`` (``csrc/flash_dkv.cu``) ``_flash_dkv_kernel``
  (:699), the two kernels of ``_flash_bhsd_bwd`` (:808), from the
  forward's lse and ``delta = sum(g * out, -1)``, which the backward
  computes in torch outside any kernel as JAX does.

All three work on ``(b*h, seq, d)`` arrays, take float32 or bfloat16
(q, k, v and the cotangent in one dtype; lse and delta float32), sum in
float32 and round only their outputs to the input dtype, as the TPU
kernels cast to ``o_ref.dtype``; the bf16 builds count their launches
under ``*_bf16``.  The f32 builds run their products on the TF32 tensor
cores with the 3xTF32 split (three TF32 products a term, each tile's
products summed apart), which keeps f32 accuracy.  The f32 forward
scales q before the dot, dq and dk scale after it, as the TPU kernels
do; the bf16 forward runs both of its products on the tensor cores from
bf16 operands, scales the f32 score after the dot and multiplies V by
the softmax weights split into two bf16 halves (``csrc/flash_fwd.cu``),
so it stays within one bf16 step of the plain version.  ``causal`` is
the top-left mask (query r sees keys c <= r).

The plain versions compute the same functions densely, one ``b*h``
slice at a time (an ``(sq, sk)`` score matrix per slice), with the same
masks and scale points.
"""

from __future__ import annotations

import math

import torch

from . import build, launches
from .kernels import pallas_mode

#: the dense-score budget of the JAX gate (pallas_kernels.py:63): the
#: local attention's batch*heads*seq^2 f32 score matrix at this size or
#: above takes the flash kernels under ``auto``
FLASH_SCORE_BYTES = 4 << 30


def attn_use_flash(seq_len: int, batch: int = 1, heads: int = 1,
                   mode='auto', device='cpu') -> bool:
    """Whether flash attention replaces the dense local attention of a
    ``batch x heads x seq x seq`` problem on ``device``.  ``mode`` is the
    ``use_pallas`` tri-state (:func:`kernels.pallas_mode` spellings):
    ``on`` forces the kernels (their plain versions on the CPU), ``off``
    the dense path; ``auto`` engages only on a CUDA device and only when
    the dense f32 scores would reach :data:`FLASH_SCORE_BYTES`, as the
    JAX gate engages only on a TPU.  A memory bound, not a speed
    claim."""
    mode = pallas_mode(mode)
    if mode != 'auto':
        return mode == 'on'
    return (torch.device(device).type == 'cuda'
            and 4.0 * batch * heads * seq_len * seq_len >= FLASH_SCORE_BYTES)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(sq, sk) bool, True where query r attends key c (c <= r)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril()


def flash_fwd_plain(q, k, v, causal: bool):
    """The plain forward: ``(out, lse)`` for (bh, sq, d) q and (bh, sk,
    d) k, v; lse is float32 over the live keys."""
    bh, sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    mask = _causal_mask(sq, k.shape[1], q.device) if causal else None
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    for i in range(bh):
        s = (q[i].float() * scale) @ k[i].float().T
        if mask is not None:
            s = s.masked_fill(~mask, -math.inf)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        out[i] = ((p @ v[i].float()) / l).to(q.dtype)
        lse[i] = (m + torch.log(l))[:, 0]
    return out, lse


def _p_ds(q, k, v, do, lse, delta, mask, scale):
    """One slice's weights ``p`` and score cotangents ``ds`` (sq, sk)."""
    s = (q.float() @ k.float().T) * scale
    p = torch.exp(s - lse[:, None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = do.float() @ v.float().T
    return p, p * (dp - delta[:, None])


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool):
    """The plain dq: ``scale * ds @ k`` per slice."""
    sq, d = q.shape[1:]
    scale = 1.0 / math.sqrt(d)
    mask = _causal_mask(sq, k.shape[1], q.device) if causal else None
    dq = torch.empty_like(q)
    for i in range(q.shape[0]):
        _, ds = _p_ds(q[i], k[i], v[i], do[i], lse[i], delta[i], mask, scale)
        dq[i] = ((ds @ k[i].float()) * scale).to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """The plain dk, dv: ``scale * ds^T @ q`` and ``p^T @ do`` per
    slice."""
    sq, d = q.shape[1:]
    scale = 1.0 / math.sqrt(d)
    mask = _causal_mask(sq, k.shape[1], q.device) if causal else None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for i in range(q.shape[0]):
        p, ds = _p_ds(q[i], k[i], v[i], do[i], lse[i], delta[i], mask,
                      scale)
        dv[i] = (p.T @ do[i].float()).to(v.dtype)
        dk[i] = ((ds.T @ q[i].float()) * scale).to(k.dtype)
    return dk, dv


_ENTRY_SUFFIX = {torch.float32: '', torch.bfloat16: '_bf16'}


def _check(name, q, k, v, do=None, lse=None, delta=None) -> str:
    """Device, dtype, shape and contiguity checks of a kernel launch;
    returns the build's suffix (``''`` f32, ``'_bf16'``)."""
    if q.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {q.device}')
    if q.dtype not in _ENTRY_SUFFIX:
        raise ValueError(f'{name}: q is {q.dtype}; the kernels take float32 '
                         'or bfloat16')
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f'{name}: q and k must be (bh, seq, d), got '
                         f'{tuple(q.shape)} and {tuple(k.shape)}')
    bh, sq, d = q.shape
    sk = k.shape[1]
    want = [('q', q, q.dtype, (bh, sq, d)), ('k', k, q.dtype, (bh, sk, d)),
            ('v', v, q.dtype, (bh, sk, d))]
    if do is not None:
        want += [('do', do, q.dtype, (bh, sq, d)),
                 ('lse', lse, torch.float32, (bh, sq)),
                 ('delta', delta, torch.float32, (bh, sq))]
    for tname, t, dt, shape in want:
        if t.device != q.device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f'{name}: {tname} must be a contiguous {dt} tensor of shape '
                f'{shape} on {q.device}, got {tuple(t.shape)} {t.dtype} on '
                f'{t.device}' + ('' if t.is_contiguous()
                                 else ' (not contiguous)'))
    if not (0 < d <= 128 and 0 < bh <= 65535 and sq > 0 and sk > 0):
        raise ValueError(f'{name}: (bh, sq, sk, d) = {(bh, sq, sk, d)} '
                         'outside the kernels\' 1..65535 slices and head '
                         'dims 1..128')
    return _ENTRY_SUFFIX[q.dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False):
    """``(out, lse)`` of attention of (bh, sq, d) ``q`` over (bh, sk, d)
    ``k``, ``v``.  The CUDA kernel on the card, :func:`flash_fwd_plain`
    on the CPU."""
    if q.device.type == 'cpu':
        return flash_fwd_plain(q, k, v, causal)
    sfx = _check('flash_fwd', q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = build.entry('flash_fwd' + sfx)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, k.shape[1], d, int(causal),
        1.0 / math.sqrt(d), _stream(q))
    build.check_launch(err, 'flash_fwd')
    launches.add('flash_fwd' + sfx)
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool = False) -> torch.Tensor:
    """dq of the attention from the cotangent ``do`` (bh, sq, d), the
    forward's ``lse`` and ``delta = sum(do * out, -1)`` (bh, sq) f32.
    The CUDA kernel on the card, :func:`flash_dq_plain` on the CPU."""
    if q.device.type == 'cpu':
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    sfx = _check('flash_dq', q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    err = build.entry('flash_dq' + sfx)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
        d, int(causal), 1.0 / math.sqrt(d), _stream(q))
    build.check_launch(err, 'flash_dq')
    launches.add('flash_dq' + sfx)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """``(dk, dv)`` of the attention, from the same inputs as
    :func:`flash_dq`.  The CUDA kernel on the card,
    :func:`flash_dkv_plain` on the CPU."""
    if q.device.type == 'cpu':
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    sfx = _check('flash_dkv', q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.entry('flash_dkv' + sfx)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, k.shape[1], d, int(causal), 1.0 / math.sqrt(d), _stream(q))
    build.check_launch(err, 'flash_dkv')
    launches.add('flash_dkv' + sfx)
    return dk, dv


class _FlashBHSD(torch.autograd.Function):
    """Attention over (bh, s, d) arrays: the forward kernel, and a
    backward of one dq and one dk/dv launch (``_flash_bhsd`` :791 and its
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(-1)
        dq = flash_dq(q, k, v, g, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128):
    """Exact attention over ``(batch, seq, heads, head_dim)`` tensors,
    differentiable, without an ``(sq, sk)`` matrix in device memory on
    the card.  Oracle: ``parallel.sequence.attention_reference``.

    ``causal=True`` is the top-left mask, which only makes sense for
    ``sq == sk``; other lengths with ``causal`` raise, as in the JAX
    package.  ``block_q``/``block_k`` are the JAX signature's tile sizes:
    the kernels tile 64 x 64 and the plain versions are dense, and
    neither changes a result."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError(
            f'causal flash_attention requires q and k of equal length '
            f'(top-left mask alignment); got sq={sq} sk={sk}')
    if block_q < 1 or block_k < 1:
        raise ValueError(f'block sizes must be positive, got {block_q}, '
                         f'{block_k}')

    def to_bhsd(x, s):
        return x.transpose(1, 2).reshape(b * h, s, x.shape[-1]).contiguous()

    out = _FlashBHSD.apply(to_bhsd(q, sq), to_bhsd(k, sk), to_bhsd(v, sk),
                           causal)
    return out.reshape(b, h, sq, d).transpose(1, 2)
