"""The paged flash-decode and flash-verify kernels, their plain versions,
and the gate of the decode engine's attention leg.

Counterpart of the paged-attention half of
``cxxnet_tpu/ops/pallas_kernels.py``.  Each wrapper checks its inputs and
launches its CUDA kernel on CUDA tensors (counting the launch), runs the
plain version on CPU tensors, and raises on anything else; there is no
fallback from the card to the plain version.

* ``paged_flash_decode`` (``csrc/paged_decode.cu``) replaces
  ``_paged_decode_kernel`` (pallas_kernels.py:910, ``paged_flash_decode``
  :942): each slot's one query attends its live rows ``[w, pos]``, read
  in place from one stage's ``(P, ps, H, hd)`` page pool through the
  ``(S, pp)`` page table.
* ``paged_flash_verify`` (``csrc/paged_verify.cu``) replaces
  ``_paged_verify_kernel`` (:988, ``paged_flash_verify`` :1021): the
  K-query window, query k over ``[w, pos + k]``.

Both take f32 or bf16 (the quantized serving tiers' compute dtype) with
q and the pools in one dtype; the bf16 builds read bf16 rows, accumulate
in f32 and round where :func:`dense_attend` on bf16 tensors rounds, and
count their launches under their own names
(``paged_flash_decode_bf16``, ``paged_flash_verify_bf16``).

The plain versions gather ``kpool[table]`` into the dense ``(S, T, H,
hd)`` cache and run :func:`dense_attend`, the one copy of
``transformer.decode_step`` / ``verify_step``'s attention (the same -inf
mask and f32 softmax).  The kernels' arithmetic depends only on the live
rows in position order (``csrc/paged_attn.cuh``), never on the cache
length, the page size or the table: a stream decoded in the engine's
shared pool and the same stream decoded alone agree bitwise, and a
verify-window query equals the decode step at its position.
"""

from __future__ import annotations

import math

import torch

from . import build, launches

_TRUE = ('1', 'true', 'yes', 'on')
_FALSE = ('0', 'false', 'no', 'off')


def decode_use_flash(explicit=None, device='cpu') -> bool:
    """Whether a decode engine on ``device`` takes the paged kernels
    (``serve.flash_decode``): ``1``/``0`` force them on or off (on the
    CPU, on means the kernels' plain versions, the validation path);
    ``auto``/None sends a CUDA engine to the kernels, as the JAX gate
    (``pallas_kernels.py:165``) sends a TPU engine to Pallas, and a CPU
    engine to the gather leg."""
    if explicit is not None:
        text = str(explicit).strip().lower()
        if text in _TRUE:
            return True
        if text in _FALSE:
            return False
        if text not in ('', 'auto'):
            raise ValueError(f'serve.flash_decode={explicit!r}: want auto, '
                             '0 or 1')
    return torch.device(device).type == 'cuda'


def live_mask(total: int, t: torch.Tensor, w: torch.Tensor,
              K: int = 1) -> torch.Tensor:
    """``(b, 1, K, total)`` bool: window query k of row r attends cache
    positions ``[w[r], t[r] + k]`` (K = 1 is the decode step's mask)."""
    ar = torch.arange(total, device=t.device)
    tq = t[:, None] + torch.arange(K, device=t.device)[None, :]
    return ((ar[None, None, :] <= tq[:, :, None])
            & (ar[None, None, :] >= w[:, None, None]))[:, None]


def dense_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 live: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention of ``q`` (b, K, H, hd) over a dense cache ``kc``/``vc``
    (b, T, H, hd) under ``live`` (b, 1, K, T): the scores, the -inf mask,
    the softmax in f32 and the weighted sum of ``decode_step`` /
    ``verify_step`` (transformer.py:871-879, :731-738)."""
    s = torch.einsum('bqhd,bkhd->bhqk', q, kc) * scale
    s = torch.where(live, s, -math.inf)
    p = torch.softmax(s.float(), dim=-1).to(kc.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, vc)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``pool[table]`` as the dense per-slot cache: (P, ps, H, hd) and
    (S, pp) -> (S, pp * ps, H, hd)."""
    S, pp = table.shape
    ps = pool.shape[1]
    return pool[table.long()].reshape(S, pp * ps, *pool.shape[2:])


def paged_flash_decode_plain(q, kpool, vpool, table, pos, w, scale):
    """The plain version: gather the slots' pages, then the dense
    attention of ``decode_step``."""
    T = table.shape[1] * kpool.shape[1]
    out = dense_attend(q[:, None], gather_pages(kpool, table),
                       gather_pages(vpool, table),
                       live_mask(T, pos.long(), w.long()), scale)
    return out[:, 0]


def paged_flash_verify_plain(q, kpool, vpool, table, pos, w, scale):
    """The plain version: gather the slots' pages, then the dense
    attention of ``verify_step`` (query k over ``[w, pos + k]``)."""
    T = table.shape[1] * kpool.shape[1]
    return dense_attend(q, gather_pages(kpool, table),
                        gather_pages(vpool, table),
                        live_mask(T, pos.long(), w.long(), q.shape[1]),
                        scale)


_ENTRY_SUFFIX = {torch.float32: '', torch.bfloat16: '_bf16'}


def _check(name, q, kpool, vpool, table, pos, w, q_dims) -> str:
    """Device, dtype, shape and contiguity checks of a kernel launch;
    returns the build's suffix (``''`` f32, ``'_bf16'``)."""
    if q.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {q.device}')
    if q.dtype not in _ENTRY_SUFFIX:
        raise ValueError(f'{name}: q is {q.dtype}; the kernels take float32 '
                         'or bfloat16')
    if q.dim() != q_dims:
        raise ValueError(f'{name}: q must have {q_dims} dims, got '
                         f'{tuple(q.shape)}')
    S, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    if kpool.dim() != 4 or tuple(kpool.shape[2:]) != (H, hd):
        raise ValueError(f'{name}: pool {tuple(kpool.shape)} is not '
                         f'(P, ps, {H}, {hd})')
    if table.dim() != 2 or table.shape[0] != S:
        raise ValueError(f'{name}: table {tuple(table.shape)} is not '
                         f'({S}, pp)')
    for tname, t, dt, shape in (
            ('q', q, q.dtype, tuple(q.shape)),
            ('kpool', kpool, q.dtype, tuple(kpool.shape)),
            ('vpool', vpool, q.dtype, tuple(kpool.shape)),
            ('table', table, torch.int32, tuple(table.shape)),
            ('pos', pos, torch.int32, (S,)), ('w', w, torch.int32, (S,))):
        if t.device != q.device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f'{name}: {tname} must be a contiguous {dt} tensor of shape '
                f'{shape} on {q.device}, got {tuple(t.shape)} {t.dtype} on '
                f'{t.device}')
    if not 0 < hd <= 256:
        raise ValueError(f'{name}: head_dim {hd} outside 1..256')
    return _ENTRY_SUFFIX[q.dtype]


def paged_flash_decode(q: torch.Tensor, kpool: torch.Tensor,
                       vpool: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, w: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """One decode step's attention for every slot over the paged pool.

    ``q`` (S, H, hd) f32 or bf16, one query per slot; ``kpool``/``vpool`` (P, ps,
    H, hd), ONE stage's pool with this step's rows already written at
    ``pos``; ``table`` (S, pp) int32 (page 0 is the scratch page);
    ``pos``/``w`` (S,) int32, each slot's position and left-pad width.
    Returns (S, H, hd).  The CUDA kernel on the card,
    :func:`paged_flash_decode_plain` on the CPU."""
    if q.device.type == 'cpu':
        return paged_flash_decode_plain(q, kpool, vpool, table, pos, w,
                                        scale)
    sfx = _check('paged_flash_decode', q, kpool, vpool, table, pos, w, 3)
    S, H, hd = q.shape
    out = torch.empty_like(q)
    err = build.entry('paged_decode' + sfx)(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), w.data_ptr(), out.data_ptr(), S, H, hd,
        kpool.shape[1], table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, 'paged_flash_decode')
    launches.add('paged_flash_decode' + sfx)
    return out


def paged_flash_verify(q: torch.Tensor, kpool: torch.Tensor,
                       vpool: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, w: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """A K-token verify window's attention for every slot, in place over
    the paged pool: ``q`` (S, K, H, hd), query k at position ``pos + k``
    over ``[w, pos + k]`` (the window's rows already written); the rest
    as :func:`paged_flash_decode`.  Returns (S, K, H, hd).  The CUDA
    kernel on the card, :func:`paged_flash_verify_plain` on the CPU."""
    if q.device.type == 'cpu':
        return paged_flash_verify_plain(q, kpool, vpool, table, pos, w,
                                        scale)
    sfx = _check('paged_flash_verify', q, kpool, vpool, table, pos, w, 4)
    S, K, H, hd = q.shape
    out = torch.empty_like(q)
    err = build.entry('paged_verify' + sfx)(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), w.data_ptr(), out.data_ptr(), S, K, H, hd,
        kpool.shape[1], table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, 'paged_flash_verify')
    launches.add('paged_flash_verify' + sfx)
    return out
