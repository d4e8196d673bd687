"""Sequence parallelism: ring and all-to-all (Ulysses) attention.

Counterpart of ``cxxnet_tpu/parallel/sequence.py``.  Attention over a
sequence sharded along one dim of a ``DeviceMesh``
(``parallel/mesh.build_mesh``): every rank of that dim calls the same
function with its own contiguous shard ``(batch, seq / n, heads,
head_dim)``, rank i holding positions ``[i * seq / n, (i + 1) * seq /
n)`` (JAX's ``P(None, axis, None, None)`` block for mesh index i), and
gets its shard of the output back.  Both are exact: the outputs match
:func:`attention_reference` over the whole sequence to numerical
tolerance, and both are differentiable.

* :func:`ring_attention`: K/V blocks rotate around the dim's ranks
  (rank i sends to i - 1, JAX's ``ppermute`` pair ``(i, i - 1)``, so the
  block held at step t came from rank ``(i + t) % n``) while each rank
  keeps its query shard, accumulating the softmax online (running max
  and denominator): no ``(seq, seq)`` matrix exists anywhere.  The
  rotation's backward rotates the cotangent the other way.
* :func:`ulysses_attention`: an all-to-all re-shards from sequence-
  parallel to head-parallel (heads must divide the dim), each rank runs
  local attention over the whole sequence for its heads (flash attention
  when :func:`ops.flash.attn_use_flash` says so, else the dense
  :func:`_local_attention`), and a second all-to-all re-shards back.

The single-device half, ``_local_attention`` (the block math the
transformer's prefill runs) and ``attention_reference`` (the oracle),
needs no mesh.  Layout as in the JAX package: ``(batch, seq, heads,
head_dim)``.  The forwards run their library products inside
``ops.precision.full_f32`` (no TF32); a caller that wants the same of
the backward runs it inside that block too.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.flash import attn_use_flash, flash_attention
from ..ops.precision import full_f32


def _local_attention(q, k, v, scale, mask=None):
    """Dense attention on local blocks.  q:(b,sq,h,d) k,v:(b,sk,h,d);
    ``mask`` broadcasts against the (b, h, sq, sk) scores, True = attend."""
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -math.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def attention_reference(q, k, v, causal: bool = False):
    """Single-device reference attention (the correctness oracle)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device))[None, None]
    return _local_attention(q, k, v, scale, mask)


def _axis(mesh, axis_name: str):
    """``(group, n, index)`` of this rank along ``axis_name``."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


class _Rotate(torch.autograd.Function):
    """Send ``x`` to the dim's rank ``i + shift`` and receive from rank
    ``i - shift``; the backward rotates the cotangent by ``-shift``."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g.contiguous(), ctx.group, -ctx.shift), None, None


def _rotate(x, group, shift):
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(me + shift) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)])
    for r in reqs:
        r.wait()
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks along dim 0: chunk j goes to
    the dim's rank j, and the chunk from rank j lands at j.  The backward
    is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def _all_to_all(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ring_attention(q, k, v, mesh, axis_name: str = 'data',
                   causal: bool = False):
    """Exact attention over the sequence sharded along ``axis_name`` of
    ``mesh``: ``q``/``k``/``v`` are this rank's ``(b, s/n, h, d)`` shards;
    returns this rank's output shard.  ``causal`` masks by global
    position (rank i's query p sees every key at or before ``i * s/n +
    p``)."""
    with full_f32():
        return _ring_local(q, k, v, *_axis(mesh, axis_name), causal)


def _ring_local(q, k, v, group, n, me, causal: bool):
    """The per-rank body of :func:`ring_attention` (JAX's
    ``_ring_attention_local``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    sk = k.shape[1]
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    # K and V travel as one tensor, so each step is ONE rotation and the
    # backward's rotations run in one order on every rank
    kv = torch.stack([k, v])
    q_pos = me * sq + torch.arange(sq, device=q.device)
    for step in range(n):
        if step:
            kv = _Rotate.apply(kv, group, -1)
        k_blk, v_blk = kv[0], kv[1]
        src = (me + step) % n        # the rank this K/V block came from
        scores = torch.einsum('bqhd,bkhd->bhqk', q, k_blk).float() * scale
        if causal:
            k_pos = src * sk + torch.arange(sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, -math.inf)
        m_new = torch.maximum(m, scores.amax(-1))
        # guard fully-masked rows (exp(-inf - -inf)) with a finite max
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isneginf(scores), 0.0, p)
        corr = torch.exp(torch.where(torch.isneginf(m), m_safe, m) - m_safe)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + torch.einsum('bhqk,bkhd->bhqd', p, v_blk.float()))
        m = m_new
    # JAX rotates once more after the last block; the result is unused
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)          # (b, sq, h, d)


def _seq_to_heads(x, group, n):
    """(b, s/n, h, d) sequence shards -> (b, s, h/n, d) head shards: JAX's
    ``all_to_all(split_axis=2, concat_axis=1, tiled=True)``."""
    b, sl, h, d = x.shape
    send = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = _AllToAll.apply(send, group)
    # recv[j]: rank j's sequence block of this rank's heads
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x, group, n):
    """The inverse: (b, s, h/n, d) -> (b, s/n, h, d)."""
    b, s, hl, d = x.shape
    send = x.reshape(b, n, s // n, hl, d).transpose(0, 1).contiguous()
    recv = _AllToAll.apply(send, group)
    # recv[j]: head block j of this rank's sequence block
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


def _ulysses_local(q, k, v, group, n, causal: bool, use_flash: bool):
    """seq-sharded -> all-to-all -> head-sharded attention -> back."""
    q, k, v = (_seq_to_heads(x, group, n) for x in (q, k, v))
    if use_flash:
        out = flash_attention(q, k, v, causal=causal)
    else:
        mask = None
        if causal:
            s = q.shape[1]
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                         device=q.device))[None, None]
        out = _local_attention(q, k, v, 1.0 / math.sqrt(q.shape[-1]), mask)
    return _heads_to_seq(out, group, n)


def ulysses_attention(q, k, v, mesh, axis_name: str = 'data',
                      causal: bool = False, mode='auto'):
    """All-to-all (Ulysses) sequence parallelism over ``axis_name`` of
    ``mesh``: ``q``/``k``/``v`` are this rank's ``(b, s/n, h, d)``
    shards, heads must divide the dim's size.  ``mode`` is the
    ``use_pallas`` tri-state of :func:`ops.flash.attn_use_flash`, asked
    at the local problem after the head scatter (the whole sequence,
    ``h / n`` heads)."""
    group, n, _ = _axis(mesh, axis_name)
    if q.shape[2] % n:
        raise ValueError('ulysses: heads must divide the mesh axis')
    use_flash = attn_use_flash(q.shape[1] * n, batch=q.shape[0],
                               heads=max(1, q.shape[2] // n), mode=mode,
                               device=q.device)
    with full_f32():
        return _ulysses_local(q, k, v, group, n, causal, use_flash)
