"""Dense attention on one device.

The single-device half of ``cxxnet_tpu/parallel/sequence.py``:
``_local_attention`` (the block math the transformer's prefill runs) and
``attention_reference`` (the correctness oracle).  Ring and Ulysses
attention, which shard the sequence over devices, come with ROADMAP.md
queue A item 9.  Layout as in the JAX package: ``(batch, seq, heads,
head_dim)``.
"""

from __future__ import annotations

import math

import torch


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
