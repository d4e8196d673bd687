"""Pooling layers: max, sum, avg, relu_max and insanity_max.

PyTorch counterpart of ``cxxnet_tpu/layers/pooling.py`` with the
reference's semantics (``src/layer/pooling_layer-inl.hpp``):

* output size ``min(in - k + stride - 1, in - 1) // stride + 1``
  (pooling_layer:103-105), reached by padding on the right and bottom
  only — this is **not** ``ceil_mode=True``, whose windows can differ;
* max pooling pads with ``-inf``, so padding never wins; sum and avg
  with 0;
* ``avg_pooling`` divides by the full window ``kh*kw`` even for clipped
  edge windows (pooling_layer:47-49);
* ``relu_max_pooling`` applies a relu before pooling
  (layer_impl-inl.hpp:55);
* ``insanity_max_pooling`` moves each source pixel to a random clamped
  neighbour before max pooling at train time, and pools exactly at eval
  (``insanity_pooling_layer-inl.hpp:64-99,245-258``).  As in the JAX
  layer, its forward does not pad.

Only ``max_pooling`` records and replays its choices (``Decisions``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops import threefry
from .base import (Layer, NodeSpec, kAvgPooling, kInsanityPooling,
                   kMaxPooling, kReluMaxPooling, kSumPooling, register_layer)


def pool_out_dim(in_dim: int, k: int, stride: int) -> int:
    return min(in_dim - k + stride - 1, in_dim - 1) // stride + 1


def _reduce_pool(x, ky, kx, stride, mode, ref=None):
    """x: (b, y, x, c) NHWC → pooled, edge windows clipped by right-only
    padding.  With ``ref`` (max only; x's shape) each window takes the
    element of x where ref's window has its maximum."""
    oy = pool_out_dim(x.shape[1], ky, stride)
    ox = pool_out_dim(x.shape[2], kx, stride)
    pad_y = max((oy - 1) * stride + ky - x.shape[1], 0)
    pad_x = max((ox - 1) * stride + kx - x.shape[2], 0)
    xc = x.permute(0, 3, 1, 2)
    rc = None if ref is None else ref.permute(0, 3, 1, 2)
    if pad_y or pad_x:
        fill = float('-inf') if mode == 'max' else 0.0
        xc = F.pad(xc, (0, pad_x, 0, pad_y), value=fill)
        if rc is not None:
            rc = F.pad(rc, (0, pad_x, 0, pad_y), value=fill)
    if rc is not None:
        _, idx = F.max_pool2d(rc, (ky, kx), stride, return_indices=True)
        out = xc.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    elif mode == 'max':
        out = F.max_pool2d(xc, (ky, kx), stride)
    elif x.dtype == torch.float32:
        out = F.avg_pool2d(xc, (ky, kx), stride, divisor_override=1)
    else:
        out = _window_sum(xc, ky, kx, stride, oy, ox)
    return out.permute(0, 2, 3, 1).contiguous()


def _window_sum(xc, ky, kx, stride, oy, ox):
    """Each window's sum in ``xc``'s own dtype, tap by tap in row-major
    order, each add rounded: what XLA's ``reduce_window`` add computes
    on bf16 (JAX ``_reduce_pool``).  ``F.avg_pool2d`` sums a bf16 window
    in f32 and rounds once, another value."""
    out = None
    for u in range(ky):
        for v in range(kx):
            tap = xc[:, :, u:u + (oy - 1) * stride + 1:stride,
                     v:v + (ox - 1) * stride + 1:stride]
            out = tap if out is None else out + tap
    return out


class _PoolingBase(Layer):
    mode = 'max'
    pre_relu = False
    replays_decisions = False

    def infer_shapes(self, in_specs: List[NodeSpec]) -> List[NodeSpec]:
        if len(in_specs) != 1:
            raise ValueError('pooling: only supports 1-1 connection')
        p, s = self.param, in_specs[0]
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError('pooling: must set kernel_size correctly')
        iy, ix = s.y + 2 * p.pad_y, s.x + 2 * p.pad_x
        if p.kernel_width > ix or p.kernel_height > iy:
            raise ValueError('pooling: kernel size exceeds input')
        return [NodeSpec(s.c,
                         pool_out_dim(iy, p.kernel_height, p.stride),
                         pool_out_dim(ix, p.kernel_width, p.stride))]

    def forward(self, params, inputs, ctx):
        p = self.param
        x = inputs[0]
        if self.pre_relu:
            x = torch.maximum(x, x.new_zeros(()))
        # replayed max-pooling choices (layers/base.py Decisions)
        ref = ctx.replayed() if self.replays_decisions else None
        if p.pad_y or p.pad_x:
            # symmetric pad extension of the JAX package (the reference
            # pooling has none): -inf for max, 0 for sum/avg
            fill = float('-inf') if self.mode == 'max' else 0.0
            pad = (0, 0, p.pad_x, p.pad_x, p.pad_y, p.pad_y)
            x = F.pad(x, pad, value=fill)
            if ref is not None:
                ref = F.pad(ref, pad, value=fill)
        out = _reduce_pool(x, p.kernel_height, p.kernel_width, p.stride,
                           self.mode, ref)
        if self.mode == 'avg':
            # the scale in the node's dtype, as JAX's weakly typed scalar
            out = out * out.new_tensor(1.0 / (p.kernel_height
                                              * p.kernel_width))
        return [out]


@register_layer
class MaxPoolingLayer(_PoolingBase):
    type_name = 'max_pooling'
    type_id = kMaxPooling
    mode = 'max'
    replays_decisions = True


@register_layer
class SumPoolingLayer(_PoolingBase):
    type_name = 'sum_pooling'
    type_id = kSumPooling
    mode = 'sum'


@register_layer
class AvgPoolingLayer(_PoolingBase):
    type_name = 'avg_pooling'
    type_id = kAvgPooling
    mode = 'avg'


@register_layer
class ReluMaxPoolingLayer(_PoolingBase):
    type_name = 'relu_max_pooling'
    type_id = kReluMaxPooling
    mode = 'max'
    pre_relu = True


@register_layer
class InsanityPoolingLayer(_PoolingBase):
    """Max pooling after a random jitter: each source pixel keeps its
    value with probability ``keep``, else takes its clamped neighbour
    above, below, left or right, each with a quarter of the rest.  The
    jitter depends on the source pixel alone, so jittering the image and
    then pooling it is the reference's per-window read."""

    type_name = 'insanity_max_pooling'
    type_id = kInsanityPooling
    mode = 'max'

    def __init__(self, name=''):
        super().__init__(name)
        self.p_keep = 1.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'keep':
            self.p_keep = float(val)

    def forward(self, params, inputs, ctx):
        p = self.param
        x = inputs[0]
        if ctx.is_train and self.p_keep < 1.0:
            u = threefry.uniform(ctx.layer_key(), x.shape, x.dtype, x.device)
            delta = (1.0 - self.p_keep) / 4.0
            up = torch.cat([x[:, :1], x[:, :-1]], dim=1)
            down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
            left = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
            right = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
            # the first band u falls below picks, as jnp.select does
            x = torch.where(
                u < self.p_keep, x, torch.where(
                    u < self.p_keep + delta, up, torch.where(
                        u < self.p_keep + 2 * delta, down, torch.where(
                            u < self.p_keep + 3 * delta, left, right))))
        return [_reduce_pool(x, p.kernel_height, p.kernel_width, p.stride,
                             'max')]
