"""Local response normalization.

PyTorch counterpart of the LRN half of ``cxxnet_tpu/layers/norm.py``
(``src/layer/lrn_layer-inl.hpp:46-57``):
``out = x * (knorm + alpha/n * sum_{window} x^2)^(-beta)`` over a
channel window of ``local_size``, dispatched as ``norm.py:48-75`` does:
the gate ``lrn_auto_mode`` sends 128-aligned channel counts to the LRN
kernels (``full``: forward and backward), other (c % 8 == 0, c >= 96)
counts to the forward kernel with the plain backward (``hybrid``), and
the rest to the cumsum composition, whose gradient is autograd's.
``BatchNormLayer`` comes with ROADMAP.md queue A item 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels import lrn_auto_mode, lrn_forward
from .base import Layer, kLRN, register_layer


@register_layer
class LRNLayer(Layer):
    type_name = 'lrn'
    type_id = kLRN

    def __init__(self, name=''):
        super().__init__(name)
        self.knorm = 1.0
        self.nsize = 3
        self.alpha = 0.001
        self.beta = 0.75

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'local_size':
            self.nsize = int(val)
        if name == 'alpha':
            self.alpha = float(val)
        if name == 'beta':
            self.beta = float(val)
        if name == 'knorm':
            self.knorm = float(val)

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('lrn: only supports 1-1 connection')
        return [in_specs[0]]

    def forward(self, params, inputs, ctx):
        x = inputs[0]  # (b, y, x, c)
        mode = lrn_auto_mode(x.shape[-1], ctx.kernel_mode)
        if mode != 'xla':
            # both run the kernel forward; 'full' takes the backward kernel
            # (lrn_pallas), 'hybrid' the plain cumsum backward (lrn_hybrid)
            return [lrn_forward(x.contiguous(), self.nsize, self.alpha,
                                self.beta, self.knorm,
                                hybrid=mode == 'hybrid')]
        x32 = x.float()
        n = self.nsize
        half_lo = (n - 1) // 2
        half_hi = n - 1 - half_lo
        c = x.shape[-1]
        # cross-channel window sum via a cumulative sum along channels
        cums = torch.cumsum(F.pad(x32 * x32, (half_lo + 1, half_hi)), dim=-1)
        window = cums[..., n:n + c] - cums[..., 0:c]
        norm = window * (self.alpha / n) + self.knorm
        return [(x32 * norm.pow(-self.beta)).to(x.dtype)]
