"""Normalization layers: LRN and batch_norm.

PyTorch counterpart of ``cxxnet_tpu/layers/norm.py``.  LRN
(``src/layer/lrn_layer-inl.hpp:46-57``):
``out = x * (knorm + alpha/n * sum_{window} x^2)^(-beta)`` over a
channel window of ``local_size``, dispatched as ``norm.py:48-75`` does:
the gate ``lrn_auto_mode`` sends 128-aligned channel counts to the LRN
kernels (``full``: forward and backward), other (c % 8 == 0, c >= 96)
counts to the forward kernel with the plain backward (``hybrid``), and
the rest to the cumsum composition, whose gradient is autograd's.

batch_norm (``src/layer/batch_norm_layer-inl.hpp``, JAX ``norm.py:91-128``)
is the plain f32 composition of the JAX layer: mean, then the two-pass
variance, over every axis but the channel (feature) one, ``eps`` 1e-10,
slope under ``wmat`` and shift under ``bias``.  It keeps the reference's
quirk: no running averages, so evaluation also normalizes with the
batch's own statistics.  ``F.batch_norm`` is not used: its eps would sit
below cuDNN's floor of 1e-5, and the formula held is JAX's.
``fold_scale_shift`` is the algebra of folding a BN into its conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels import lrn_auto_mode, lrn_forward
from .base import Layer, kBatchNorm, kLRN, register_layer


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


def fold_scale_shift(gamma, beta, mean, var, eps):
    """The conv+BN fold algebra (``nnet/fold.py``, JAX ``norm.py:78``):
    with frozen statistics ``(mean, var)`` BN is ``y = z*scale + shift``,
    ``scale = gamma/sqrt(var+eps)``, ``shift = beta - mean*scale``, which
    a preceding conv absorbs as ``w*scale`` (output-channel axis) and
    ``b*scale + shift``.  All f32, ``sqrt(var + eps)`` spelled as
    :meth:`BatchNormLayer.forward` spells it."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


@register_layer
class BatchNormLayer(Layer):
    type_name = 'batch_norm'
    type_id = kBatchNorm
    param_fields = ('wmat', 'bias')   # slope under 'wmat', shift under 'bias'

    def __init__(self, name=''):
        super().__init__(name)
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'init_slope':
            self.init_slope = float(val)
        if name == 'init_bias':
            self.init_bias = float(val)
        if name == 'eps':
            self.eps = float(val)

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('batch_norm: only supports 1-1 connection')
        s = in_specs[0]
        self._channels = s.x if s.is_mat else s.c
        return [s]

    def init_params(self, key, in_specs, device='cpu'):
        return {'wmat': torch.full((self._channels,), self.init_slope,
                                   device=device),
                'bias': torch.full((self._channels,), self.init_bias,
                                   device=device)}

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))   # all but the trailing channel
        mean = x32.mean(dims)
        centered = x32 - mean
        var = (centered * centered).mean(dims)
        # batch statistics at train AND eval, the reference quirk
        xhat = centered / torch.sqrt(var + self.eps)
        return [(xhat * params['wmat'] + params['bias']).to(x.dtype)]
