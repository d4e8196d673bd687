"""Dense and elementwise layers: fullc, activations, flatten, dropout.

PyTorch counterpart of ``cxxnet_tpu/layers/common.py``; gradients are
autograd's (the fullc GEMM kernel brings its own backward kernels).
Bias, xelu, insanity, prelu, split, concat, maxout and fixconn come with
ROADMAP.md queue A item 2.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.kernels import fullc_gemm, fullc_use_pallas
from .base import (Layer, NodeSpec, Params, as_mat, kDropout, kFlatten,
                   kFullConnect, kRectifiedLinear, kSigmoid, kSoftplus, kTanh,
                   register_layer)


@register_layer
class FullConnectLayer(Layer):
    """Dense layer (``src/layer/fullc_layer-inl.hpp:101-130``):
    ``out = in @ W + bias`` with ``W`` stored ``(nin, nhidden)``, the JAX
    package's layout (``common.py:57-63``); model files keep the
    reference's ``(nhidden, nin)``."""

    type_name = 'fullc'
    type_id = kFullConnect
    param_fields = ('wmat', 'bias')

    def __init__(self, name: str = ''):
        super().__init__(name=name)
        self.fullc_gather = 0   # accepted for config compatibility

    def set_param(self, name: str, val: str) -> None:
        if name == 'fullc_gather':
            self.fullc_gather = int(val)
        super().set_param(name, val)

    def infer_shapes(self, in_specs: List[NodeSpec]) -> List[NodeSpec]:
        if len(in_specs) != 1:
            raise ValueError('fullc: only supports 1-1 connection')
        if self.param.num_hidden <= 0:
            raise ValueError('fullc: must set nhidden correctly')
        self.param.num_input_node = in_specs[0].flat_size
        return [NodeSpec(1, 1, self.param.num_hidden)]

    def init_params(self, gen, in_specs) -> Params:
        nin = in_specs[0].flat_size
        nh = self.param.num_hidden
        p = {'wmat': self.param.rand_init_weight(gen, (nin, nh), nin, nh)}
        if self.param.no_bias == 0:
            p['bias'] = torch.full((nh,), self.param.init_bias)
        return p

    def forward(self, params, inputs, ctx):
        x = as_mat(inputs[0]).contiguous()
        w = params['wmat']
        if fullc_use_pallas(x.shape[0], w.shape[0], w.shape[1],
                            is_train=ctx.is_train, mode=ctx.kernel_mode):
            out = fullc_gemm(x, w)
        else:
            out = torch.matmul(x, w)
        if self.param.no_bias == 0:
            out = out + params['bias']
        return [out]


class _ActivationLayer(Layer):
    """Elementwise activation (``src/layer/activation_layer-inl.hpp``)."""

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError(f'{self.type_name}: only supports 1-1 '
                             'connection')
        return [in_specs[0]]

    def forward(self, params, inputs, ctx):
        return [self._act(inputs[0])]

    def _act(self, x):
        raise NotImplementedError


@register_layer
class ReluLayer(_ActivationLayer):
    type_name = 'relu'
    type_id = kRectifiedLinear

    def forward(self, params, inputs, ctx):
        ref = ctx.replayed()
        if ref is not None:
            return [torch.where(ref > 0, inputs[0], 0.0)]
        return [self._act(inputs[0])]

    def _act(self, x):
        # jnp.maximum(x, 0.0), not torch.relu: at an exact x == 0 tie the
        # JAX gradient is 0.5 (lax.max splits equal operands) and
        # torch.maximum's is too, where torch.relu's is 0
        return torch.maximum(x, x.new_zeros(()))


@register_layer
class SigmoidLayer(_ActivationLayer):
    type_name = 'sigmoid'
    type_id = kSigmoid

    def _act(self, x):
        return torch.sigmoid(x)


@register_layer
class TanhLayer(_ActivationLayer):
    type_name = 'tanh'
    type_id = kTanh

    def _act(self, x):
        return torch.tanh(x)


@register_layer
class SoftplusLayer(_ActivationLayer):
    type_name = 'softplus'
    type_id = kSoftplus

    def _act(self, x):
        return torch.nn.functional.softplus(x)


@register_layer
class FlattenLayer(Layer):
    """Reshape to ``(batch, c*y*x)`` in the reference's NCHW element order
    (see ``as_mat``)."""

    type_name = 'flatten'
    type_id = kFlatten

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('flatten: only supports 1-1 connection')
        return [NodeSpec(1, 1, in_specs[0].flat_size)]

    def forward(self, params, inputs, ctx):
        return [as_mat(inputs[0])]


@register_layer
class DropoutLayer(Layer):
    """Inverted dropout, self-loop (``src/layer/dropout_layer-inl.hpp``):
    at train time ``x * (uniform < pkeep) / pkeep`` with the uniforms
    drawn from the layer's ``torch.Generator``
    (:meth:`ForwardContext.layer_generator`); eval is identity."""

    type_name = 'dropout'
    type_id = kDropout

    def __init__(self, name=''):
        super().__init__(name)
        self.threshold = 0.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'threshold':
            self.threshold = float(val)

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('dropout: only supports 1-1 connection')
        if not (0.0 <= self.threshold < 1.0):
            raise ValueError('DropoutLayer: invalid dropout threshold')
        return [in_specs[0]]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if not ctx.is_train or self.threshold == 0.0:
            return [x]
        pkeep = 1.0 - self.threshold
        u = torch.rand(x.shape, generator=ctx.layer_generator(x.device),
                       device=x.device, dtype=x.dtype)
        return [x * (u < pkeep).to(x.dtype) / pkeep]
