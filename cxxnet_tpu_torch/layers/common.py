"""Dense, elementwise and structural layers: fullc, activations,
flatten, dropout, bias, xelu, insanity, prelu, split, concat / ch_concat,
maxout and fixconn.

PyTorch counterpart of ``cxxnet_tpu/layers/common.py``; gradients are
autograd's (the fullc GEMM kernel brings its own backward kernels).  The
random layers (dropout, insanity, prelu's slope noise) draw JAX's
uniforms from the layer's key (:meth:`ForwardContext.layer_key`) over
the activation's own shape and dtype, through ``ops/threefry.py``.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import threefry
from ..ops.kernels import fullc_gemm, fullc_use_pallas
from .base import (Layer, NodeSpec, Params, as_mat, kBias, kChConcat,
                   kConcat, kDropout, kFixConnect, kFlatten, kFullConnect,
                   kInsanity, kMaxout, kPRelu, kRectifiedLinear, kSigmoid,
                   kSoftplus, kSplit, kTanh, kXelu, register_layer)


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

    def init_params(self, key, in_specs, device='cpu') -> Params:
        nin = in_specs[0].flat_size
        nh = self.param.num_hidden
        p = {'wmat': self.param.rand_init_weight(key, (nin, nh), nin, nh,
                                                 device)}
        if self.param.no_bias == 0:
            p['bias'] = torch.full((nh,), self.param.init_bias,
                                   device=device)
        return p

    def forward(self, params, inputs, ctx):
        # the f32 weights cast to the activations' dtype (JAX
        # layers/common.py:65-77); a bf16 product sums in f32
        x = as_mat(inputs[0]).contiguous()
        w = params['wmat'].to(x.dtype)
        if fullc_use_pallas(x.shape[0], w.shape[0], w.shape[1],
                            is_train=ctx.is_train, mode=ctx.kernel_mode):
            out = fullc_gemm(x, w)
        else:
            out = torch.matmul(x, w)
        if self.param.no_bias == 0:
            out = out + params['bias'].to(x.dtype)
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
            # where the recorded input was exactly 0 the recording relu
            # passed half the gradient (jnp.maximum's tie), so this one
            # does too; the value there, half of an input within rounding
            # of 0, stays within rounding of the recorded 0
            x = inputs[0]
            return [torch.where(ref > 0, x,
                                torch.where(ref == 0, 0.5 * x, 0.0))]
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
    at train time ``x * (uniform < pkeep) / pkeep`` in x's dtype, the
    uniforms JAX's from the layer's key over x's shape (one ``threefry``
    launch writes the mask), ``pkeep`` rounded to x's dtype as JAX's
    weakly typed float is (JAX ``common.py:180-181``); eval is
    identity."""

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
        mask = threefry.keep_mask(ctx.layer_key(), x.shape, x.dtype,
                                  x.device, pkeep)
        # a true division by pkeep in x's dtype: a 0-d tensor made on
        # x's device (a host scalar would become a reciprocal multiply on
        # the card, a host tensor a synchronizing copy)
        return [x * mask / torch.full((), pkeep, dtype=x.dtype,
                                      device=x.device)]


@register_layer
class BiasLayer(Layer):
    """Self-loop learnable bias on a matrix node
    (``src/layer/bias_layer-inl.hpp``)."""

    type_name = 'bias'
    type_id = kBias
    param_fields = ('bias',)

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('bias: only supports 1-1 connection')
        if not in_specs[0].is_mat:
            raise ValueError('BiasLayer only works for flattened nodes')
        self.param.num_input_node = in_specs[0].x
        return [in_specs[0]]

    def init_params(self, key, in_specs, device='cpu'):
        return {'bias': torch.full((in_specs[0].x,), self.param.init_bias,
                                   device=device)}

    def forward(self, params, inputs, ctx):
        return [inputs[0] + params['bias']]


@register_layer
class XeluLayer(_ActivationLayer):
    """Leaky relu ``x > 0 ? x : x / b`` (``src/layer/xelu_layer-inl.hpp``:
    a division, not a product)."""

    type_name = 'xelu'
    type_id = kXelu

    def __init__(self, name=''):
        super().__init__(name)
        self.b = 5.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'b':
            self.b = float(val)

    def _act(self, x):
        return torch.where(x > 0, x, x / self.b)


@register_layer
class InsanityLayer(_ActivationLayer):
    """Randomized leaky relu (``src/layer/insanity_layer-inl.hpp``): at
    train time the negative side divides by a draw from U[lb, ub], at eval
    by the midpoint.  ``calm_start`` / ``calm_end`` anneal both bounds
    toward the midpoint by the round, as the JAX layer derives them from
    ``ctx.round``."""

    type_name = 'insanity'
    type_id = kInsanity

    def __init__(self, name=''):
        super().__init__(name)
        self.lb = 5.0
        self.ub = 10.0
        self.calm_start = 0
        self.calm_end = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'lb':
            self.lb = float(val)
        if name == 'ub':
            self.ub = float(val)
        if name == 'calm_start':
            self.calm_start = int(val)
        if name == 'calm_end':
            self.calm_end = int(val)

    def bounds(self, step: int):
        """``(lb, ub)`` at round ``step``, rounded to float32 as the JAX
        layer computes them."""
        lb, ub = self.lb, self.ub
        if self.calm_end > self.calm_start:
            delta = (self.ub - (self.ub + self.lb) / 2.0) \
                / (self.calm_end - self.calm_start)
            s = min(max(step - self.calm_start, 0),
                    self.calm_end - self.calm_start)
            ub = float(torch.tensor(ub) - torch.tensor(delta * s))
            lb = float(torch.tensor(lb) + torch.tensor(delta * s))
        return lb, ub

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        lb, ub = self.bounds(ctx.round)
        if ctx.is_train:
            u = threefry.uniform(ctx.layer_key(), x.shape, x.dtype, x.device)
            return [torch.where(x > 0, x, x / (u * (ub - lb) + lb))]
        mid = float((torch.tensor(lb) + torch.tensor(ub)) / 2.0)
        return [torch.where(x > 0, x, x / mid)]


@register_layer
class PReluLayer(Layer):
    """Learnable per-channel slope with optional train-time noise
    (``src/layer/prelu_layer-inl.hpp``): the negative side multiplies by
    the slope clipped to [0, 1].  The reference visits the slope under
    the tag ``bias``."""

    type_name = 'prelu'
    type_id = kPRelu
    param_fields = ('bias',)

    def __init__(self, name=''):
        super().__init__(name)
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'init_slope':
            self.init_slope = float(val)
        if name == 'random_slope':
            self.init_random = int(val)
        if name == 'random':
            self.random = float(val)

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('prelu: only supports 1-1 connection')
        s = in_specs[0]
        self._channels = s.x if s.is_mat else s.c
        return [s]

    def init_params(self, key, in_specs, device='cpu'):
        if self.init_random == 0:
            slope = torch.full((self._channels,), self.init_slope,
                               device=device)
        else:
            slope = threefry.uniform(key, (self._channels,),
                                     device=device) * self.init_slope
        return {'bias': slope}

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        # the slope broadcasts over the trailing channel axis of both
        # layouts: (b, len) matrices and (b, y, x, c) NHWC images
        mask = params['bias'].expand(x.shape)
        if ctx.is_train and self.random > 0:
            u = threefry.uniform(ctx.layer_key(), x.shape, x.dtype, x.device)
            mask = mask * (1 + u * self.random * 2.0 - self.random)
        # jnp.clip's min(max(.)), whose gradient splits a tie at 0 or 1
        # as the JAX layer's does (torch.clamp's would pass it whole)
        mask = torch.minimum(torch.maximum(mask, mask.new_zeros(())),
                             mask.new_ones(()))
        return [torch.where(x > 0, x, x * mask)]


@register_layer
class SplitLayer(Layer):
    """1 -> n fan-out copy (``src/layer/split_layer-inl.hpp``); the
    gradients of the copies sum.  The net sets ``n`` from the layer's
    outputs before shape inference."""

    type_name = 'split'
    type_id = kSplit

    def __init__(self, name=''):
        super().__init__(name)
        self._n_out = 2

    def set_num_outputs(self, n: int):
        self._n_out = n

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('split: only supports 1-n connection')
        return [in_specs[0]] * self._n_out

    def forward(self, params, inputs, ctx):
        return [inputs[0]] * self._n_out


class _ConcatBase(Layer):
    """2-4 input concat (``src/layer/concat_layer-inl.hpp``): ``concat``
    along x, ``ch_concat`` along the channels (NHWC's last axis)."""

    def infer_shapes(self, in_specs):
        if not 2 <= len(in_specs) <= 4:
            raise ValueError(f'{self.type_name}: supports 2-4 inputs')
        c, y, x = in_specs[0].c, in_specs[0].y, in_specs[0].x
        if self.type_id == kConcat:
            for s in in_specs[1:]:
                if (s.c, s.y) != (c, y):
                    raise ValueError('concat: non-x dims must match')
            x = sum(s.x for s in in_specs)
        else:
            for s in in_specs[1:]:
                if (s.y, s.x) != (y, x):
                    raise ValueError('ch_concat: non-channel dims must match')
            c = sum(s.c for s in in_specs)
        return [NodeSpec(c, y, x)]

    def forward(self, params, inputs, ctx):
        if self.type_id == kConcat:
            dim = 1 if inputs[0].dim() == 2 else 2   # x axis in NHWC
        else:
            dim = 3                                   # channel axis in NHWC
        return [torch.cat(inputs, dim=dim)]


@register_layer
class ConcatLayer(_ConcatBase):
    type_name = 'concat'
    type_id = kConcat


@register_layer
class ChConcatLayer(_ConcatBase):
    type_name = 'ch_concat'
    type_id = kChConcat


@register_layer
class MaxoutLayer(Layer):
    """Max over groups of ``ngroup`` consecutive channels (features of a
    matrix node), as the JAX package defines it (the reference declares
    ``kMaxout`` but builds no layer for it).  ``torch.amax`` splits the
    gradient of a tie evenly, as JAX's max reduction does."""

    type_name = 'maxout'
    type_id = kMaxout

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('maxout: only supports 1-1 connection')
        s = in_specs[0]
        k = self.param.num_group
        if k <= 1:
            raise ValueError('maxout: set ngroup > 1')
        if s.is_mat:
            if s.x % k:
                raise ValueError('maxout: input width must divide ngroup')
            return [NodeSpec(1, 1, s.x // k)]
        if s.c % k:
            raise ValueError('maxout: channels must divide ngroup')
        return [NodeSpec(s.c // k, s.y, s.x)]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        k = self.param.num_group
        return [torch.amax(x.reshape(x.shape[:-1] + (x.shape[-1] // k, k)),
                           dim=-1)]


@register_layer
class FixConnectLayer(Layer):
    """Fixed sparse projection read from a text file
    (``src/layer/fixconn_layer-inl.hpp:42-57``): ``nrow ncol nnz`` then
    ``row col value`` triples; the weight is ``(nhidden, nin)``, applied
    as ``out = in @ W.T``.  The matrix is a constant, not a parameter."""

    type_name = 'fixconn'
    type_id = kFixConnect

    def __init__(self, name=''):
        super().__init__(name)
        self.fname_weight = 'NULL'
        self._wmat = None

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'fixconn_weight':
            self.fname_weight = val

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('fixconn: only supports 1-1 connection')
        if not in_specs[0].is_mat:
            raise ValueError('FixConnLayer: input must be a matrix')
        if self.param.num_hidden <= 0:
            raise ValueError('FixConnLayer: must set nhidden correctly')
        if self.fname_weight == 'NULL':
            raise ValueError('FixConnLayer: must specify fixconn_weight')
        w = torch.zeros((self.param.num_hidden, in_specs[0].x))
        with open(self.fname_weight) as f:
            toks = f.read().split()
        nrow, ncol, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        if (nrow, ncol) != tuple(w.shape):
            raise ValueError('FixConnLayer: weight shape mismatch')
        for i in range(nnz):
            r, c, v = toks[3 + 3 * i:6 + 3 * i]
            w[int(r), int(c)] = float(v)
        self._wmat = w
        return [NodeSpec(1, 1, self.param.num_hidden)]

    def forward(self, params, inputs, ctx):
        x = as_mat(inputs[0])
        if self._wmat.device != x.device:
            self._wmat = self._wmat.to(x.device)
        # a bf16 node promotes against the f32 matrix, as in JAX
        return [x.to(self._wmat.dtype) @ self._wmat.t()]
