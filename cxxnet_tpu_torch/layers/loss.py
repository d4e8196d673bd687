"""Loss layers: softmax, l2_loss, multi_logistic.

PyTorch counterpart of ``cxxnet_tpu/layers/loss.py``.  The reference's
loss layers overwrite their node with the forward transform and then
with a hand-set gradient; here, as in the JAX package, the forward
transform stays for metrics and prediction, and each layer adds a scalar
loss whose autograd gradient is the reference's hand-set one:

* softmax (``loss/softmax_layer-inl.hpp``): grad p - onehot(y) ⇔ CE;
* l2_loss (``loss/l2_loss_layer-inl.hpp``): grad pred - label ⇔ 0.5 SSE;
* multi_logistic (``loss/multi_logistic_layer-inl.hpp``): grad p - y ⇔
  binary CE with logits.

Each is scaled by ``grad_scale / (batch_size * update_period)``
(loss_layer_base:61-63), masked per instance by the 0/1 ``mask`` of
padded tail batches, and always computed in f32.
"""

from __future__ import annotations

import torch

from .base import (Layer, as_mat, kL2Loss, kMultiLogistic, kSoftmax,
                   register_layer)


class LossLayerBase(Layer):
    """Self-loop loss layer (``loss_layer_base-inl.hpp:14-63``)."""

    def __init__(self, name=''):
        super().__init__(name)
        self.target = 'label'
        self.grad_scale = 1.0
        self.batch_size = 1
        self.update_period = 1

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'target':
            self.target = val
        if name == 'grad_scale':
            self.grad_scale = float(val)
        if name == 'batch_size':
            self.batch_size = int(val)
        if name == 'update_period':
            self.update_period = int(val)

    @property
    def is_loss(self):
        return True

    def infer_shapes(self, in_specs):
        if len(in_specs) != 1:
            raise ValueError('LossLayer: only supports 1-1 connection')
        return [in_specs[0]]

    @property
    def scale(self) -> float:
        return self.grad_scale / (self.batch_size * self.update_period)

    def loss(self, params, inputs, labels, ctx, mask=None) -> torch.Tensor:
        """Scalar loss.  ``labels``: (batch, label_width) for this layer's
        target field; ``mask``: optional (batch,) 0/1 instance weights."""
        x = as_mat(inputs[0]).float()
        per_inst = self._per_instance_loss(x, labels.float())
        if mask is not None:
            per_inst = per_inst * mask
        return per_inst.sum() * self.scale

    def _per_instance_loss(self, x, labels):
        raise NotImplementedError


@register_layer
class SoftmaxLayer(LossLayerBase):
    type_name = 'softmax'
    type_id = kSoftmax

    def forward(self, params, inputs, ctx):
        return [torch.softmax(as_mat(inputs[0]).float(), dim=-1)]

    def _per_instance_loss(self, x, labels):
        logp = torch.log_softmax(x, dim=-1)
        idx = labels[:, 0].to(torch.int64)
        return -torch.gather(logp, 1, idx[:, None])[:, 0]


@register_layer
class L2LossLayer(LossLayerBase):
    type_name = 'l2_loss'
    type_id = kL2Loss

    def forward(self, params, inputs, ctx):
        return [inputs[0]]

    def _per_instance_loss(self, x, labels):
        return 0.5 * ((x - labels) ** 2).sum(-1)


@register_layer
class MultiLogisticLayer(LossLayerBase):
    type_name = 'multi_logistic'
    type_id = kMultiLogistic

    def forward(self, params, inputs, ctx):
        return [torch.sigmoid(as_mat(inputs[0]))]

    def _per_instance_loss(self, x, labels):
        # sum of binary cross-entropies with logits x; d/dx = sigmoid(x)-y
        return (torch.logaddexp(x.new_zeros(()), x) - x * labels).sum(-1)
