"""Convolution layer, native lowering.

PyTorch counterpart of ``cxxnet_tpu/layers/conv.py``.  Weights stay HWIO
``(kh, kw, cin/g, cout)`` as in the JAX package, activations NHWC; the
output size is the reference's ``(in + 2*pad - k) / stride + 1`` (floor).
A conv paired with an in-place relu runs fused in ``ops/cnn.py`` (the
net decides, ``nnet/net.py``); an unfused conv is left to
``F.conv2d``, as the JAX package leaves it to XLA.  The ``im2col``,
``s2d`` and ``split`` lowerings and ``micro_batch`` come with ROADMAP.md
queue A item 2 (``layers/base.py`` refuses them).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .base import Layer, NodeSpec, kConv, register_layer


def conv_native(x: torch.Tensor, w: torch.Tensor, strides, pad,
                groups: int = 1) -> torch.Tensor:
    """NHWC/HWIO convolution through ``F.conv2d``: the input is viewed
    NCHW (channels-last memory, no copy), the weight transposed to OIHW;
    ``pad`` is ``((top, bottom), (left, right))``."""
    (py_lo, py_hi), (px_lo, px_hi) = pad
    xc = x.permute(0, 3, 1, 2)
    if py_lo != py_hi or px_lo != px_hi:
        xc = F.pad(xc, (px_lo, px_hi, py_lo, py_hi))
        py_lo = px_lo = 0
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(strides),
                   padding=(py_lo, px_lo), groups=groups)
    return out.permute(0, 2, 3, 1).contiguous()


@register_layer
class ConvolutionLayer(Layer):
    type_name = 'conv'
    type_id = kConv
    param_fields = ('wmat', 'bias')

    def infer_shapes(self, in_specs: List[NodeSpec]) -> List[NodeSpec]:
        if len(in_specs) != 1:
            raise ValueError('conv: only supports 1-1 connection')
        p = self.param
        s = in_specs[0]
        if p.num_channel <= 0:
            raise ValueError('conv: must set nchannel correctly')
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError('conv: must set kernel_size correctly')
        if s.c % p.num_group or p.num_channel % p.num_group:
            raise ValueError('conv: channels must be divisible by ngroup')
        p.num_input_channel = s.c
        oy = (s.y + 2 * p.pad_y - p.kernel_height) // p.stride + 1
        ox = (s.x + 2 * p.pad_x - p.kernel_width) // p.stride + 1
        if oy <= 0 or ox <= 0:
            raise ValueError('conv: kernel larger than padded input')
        return [NodeSpec(p.num_channel, oy, ox)]

    def init_params(self, key, in_specs, device='cpu'):
        p = self.param
        cin_g = in_specs[0].c // p.num_group
        # drawn over the HWIO shape, the layout both packages store (JAX
        # conv.py:146-157, interop.py); the fan numbers match the
        # reference's (ngroup, nch/g, nin/g*kh*kw)
        shape = (p.kernel_height, p.kernel_width, cin_g, p.num_channel)
        in_num = cin_g * p.kernel_height * p.kernel_width
        out_num = p.num_channel // p.num_group
        out = {'wmat': p.rand_init_weight(key, shape, in_num, out_num,
                                          device)}
        if p.no_bias == 0:
            out['bias'] = torch.full((p.num_channel,), p.init_bias,
                                     device=device)
        return out

    def geometry(self):
        """``(strides, padding)`` in the fused kernel's convention."""
        p = self.param
        return ((p.stride, p.stride),
                ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x)))

    def forward(self, params, inputs, ctx):
        # the f32 weights cast to the activations' dtype (JAX
        # layers/conv.py:205-227); a bf16 product sums in f32
        x = inputs[0]
        strides, pad = self.geometry()
        out = conv_native(x, params['wmat'].to(x.dtype), strides, pad,
                          self.param.num_group)
        if self.param.no_bias == 0:
            out = out + params['bias'].to(x.dtype)
        return [out]
