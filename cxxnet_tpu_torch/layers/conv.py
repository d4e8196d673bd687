"""Convolution layer and its lowerings.

PyTorch counterpart of ``cxxnet_tpu/layers/conv.py``.  Weights stay HWIO
``(kh, kw, cin/g, cout)`` as in the JAX package, activations NHWC; the
output size is the reference's ``(in + 2*pad - k) / stride + 1`` (floor).
A conv paired with an in-place relu runs fused in ``ops/cnn.py`` (the
net decides, ``nnet/net.py``); an unfused conv takes the lowering that
``conv_lowering`` names, resolved per shape as JAX's ``_lowering`` does:

* ``native`` (and ``auto``): one ``F.conv2d``, as the JAX package leaves
  it to XLA;
* ``im2col``: the patch matrix, columns in JAX's ``(c, kh, kw)`` order,
  times the reshaped weight (``torch.matmul``; JAX's GEMM is XLA's too);
* ``s2d``: space-to-depth, a stride-s conv as a stride-1 conv over s x s
  pixel blocks (any pads, folded into zeros before blocking);
* ``split``: one convolution a group, concatenated.

Backward: an im2col conv, and a native conv on a card in f32, take the
fused kernel's transposes (``ops/cnn.conv_transposes``: GEMMs in full
f32, col2im in f32 in a fixed order), since cuDNN's f32 weight gradient
lies up to 2.7e-2 of its largest value from float64 at AlexNet's conv2
and repeats in other bits, and autograd's col2im of an im2col conv rounds
each tap's add in bf16; the others autograd's (oneDNN on the CPU, cuDNN
in bf16, both within float64's bound).  ``micro_batch = k`` runs the
native or im2col conv over ``k`` batch slices (``ops/microbatch.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.cnn import conv_transposes
from ..ops.microbatch import microbatched_conv
from .base import Layer, NodeSpec, kConv, register_layer


def _native_operands(x: torch.Tensor, w: torch.Tensor, pad):
    """``F.conv2d``'s operands for NHWC ``x`` / HWIO ``w``: ``x`` viewed
    NCHW (channels-last memory, no copy), zero-padded first when the pads
    are asymmetric, the weight viewed OIHW, and the symmetric padding."""
    (py_lo, py_hi), (px_lo, px_hi) = pad
    xc = x.permute(0, 3, 1, 2)
    if py_lo != py_hi or px_lo != px_hi:
        xc = F.pad(xc, (px_lo, px_hi, py_lo, py_hi))
        py_lo = px_lo = 0
    return xc, w.permute(3, 2, 0, 1), (py_lo, px_lo)


def _conv2d(x, w, strides, pad, groups):
    xc, wc, padding = _native_operands(x, w, pad)
    out = F.conv2d(xc, wc, stride=tuple(strides), padding=padding,
                   groups=groups)
    return out.permute(0, 2, 3, 1).contiguous()


def _im2col(x, w, strides, pad, groups=1):
    kh, kw, cin, cout = w.shape
    (py_lo, py_hi), (px_lo, px_hi) = pad
    xp = F.pad(x, (0, 0, px_lo, px_hi, py_lo, py_hi))
    pat = xp.unfold(1, kh, strides[0]).unfold(2, kw, strides[1])
    b, oy, ox = pat.shape[:3]
    w2 = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return (pat.reshape(b * oy * ox, cin * kh * kw) @ w2).reshape(
        b, oy, ox, cout)


class _TransposedBackward(torch.autograd.Function):
    """``forward(x, w, strides, pad, groups)`` with the backward of
    :func:`conv_transposes`."""

    @staticmethod
    def forward(ctx, x, w, strides, pad, groups, forward):
        ctx.save_for_backward(x, w)
        ctx.args = (strides, pad, groups)
        return forward(x, w, strides, pad, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv_transposes(x, w, g, *ctx.args,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        return dx, dw, None, None, None, None


def _transposed_backward(x: torch.Tensor) -> bool:
    """Whether a native conv on ``x`` takes :func:`conv_transposes` for
    its backward: on a card in f32, where cuDNN's is off float64."""
    return x.device.type == 'cuda' and x.dtype == torch.float32


def conv_native(x: torch.Tensor, w: torch.Tensor, strides, pad,
                groups: int = 1) -> torch.Tensor:
    """NHWC/HWIO convolution through ``F.conv2d``; ``pad`` is ``((top,
    bottom), (left, right))``."""
    if _transposed_backward(x):
        return _TransposedBackward.apply(x, w, strides, pad, groups,
                                         _conv2d)
    return _conv2d(x, w, strides, pad, groups)


def _native_backward(x, w, g, strides, pad, groups, mask):
    """A native conv's ``(dx NHWC, dw HWIO)`` for the gradients ``mask``
    asks, by the call its autograd makes: the transposes on a card in
    f32, else ``convolution_backward`` on ``F.conv2d``'s operands."""
    if _transposed_backward(x):
        return conv_transposes(x, w, g, strides, pad, groups, *mask)
    xc, wc, padding = _native_operands(x, w, pad)
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xc, wc, None, list(strides), list(padding),
        [1, 1], False, [0, 0], groups, [mask[0], mask[1], False])
    if gx is not None:
        (py_lo, _), (px_lo, _) = pad
        if xc.shape[2] != x.shape[1] or xc.shape[3] != x.shape[2]:
            gx = gx[:, :, py_lo:py_lo + x.shape[1], px_lo:px_lo + x.shape[2]]
        gx = gx.permute(0, 2, 3, 1)
    return gx, None if gw is None else gw.permute(2, 3, 1, 0)


def _beside_a_zero_image(x: torch.Tensor) -> bool:
    """Whether a slice's library call runs at two images, the slice's
    one and a zero image, and keeps the first.  PyTorch's CPU dispatch
    sends a one-image batch of a small ungrouped conv to its own im2col
    route instead of oneDNN, which a larger batch of it takes
    (``use_mkldnn`` wants more than one image there), and that route
    sums the input gradient in another order; on a card cuDNN takes
    every batch size."""
    return x.device.type == 'cpu' and x.shape[0] == 1


def native_mb_forward(x, w, strides, pad, groups):
    """:func:`conv_native` on one ``microbatched_conv`` slice."""
    if _beside_a_zero_image(x):
        return conv_native(torch.cat([x, torch.zeros_like(x)]), w, strides,
                           pad, groups)[:1]
    return conv_native(x, w, strides, pad, groups)


def native_input_grad(x, w, g, strides, pad, groups):
    """``dx`` of :func:`conv_native` on one slice (no forward)."""
    if _beside_a_zero_image(x):
        return _native_backward(
            torch.cat([x, torch.zeros_like(x)]), w,
            torch.cat([g, torch.zeros_like(g)]), strides, pad, groups,
            (True, False))[0][:1]
    return _native_backward(x, w, g, strides, pad, groups, (True, False))[0]


def native_weight_grad(x, w, g, strides, pad, groups):
    """``dw`` of :func:`conv_native` (no forward)."""
    return _native_backward(x, w, g, strides, pad, groups, (False, True))[1]


def conv_im2col(x: torch.Tensor, w: torch.Tensor, strides,
                pad) -> torch.Tensor:
    """The patches-times-GEMM lowering (JAX ``layers/conv.py:34``): the
    zero-padded input's windows as a matrix, one row per output position,
    columns in ``(c, kh, kw)`` order as ``lax.conv_general_dilated_
    patches`` gives them, times the weight reshaped to that order; the
    backward the transposes' (``dw`` a GEMM, ``dx`` a GEMM and col2im in
    f32, as XLA's patches transpose sums)."""
    return _TransposedBackward.apply(x, w, strides, pad, 1, _im2col)


def im2col_input_grad(x, w, g, strides, pad, groups):
    """``dx`` of :func:`conv_im2col` on one slice (no forward)."""
    return conv_transposes(x, w, g, strides, pad, 1, True, False)[0]


def im2col_weight_grad(x, w, g, strides, pad, groups):
    """``dw`` of :func:`conv_im2col` (no forward)."""
    return conv_transposes(x, w, g, strides, pad, 1, False, True)[1]


def im2col_mb_forward(x, w, strides, pad, groups):
    """:func:`conv_im2col` on one ``microbatched_conv`` slice."""
    return conv_im2col(x, w, strides, pad)


#: ``microbatched_conv``'s ``(conv_fn, input_grad, weight_grad)`` of the
#: two lowerings it splits (the gate sends im2col ungrouped convs only)
MICRO_BATCHED = {
    'native': (native_mb_forward, native_input_grad, native_weight_grad),
    'im2col': (im2col_mb_forward, im2col_input_grad, im2col_weight_grad),
}


def conv_s2d(x: torch.Tensor, w: torch.Tensor, strides,
             pad) -> torch.Tensor:
    """Space-to-depth lowering (JAX ``layers/conv.py:52-95``): with the
    kernel zero-padded to ``ceil(k/s)*s`` taps, ``y[o] = sum_u x[o*s+u]
    w[u]`` regroups by ``u = a*s + r`` into a stride-1 conv over block
    index ``a`` with ``(r, c)`` as channels.  Exact for any pads (they
    become zeros before blocking); backward by autograd through the
    reshapes."""
    sy, sx = strides
    (py_lo, py_hi), (px_lo, px_hi) = pad
    b, _, _, c = x.shape
    kh, kw, cin, cout = w.shape
    x = F.pad(x, (0, 0, px_lo, px_hi, py_lo, py_hi))
    h2, w2 = x.shape[1], x.shape[2]
    out_h = (h2 - kh) // sy + 1
    out_w = (w2 - kw) // sx + 1
    bkh, bkw = -(-kh // sy), -(-kw // sx)       # kernel taps in blocks
    wp = F.pad(w, (0, 0, 0, 0, 0, bkw * sx - kw, 0, bkh * sy - kh))
    # the input must cover block (out - 1) + bk - 1 on each axis
    hp = max(-(-h2 // sy), out_h - 1 + bkh) * sy
    wpx = max(-(-w2 // sx), out_w - 1 + bkw) * sx
    x = F.pad(x, (0, 0, 0, wpx - w2, 0, hp - h2))
    xb = x.reshape(b, hp // sy, sy, wpx // sx, sx, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, hp // sy, wpx // sx, sy * sx * c)
    wb = wp.reshape(bkh, sy, bkw, sx, cin, cout).permute(
        0, 2, 1, 3, 4, 5).reshape(bkh, bkw, sy * sx * cin, cout)
    out = conv_native(xb, wb, (1, 1), ((0, 0), (0, 0)))
    return out[:, :out_h, :out_w, :]


def conv_split(x: torch.Tensor, w: torch.Tensor, strides, pad,
               groups: int) -> torch.Tensor:
    """One convolution a group, concatenated along the channels, in
    place of a grouped convolution (JAX ``layers/conv.py:109``)."""
    cin_g = x.shape[-1] // groups
    cout_g = w.shape[-1] // groups
    return torch.cat([
        conv_native(x[..., i * cin_g:(i + 1) * cin_g],
                    w[..., i * cout_g:(i + 1) * cout_g], strides, pad)
        for i in range(groups)], dim=-1)


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

    def _lowering(self) -> str:
        """The lowering this conv runs (JAX ``layers/conv.py:159-186``):
        ``auto`` means native; each other mode degrades to native off the
        shapes it targets, so the knob works as a netconfig global —
        im2col ungrouped convs, split grouped ones, s2d ungrouped strided
        convs whose pads the stride divides (a policy bound: ``conv_s2d``
        is exact for any pads)."""
        p = self.param
        mode = p.conv_lowering
        if mode == 'auto':
            return 'native'
        if mode == 'split' and p.num_group == 1:
            return 'native'
        if mode == 'im2col' and p.num_group != 1:
            return 'native'
        if mode == 's2d' and (p.num_group != 1 or p.stride <= 1
                              or p.pad_y % p.stride or p.pad_x % p.stride):
            return 'native'
        return mode

    def _micro_split(self, mode: str, batch: int) -> int:
        """The ``micro_batch`` split of this call (JAX
        ``layers/conv.py:188-199``): only on the native and im2col
        lowerings (s2d and split reshape the batch themselves) and only
        when it divides the batch; anything else runs unsplit."""
        split = self.param.micro_batch
        if split <= 1 or mode not in ('native', 'im2col') or batch % split:
            return 1
        return split

    def forward(self, params, inputs, ctx):
        # the f32 weights cast to the activations' dtype (JAX
        # layers/conv.py:201-227); a bf16 product sums in f32
        p = self.param
        x = inputs[0]
        w = params['wmat'].to(x.dtype)
        strides, pad = self.geometry()
        mode = self._lowering()
        split = self._micro_split(mode, x.shape[0])
        if split > 1:
            out = microbatched_conv(x, w, strides, pad, p.num_group, split,
                                    *MICRO_BATCHED[mode])
        elif mode == 'im2col':
            out = conv_im2col(x, w, strides, pad)
        elif mode == 's2d':
            out = conv_s2d(x, w, strides, pad)
        elif mode == 'split':
            out = conv_split(x, w, strides, pad, p.num_group)
        else:
            out = conv_native(x, w, strides, pad, p.num_group)
        if p.no_bias == 0:
            out = out + params['bias'].to(x.dtype)
        return [out]
