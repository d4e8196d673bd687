"""μ-cuDNN-style convolution microbatching.

Counterpart of ``microbatched_conv`` (``cxxnet_tpu/ops/pallas_cnn.py:
244-294``), a ``lax.map`` under a custom VJP there, not a Pallas kernel;
here a ``torch.autograd.Function`` that launches no kernel of this
repository.  The conv's forward and its input gradient run over ``split``
batch slices in turn, so the library's per-call workspace and transient
tensors are a slice's; the weight gradient comes from ONE full-batch call,
the same call on the same operands that the unsplit conv's backward
makes, since a weight gradient summed slice by slice reduces in another
order.  The forward and the input gradient are per-example independent,
so where the library computes an example's values alike at every batch
size a split step is a bitwise twin of the unsplit step (JAX's contract;
``tests/test_torch_micro_batch.py`` holds it on the CPU and
``chip_smoke.py``'s ``lowering`` phase measures it on a card).
"""

from __future__ import annotations

from typing import Callable

import torch


def _by_slices(fn, split: int, *tensors) -> torch.Tensor:
    """``fn`` on each of ``split`` batch slices of ``tensors`` (views, in
    the tensors' own strides: no copy), written into one output as it
    comes, so a slice's result is freed before the next slice runs."""
    m = tensors[0].shape[0] // split
    out = None
    for i in range(split):
        part = fn(*(t[i * m:(i + 1) * m] for t in tensors))
        if out is None:
            out = part.new_empty((split * m,) + tuple(part.shape[1:]))
        out[i * m:(i + 1) * m] = part
        del part
    return out


class _MicroBatchedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides, padding, groups, split, conv_fn,
                input_grad, weight_grad):
        y = _by_slices(lambda xi: conv_fn(xi, w, strides, padding, groups),
                       split, x)
        ctx.save_for_backward(x, w)
        ctx.args = (strides, padding, groups, split, input_grad,
                    weight_grad)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        strides, padding, groups, split, input_grad, weight_grad = ctx.args
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _by_slices(lambda xi, gi: input_grad(
                xi, w, gi, strides, padding, groups), split, x, g)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, w, g, strides, padding, groups)
        return dx, dw, None, None, None, None, None, None, None


def microbatched_conv(x: torch.Tensor, w: torch.Tensor, strides, padding,
                      groups: int, split: int, conv_fn: Callable,
                      input_grad: Callable,
                      weight_grad: Callable) -> torch.Tensor:
    """``conv_fn(x, w, strides, padding, groups)`` (NHWC ``x``, HWIO
    ``w``) over ``split`` sequential batch slices; the batch must divide
    evenly (callers gate on ``batch % split == 0``, JAX
    ``layers/conv.py:188-199``).  ``input_grad`` / ``weight_grad`` —
    ``fn(x, w, g, strides, padding, groups)`` — are the unsplit conv's
    backward calls for ``dx`` alone, run on each slice, and for ``dw``
    alone, run on the full batch (``layers/conv.MICRO_BATCHED``)."""
    if split < 1 or x.shape[0] % split:
        raise ValueError(f'microbatched_conv: split {split} does not divide '
                         f'the batch of {x.shape[0]}')
    return _MicroBatchedConv.apply(
        x, w, tuple(int(s) for s in strides),
        tuple(tuple(int(p) for p in pr) for pr in padding), int(groups),
        int(split), conv_fn, input_grad, weight_grad)
