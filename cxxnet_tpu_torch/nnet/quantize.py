"""Quantized inference parameters: the int8 and bf16 serving tiers.

PyTorch counterpart of ``cxxnet_tpu/nnet/quantize.py``.  A model served
at ``serve.dtype=int8`` keeps about a quarter of its f32 resident bytes,
one at ``bf16`` half.  Quantization happens once, at load and swap time:
the hot path never re-quantizes weights.

* **bf16** — every float leaf cast to bfloat16.
* **int8** — symmetric per-channel quantization of the matmul weights:
  ``q = round(x / scale)`` with ``scale = max|x| / 127`` over the
  contraction axis (``axis=-2``), so each output channel keeps its own
  range; leading stack axes (the transformer's stage axis) keep a scale
  per entry, so ``leaf[i]`` slices a stacked :class:`QuantLeaf` like a
  tensor.  Other leaves (layer-norm scales, biases) stay in the compute
  dtype.  :func:`quantize_leaf` runs in numpy exactly as the JAX package
  does, so ``q`` and ``scale`` are bitwise the JAX package's.

Execution: the transformer routes its matmuls through :func:`qdot` and
its embedding gathers through :func:`qtake`.  For a plain tensor
``qdot(x, w)`` IS ``x @ w``, so the f32 path is bitwise untouched.  For
a :class:`QuantLeaf` it runs W8A8: per-row symmetric activation
quantization, an int8 x int8 product with exact int32 accumulation, one
f32 rescale.

Where the product runs differs from the JAX package, whose ``auto`` mode
sends int8 operands to XLA's ``dot_general`` and only a forced Pallas
mode to ``pallas_int8_matmul``: here every ``qdot`` on the card launches
the hand-written CUDA kernel (``ops/kernels.int8_matmul``,
``csrc/int8_gemm.cu``).  Integer accumulation carries no rounding, so
the choice changes no number.  No stock PyTorch op computes s8 x s8 ->
s32 at every shape of the decode path either: ``torch._int_mm`` needs
more than 16 rows, which the prefill's one-row head product breaks, and
``int8 @ int8`` returns int8 and overflows.

``shard_put`` (tensor-parallel placement) comes with ROADMAP.md queue A
item 9.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ['QuantLeaf', 'quantize_leaf', 'quantize_tree', 'quantize_lm_tree',
           'dequantize_tree', 'qdot', 'qtake', 'tree_nbytes',
           'parse_serve_dtype', 'SERVE_DTYPES', 'LM_MATMUL_KEYS']

SERVE_DTYPES = ('f32', 'bf16', 'int8')

#: transformer-tree leaf names consumed through ``qdot``/``qtake``: the
#: int8 tier quantizes exactly these
LM_MATMUL_KEYS = ('embed', 'head', 'wq', 'wk', 'wv', 'wo',
                  'w1', 'w2', 'gate')


def parse_serve_dtype(value) -> str:
    """Validate a ``serve.dtype`` value ('f32' aliases 'float32')."""
    text = str(value).strip().lower()
    if text in ('', 'f32', 'float32', 'fp32'):
        return 'f32'
    if text in ('bf16', 'bfloat16'):
        return 'bf16'
    if text == 'int8':
        return 'int8'
    raise ValueError(
        f'serve.dtype must be one of {SERVE_DTYPES}, got {value!r}')


class QuantLeaf:
    """A symmetric per-channel int8 tensor: ``x ~= q * scale`` with
    ``scale`` broadcast along the contraction axis (``axis=-2``).
    ``out_dtype`` is the compute dtype :func:`qdot` / :func:`qtake`
    produce."""

    __slots__ = ('q', 'scale', 'out_dtype')

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32):
        self.q = q
        self.scale = scale
        self.out_dtype = out_dtype

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def device(self):
        return self.q.device

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, i) -> 'QuantLeaf':
        """Slice the leading (stage) axis of both children."""
        return QuantLeaf(self.q[i], self.scale[i], self.out_dtype)

    def to(self, device, copy: bool = False) -> 'QuantLeaf':
        """Both children on ``device`` (as ``Tensor.to``)."""
        return QuantLeaf(self.q.to(device, copy=copy),
                         self.scale.to(device, copy=copy), self.out_dtype)

    def dequantize(self, dtype: Optional[torch.dtype] = None):
        """``q * scale`` (one f32 multiply per element), cast to
        ``dtype`` (default ``out_dtype``)."""
        return (self.q.float() * self.scale.unsqueeze(-2)).to(
            self.out_dtype if dtype is None else dtype)

    def __repr__(self):
        return (f'QuantLeaf(int8 {self.shape}, scale '
                f'{tuple(self.scale.shape)}, out={self.out_dtype})')


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def quantize_leaf(x, out_dtype: torch.dtype = torch.float32) -> QuantLeaf:
    """Symmetric per-channel int8 quantization over ``axis=-2``: every
    output channel (and every entry of a leading stack axis) gets its own
    ``max|x| / 127`` scale; an all-zero channel takes scale 1 so ``q``
    stays 0.  In numpy on the host, step by step as the JAX package."""
    xf = _host_f32(x)
    if xf.ndim < 2:
        raise ValueError(f'quantize_leaf needs ndim >= 2, got {xf.shape}')
    amax = np.max(np.abs(xf), axis=-2)
    scale = np.where(amax == 0.0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.round(xf / np.expand_dims(scale, -2)),
                -127, 127).astype(np.int8)
    return QuantLeaf(torch.from_numpy(q), torch.from_numpy(scale), out_dtype)


def _map_named(fn, tree, name=''):
    """Depth-first map over a nested-dict tree with each leaf's own key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def _default_quant_key(name: str, leaf) -> bool:
    """The generic (netconfig) int8 rule: weight-shaped leaves (ndim >= 2)
    quantize; vectors (biases, norm scales) stay float."""
    return len(getattr(leaf, 'shape', ())) >= 2


def lm_quant_key(name: str, leaf) -> bool:
    """The transformer rule: exactly the ``qdot``/``qtake`` matmul
    leaves."""
    return (name in LM_MATMUL_KEYS
            and 2 <= len(getattr(leaf, 'shape', ())) <= 3)


def quantize_tree(tree, mode: str, *, out_dtype: Optional[torch.dtype] = None,
                  quant_key=None):
    """A host or device param tree in its serving storage tier.

    ``mode``: ``'f32'`` (the tree itself), ``'bf16'`` (float leaves cast)
    or ``'int8'`` (leaves passing ``quant_key`` become :class:`QuantLeaf`
    on the host, the other float leaves cast to ``out_dtype``, default
    f32)."""
    mode = parse_serve_dtype(mode)
    if mode == 'f32':
        return tree
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    key = _default_quant_key if quant_key is None else quant_key

    def one(name, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.array(leaf))
        if not t.is_floating_point():
            return t
        if mode == 'bf16':
            return t.to(torch.bfloat16)
        if key(name, t):
            return quantize_leaf(t, out_dtype)
        return t.to(out_dtype)

    return _map_named(one, tree)


def quantize_lm_tree(tree, mode: str, *,
                     out_dtype: Optional[torch.dtype] = None):
    """A transformer param tree in its serving tier under the LM
    matmul-leaf rule: the one call the decode engine makes for its target
    and its draft alike."""
    return quantize_tree(tree, mode, out_dtype=out_dtype,
                         quant_key=lm_quant_key)


def dequantize_tree(tree, dtype: Optional[torch.dtype] = None):
    """Expand every :class:`QuantLeaf` (and cast every float leaf to
    ``dtype`` when given): the weight-only predict tier's per-forward
    step."""

    def one(_name, leaf):
        if isinstance(leaf, QuantLeaf):
            return leaf.dequantize(dtype)
        if dtype is not None and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return _map_named(one, tree)


def tree_nbytes(tree) -> int:
    """Storage bytes of a (possibly quantized) tree: a :class:`QuantLeaf`
    counts its int8 payload and its scales."""
    total = 0

    def one(_name, leaf):
        nonlocal total
        total += (leaf.nbytes if isinstance(leaf, QuantLeaf)
                  else leaf.numel() * leaf.element_size())

    _map_named(one, tree)
    return int(total)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` through the quantized-leaf dispatcher.

    A plain tensor ``w``: ``x @ w``, the native op.  A 2-d
    :class:`QuantLeaf` ``w``: W8A8 — per-row symmetric activation
    quantization (``torch.round`` rounds half to even, as ``jnp.round``),
    the exact int32 product of ``ops.kernels.int8_matmul``, one f32
    rescale, the result in ``w.out_dtype``."""
    if not isinstance(w, QuantLeaf):
        return x @ w
    from ..ops.kernels import int8_matmul
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]).contiguous(), w.q)
    out = acc.float() * xs.reshape(-1, 1) * w.scale[None, :]
    return out.reshape(*lead, w.q.shape[-1]).to(w.out_dtype)


def qtake(emb, idx: torch.Tensor) -> torch.Tensor:
    """Embedding rows ``emb[idx]``: an int8 embedding gathers its rows and
    dequantizes just those (``scale`` is per embedding channel)."""
    if not isinstance(emb, QuantLeaf):
        return emb[idx]
    return (emb.q[idx].float() * emb.scale).to(emb.out_dtype)
