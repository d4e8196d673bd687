"""Carry parameters from the JAX package into the port.

``params_from_jax(tree)`` takes the JAX trainer's ``params`` — a dict
keyed by ``str(layer_primary index)`` whose leaves are arrays (numpy, or
anything ``np.asarray`` accepts) — and returns the port's tree of float32
tensors on ``device``.  No layout changes: both packages keep conv
weights HWIO ``(kh, kw, cin/g, cout)`` and fullc weights
``(nin, nhidden)``, and both key layers and fields alike — batch_norm's
``(C,)`` slope ``wmat`` and shift ``bias``, prelu's slope under ``bias``,
the bias layer's ``bias`` and a pairtest layer's master fields included —
so the two nets compute the same function from the same numbers.
``opt_state_from_jax(opt_state)`` carries the optimizer slots (SGD/NAG
momentum ``m``, Adam ``m1``/``m2``) the same way, so both packages can
start from the same mid-run state.  ``lm_params_from_jax(tree)`` carries
a TransformerLM tree (``embed``, ``head``, nested ``stages``) with its
layout unchanged, quantized serving trees included: a leaf with ``.q``
and ``.scale`` (the JAX package's ``QuantLeaf``) becomes the port's
``QuantLeaf`` bitwise, and bfloat16 and float16 leaves keep their
dtype.  This module
imports no JAX; the caller hands over host arrays (or leaves whose
children are host arrays).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, device='cpu'
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX param tree (host arrays) → the port's param tree on
    ``device``; every leaf is copied, layout unchanged."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, fields in tree.items():
        out[str(key)] = {
            f: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for f, v in fields.items()}
    return out


def opt_state_from_jax(opt_state: Mapping, device='cpu'
                       ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """JAX optimizer state (``{slot: param-shaped tree}`` of host arrays)
    → the port's, every slot tree copied like :func:`params_from_jax`."""
    return {str(slot): params_from_jax(tree, device)
            for slot, tree in opt_state.items()}


#: the 16-bit float dtypes a JAX leaf may carry, by numpy dtype name
_HALF_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16}


def _lm_leaf(leaf, device):
    arr = np.asarray(leaf)
    half = _HALF_DTYPES.get(arr.dtype.name)
    if half is not None:                 # exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=half)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def lm_params_from_jax(tree: Mapping, device='cpu'):
    """JAX TransformerLM param tree (host arrays, nested ``stages``) → the
    port's tree on ``device``, layout unchanged: float32 tensors,
    bfloat16 / float16 ones where the leaf is, and a ``QuantLeaf`` (int8
    ``q``, float32 ``scale``, the same ``out_dtype``) where the leaf has
    ``.q`` and ``.scale``."""
    from .nnet.quantize import QuantLeaf
    if isinstance(tree, Mapping):
        return {str(k): lm_params_from_jax(v, device)
                for k, v in tree.items()}
    if hasattr(tree, 'q') and hasattr(tree, 'scale'):
        out = _HALF_DTYPES.get(np.dtype(tree.out_dtype).name, torch.float32)
        return QuantLeaf(
            torch.from_numpy(np.array(tree.q, dtype=np.int8)).to(device),
            torch.from_numpy(np.array(tree.scale, dtype=np.float32)).to(
                device), out)
    return _lm_leaf(tree, device)
