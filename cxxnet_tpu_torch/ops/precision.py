"""Full-precision library math.

PyTorch lets cuDNN convolutions use TF32 (a 10-bit mantissa) by default,
``torch.backends.cuda.matmul.allow_tf32`` can turn it on for cuBLAS, and
``allow_bf16_reduced_precision_reduction`` and
``allow_fp16_reduced_precision_reduction`` (on by default) let cuBLAS
round a bf16 or f16 product's partial sums to 16 bits on the way.  The
port computes in f32, and accumulates its 16-bit products in f32, as the
JAX package does (the TPU's MXU sums bf16 products in f32; XLA's dots
take f32 accumulators) and as the kernels of ``csrc/`` do, so every
library call it makes on the card runs inside :func:`full_f32`.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0          # guarded-by: _lock (blocks open across all threads)
_saved = None       # guarded-by: _lock (the flags the first block found)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)


def _set_flags(flags) -> None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
     torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction) = \
        flags


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuBLAS and cuDNN and bf16 and f16
    reduced-precision reductions off for cuBLAS inside the block, and restore the caller's
    flags after it.  The flags are process-wide, as PyTorch keeps them, so
    blocks open on several threads at once (a decode engine's loop and
    its admitting thread) share one setting: the first to open saves the
    flags, the last to close restores them.  The CPU ignores them."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _flags()
            _set_flags((False, False, False, False))
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _set_flags(_saved)
