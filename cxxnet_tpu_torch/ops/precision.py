"""Full-f32 library math.

PyTorch lets cuDNN convolutions use TF32 (a 10-bit mantissa) by default,
and ``torch.backends.cuda.matmul.allow_tf32`` can turn it on for cuBLAS.
The port computes in f32, as the JAX package's f32 path and the kernels
of ``csrc/`` do, so every library call it makes on the card runs inside
:func:`full_f32`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuBLAS and cuDNN inside the block and restore
    the caller's flags after it.  The flags are process-wide, as PyTorch
    keeps them; the CPU ignores them."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
