"""JAX's random draws on the port's device: the ``threefry`` kernel.

The JAX package draws initial weights and dropout, insanity and prelu
noise with ``jax.random.uniform`` / ``normal`` from ``fold_in`` keys
(``cxxnet_tpu/layers/base.py:189-209``).  These functions draw the same
numbers, bitwise for the uniforms, in the same shapes and dtypes: on a
CUDA tensor's device through ``csrc/threefry.cu`` (counted as
``threefry_uniform``), on the CPU through its plain version
``utils/prng.uniform_plain``.  No ``pallas_call`` stands behind them in
the JAX package (XLA compiles its threefry), so this kernel replaces no
TPU kernel; there is no fall-back to ``torch.rand`` on any device.

* :func:`uniform` — ``jax.random.uniform(key, shape, dtype, minval,
  maxval)``;
* :func:`normal` — ``jax.random.normal(key, shape, dtype)``:
  ``sqrt(2) erf_inv(u)`` of a uniform over ``(nextafter(-1, 0), 1)``.
  The uniforms are JAX's bit for bit; ``erf_inv`` is XLA's polynomial
  (``utils/prng.erf_inv``, plain PyTorch on every device), a few float32
  ulps from JAX's (in float16 computed in float32 and rounded once, as
  XLA does, which lands on JAX's f16 values);
* :func:`keep_mask` — ``(jax.random.uniform(key, shape, dtype) <
  pkeep)`` in ``dtype``: a dropout mask in one launch.
"""

from __future__ import annotations

import torch

from ..utils import prng
from . import build, launches


def _draw(key, shape, dtype, device, minval, maxval, thresh=None):
    device = torch.device(device)
    n = 1
    for d in shape:
        n *= int(d)
    if device.type == 'cpu':
        return prng.uniform_plain(key, n, dtype, minval, maxval, thresh,
                                  device).reshape(shape)
    if device.type != 'cuda':
        raise RuntimeError(f'threefry_uniform: no kernel for device {device}')
    sfx = build.dtype_suffix('threefry_uniform', dtype)
    lo, span = prng.affine_args(dtype, minval, maxval)
    th = 0.0 if thresh is None else float(
        torch.tensor(thresh, dtype=torch.float32).to(dtype))
    out = torch.empty(shape, dtype=dtype, device=device)
    err = build.entry('threefry' + sfx)(
        out.data_ptr(), int(key[0]), int(key[1]), n,
        0 if thresh is None else 1, float(lo), float(span), th,
        torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(err, 'threefry_uniform' + sfx)
    launches.add('threefry_uniform')
    return out


def uniform(key, shape, dtype=torch.float32, device='cpu', minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` on
    ``device``, bitwise (float32, bfloat16 or float16)."""
    return _draw(key, tuple(shape), dtype, device, minval, maxval)


def normal(key, shape, dtype=torch.float32, device='cpu') -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on ``device``: JAX's
    uniforms bitwise, then ``sqrt(2) erf_inv(u)`` (a few ulps from
    JAX's)."""
    u = _draw(key, tuple(shape), dtype, device, prng.normal_lo(dtype), 1.0)
    if dtype == torch.float16:
        # XLA's f16 erf_inv runs in f32 and rounds once; the product by
        # sqrt(2) rounded to f16 is an f16 product
        return prng.erf_inv(u.float()).to(dtype).mul_(prng.SQRT2_F16)
    return prng.erf_inv(u).mul_(prng.SQRT2)


def keep_mask(key, shape, dtype, device, pkeep: float) -> torch.Tensor:
    """``(jax.random.uniform(key, shape, dtype) < pkeep)`` as 1 / 0 in
    ``dtype`` (``pkeep`` rounded to ``dtype``, as JAX compares)."""
    return _draw(key, tuple(shape), dtype, device, 0.0, 1.0, pkeep)
