"""JAX's threefry random stream without JAX: keys, uniforms and normals.

The JAX package samples pick n of a stream with
``jax.random.categorical(keys[n], logits / temperature)`` over
``keys = jax.random.split(jax.random.PRNGKey(seed), max_new + 1)``, and
its CNN trainer draws initial weights and dropout / insanity / prelu
noise from ``fold_in`` keys of ``PRNGKey(seed)``.  This module computes
the same keys and the same bits without JAX, so the port's sampled
streams, initial weights and noise are JAX's: the Threefry-2x32 hash
(Salmon et al., SC'11; 20 rounds) and the counter layout of JAX's
partitionable threefry (``jax_threefry_partitionable=True``, jax 0.9's
default), with 64-bit mode off.  Under that layout the bits of element i
of a draw are the hash of the 64-bit counter i (high word, low word), so
one row of a ``(rows, n)`` draw is computed alone from its counters.

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: ``(0, seed mod 2^32)``
  (x64 off keeps the low 32 bits of the seed);
* :func:`split` — ``jax.random.split(key, num)``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the hash of the
  counter words ``(0, data mod 2^32)``;
* :func:`uniform` — ``jax.random.uniform(key, shape, float32, minval,
  maxval)``, bitwise, in numpy;
* :func:`uniform_plain` — the plain version of the ``threefry`` kernel
  (``ops/csrc/threefry.cu``, wrapped by ``ops/threefry.py``): elements
  0 .. n-1 of ``jax.random.uniform`` in float32, bfloat16 or float16 as
  torch tensors, bitwise, optionally compared with a threshold.  In bf16
  JAX draws 8 bits an element (``nmant`` 7 < 8): the low byte of the two
  hash words' xor, shifted right once under bf16's 1.0; in f16 16 bits:
  the low 16 bits of the xor, shifted right by 6 under f16's 1.0 (its
  10 mantissa bits); ``(f - 1) (hi - lo) + lo`` is then, as XLA's CPU
  backend computes it, one fused multiply-add in float32, a bf16 product
  then a bf16 sum in bfloat16, and in float16 the product (exact) and
  the sum in float32 with one rounding to float16 (so a sum that rounds
  to zero from below is -0, as JAX's is); clamped at ``lo``;
* :func:`gumbel_row` — row ``row`` of ``jax.random.gumbel(key, (rows,
  n))`` (low mode, the default): ``-log(-log(u))`` in float32 of
  ``uniform(minval=tiny, maxval=1)``.  numpy's and XLA's float32 ``log``
  round apart in the last bit, so the noise matches JAX's to a few
  float32 ulps, and a pick wherever the perturbed top two are not that
  close.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_TINY = np.finfo(np.float32).tiny


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays of
    one shape) under ``key`` ((2,) uint32): the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(start: int, n: int):
    """The high and low words of the 64-bit counters start .. start+n-1."""
    c = np.arange(start, start + n, dtype=np.uint64)
    return ((c >> np.uint64(32)).astype(np.uint32),
            (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    return np.stack(threefry2x32(key, *_counters(0, num)), axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: (2,) uint32, the hash of the
    counter words ``(0, data)`` (``data`` taken mod 2^32, as JAX's uint32
    cast keeps it)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _bits(key, start: int, n: int) -> np.ndarray:
    """32 random bits of elements start .. start+n-1 of a draw."""
    b0, b1 = threefry2x32(key, *_counters(start, n))
    return b0 ^ b1


def _to_unit(bits: np.ndarray, minval, maxval) -> np.ndarray:
    """JAX's float32 uniform from 32 random bits: the top 23 bits as the
    mantissa of a float in [1, 2), less 1, scaled by one fused
    multiply-add (exact in float64, then rounded once, as XLA's CPU
    backend contracts it) and clamped to ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = (f - np.float32(1.0)).astype(np.float64) * np.float64(hi - lo) \
        + np.float64(lo)
    return np.maximum(lo, u.astype(np.float32))


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    n = int(np.prod(shape, dtype=np.int64))
    return _to_unit(_bits(key, 0, n), minval, maxval).reshape(shape)


def gumbel_row(key, n: int, row: int = 0) -> np.ndarray:
    """Row ``row`` of the ``(rows, n)`` float32 Gumbel noise that
    ``jax.random.categorical(key, logits)`` adds to ``(rows, n)`` logits
    (a ``(n,)`` draw is row 0)."""
    u = _to_unit(_bits(key, row * n, n), _TINY, 1.0)
    return -np.log(-np.log(u))


# --- the plain version of the threefry kernel (torch) --------------------------

#: elements a chunk of the plain versions (their temporaries stay small)
_CHUNK = 1 << 22


def _i32(v: int) -> int:
    """A uint32 value as the int32 of the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _threefry_torch(key, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """:func:`threefry2x32` on int32 tensors holding the uint32 words'
    bits (adds wrap; a right shift is masked to be logical); the xor of
    the two output words."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = x0 + _i32(ks[0])
    x1 = x1 + _i32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + _i32(ks[(i + 1) % 3])
        x1 = x1 + _i32(ks[(i + 2) % 3] + i + 1)
    return x0 ^ x1


def affine_args(dtype: torch.dtype, minval: float, maxval: float):
    """``(lo, span)`` as 0-d tensors of ``dtype``: JAX converts minval and
    maxval to the element type, then takes ``maxval - minval`` in it."""
    lo = torch.tensor(minval, dtype=torch.float32).to(dtype)
    hi = torch.tensor(maxval, dtype=torch.float32).to(dtype)
    return lo, hi - lo


def unit_from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``floats - 1`` in [0, 1) of ``dtype`` from 32 hash bits (an
    int32 tensor): float32 keeps the top 23 bits as the mantissa, bfloat16
    the low byte shifted right once (7 bits), float16 the low 16 bits
    shifted right by 6 (10 bits)."""
    if dtype == torch.float32:
        return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(
            torch.float32) - 1.0
    if dtype == torch.bfloat16:
        return (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16) - 1.0
    if dtype == torch.float16:
        return (((bits & 0xFFFF) >> 6) | 0x3C00).to(torch.int16).view(
            torch.float16) - 1.0
    raise ValueError(f'threefry uniform: no {dtype} draw (float32, '
                     'bfloat16 or float16)')


def uniform_plain(key, n: int, dtype: torch.dtype = torch.float32,
                  minval: float = 0.0, maxval: float = 1.0,
                  thresh=None, device='cpu') -> torch.Tensor:
    """Elements 0 .. n-1 of ``jax.random.uniform(key, (n,), dtype, minval,
    maxval)`` as a 1-d tensor of ``dtype`` on ``device``, bitwise; with
    ``thresh``, ``(u < thresh)`` in ``dtype`` (``thresh`` rounded to
    ``dtype`` first, as JAX compares with a weakly typed float).  The plain
    version of the ``threefry`` kernel, in int32 torch arithmetic, a chunk
    of elements at a time (the 64-bit counter's high word is 0 below
    2^31 elements)."""
    if n >= 1 << 31:
        raise ValueError(f'uniform_plain: {n} elements; the plain version '
                         'counts in int32')
    lo, span = (t.to(device) for t in affine_args(dtype, minval, maxval))
    out = torch.empty(n, dtype=dtype, device=device)
    for s in range(0, n, _CHUNK):
        c = torch.arange(s, min(n, s + _CHUNK), dtype=torch.int32,
                         device=device)
        u = unit_from_bits(_threefry_torch(key, torch.zeros_like(c), c),
                           dtype)
        if dtype == torch.float32:
            # one fused multiply-add, as XLA's CPU backend contracts it:
            # f (23 bits) x span (24) + lo is exact in float64, so its
            # one rounding to float32 is the fma's
            u = (u.double() * span.double() + lo.double()).float()
        elif dtype == torch.float16:
            # XLA computes the f16 expression in f32 and rounds once: f
            # (10 bits) x span (11) is exact in f32, the sum is rounded to
            # f32, then to f16 (24 >= 2 x 11 + 2: the double rounding is
            # the direct one)
            u = (u.float() * span.float() + lo.float()).to(dtype)
        else:
            u = u * span + lo     # bf16 product, then bf16 sum
        u = torch.maximum(lo, u)
        if thresh is not None:
            u = (u < torch.tensor(thresh, dtype=torch.float32).to(
                dtype)).to(dtype)
        out[s:s + len(c)] = u
    return out


def normal_lo(dtype: torch.dtype) -> float:
    """``nextafter(-1, 0)`` in ``dtype``: the lower end of the uniform
    under JAX's normal (half an ulp of 1 below it: f32's 2^-24, f16's
    2^-11, bf16's 2^-8)."""
    return -1.0 + torch.finfo(dtype).eps / 2


#: sqrt(2) as JAX's normal multiplies by it (rounded to float32), and in
#: float16 (rounded to float16)
SQRT2 = float(np.float32(math.sqrt(2)))
SQRT2_F16 = float(np.float16(math.sqrt(2)))

# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function",
# GPU Computing Gems, 2010: single-precision polynomials in
# w = -log1p(-x^2), about w - 2.5 below 5 and sqrt(w) - 3 above)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` step by step (its polynomials, its edge
    case at |x| = 1), on tensors: within a few float32 ulps of JAX's
    (log1p and the Horner steps' roundings differ), where torch.erfinv's
    rational approximation lies up to ~90 ulps off in the tails."""
    out = torch.empty_like(x)
    flat, res = x.reshape(-1), out.view(-1)
    coef = torch.tensor((_ERFINV_LT5, _ERFINV_GE5), dtype=x.dtype,
                        device=x.device)
    for s in range(0, flat.numel(), _CHUNK):
        v = flat[s:s + _CHUNK]
        w = -torch.log1p(-v * v)
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = None
        for i in range(len(_ERFINV_LT5)):
            c = torch.where(lt, coef[0, i], coef[1, i])
            p = c if p is None else c + p * w
        r = p * v
        res[s:s + _CHUNK] = torch.where(v.abs() == 1.0, v * math.inf, r)
    return out
