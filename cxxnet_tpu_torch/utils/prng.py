"""JAX's threefry key schedule in numpy, for sampled decoding.

The JAX package samples pick n of a stream with
``jax.random.categorical(keys[n], logits / temperature)`` over
``keys = jax.random.split(jax.random.PRNGKey(seed), max_new + 1)``.
This module computes the same keys and the same float32 uniforms without
JAX, so the port's sampled streams are JAX's: the Threefry-2x32 hash
(Salmon et al., SC'11; 20 rounds) and the counter layout of JAX's
partitionable threefry (``jax_threefry_partitionable=True``, jax 0.9's
default), with 64-bit mode off.  Under that layout the bits of element i
of a draw are the hash of the 64-bit counter i (high word, low word), so
one row of a ``(rows, n)`` draw is computed alone from its counters.

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: ``(0, seed mod 2^32)``
  (x64 off keeps the low 32 bits of the seed);
* :func:`split` — ``jax.random.split(key, num)``;
* :func:`uniform` — ``jax.random.uniform(key, shape, float32, minval,
  maxval)``, bitwise;
* :func:`gumbel_row` — row ``row`` of ``jax.random.gumbel(key, (rows,
  n))`` (low mode, the default): ``-log(-log(u))`` in float32 of
  ``uniform(minval=tiny, maxval=1)``.  numpy's and XLA's float32 ``log``
  round apart in the last bit, so the noise matches JAX's to a few
  float32 ulps, and a pick wherever the perturbed top two are not that
  close.
"""

from __future__ import annotations

import numpy as np

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


def _bits(key, start: int, n: int) -> np.ndarray:
    """32 random bits of elements start .. start+n-1 of a draw."""
    b0, b1 = threefry2x32(key, *_counters(start, n))
    return b0 ^ b1


def _to_unit(bits: np.ndarray, minval, maxval) -> np.ndarray:
    """JAX's float32 uniform from 32 random bits: the top 23 bits as the
    mantissa of a float in [1, 2), less 1, scaled and clamped to
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(lo, (f - np.float32(1.0)) * (hi - lo) + lo)


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
