"""The numeric design and the work layout of the port's LRN kernels
(``ops/csrc/lrn.cu``, ``lrn_bwd.cu``, ``lrn.cuh``), modelled in numpy on
the CPU before any card time.

The model repeats the kernels' arithmetic in float32, in their order:

* forward: each channel's window summed in ascending channel order from
  0, one fma a term (``fma(x, x, win)``), ``norm = fma(alpha/n, win,
  knorm)``, ``y = x * p``;
* the power ``p = norm^-beta``: at beta = 0.75 ``(r * r) * rsqrt(r)``
  with ``r = rsqrt(norm)``, otherwise ``exp2(-beta * log2(norm))`` (the
  MUFU operations modelled as correctly rounded f32 results);
* backward: ``t = (g * x) * (p * rcp(norm))``, the transposed window
  [j - hi, j + lo] summed in ascending order from 0, ``dx = fma(-(coef *
  x), win, g * p)``;
* the fast path (16-byte items of 4 channels, window 5) reads an item's
  own 4 channels and its two neighbouring items, zero past the row's
  ends; the general path sums the window clipped to the row.

Each model is held against the JAX package's ``lrn_pallas`` and its vjp
(the Pallas kernels in interpret mode, as ``tests/test_torch_kernels.py``
runs them) within 1e-5 of the largest value (``chip_smoke.TOL``), and the
backward with the forward's window instead of the transposed one must
miss that at an even n.  The layout model walks the kernels' tiles (one
block a tile) and items as the sources define them (their constants are
read from the sources) and shows every (row, channel) covered exactly once
and every shared-memory read inside its row.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cxxnet_tpu.ops.pallas_kernels import _lrn_fwd_impl, lrn_pallas

pytestmark = pytest.mark.torch_port

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'cxxnet_tpu_torch', 'ops', 'csrc')
#: chip_smoke.py's TOL['lrn_forward'] and TOL['lrn_backward']
LRN_TOL = 1e-5
ALPHA, KNORM = 1e-3, 1.0
F32, F64 = np.float32, np.float64


def _const(fn, name):
    with open(os.path.join(CSRC, fn)) as f:
        m = re.findall(r'constexpr int ' + name + r' = (\d+);', f.read())
    assert len(m) == 1, (fn, name)
    return int(m[0])


def _fma(a, b, c):
    """fmaf: a * b + c rounded once to f32 (a * b is exact in f64)."""
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def _pow(nrm, beta):
    """lrn.cuh's lrn_pow on f32 norms."""
    if beta == 0.75:
        r = (1.0 / np.sqrt(nrm.astype(F64))).astype(F32)
        return (r * r) * (1.0 / np.sqrt(r.astype(F64))).astype(F32)
    lg = np.log2(nrm.astype(F64)).astype(F32)
    return np.exp2((F32(-beta) * lg).astype(F64)).astype(F32)


def _window(lo, hi):
    """Per output channel j, the summed channels j - lo .. j + hi."""
    return range(-lo, hi + 1)


def _items(a):
    """(rows, c) -> (rows, cq, 12): each item's previous, own and next 4
    channels, zero past the row (c % 4 == 0)."""
    rows, c = a.shape
    own = a.reshape(rows, c // 4, 4)
    z = np.zeros((rows, 1, 4), F32)
    prev = np.concatenate([z, own[:, :-1]], axis=1)
    nxt = np.concatenate([own[:, 1:], z], axis=1)
    return np.concatenate([prev, own, nxt], axis=2)


def _sum_window(a, offsets, fast, square):
    """Each channel's window over ``offsets`` of ``a`` (rows, c), in
    ascending order from 0: the fast path's item registers, or the
    general path's sum clipped to the row."""
    rows, c = a.shape
    win = np.zeros((rows, c), F32)
    if fast:
        v = _items(a)
        out = np.zeros((rows, c // 4, 4), F32)
        for e in range(4):
            w = np.zeros((rows, c // 4), F32)
            for off in offsets:
                q = v[:, :, 4 + e + off]
                w = _fma(q, q, w) if square else (w + q).astype(F32)
            out[:, :, e] = w
        return out.reshape(rows, c)
    for off in offsets:
        lo_j, hi_j = max(0, -off), min(c, c - off)
        q = a[:, lo_j + off:hi_j + off]
        part = win[:, lo_j:hi_j]
        win[:, lo_j:hi_j] = _fma(q, q, part) if square else \
            (part + q).astype(F32)
    return win


def fwd_model(x, nsize, beta, fast):
    """The forward kernel: (y, norm) of (rows, c) f32 x."""
    lo = (nsize - 1) // 2
    win = _sum_window(x, _window(lo, nsize - 1 - lo), fast, True)
    nrm = _fma(np.full_like(win, ALPHA / nsize), win,
               np.full_like(win, KNORM))
    return (x * _pow(nrm, beta)).astype(F32), nrm


def bwd_model(x, g, nrm, nsize, beta, fast, transposed=True):
    """The backward kernel: dx from x, g and the forward's f32 norm."""
    lo = (nsize - 1) // 2
    hi = nsize - 1 - lo
    p = _pow(nrm, beta)
    rcp = (1.0 / nrm.astype(F64)).astype(F32)
    t = ((g * x).astype(F32) * (p * rcp).astype(F32)).astype(F32)
    win = _sum_window(t, _window(hi, lo) if transposed else _window(lo, hi),
                      fast, False)
    coef = F32(2.0 * beta * ALPHA / nsize)
    return _fma(-(coef * x).astype(F32), win, (g * p).astype(F32))


def _case(c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 5, 5, c) * 3.0).astype(F32)
    g = rng.randn(2, 5, 5, c).astype(F32)
    return x, g


def _rel(got, want):
    want = np.asarray(want, F64)
    return np.abs(np.asarray(got, F64) - want).max() / np.abs(want).max()


MODEL_CASES = [(c, n, b) for c in (96, 256, 13, 130) for n in (5, 4, 1)
               for b in (0.75, 0.6)]


@pytest.mark.parametrize('c,nsize,beta', MODEL_CASES)
def test_forward_model_holds_pallas(c, nsize, beta):
    """y and norm of the forward kernel's model within 1e-5 of the
    largest value of JAX's Pallas forward (interpret mode)."""
    x, _ = _case(c, 100 + c + nsize)
    fast = c % 4 == 0 and nsize == 5
    y, nrm = fwd_model(x.reshape(-1, c), nsize, beta, fast)
    want_y, want_n = _lrn_fwd_impl(jnp.asarray(x), nsize, ALPHA, beta,
                                   KNORM)
    assert _rel(y, np.asarray(want_y).reshape(-1, c)) <= LRN_TOL
    assert _rel(nrm, np.asarray(want_n)) <= LRN_TOL


@pytest.mark.parametrize('c,nsize,beta', MODEL_CASES)
def test_backward_model_holds_pallas_vjp(c, nsize, beta):
    """dx of the backward kernel's model within 1e-5 of the largest value
    of ``jax.vjp`` of ``lrn_pallas`` (the Pallas backward, interpret)."""
    x, g = _case(c, 200 + c + nsize)
    fast = c % 4 == 0 and nsize == 5
    nrm = fwd_model(x.reshape(-1, c), nsize, beta, fast)[1]
    dx = bwd_model(x.reshape(-1, c), g.reshape(-1, c), nrm, nsize, beta,
                   fast)
    _, vjp = jax.vjp(lambda v: lrn_pallas(v, nsize, ALPHA, beta, KNORM),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    assert _rel(dx, np.asarray(want).reshape(-1, c)) <= LRN_TOL


@pytest.mark.parametrize('nsize', [4, 6])
def test_backward_model_with_the_forward_window_misses(nsize):
    """At an even n the forward's window [j - lo, j + hi] is not the
    backward's [j - hi, j + lo]: summing t over it misses JAX's vjp by
    far more than the tolerance, so the model's tests can tell."""
    c = 96
    x, g = _case(c, 300 + nsize)
    nrm = fwd_model(x.reshape(-1, c), nsize, 0.75, False)[1]
    dx = bwd_model(x.reshape(-1, c), g.reshape(-1, c), nrm, nsize, 0.75,
                   False, transposed=False)
    _, vjp = jax.vjp(lambda v: lrn_pallas(v, nsize, ALPHA, 0.75, KNORM),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    assert _rel(dx, np.asarray(want).reshape(-1, c)) > 100 * LRN_TOL


@pytest.mark.parametrize('c', [96, 256, 8])
@pytest.mark.parametrize('beta', [0.75, 0.6])
def test_fast_window_is_bitwise_the_clipped_sum(c, beta):
    """The fast path's zeros past a row's ends add nothing: its y, norm and
    dx equal the general path's clipped sums bitwise."""
    x, g = _case(c, 400 + c)
    x, g = x.reshape(-1, c), g.reshape(-1, c)
    y_f, n_f = fwd_model(x, 5, beta, True)
    y_g, n_g = fwd_model(x, 5, beta, False)
    assert np.array_equal(y_f, y_g) and np.array_equal(n_f, n_g)
    assert np.array_equal(bwd_model(x, g, n_f, 5, beta, True),
                          bwd_model(x, g, n_f, 5, beta, False))


# --- the work layout -----------------------------------------------------------

def _fwd_walk(rows, c):
    """lrn.cu's forward: (row, item) -> launches, and each item's staged
    reads (window 5: the fast path's neighbouring items where c % 4 == 0,
    else the clipped window), one block a tile."""
    threads = _const('lrn.cu', 'LRN_THREADS')
    tile_floats = _const('lrn.cu', 'LRN_TILE_FLOATS')
    tile_rows = 1 if c >= tile_floats else tile_floats // c
    ntiles = -(-rows // tile_rows)
    cq = -(-c // 4)
    seen = np.zeros((rows, cq), np.int64)
    reads = []
    for block in range(ntiles):
        r0 = block * tile_rows
        nrows = min(tile_rows, rows - r0)
        staged = nrows * c
        for tid in range(threads):
            # the kernel's walk: one division, then steps
            r, j = divmod(tid, cq)
            dr, dj = divmod(threads, cq)
            while r < nrows:
                seen[r0 + r, j] += 1
                ch = 4 * j
                if c % 4 == 0:    # the fast path: 16-byte items
                    lo_read = r * c + (ch - 4 if ch > 0 else ch)
                    hi_read = r * c + (ch + 8 if ch + 4 < c else ch + 4)
                else:             # the clipped window of 5
                    lo_read = r * c + max(0, ch - 2)
                    hi_read = r * c + min(c, ch + 4 + 2)
                reads.append((lo_read, hi_read, r * c, r * c + c, staged))
                j += dj
                r += dr
                if j >= cq:
                    j -= cq
                    r += 1
    return seen, reads


def _bwd_walk(rows, c):
    """lrn_bwd.cu's backward: (row, item) -> launches, one block a tile,
    and each item's staged-t slot and reads."""
    items = _const('lrn_bwd.cu', 'LRN_BWD_ITEMS')
    threads = _const('lrn_bwd.cu', 'LRN_BWD_THREADS')
    max_threads = _const('lrn_bwd.cu', 'LRN_BWD_MAX_THREADS')
    cq = -(-c // 4)
    cs = 4 * cq
    if cq > items * threads:
        threads = -(-cq // (items * 32)) * 32
    assert threads <= max_threads
    tile_rows = items * threads // cq
    assert tile_rows >= 1
    ntiles = -(-rows // tile_rows)
    seen = np.zeros((rows, cq), np.int64)
    slots = []
    for block in range(ntiles):
        r0 = block * tile_rows
        nrows = min(tile_rows, rows - r0)
        for tid in range(threads):
            for p in range(items):
                k = tid + p * threads
                r, j = divmod(k, cq)
                if r >= nrows:
                    continue
                seen[r0 + r, j] += 1
                slots.append((r * cs + 4 * j, tile_rows * cs, r * cs,
                              r * cs + cs))
    return seen, slots


@pytest.mark.parametrize('c', [96, 256, 13, 130, 5000])
def test_forward_walk_covers_each_item_once(c):
    """Every (row, item of 4 channels) of the forward is computed exactly
    once, the row count not a multiple of the tile, one block a tile;
    each fast-path read (the neighbouring items) stays inside its own
    staged row and inside the staged tile."""
    tile_floats = _const('lrn.cu', 'LRN_TILE_FLOATS')
    tile_rows = 1 if c >= tile_floats else tile_floats // c
    rows = 3 * tile_rows + 5
    seen, reads = _fwd_walk(rows, c)
    assert (seen == 1).all()
    for lo_read, hi_read, row_lo, row_hi, staged in reads:
        assert row_lo <= lo_read < hi_read <= row_hi <= staged


@pytest.mark.parametrize('c', [96, 256, 13, 130, 5000])
def test_backward_walk_covers_each_item_once(c):
    """Every (row, item) of the backward is computed exactly once by one
    of a thread's two item slots; each item's 16-byte t slot and its
    neighbours lie inside its staged row, inside the staged tile."""
    items = _const('lrn_bwd.cu', 'LRN_BWD_ITEMS')
    cq = -(-c // 4)
    threads = _const('lrn_bwd.cu', 'LRN_BWD_THREADS')
    if cq > items * threads:
        threads = -(-cq // (items * 32)) * 32
    tile_rows = items * threads // cq
    rows = 3 * tile_rows + 2
    seen, slots = _bwd_walk(rows, c)
    assert (seen == 1).all()
    for at, tile_floats, row_lo, row_hi in slots:
        assert row_lo <= at and at + 4 <= row_hi <= tile_floats
        assert at % 4 == 0    # a 16-byte aligned slot
