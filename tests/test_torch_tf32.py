"""The numeric design of the port's f32 kernels on the TF32 tensor cores
(3xTF32), modelled in torch on the CPU before any card time.

The tensor cores read a raw f32 register as TF32 by truncation and round
each product's sum into its f32 accumulator toward zero
(``ops/csrc/flash_tf32.cuh``).  ``_mma_tf32`` takes a product as the
kernels do: each operand split into hi + lo, three TF32 products a term
(or one, ``1x``), each 8-deep step's sum rounded toward zero, and each
tile's products summed in a fresh accumulator that an f32 add puts into
the result.  Each model below is held against the plain version and the
JAX package's Pallas kernel (interpret mode) on the same numpy-seeded
inputs, and the same model with one TF32 product a term must miss the
bound that the split holds:

* the f32 flash dq and dk/dv (``flash_dq.cu``, ``flash_dkv.cu``): within
  1e-4 of the largest value of each gradient; one chain of products a
  gradient over 16384 queries misses it (at 1000, the card test's rule);
* the fullc weight-gradient GEMM (``fullc_gemm_tn.cu``, 32-deep slices
  of the batch): within the card test's GEMM rule, 1e-5 of the largest
  value + 1e-6;
* the f32 flash forward (``flash_fwd.cu``: the online softmax over
  64-key tiles, ``ex2.approx``): out and lse within 1e-4 of the largest
  value.
"""

import math

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import flash as F
from cxxnet_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


# --- the TF32 model, and the f32 flash backward -----------------------------

#: (bh, sq, sk, causal, JAX block) of the f32 flash models: causal, cross and
#: ragged causal lengths, each at d in TF32_DIMS
TF32_CASES = {'causal': (2, 128, 128, True, 64),
              'cross_70x150': (2, 70, 150, False, 32),
              'ragged_97': (2, 97, 97, True, 32)}
TF32_DIMS = (33, 64, 128)
#: chip_smoke.py's TOL['flash_fwd'], TOL['flash_dq'] and TOL['flash_dkv']:
#: max |err| / max |ref| of each output
TF32_TOL = 1e-4


def _tf32(x, rn=True):
    """x as TF32 (10 explicit mantissa bits), by bit mask: rounded to
    nearest, ties away from zero (what ``cvt.rna.tf32.f32`` gives), or
    truncated (how the tensor cores read a raw f32 register)."""
    b = x.contiguous().view(torch.int32)
    return (((b + 0x1000) if rn else b) & ~0x1fff).view(torch.float32)


def _rz(x):
    """float64 x rounded to f32 toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_tf32(a, b, mode='trunc', tile=None):
    """a @ b as the f32 kernels take it on the TF32 tensor cores.  Each
    operand is split into hi + lo and every 8-deep step of the
    contraction is three m16n8k8 products, a_lo b_hi, a_hi b_lo, a_hi
    b_hi (TF32 products are exact in f32), each summed into its f32
    accumulator rounding toward zero, as the tensor cores round.
    ``tile``: each ``tile`` steps of the contraction sum in a fresh
    accumulator that an f32 add (to nearest) puts into the result, as
    flash_tf32.cuh ``tf_grad`` does; None: one accumulator over the whole
    contraction.  ``trunc``: hi = trunc(x), lo = trunc(x - hi), the
    kernels' split of raw registers; ``rn``: both parts rounded to
    nearest; ``1x``: a_hi b_hi alone, hi rounded to nearest."""
    rn = mode != 'trunc'
    ah, bh = _tf32(a, rn), _tf32(b, rn)
    terms = [(ah, bh)] if mode == '1x' else [
        (_tf32(a - ah, rn), bh), (ah, _tf32(b - bh, rn)), (ah, bh)]
    terms = [(x.double(), y.double()) for x, y in terms]
    depth = a.shape[1]
    tile = tile or depth
    out = torch.zeros(a.shape[0], b.shape[1])
    for t0 in range(0, depth, tile):
        acc = torch.zeros_like(out)
        for k0 in range(t0, min(t0 + tile, depth), 8):
            for x, y in terms:
                acc = _rz(acc.double() + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        out = out + acc
    return out


def _ex2_approx(x):
    """2^x as the kernels take it (flash_mma.cuh ``fw_exp2``,
    ``ex2.approx.ftz.f32``: within ~2 ulp, results below 2^-126 flushed
    to 0), modelled at its worst one way: every value 2 ulp low."""
    y = (torch.exp2(x.double()).float().double() * (1 - 2.0 ** -22)).float()
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def _tf32_p_ds(q, k, v, do, lse, delta, causal, mode, kv_rows):
    """p and ds of one slice as a kernel forms them: S and dP by
    :func:`_mma_tf32` (one accumulator over d), p = 2^(s scale log2(e) -
    lse log2(e)) by one f32 fma and :func:`_ex2_approx`, ds = p (dp -
    delta) in f32.  ``kv_rows``: the dk/dv kernel's transposed products
    (S^T = K Q^T, dP^T = V dO^T, the split's terms on the other side)."""
    sq, d = q.shape
    log2e = np.float32(1.4426950408889634)
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(d)) * log2e)
    if kv_rows:
        s, dp = _mma_tf32(k, q.T, mode).T, _mma_tf32(v, do.T, mode).T
    else:
        s, dp = _mma_tf32(q, k.T, mode), _mma_tf32(do, v.T, mode)
    nl = (-lse * log2e)[:, None]
    p = _ex2_approx((s.double() * float(scale_log2) + nl.double()).float())
    if causal:
        p = p * torch.ones_like(p).tril()
    return p, p * (dp - delta[:, None])


def _tf32_bwd_model(q, k, v, do, lse, delta, causal, mode='trunc',
                    tiles=True):
    """What the f32 dq and dk/dv kernels compute, one slice at a time:
    p and ds by :func:`_tf32_p_ds`, then dq = scale dS K, dv = P^T dO and
    dk = scale dS^T Q by :func:`_mma_tf32`, summed a tile at a time as the
    kernels' rings walk them (dq 32 keys, dk/dv 64 queries, 16 at d >
    64); ``tiles=False``: each gradient one chain over the whole
    contraction."""
    d = q.shape[2]
    scale = np.float32(1.0 / np.sqrt(d))
    kt, qt = (32, 64 if d <= 64 else 16) if tiles else (None, None)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for i in range(q.shape[0]):
        args = (q[i], k[i], v[i], do[i], lse[i], delta[i], causal, mode)
        _, ds = _tf32_p_ds(*args, kv_rows=False)
        dq[i] = _mma_tf32(ds, k[i], mode, kt) * scale
        p, ds = _tf32_p_ds(*args, kv_rows=True)
        dv[i] = _mma_tf32(p.T, do[i], mode, qt)
        dk[i] = _mma_tf32(ds.T, q[i], mode, qt) * scale
    return dq, dk, dv


def _rel(got, want):
    got, want = _np32(got), _np32(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize('d', TF32_DIMS)
@pytest.mark.parametrize('case', list(TF32_CASES))
def test_flash_f32_tf32_split_rounding_model(case, d):
    """The numeric design of the f32 dq and dk/dv kernels (3xTF32 on the
    tensor cores), checked before any card time: a torch model of their
    arithmetic (``_tf32_bwd_model``, with the kernels' truncating split
    and with both parts rounded to nearest) is within TF32_TOL of the
    largest value of each gradient against the plain versions and against
    JAX's flash backward (Pallas in interpret mode) on the same inputs,
    and the same model with one TF32 product a term (no split) is not."""
    from cxxnet_tpu.ops import pallas_kernels as pk
    import jax.numpy as jnp
    bh, sq, sk, causal, blk = TF32_CASES[case]
    rng = np.random.RandomState(17)
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32)
                  for s in (sq, sk, sk, sq))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out_j, lse_j = pk._flash_fwd_impl(jq, jk, jv, causal, blk, blk)
    want_j = pk._flash_bhsd_bwd(causal, blk, blk,
                                (jq, jk, jv, out_j, lse_j), jg)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    lse = torch.from_numpy(np.array(lse_j, dtype=np.float32))
    delta = (tg * torch.from_numpy(np.array(out_j))).sum(-1)
    plain = (F.flash_dq_plain(tq, tk, tv, tg, lse, delta, causal),
             *F.flash_dkv_plain(tq, tk, tv, tg, lse, delta, causal))
    for mode in ('trunc', 'rn'):
        got = _tf32_bwd_model(tq, tk, tv, tg, lse, delta, causal, mode)
        for name, a, b, j in zip(('dq', 'dk', 'dv'), got, plain, want_j):
            assert _rel(a, b) <= TF32_TOL, (mode, name, _rel(a, b))
            assert _rel(a, j) <= TF32_TOL, (mode, name, _rel(a, j))
    # the bound tells the split from one TF32 product a term, which
    # misses it
    coarse = _tf32_bwd_model(tq, tk, tv, tg, lse, delta, causal, '1x')
    assert max(_rel(a, b) for a, b in zip(coarse, plain)) > TF32_TOL


#: (sq, sk, causal, the bound one chain misses) of the long f32 cases at d
#: = 128: the card case that showed the drift (tests/test_torch_cuda.py
#: ``s1000_d128``), held to that test's f32 rule, and 16384 queries a key
#: (one chain over them drifts past TF32_TOL)
TF32_LONG = {'s1000_d128': (1000, 1000, True, 'card'),
             'cross_16384x16_d128': (16384, 16, False, 'tol')}
#: tests/test_torch_cuda.py's f32 flash rule: |err| <= RTOL max|ref| +
#: FLASH_ATOL
CARD_RTOL, CARD_ATOL = 1e-5, 1e-5


@pytest.mark.parametrize('case', list(TF32_LONG))
def test_flash_f32_tf32_tile_sums_contain_round_toward_zero(case):
    """The tensor cores round each product's sum into its accumulator
    toward zero, so one chain of products drifts one way.  The f32 dq and
    dk/dv kernels sum each tile's products in a fresh accumulator and add
    it in f32 (flash_tf32.cuh ``tf_grad``): modelled so
    (``_tf32_bwd_model``, which rounds as the tensor cores do), they are
    within TF32_TOL and the card test's rule of the plain versions, and
    the same model with one chain a gradient misses the case's bound."""
    sq, sk, causal, bound = TF32_LONG[case]
    rng = np.random.RandomState(71)
    q, k, v, g = (torch.from_numpy(rng.randn(1, s, 128).astype(np.float32))
                  for s in (sq, sk, sk, sq))
    out, lse = F.flash_fwd_plain(q, k, v, causal)
    delta = (g * out).sum(-1)
    plain = (F.flash_dq_plain(q, k, v, g, lse, delta, causal),
             *F.flash_dkv_plain(q, k, v, g, lse, delta, causal))

    def within(got, rule):
        err = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        top = [b.abs().max().item() for b in plain]
        if rule == 'card':
            return [e <= CARD_RTOL * m + CARD_ATOL for e, m in zip(err, top)]
        return [e <= TF32_TOL * m for e, m in zip(err, top)]
    tiles = _tf32_bwd_model(q, k, v, g, lse, delta, causal)
    assert all(within(tiles, 'card') + within(tiles, 'tol'))
    chain = _tf32_bwd_model(q, k, v, g, lse, delta, causal, tiles=False)
    assert not all(within(chain, bound))


# --- the fullc weight gradient (fullc_gemm_tn.cu) ----------------------------

#: (m, k, n) of a (m, k)^T @ g (m, n), contracting the batch m: ragged
#: and multi-slice shapes, a 1000-wide output, and batch 256
TN_CASES = {'small_ragged': (16, 32, 20), 'multi_slice': (9, 600, 130),
            'fc8_like': (70, 1000, 45), 'batch256': (256, 64, 72)}
#: the kernel's slice of the batch (fullc_gemm_tn.cu TN_BK), summed fresh
TN_SLICE = 32
#: tests/test_torch_cuda.py's GEMM rule: |err| <= RTOL max|ref| + ATOL
GEMM_RTOL, GEMM_ATOL = 1e-5, 1e-6


def _within_gemm_rule(got, ref):
    got, ref = _np32(got), _np32(ref)
    return np.abs(got - ref).max() <= GEMM_RTOL * np.abs(ref).max() \
        + GEMM_ATOL


@pytest.mark.parametrize('case', list(TN_CASES))
def test_gemm_tn_tf32_split_model(case):
    """The TN kernel's arithmetic (the truncating split, three products a
    term, each 32-deep slice of the batch summed fresh) is within the
    card test's GEMM rule of ``fullc_gemm_tn_plain`` and of JAX's
    ``_matmul_tn_impl`` (Pallas in interpret mode) on the same inputs;
    one TF32 product a term is not."""
    import jax.numpy as jnp
    from cxxnet_tpu.ops.pallas_kernels import _matmul_tn_impl
    m, k, n = TN_CASES[case]
    rng = np.random.RandomState(23)
    a = rng.randn(m, k).astype(np.float32)
    g = rng.randn(m, n).astype(np.float32)
    ta, tg = torch.from_numpy(a), torch.from_numpy(g)
    plain = kernels.fullc_gemm_tn_plain(ta, tg)
    want_j = _matmul_tn_impl(jnp.asarray(a), jnp.asarray(g))
    got = _mma_tf32(ta.T, tg, 'trunc', TN_SLICE)
    assert _within_gemm_rule(got, plain)
    assert _within_gemm_rule(got, want_j)
    coarse = _mma_tf32(ta.T, tg, '1x', TN_SLICE)
    assert not _within_gemm_rule(coarse, plain)


# --- the f32 flash forward (flash_fwd.cu) ------------------------------------

#: keys a tile of the f32 forward kernel (flash_fwd.cu FwdTf::KT)
FWD_KT = 64


def _tf32_fwd_model(q, k, v, causal, mode='trunc'):
    """What the f32 forward kernel computes, one slice at a time: q scaled
    in f32 before the dot; per FWD_KT-key tile S = (q scale) K^T by
    :func:`_mma_tf32` (one accumulator over d), the online softmax in f32
    (p = 2^(s log2(e) - m log2(e)) by one fma and :func:`_ex2_approx`,
    the denominator and O rescaled by 2^((m_old - m) log2(e)), exactly 1
    where a row's max did not move, a row with nothing live yet keeping
    the reference point 0), O += P V by :func:`_mma_tf32` (the tile's
    products in a fresh accumulator added in f32); then out = O / l and
    lse = m + ln l."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(d)))
    log2e = np.float32(1.4426950408889634)
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq)
    rows = torch.arange(sq)[:, None]
    for i in range(bh):
        qs = q[i] * scale
        m = torch.full((sq,), -math.inf)
        l = torch.zeros(sq)
        o = torch.zeros(sq, d)
        for k0 in range(0, sk, FWD_KT):
            kt, vt = k[i, k0:k0 + FWD_KT], v[i, k0:k0 + FWD_KT]
            s = _mma_tf32(qs, kt.T, mode)
            if causal:
                cols = torch.arange(k0, k0 + kt.shape[0])[None, :]
                s = s.masked_fill(cols > rows, -math.inf)
            m_new = torch.maximum(m, s.amax(1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            corr = torch.where(m == m_use, 1.0,
                               _ex2_approx((m - m_use) * log2e))
            nms = (-m_use * log2e).double()[:, None]
            p = _ex2_approx((s.double() * float(log2e) + nms).float())
            l = l * corr + p.sum(1)
            o = o * corr[:, None] + _mma_tf32(p, vt, mode)
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        out[i] = o / l_safe[:, None]
        lse[i] = m + torch.log(l_safe)
    return out, lse


@pytest.mark.parametrize('d', TF32_DIMS)
@pytest.mark.parametrize('case', list(TF32_CASES))
def test_flash_f32_tf32_forward_model(case, d):
    """The f32 forward kernel's arithmetic (``_tf32_fwd_model`` with the
    truncating split) is within TF32_TOL of the largest value of out and
    of lse against ``flash_fwd_plain`` and JAX's ``_flash_fwd_impl``
    (Pallas in interpret mode) on the same inputs; with one TF32 product
    a term it is not."""
    import jax.numpy as jnp
    from cxxnet_tpu.ops import pallas_kernels as pk
    bh, sq, sk, causal, blk = TF32_CASES[case]
    rng = np.random.RandomState(29)
    q, k, v = (rng.randn(bh, s, d).astype(np.float32)
               for s in (sq, sk, sk))
    out_j, lse_j = pk._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, blk, blk)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = F.flash_fwd_plain(tq, tk, tv, causal)
    got = _tf32_fwd_model(tq, tk, tv, causal)
    for name, a, b, j in zip(('out', 'lse'), got, plain, (out_j, lse_j)):
        assert _rel(a, b) <= TF32_TOL, (name, _rel(a, b))
        assert _rel(a, j) <= TF32_TOL, (name, _rel(a, j))
    coarse = _tf32_fwd_model(tq, tk, tv, causal, '1x')
    assert max(_rel(a, b) for a, b in zip(coarse, plain)) > TF32_TOL
