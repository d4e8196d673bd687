"""The paged attention kernels' reduction order (``ops/csrc/paged_attn.cuh``,
the body of ``paged_decode.cu`` and ``paged_verify.cu``), modelled in
float32 torch on the CPU before any card time.

``_attend_one`` follows ``paged_attend_one`` step by step:

* the slot's page ids are read once, and row t is ``table[t / ps]`` at
  offset ``t % ps``, t / ps by ``pa_quot``'s multiply and shift
  (paged_attn.cuh:161-177, 212-213, 231);
* a row is cut into chunks of 16 bytes (4 f32, 8 bf16; 1 element where
  hd does not allow it), LPR = the power of two >= chunks / 2 (<= 32)
  lanes a row (``pa_lanes``, :154-159), warp v owning live rows
  [v R, v R + R), R = ceil(n / 8) (:215-221);
* a score is each lane's fma chain over its chunks, d ascending, then an
  xor butterfly over the row's lanes, rounded to bf16 and scaled and
  rounded in the bf16 build (:259-286); the max is exact (:289-299);
* the denominator is thread i's sum over rows i, i + 256, ..., a 32-lane
  xor butterfly, then warps 0..7 in order (:301-314); p = e / l rounded
  to bf16 in the bf16 build, divided once (:315-317);
* the output is each row group's fma chain over its rows in position
  order, an xor butterfly over the warp's groups (16 lanes apart first),
  then warps 0..7 in order, rounded at the store (:320-369).

A fused multiply-add is modelled as one float64 step rounded to float32.
The model must be within the card's ``TOL`` (f32) of
``paged_flash_decode_plain`` and the JAX package's ``paged_flash_decode``
(interpret mode), within ``BF16_REL`` of the plain bf16 version, bitwise
the same under another page size and a shuffled table, and a verify
query k bitwise the decode step at ``pos + k``; the same model with the
denominator summed page by page must lose the page-size invariance.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cxxnet_tpu.ops import pallas_kernels as JPK
import torch

from cxxnet_tpu_torch.ops.attention import (paged_flash_decode_plain,
                                            paged_flash_verify_plain)

pytestmark = pytest.mark.torch_port

WARPS, THREADS = 8, 256
LANE_CHUNKS = 2     # 16-byte chunks of a row a lane holds (pa_lanes)
#: chip_smoke.py's TOL['paged_flash_decode'] and the card tests' BF16_REL
TOL, BF16_REL = 1e-5, 1e-2


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x, width, dim):
    """An xor butterfly over ``width`` lanes of ``dim`` (size width),
    widest offset first; every lane ends with the same bits."""
    idx = torch.arange(width)
    off = width // 2
    while off > 0:
        x = x + x.index_select(dim, idx ^ off)
        off //= 2
    return x


def _quot(t, d):
    """``pa_quot``: t // d by a multiply and a shift, 0 <= t < 2^31."""
    s = max(d - 1, 0).bit_length()
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return ((((t * m) >> 32) + t) & 0xffffffff) >> s


def _attend_one(q, kpool, vpool, table_row, h, w, last, scale,
                page_order=False):
    """One (slot, head, query) as ``paged_attend_one`` computes it: q
    (hd,), pools (P, ps, H, hd) in f32 or bf16."""
    bf16 = kpool.dtype == torch.bfloat16

    def rnd(x):
        return x.bfloat16().float() if bf16 else x
    ps, hd = kpool.shape[1], kpool.shape[3]
    n = last - w + 1
    t = torch.arange(w, last + 1)
    pg = torch.tensor([_quot(int(x), ps) for x in t])
    rows = table_row[pg].long() * ps + (t - pg * ps)
    kr = kpool.reshape(-1, *kpool.shape[2:])[rows, h].float()   # (n, hd)
    vr = vpool.reshape(-1, *vpool.shape[2:])[rows, h].float()
    q = q.float()

    esz = kpool.element_size()
    vec = 16 // esz if hd * esz % 16 == 0 else 1
    chunks = hd // vec
    lpr = 1
    while lpr < -(-chunks // LANE_CHUNKS) and lpr < 32:
        lpr *= 2
    rpw = 32 // lpr
    R = -(-n // WARPS)

    # scores: lane `sub` chains its chunks sub, sub + lpr, ... (d ascending)
    part = torch.zeros(n, lpr)
    for sub in range(lpr):
        for ch in range(sub, chunks, lpr):
            for d in range(ch * vec, (ch + 1) * vec):
                part[:, sub] = _fma(q[d].expand(n), kr[:, d], part[:, sub])
    s = rnd(rnd(_butterfly(part, lpr, 1)[:, 0]) * scale)
    m = s.max()
    e = torch.exp(s - m)
    if page_order:          # a variant whose order follows the pages
        l = torch.zeros(())
        for p in torch.unique_consecutive(pg):
            l = l + e[pg == p].sum()
    else:
        thr = torch.zeros(THREADS)
        for i in range(0, n, THREADS):
            blk = e[i:i + THREADS]
            thr[:len(blk)] = thr[:len(blk)] + blk
        warp = _butterfly(thr.view(WARPS, 32), 32, 1)[:, 0]
        l = warp[0]
        for v in range(1, WARPS):
            l = l + warp[v]
    p = rnd(e / l)

    out = torch.zeros(hd)
    for v in range(WARPS):
        r0, r1 = min(n, v * R), min(n, v * R + R)
        acc = torch.zeros(rpw, hd)
        for grp in range(rpw):
            for idx in range(r0 + grp, r1, rpw):
                acc[grp] = _fma(p[idx].expand(hd), vr[idx], acc[grp])
        wo = _butterfly(acc, rpw, 0)[0]
        out = wo if v == 0 else out + wo
    return rnd(out)


def _model(q, kpool, vpool, table, pos, w, scale, page_order=False):
    """The decode kernel (q (S, H, hd)) or the verify kernel (q (S, K, H,
    hd): query k over [w, pos + k]) on the model's order."""
    verify = q.dim() == 4
    qk = q if verify else q[:, None]
    out = torch.zeros(qk.shape, dtype=qk.dtype)
    for s in range(qk.shape[0]):
        for k in range(qk.shape[1]):
            for h in range(qk.shape[2]):
                out[s, k, h] = _attend_one(
                    qk[s, k, h], kpool, vpool, table[s], h, int(w[s]),
                    int(pos[s]) + k, scale, page_order)
    return out if verify else out[:, 0]


def _case(S, pp, ps, H, hd, pos, w, seed, K=1, dtype=torch.float32):
    g = np.random.RandomState(seed)
    P = S * pp + 3
    pools = [torch.from_numpy(g.randn(P, ps, H, hd).astype(np.float32))
             .to(dtype) for _ in range(2)]
    table = g.permutation(np.arange(1, P))[:S * pp].reshape(S, pp)
    shape = (S, K, H, hd) if K > 1 else (S, H, hd)
    q = torch.from_numpy(g.randn(*shape).astype(np.float32)).to(dtype)
    return (q, pools[0], pools[1],
            torch.from_numpy(table.astype(np.int32)),
            torch.tensor(pos, dtype=torch.int32),
            torch.tensor(w, dtype=torch.int32))


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


#: (S, pp, ps, H, hd, pos, w): the smoke's 16-position pages at 256 live
#: rows, live lengths past 256 (T = 2048), hd 32 and 128 (LPR 4 and 16),
#: a ragged page size, and hd 20: 5 chunks over 4 lanes in f32, the
#: 1-element chunks in bf16
DECODE = {'smoke_pages': (3, 16, 16, 2, 64, [255, 31, 0], [0, 7, 0]),
          'T2048': (2, 128, 16, 2, 64, [2047, 1300], [5, 0]),
          'hd32': (2, 6, 8, 3, 32, [47, 20], [0, 3]),
          'hd128_ps7': (2, 6, 7, 2, 128, [41, 33], [1, 6]),
          'hd20': (2, 4, 5, 2, 20, [19, 4], [0, 2])}


@pytest.mark.parametrize('case', list(DECODE), ids=list(DECODE))
def test_f32_model_within_tol_of_plain_and_jax(case):
    S, pp, ps, H, hd, pos, w = DECODE[case]
    args = _case(S, pp, ps, H, hd, pos, w, 61)
    scale = hd ** -0.5
    got = _model(*args, scale)
    assert _rel(got, paged_flash_decode_plain(*args, scale)) <= TOL
    q, kp, vp, table, p, wv = (jnp.asarray(x.numpy()) for x in args)
    jax_out = torch.from_numpy(np.array(JPK.paged_flash_decode(
        q, kp, vp, table, p, wv, scale)))
    assert _rel(got, jax_out) <= TOL


@pytest.mark.parametrize('case', ['smoke_pages', 'T2048', 'hd32',
                                  'hd128_ps7', 'hd20'])
def test_bf16_rounding_points_within_bf16_rel_of_plain(case):
    S, pp, ps, H, hd, pos, w = DECODE[case]
    args = _case(S, pp, ps, H, hd, pos, w, 63, dtype=torch.bfloat16)
    got = _model(*args, hd ** -0.5)
    assert got.dtype == torch.bfloat16
    assert _rel(got, paged_flash_decode_plain(*args, hd ** -0.5)) \
        <= BF16_REL


def _repaged(k, v, ps, seed):
    """Slot rows k, v (S, T, H, hd) laid into a pool of page size ps under
    a shuffled table."""
    S, T = k.shape[:2]
    pp = T // ps
    perm = np.random.RandomState(seed).permutation(S * pp) + 1
    table = perm.reshape(S, pp).astype(np.int32)
    kp = torch.zeros(S * pp + 1, ps, *k.shape[2:], dtype=k.dtype)
    vp = torch.zeros_like(kp)
    for s in range(S):
        for lp in range(pp):
            kp[table[s, lp]] = k[s, lp * ps:(lp + 1) * ps]
            vp[table[s, lp]] = v[s, lp * ps:(lp + 1) * ps]
    return kp, vp, torch.from_numpy(table)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_model_ignores_page_size_and_table(dtype):
    g = np.random.RandomState(65)
    S, T, H, hd = 2, 96, 3, 64
    k, v = (torch.from_numpy(g.randn(S, T, H, hd).astype(np.float32))
            .to(dtype) for _ in range(2))
    q = torch.from_numpy(g.randn(S, H, hd).astype(np.float32)).to(dtype)
    pos = torch.tensor([95, 40], dtype=torch.int32)
    w = torch.tensor([3, 0], dtype=torch.int32)
    outs = [_model(q, *_repaged(k, v, ps, ps), pos, w, 0.125)
            for ps in (4, 16, 48)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    if dtype == torch.bfloat16:
        return
    # the same model with the denominator summed page by page: its f32
    # bits move with the page size (bf16's rounding of the output can
    # hide that)
    paged = [_model(q, *_repaged(k, v, ps, ps), pos, w, 0.125,
                    page_order=True) for ps in (4, 16, 48)]
    assert not (torch.equal(paged[0], paged[1])
                and torch.equal(paged[0], paged[2]))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_verify_query_k_is_bitwise_the_decode_step(dtype):
    q, kp, vp, table, pos, w = _case(3, 5, 8, 2, 64, [5, 14, 33],
                                     [0, 2, 1], 67, K=4, dtype=dtype)
    win = _model(q, kp, vp, table, pos, w, 0.125)
    assert _rel(win, paged_flash_verify_plain(q, kp, vp, table, pos, w,
                                              0.125)) \
        <= (TOL if dtype == torch.float32 else BF16_REL)
    for k in range(4):
        step = _model(q[:, k], kp, vp, table, pos + k, w, 0.125)
        assert torch.equal(step, win[:, k]), k


def test_page_quotient_by_multiply_and_shift():
    g = np.random.RandomState(69)
    ts = np.concatenate([np.arange(4096), g.randint(0, 2 ** 31, 20000),
                         [2 ** 31 - 1, 2 ** 31 - 2]])
    for d in list(range(1, 70)) + [127, 128, 1000, 4096, 65535, 2 ** 20 + 3]:
        got = [_quot(int(t), d) for t in ts]
        assert got == [int(t) // d for t in ts], d
