"""The bf16 builds of the fullc backward GEMMs on Hopper's wgmma
(``ops/csrc/fullc_gemm_nt_bf16.cu``, ``ops/csrc/fullc_gemm_tn_bf16.cu`` on
``gemm_wgmma.cuh``), modelled in numpy on the CPU before any card time.

The model stages each slice into a shared-memory image exactly as the
kernels' loader (``gw_stage``) does, encodes each wgmma's descriptors as
the kernels do (``gw_desc_k``, ``gw_desc_mn``), and reads every operand
of every wgmma back out of the image through the descriptor, K-major or,
for the weight gradient's batch-major operands, through the transpose
bits:

* the 128-byte swizzle layout (``gw_off``): atoms of ROWS rows x 64
  columns, 128 bytes a row, the 16-byte chunk c / 8 % 8 of row r at
  chunk (c / 8 % 8) ^ (r % 8).  A descriptor holds the start address,
  the leading and stride offsets (each / 16) and the layout type (bits
  62-63; 1 = 128-byte swizzle).  The card reads element (i, kk) of a
  K-major operand at start + (i / 8) SBO + 128 (i % 8) + 2 kk and of an
  MN-major one at start + (i / 64) LBO + (kk / 8) SBO + 128 (kk % 8) + 2
  (i % 64), each address with its bits 4-6 xor-ed with bits 7-9 (the
  canonical layouts of the PTX ISA's wgmma descriptors);
* the input gradient (NT): 128 x BN tiles of two warpgroups (BN one of
  the widths ``nb_plan`` picks from), 64-deep slices through the ring,
  copies NB_STAGES - 2 slices ahead, the S ranges of a tile pushed as
  f32 rows into their owner's ring (rank r owns rows [r 128 / S, (r + 1)
  128 / S), sender z in slot z) and summed there in rank order, then one
  rounding;
* the weight gradient (TN): 128 x 256 tiles walked by a persistent grid
  (tile blockIdx.x, then + gridDim.x, ...), 32-deep batch slices of both
  operands as one stream across a block's tiles through the ring, copies
  TB_STAGES - 2 slices ahead, one rounding a tile.

The tile sizes, slice depths, ring depths, copy distances and tile
widths are read from the sources.  Each case is held within one bf16
step of the JAX package's ``_matmul_nt_impl`` / ``_matmul_tn_impl``
(interpret mode) on the same numpy-seeded operands at small ragged
shapes, and of the product in float64; the same model with the
descriptors' offsets swapped must miss.  At the AlexNet, GoogLeNet and
ragged shapes every plan the input gradient may take, and the weight
gradient's walk, cover every output element exactly once, and no
slice's copy lands in a buffer that a wgmma still reads.  Which plan the
card picks is asserted on the card (``tests/test_torch_cuda.py``).
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp

from cxxnet_tpu.ops import pallas_kernels as jpk

pytestmark = pytest.mark.torch_port

BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'cxxnet_tpu_torch', 'ops', 'csrc')


def _consts(fn, *names):
    """The values of ``constexpr int`` names in a source, in order; each
    may be written in terms of those before it."""
    with open(os.path.join(CSRC, fn)) as f:
        src = f.read()
    got = {}
    for name in names:
        m = re.findall(r'\b' + name + r' = ([\w +\-*/]+?)\s*[,;]', src)
        assert len(m) == 1, (fn, name)
        got[name] = int(eval(m[0], {}, dict(got)))
    return [got[n] for n in names]


NB_BM, NB_BK, NB_STAGES, NB_AHEAD, NB_MAX_SPLITS = _consts(
    'fullc_gemm_nt_bf16.cu', 'NB_BM', 'NB_BK', 'NB_STAGES', 'NB_AHEAD',
    'NB_MAX_SPLITS')
with open(os.path.join(CSRC, 'fullc_gemm_nt_bf16.cu')) as _f:
    _NB_SRC = _f.read()
# the tile widths nb_plan picks from, and a pushed partial's row padding
NB_WIDTHS = tuple(int(w) for w in re.search(
    r'for \(int bn : \{([\d, ]+)\}\)', _NB_SRC).group(1).split(','))
NB_LD_PAD = int(re.search(r'int LD = BN \+ (\d+);', _NB_SRC).group(1))
TB_BM, TB_BN, TB_BK, TB_STAGES, TB_AHEAD = _consts(
    'fullc_gemm_tn_bf16.cu', 'TB_BM', 'TB_BN', 'TB_BK', 'TB_STAGES',
    'TB_AHEAD')


def _bf(a):
    """f32 -> the nearest bf16 values (ties to even), as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _np(seed, shape, scale=1.0):
    return _bf(np.random.RandomState(seed).randn(*shape) * scale)


def _excess(got, ref):
    """max |got - ref| / (2^-7 |ref| + 1e-3 mean |ref|): <= 1 within one
    bf16 step everywhere."""
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    lim = BF16_STEP * np.abs(r) + BF16_FLOOR * np.abs(r).mean() + 1e-30
    return float((np.abs(g - r) / lim).max())


# --- shared memory, descriptors, wgmma ----------------------------------------

def gw_off(r, c, rows):
    """``gw_off``: the byte offset of (r, c) in a staged tile of ``rows``
    rows."""
    return ((((c >> 6) * rows + r) << 7) + ((((c >> 3) ^ r) & 7) << 4)
            + ((c & 7) << 1))


def stage(img, base, src, ld, r0, rlim, c0, clim, rows, cols, vec,
          threads=256):
    """``gw_stage``: rows [r0, r0 + rows) x columns [c0, c0 + cols) of the
    row-major ``src`` (flat, ``ld`` a row) into the f32 image ``img``
    (element index = byte offset / 2) at byte ``base``, zero outside
    rows < rlim and columns < clim.  Returns the bytes each thread wrote,
    by thread."""
    wrote = {}
    ch = cols // 8
    if vec:
        for j in range(-(-rows * ch // threads)):
            for t in range(threads):
                i = t + j * threads
                if i >= rows * ch:
                    break
                r, c = i // ch, 8 * (i % ch)
                ok = r0 + r < rlim and c0 + c < clim
                off = base + gw_off(r, c, rows)
                vals = (src[(r0 + r) * ld + c0 + c:(r0 + r) * ld + c0 + c + 8]
                        if ok else np.zeros(8, np.float32))
                img[off // 2:off // 2 + 8] = vals
                wrote.setdefault(t, []).extend(range(off, off + 16))
    else:
        for i in range(rows * cols):
            r, c = i // cols, i % cols
            off = base + gw_off(r, c, rows)
            ok = r0 + r < rlim and c0 + c < clim
            img[off // 2] = src[(r0 + r) * ld + c0 + c] if ok else 0.0
            wrote.setdefault(i % threads, []).extend((off, off + 1))
    return wrote


def fw_desc(addr, lead, stride):
    return (((addr & 0x3FFFF) >> 4) | (((lead >> 4) & 0x3FFF) << 16)
            | (((stride >> 4) & 0x3FFF) << 32))


GW_KSTEP_K, GW_KSTEP_MN = 2, 128


def desc_k(addr):
    """``gw_desc_k``."""
    return fw_desc(addr, 16, 1024) | (1 << 62)


def desc_mn(addr, rows):
    """``gw_desc_mn``."""
    return fw_desc(addr, rows * 128, 1024) | (1 << 62)


def read_operand(img, desc, mn, trans):
    """The ``mn`` x 16 operand a wgmma reads through ``desc`` (K-major, or
    MN-major where ``trans``): element (i, kk)."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lead = ((desc >> 16) & 0x3FFF) << 4
    stride = ((desc >> 32) & 0x3FFF) << 4
    i = np.arange(mn)[:, None]
    kk = np.arange(16)[None, :]
    if trans:
        off = start + (i >> 6) * lead + (kk >> 3) * stride \
            + 128 * (kk & 7) + 2 * (i & 63)
    else:
        off = start + (i >> 3) * stride + 128 * (i & 7) + 2 * kk
    off = off ^ (((off >> 7) & 7) << 4)
    assert (off % 2 == 0).all()
    # (a wrong descriptor may point past the ring: it reads some other
    # shared memory, here the ring's start again)
    return img[off // 2 % img.size]


def wgmma(acc, img, da, db, n, ta, tb):
    """acc (64 x n) += a (64 x 16) b (16 x n): products of bf16 values,
    exact in f32, summed in f32."""
    a = read_operand(img, da, 64, ta)
    b = read_operand(img, db, n, tb)
    acc += (a.astype(np.float32) @ b.T.astype(np.float32)).astype(np.float32)


# --- the input gradient -------------------------------------------------------

def copy_ahead_ok(q, total, stages, ahead):
    """At iteration ``q`` of a ring of ``stages`` buffers that copies
    slice q + ``ahead`` before its products on slice q: the buffer copied
    into is neither read now nor by the wgmma group still in flight
    (slice q - 1)."""
    return q + ahead >= total or (q + ahead) % stages not in (
        q % stages, (q - 1) % stages)


def nt_ranges(n, splits):
    """The slices a contraction range and the cluster size the entry
    launches for ``splits`` ranges over a contraction of ``n``."""
    slices = max(-(-n // NB_BK), 1)
    per = -(-slices // splits)
    return per, -(-slices // per)


def nt_plans(n):
    """Every (tile width, S) the plan may pick for a contraction of
    ``n``: S <= 8 non-empty ranges."""
    slices = -(-n // NB_BK)
    return [(bn, S) for bn in NB_WIDTHS
            for S in range(1, min(NB_MAX_SPLITS, slices) + 1)
            if nt_ranges(n, S)[1] == S]


def nt_owner(row, S):
    """The rank that owns a tile row (the kernel's ((row + 1) S - 1) /
    128)."""
    return ((row + 1) * S - 1) // NB_BM


def nt_model(g, b, splits, bn, swap=False):
    """c = g @ b^T as fullc_gemm_nt_bf16.cu computes it on its 128 x bn
    tile, block by block, its ring and the pushes into the owners' rings
    included."""
    m, n = g.shape
    k = b.shape[0]
    per, S = nt_ranges(n, splits)
    vec = n % 8 == 0
    gf, bf = g.reshape(-1), b.reshape(-1)
    c = np.full((m, k), np.nan, np.float32)
    a_bytes = NB_BM * NB_BK * 2
    stage_bytes = (NB_BM + bn) * NB_BK * 2
    ring = NB_STAGES * stage_bytes // 4          # floats
    ld = bn + NB_LD_PAD
    slot = -(-NB_BM // S) * ld                   # floats a sender's slot
    for mt in range(-(-m // NB_BM)):
        for kt in range(-(-k // bn)):
            m0, k0 = mt * NB_BM, kt * bn
            recv = [np.full(ring, np.nan, np.float32) for _ in range(S)]
            for s in range(S):
                nbeg = s * per * NB_BK
                nend = min(n, nbeg + per * NB_BK)
                nk = -(-(nend - nbeg) // NB_BK) if nend > nbeg else 0
                img = np.zeros(NB_STAGES * stage_bytes // 2, np.float32)
                held = [None] * NB_STAGES    # the slice each buffer holds

                def issue(j):
                    sa = (j % NB_STAGES) * stage_bytes
                    n0 = nbeg + j * NB_BK
                    stage(img, sa, gf, n, m0, m, n0, nend, NB_BM, NB_BK, vec)
                    stage(img, sa + a_bytes, bf, n, k0, k, n0, nend, bn,
                          NB_BK, vec)
                    held[j % NB_STAGES] = j

                for j in range(min(NB_AHEAD, nk)):
                    issue(j)
                acc = [np.zeros((64, bn), np.float32) for _ in range(2)]
                for j in range(nk):
                    assert held[j % NB_STAGES] == j
                    assert copy_ahead_ok(j, nk, NB_STAGES, NB_AHEAD)
                    if j + NB_AHEAD < nk:
                        issue(j + NB_AHEAD)
                    sa = (j % NB_STAGES) * stage_bytes
                    for grp in range(2):
                        da = desc_k(sa + grp * 64 * NB_BK * 2)
                        db = desc_k(sa + a_bytes)
                        ks = GW_KSTEP_K
                        if swap:    # the stride offset halved
                            da = (da & ~(0x3FFF << 32)) | (
                                ((da >> 33) & 0x3FFF) << 32)
                        for kk in range(NB_BK // 16):
                            wgmma(acc[grp], img, da + kk * ks, db + kk * ks,
                                  bn, 0, 0)
                # row by row into the owner's ring, slot s
                part = np.concatenate(acc)
                for row in range(NB_BM):
                    r = nt_owner(row, S)
                    off = s * slot + (row - r * NB_BM // S) * ld
                    assert off + bn <= ring, 'a push past the ring'
                    assert np.isnan(recv[r][off:off + bn]).all(), 'overlap'
                    recv[r][off:off + bn] = part[row]
            # owner r sums its rows' S slots in rank order, rounds once
            for r in range(S):
                rb, re_ = r * NB_BM // S, (r + 1) * NB_BM // S
                at = np.arange(re_ - rb)[:, None] * ld + np.arange(bn)
                tot = recv[r][at].copy()
                for z in range(1, S):
                    tot += recv[r][z * slot + at]
                rows = slice(m0 + rb, min(m0 + re_, m))
                cols = slice(k0, min(k0 + bn, k))
                nr, nc = rows.stop - rows.start, cols.stop - cols.start
                if nr > 0 and nc > 0:
                    assert np.isnan(c[rows, cols]).all(), 'written twice'
                    c[rows, cols] = _bf(tot[:nr, :nc])
    assert not np.isnan(c).any(), 'an output never written'
    return c


# --- the weight gradient ------------------------------------------------------

def tn_walk(m, n, k, sms):
    """Each block's tiles (blockIdx.x, + gridDim.x, ...) and its slice
    stream: [(block, [(tile, k0, n0)], slices a tile)]."""
    tiles_n = -(-n // TB_BN)
    tiles = -(-k // TB_BM) * tiles_n
    grid = min(tiles, sms)
    nk = -(-m // TB_BK) if m > 0 else 1
    return [(blk, [(t, t // tiles_n * TB_BM, t % tiles_n * TB_BN)
                   for t in range(blk, tiles, grid)], nk)
            for blk in range(grid)]


def tn_model(a, g, sms, swap=False):
    """c = a^T @ g as fullc_gemm_tn_bf16.cu computes it, block by block,
    its ring included."""
    m, k = a.shape
    n = g.shape[1]
    vec = k % 8 == 0 and n % 8 == 0
    af, gf = a.reshape(-1), g.reshape(-1)
    c = np.full((k, n), np.nan, np.float32)
    a_bytes = TB_BK * TB_BM * 2
    stage_bytes = TB_BK * (TB_BM + TB_BN) * 2
    for blk, mine, nk in tn_walk(m, n, k, sms):
        total = len(mine) * nk
        img = np.zeros(TB_STAGES * stage_bytes // 2, np.float32)
        held = [None] * TB_STAGES      # the slice each buffer holds

        def issue(q):
            tile, k0, n0 = mine[q // nk]
            mb = q % nk * TB_BK
            sa = (q % TB_STAGES) * stage_bytes
            stage(img, sa, af, k, mb, m, k0, k, TB_BK, TB_BM, vec)
            stage(img, sa + a_bytes, gf, n, mb, m, n0, n, TB_BK, TB_BN, vec)
            held[q % TB_STAGES] = q

        for q in range(min(TB_AHEAD, total)):
            issue(q)
        q = 0
        for tile, k0, n0 in mine:
            acc = [np.zeros((64, TB_BN), np.float32) for _ in range(2)]
            for j in range(nk):
                assert held[q % TB_STAGES] == q
                assert copy_ahead_ok(q, total, TB_STAGES, TB_AHEAD)
                if q + TB_AHEAD < total:
                    issue(q + TB_AHEAD)
                sa = (q % TB_STAGES) * stage_bytes
                for grp in range(2):
                    da = desc_mn(sa + grp * TB_BK * 128, TB_BK)
                    db = desc_mn(sa + a_bytes, TB_BK)
                    ka = kb = GW_KSTEP_MN
                    if swap:    # the leading and stride offsets swapped
                        da, db = (
                            (d & ~((0x3FFF << 16) | (0x3FFF << 32)))
                            | (((d >> 32) & 0x3FFF) << 16)
                            | (((d >> 16) & 0x3FFF) << 32) for d in (da, db))
                    for kk in range(TB_BK // 16):
                        wgmma(acc[grp], img, da + kk * ka, db + kk * kb,
                              TB_BN, 1, 1)
                q += 1
            tot = _bf(np.concatenate(acc))
            rows = slice(k0, min(k0 + TB_BM, k))
            cols = slice(n0, min(n0 + TB_BN, n))
            nr, nc = rows.stop - rows.start, cols.stop - cols.start
            assert np.isnan(c[rows, cols]).all(), 'written twice'
            c[rows, cols] = tot[:nr, :nc]
    assert not np.isnan(c).any(), 'an output never written'
    return c


# --- the cases ----------------------------------------------------------------

@pytest.mark.parametrize('m,n,k,splits,bn', [
    (70, 333, 129, 1, 144), (70, 333, 129, 3, 128), (37, 16, 65, 1, 128),
    (130, 256, 200, 2, 144), (1, 136, 24, 1, 128), (40, 64, 300, 1, 144)],
    ids=['ragged', 'ragged_s3', 'ragged_small', 'two_m_tiles_s2', 'm1',
         'tile144'])
def test_nt_model_matches_pallas_interpret(m, n, k, splits, bn):
    """The input gradient's staging, K-major descriptors, wgmma reads,
    cluster sum in rank order and one rounding, on either tile: within
    one bf16 step of ``_matmul_nt_impl`` (interpret) and of the float64
    product."""
    g, b = _np(50, (m, n)), _np(51, (k, n), n ** -0.5)
    got = nt_model(g, b, splits, bn)
    ref = np.asarray(jpk._matmul_nt_impl(
        jnp.asarray(g).astype(jnp.bfloat16),
        jnp.asarray(b).astype(jnp.bfloat16)).astype(jnp.float32))
    assert _excess(got, ref) <= 1.0
    assert _excess(got, g.astype(np.float64) @ b.T.astype(np.float64)) <= 1.0


@pytest.mark.parametrize('m,n,k,sms', [
    (70, 333, 129, 1), (37, 16, 65, 2), (40, 264, 136, 3), (1, 24, 8, 1)],
    ids=['ragged', 'ragged_small', 'walk_tail', 'm1'])
def test_tn_model_matches_pallas_interpret(m, n, k, sms):
    """The weight gradient's batch-major staging, transposed descriptors,
    persistent walk, ring and one rounding: within one bf16 step of
    ``_matmul_tn_impl`` (interpret) and of the float64 product."""
    a, g = _np(52, (m, k)), _np(53, (m, n))
    got = tn_model(a, g, sms)
    ref = np.asarray(jpk._matmul_tn_impl(
        jnp.asarray(a).astype(jnp.bfloat16),
        jnp.asarray(g).astype(jnp.bfloat16)).astype(jnp.float32))
    assert _excess(got, ref) <= 1.0
    assert _excess(got, a.T.astype(np.float64) @ g.astype(np.float64)) <= 1.0


def test_models_miss_with_swapped_offsets():
    """The check has teeth: with the leading and stride offsets swapped
    the wgmma reads other elements, and the models miss."""
    a, g = _np(54, (40, 24)), _np(55, (40, 40))
    ref = a.T.astype(np.float64) @ g.astype(np.float64)
    assert _excess(tn_model(a, g, 1, swap=True), ref) > 1.0
    b = _np(56, (48, 64))
    g2 = _np(57, (64, 64))
    assert _excess(nt_model(g2, b, 1, 128, swap=True),
                   g2.astype(np.float64) @ b.T.astype(np.float64)) > 1.0


@pytest.mark.parametrize('rows,cols,vec', [
    (128, 64, True), (144, 64, False), (144, 64, True), (32, 128, True),
    (32, 256, True), (16, 64, False)])
def test_stage_writes_each_byte_once(rows, cols, vec):
    """``gw_stage`` fills the tile exactly once; a warp's 16-byte copies
    read whole 128-byte lines of one row, and every 8 lanes write eight
    different 16-byte bank groups."""
    img = np.zeros(rows * cols, np.float32)
    src = np.arange(rows * cols, dtype=np.float32)
    wrote = stage(img, 0, src, cols, 0, rows, 0, cols, rows, cols, vec)
    every = sorted(b for t in wrote.values() for b in t)
    assert every == list(range(rows * cols * 2))
    r, c = np.divmod(np.arange(rows * cols), cols)
    assert (img[gw_off(r, c, rows) // 2] == src).all()
    if vec:
        for q in range(0, 256, 8):
            first = [wrote[t][0] for t in range(q, q + 8)]
            assert len({b % 128 for b in first}) == 8
            assert len(set(np.arange(q, q + 8) // (cols // 8))) == 1


@pytest.mark.parametrize('m,n,k', [
    (256, 4096, 9216), (256, 4096, 4096), (256, 1000, 4096),
    (128, 1000, 1024), (128, 1024, 2048), (70, 333, 129), (1, 17, 5),
    (64, 4096, 1024)],
    ids=['fc6', 'fc7', 'fc8', 'gn_fc', 'gn_aux_fc', 'ragged', 'tiny',
         'nt_split'])
def test_schedules_cover_each_output_once(m, n, k):
    """At the AlexNet, GoogLeNet and ragged shapes: for every tile width
    and S <= 8 the input gradient's plan may pick, the (tile, range)
    blocks and owners write each element of c once, every range is
    non-empty and its ring never copies into a buffer that a wgmma still
    reads; the weight gradient's persistent walk on 132 SMs visits each
    tile once, and each block's ring never does either."""
    plans = nt_plans(n)
    assert plans
    for bn, S in plans:
        per, _ = nt_ranges(n, S)
        slices = -(-n // NB_BK)
        assert (S - 1) * per < slices
        for s in range(S):
            nk = min(per, slices - s * per)
            assert nk >= 1 and all(copy_ahead_ok(j, nk, NB_STAGES, NB_AHEAD)
                                   for j in range(nk))
        hits = np.zeros((m, k), np.int32)
        for mt in range(-(-m // NB_BM)):
            for kt in range(-(-k // bn)):
                for r in range(S):
                    rb, re_ = r * NB_BM // S, (r + 1) * NB_BM // S
                    rows = slice(mt * NB_BM + rb, min(mt * NB_BM + re_, m))
                    hits[rows, kt * bn:(kt + 1) * bn] += 1
        assert (hits == 1).all(), (bn, S)
        owners = [nt_owner(row, S) for row in range(NB_BM)]
        assert owners == sorted(owners) and set(owners) == set(range(S))

    hits = np.zeros((-(-k // TB_BM), -(-n // TB_BN)), np.int32)
    walk = tn_walk(m, n, k, 132)
    for blk, mine, nk in walk:
        for tile, k0, n0 in mine:
            hits[k0 // TB_BM, n0 // TB_BN] += 1
        total = len(mine) * nk
        assert all(copy_ahead_ok(q, total, TB_STAGES, TB_AHEAD)
                   for q in range(total))
    assert (hits == 1).all()
    assert len(walk) == min(hits.size, 132)


def test_ring_hazard_check_has_teeth():
    """The copy-ahead check fails where it should: a ring two buffers
    deeper than its copy distance passes, one buffer deeper would copy
    into the buffer the wgmma group in flight still reads."""
    assert all(copy_ahead_ok(q, 40, NB_STAGES, NB_AHEAD) for q in range(40))
    assert all(copy_ahead_ok(q, 40, TB_STAGES, TB_AHEAD) for q in range(40))
    assert not copy_ahead_ok(3, 40, NB_AHEAD + 1, NB_AHEAD)
    assert not copy_ahead_ok(3, 40, TB_AHEAD + 1, TB_AHEAD)
