"""The int8 GEMM's design on Hopper's s8 tensor cores
(``ops/csrc/int8_gemm.cu``), modelled in numpy on the CPU before any card
time.

The model packs ragged ``a`` and ``b`` into the kernel's shared-memory
stages exactly as its loaders do, reads every lane's fragment registers
as the kernel reads them, multiplies per lane through the PTX ISA's
``mma.m16n8k32`` s8 fragment layouts, and reassembles ``c``:

* ``_splits`` is ``int8_gemm_splits`` (int8_gemm.cu:346-355): the power
  of two S <= 8, <= half the 64-deep tiles, that first gives >= 132
  blocks; ``_gemm`` cuts the tiles into S ranges of ``ceil(tiles / S)``
  (:389, :211-213) and block r of a tile's cluster sums rows
  [r 64 / S, (r + 1) 64 / S) of the S partials in rank order (:293-342);
* ``_load_stage`` is ``load_stage`` (:152-187): two 16-byte chunks of a
  and of b per thread, zero outside, a's chunks at ``a_off`` and b's at
  ``b_off`` (:85-95), the 16-byte path and the byte path
  (``copy16_bytes``, :118-125);
* ``_block`` is the main loop and the partial tile (:231-291):
  ``ldmatrix.x4`` A fragments, b's words of 4 k-rows at 4 columns
  regrouped by ``transpose4x4``'s eight ``prmt``s (:129-139), product j
  of a warp reading column g as the warp's column 4 g + j, and the
  accumulator written back through that map;
* ``_mma`` is the hardware: A (16 x 32), B (32 x 8) and C (16 x 8)
  placed per lane as the PTX ISA's ``m16n8k32`` ``.s8`` figures give
  them (a_i: row g + 8 [4 <= i < 8 or i >= 12], k 4 t + (i & 3) + 16
  [i >= 8]; b_i: k 4 t + (i & 3) + 16 [i >= 4], column g; c_i: row g + 8
  [i >= 2], column 2 t + (i & 1); g = lane / 4, t = lane % 4).

Each case must equal ``a @ b`` exactly, and the JAX package's
``pallas_int8_matmul`` (interpret mode) on the same numpy-seeded
operands; the same model without the byte regroup must miss.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cxxnet_tpu.ops import pallas_kernels as JPK
import torch

from cxxnet_tpu_torch.ops.kernels import int8_matmul_plain

pytestmark = pytest.mark.torch_port

BM = BN = BK = 64
THREADS = 128
MAX_SPLITS, TARGET_BLOCKS = 8, 132
CS = BN + 4
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _splits(m, n, k):
    tiles = -(-m // BM) * -(-n // BN)
    ktiles = -(-k // BK)
    s = 1
    while s < MAX_SPLITS and 2 * s <= ktiles and tiles * s < TARGET_BLOCKS:
        s *= 2
    return s


def _a_off(row, c):
    return row * BK + ((c ^ ((row >> 1) & 3)) << 4)


def _b_off(kr, c):
    return (kr >> 1) * 128 + (((((kr & 1) << 2) | c)
                                ^ (((kr >> 2) & 3) << 1)) << 4)


def _chunk(src, r, c0, nrows, ncols, vec):
    """16 bytes of ``src`` at row r from column c0, zero outside: the
    16-byte copy (all or nothing: ``vec`` needs ncols % 16 == 0) or the
    byte path."""
    out = np.zeros(16, np.uint8)
    if r >= nrows or c0 >= ncols:
        return out
    avail = 16 if vec else min(16, ncols - c0)
    out[:avail] = src[r, c0:c0 + avail].view(np.uint8)
    return out


def _load_stage(a, b, m0, n0, k0, va, vb):
    """One stage of the ring: (a's 4096 bytes, b's 4096 bytes)."""
    m, k = a.shape
    n = b.shape[1]
    As = np.full(BM * BK, 0xAA, np.uint8)   # every byte must be written
    Bs = np.full(BK * BN, 0xAA, np.uint8)
    for tid in range(THREADS):
        for j in range(2):
            i = tid + THREADS * j
            row, c = i >> 2, i & 3
            off = _a_off(row, c)
            As[off:off + 16] = _chunk(a, m0 + row, k0 + 16 * c, m, k, va)
            kr = i >> 2
            off = _b_off(kr, c)
            Bs[off:off + 16] = _chunk(b, k0 + kr, n0 + 16 * c, k, n, vb)
    return As, Bs


def _u32(buf, off):
    off = np.asarray(off)
    return sum(buf[off + i].astype(np.uint64) << np.uint64(8 * i)
               for i in range(4))


def _byte(x, i):
    return ((x >> np.uint64(8 * i)) & np.uint64(0xff)).astype(
        np.uint8).view(np.int8).astype(np.int64)


def _byte_perm(x, y, sel):
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xff) for i in range(4)] + \
          [(y >> np.uint64(8 * i)) & np.uint64(0xff) for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << np.uint64(8 * i)
               for i in range(4))


def _transpose4x4(w):
    t0 = _byte_perm(w[0], w[1], 0x5140)
    t1 = _byte_perm(w[0], w[1], 0x7362)
    t2 = _byte_perm(w[2], w[3], 0x5140)
    t3 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _ldmatrix_x4(buf, addr):
    """Lane L names row L & 7 of matrix L >> 3 (``addr``); matrix q's
    register in lane L is row L >> 2's bytes 4 (L & 3) .. + 3."""
    return [_u32(buf, addr[8 * q + (LANE >> 2)] + 4 * (LANE & 3))
            for q in range(4)]


def _mma(d, a, b):
    """``mma.m16n8k32.row.col.s32.s8.s8.s32``: d (32, 4) += A @ B with
    each lane's registers placed by the PTX ISA's fragment layouts."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(16):
        row = G + (8 if (4 <= i < 8 or i >= 12) else 0)
        col = 4 * T + (i & 3) + (16 if i >= 8 else 0)
        A[row, col] = _byte(a[i // 4], i % 4)
    for i in range(8):
        B[4 * T + (i & 3) + (16 if i >= 4 else 0), G] = _byte(b[i // 4],
                                                             i % 4)
    D = A @ B
    for i in range(4):
        d[:, i] += D[G + 8 * (i >> 1), 2 * T + (i & 1)]


def _block(a, b, m0, n0, s, tps, va, vb, regroup=True):
    """Split s of the output tile at (m0, n0): its 64 x 64 partial as the
    kernel leaves it in shared memory (rows and columns in tile order)."""
    ktiles = -(-a.shape[1] // BK)
    kt0 = s * tps
    nt = max(min(ktiles, kt0 + tps) - kt0, 0)
    acc = np.zeros((4, 2, 4, 32, 4), np.int64)
    for it in range(nt):
        As, Bs = _load_stage(a, b, m0, n0, (kt0 + it) * BK, va, vb)
        for warp in range(4):
            wm, wn = warp & 1, warp >> 1
            for kk in range(BK // 32):
                q = LANE >> 3
                af = []
                for i in range(2):
                    row = 32 * wm + 16 * i + ((q & 1) << 3) + (LANE & 7)
                    af.append(_ldmatrix_x4(As, _a_off(row, 2 * kk + (q >> 1))))
                bf = []
                for h in range(2):
                    w = [_u32(Bs, _b_off(32 * kk + 16 * h + 4 * T + r,
                                         2 * wn + (G >> 2)) + 4 * (G & 3))
                         for r in range(4)]
                    bf.append(_transpose4x4(w) if regroup else w)
                for i in range(2):
                    for j in range(4):
                        _mma(acc[warp, i, j], af[i], (bf[0][j], bf[1][j]))
    part = np.zeros((BM, CS), np.int64)
    written = np.zeros((BM, CS), np.int64)
    for warp in range(4):
        wm, wn = warp & 1, warp >> 1
        for i in range(2):
            for j in range(4):
                for e in range(4):
                    row = 32 * wm + 16 * i + G + 8 * (e >> 1)
                    col = 32 * wn + 4 * (2 * T + (e & 1)) + j
                    part[row, col] = acc[warp, i, j, :, e]
                    written[row, col] += 1
    assert (written[:, :BN] == 1).all()
    return part


def _gemm(a, b, va=None, vb=None, regroup=True):
    m, k = a.shape
    n = b.shape[1]
    va = k % 16 == 0 if va is None else va
    vb = n % 16 == 0 if vb is None else vb
    S = _splits(m, n, k)
    tps = -(-(-(-k // BK)) // S)
    c = np.zeros((m, n), np.int64)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            parts = [_block(a, b, m0, n0, s, tps, va, vb, regroup)
                     for s in range(S)]
            rows = BM // S
            for s in range(S):   # rank s adds rows [s rows, (s + 1) rows)
                for row in range(s * rows, (s + 1) * rows):
                    if m0 + row >= m:
                        continue
                    tot = parts[0][row, :BN].copy()
                    for r in range(1, S):
                        tot += parts[r][row, :BN]
                    cols = min(BN, n - n0)
                    c[m0 + row, n0:n0 + cols] = tot[:cols]
    return c


def _operands(m, k, n, seed):
    g = np.random.RandomState(seed)
    return (g.randint(-127, 128, (m, k)).astype(np.int8),
            g.randint(-127, 128, (k, n)).astype(np.int8))


#: (m, k, n): the decode step's 64 rows and prefill's 128, 8 and 1; k
#: below one tile, not a multiple of 16, of the tile or of the split
#: (an empty last split); n ragged and below one column group
CASES = {'m1_k300_n70': (1, 300, 70),       # S 4 over 5 tiles: split 3 empty
         'm8_k200_n130': (8, 200, 130),     # S 4, n ragged: the byte path
         'm64_k1024_n64': (64, 1024, 64),   # the decode step's depth, S 8
         'm128_k96_n48': (128, 96, 48),     # prefill's 128 rows, S 2
         'm64_k40_n33': (64, 40, 33),       # k below one tile: S 1
         'm70_k129_n17': (70, 129, 17)}     # two m tiles, every edge ragged


def test_splits_follow_the_kernels_rule():
    assert [_splits(64, n, k) for k, n in ((1024, 1024), (1024, 4096),
                                            (4096, 1024), (1024, 32768))] \
        == [8, 4, 8, 1]
    assert [_splits(128, 1024, 1024), _splits(8, 1024, 4096),
            _splits(1, 32768, 1024)] == [8, 8, 1]
    assert _splits(3, 5, 40) == 1 and _splits(1, 70, 300) == 4


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_model_equals_a_at_b_and_jax(case):
    m, k, n = CASES[case]
    a, b = _operands(m, k, n, sum(CASES[case]))
    got = _gemm(a, b)
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(JPK.pallas_int8_matmul(jnp.asarray(a),
                                               jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, int8_matmul_plain(torch.from_numpy(a),
                               torch.from_numpy(b)).numpy())


@pytest.mark.parametrize('va,vb', [(False, False), (True, False),
                                   (False, True)])
def test_byte_path_stages_what_the_16_byte_path_stages(va, vb):
    m, k, n = 64, 192, 96
    a, b = _operands(m, k, n, 5)
    for k0 in (0, 128):
        want = _load_stage(a, b, 0, 64, k0, True, True)
        got = _load_stage(a, b, 0, 64, k0, va, vb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_gemm(a, b, va, vb),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_swizzles_are_bijective_and_conflict_free():
    # every byte of a stage written once, and each warp-wide read of A
    # (ldmatrix: 8 rows of 16 bytes a phase) and of B (32 words) on 32
    # distinct banks
    a_offs = sorted(_a_off(r, c) for r in range(BM) for c in range(4))
    b_offs = sorted(_b_off(r, c) for r in range(BK) for c in range(4))
    assert a_offs == b_offs == list(range(0, BM * BK, 16))
    for kk in range(2):
        for i in range(2):
            for q in range(4):
                rows = 16 * i + ((q & 1) << 3) + np.arange(8)
                banks = {(_a_off(r, 2 * kk + (q >> 1)) // 4 + w) % 32
                         for r in rows for w in range(4)}
                assert len(banks) == 32
        for wn in range(2):
            for h in range(2):
                for r in range(4):
                    words = (_b_off(32 * kk + 16 * h + 4 * T + r,
                                    2 * wn + (G >> 2)) + 4 * (G & 3)) // 4
                    assert len(set(words % 32)) == 32


def test_model_without_the_byte_regroup_misses():
    a, b = _operands(64, 64, 64, 9)
    got = _gemm(a, b, regroup=False)
    assert not np.array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
