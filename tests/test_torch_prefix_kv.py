"""Prefix sharing, the tiered KV cache and disaggregated prefill of the
port's decode engine (``serve/decode.py``, ``serve/kvcache.py``,
``serve/kvstore.py``, ``models/transformer.prefill_tail_kv``), on the CPU.

Held against the JAX package (same numpy-seeded weights, carried across
with ``interop.lm_params_from_jax``):

* ``prefill_tail_kv``'s rows and logits (the port's walks the whole
  prompt, JAX's the tail over the cached prefix) match JAX's (rtol 1e-4,
  atol 1e-5) for tails of 1, 2 and 8 tokens, at pad widths 0 and 3;
* a spill record is byte for byte JAX's (f32 and bf16), each package
  decodes the other's, a store's record and sidecar files are JAX's, and
  each package adopts the other's records through a share dir;
* ``key_digest`` is JAX's; ``TieredKVCache`` under the same operations
  gives JAX's counters, bytes and LRU order; ``kv_engine_kwargs`` JAX's
  dict (``tests/test_torch_serve_fleet.py``);
* greedy shared streams equal the JAX engine's up to a near-tie, with
  the same prefix counters.

Inside the port (bitwise): the tail's rows and logits are the port's own
``prefill_kv`` rows of the whole prompt (f32, bf16 and int8); shared,
promoted (host and disk, sampled, mid-stream join), adopted and
worker-prefilled streams equal the port's ``generate``; a promoted
record's rows never reach a stream (a page promoted from another bucket
or holding planted rows holds the prompt's own rows); a ``corrupt_kv``
record is quarantined and never reaches a stream; the refcounts, the
index's cap and eviction, the swap and the gauges behave as JAX's tests
of the same names pin them.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from cxxnet_tpu.models import transformer as JT
from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu.serve.decode import DecodeEngine as JDecodeEngine
from cxxnet_tpu.serve.kvcache import TieredKVCache as JTieredKVCache
from cxxnet_tpu.serve.kvstore import KVStore as JKVStore
from cxxnet_tpu.serve.kvstore import decode_record as jdecode_record
from cxxnet_tpu.serve.kvstore import encode_record as jencode_record
from cxxnet_tpu.serve.kvstore import key_digest as jkey_digest
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.interop import lm_params_from_jax
from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.nnet import quantize
from cxxnet_tpu_torch.runtime import faults
from cxxnet_tpu_torch.runtime.faults import (DecodePagesExhaustedError,
                                             DecodeSlotsExhaustedError,
                                             PrefixIndexFullError, ServeError)
from cxxnet_tpu_torch.serve import (DecodeEngine, DecodeService,
                                    DynamicBatcher, KVStore, ServeRequest,
                                    TieredKVCache)
from cxxnet_tpu_torch.serve.decode import _prompt_bucket
from cxxnet_tpu_torch.serve.kvstore import (decode_record, encode_record,
                                            key_digest)
from cxxnet_tpu_torch.utils.metric import StatSet
from cxxnet_tpu_torch.wrapper import LMServe

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, d_model=32, num_heads=4, d_ff=48, num_stages=2,
          seq_len=32, attn='local')
CFG, JCFG = T.TransformerConfig(**KW), JT.TransformerConfig(**KW)
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-3
JPARAMS = jax.tree_util.tree_map(
    np.asarray, JT.init_params(np.random.RandomState(0), JCFG))
PARAMS = lm_params_from_jax(JPARAMS)


def _wait_ok(req, timeout=120):
    assert req.event.wait(timeout), 'request never completed'
    if req.error is not None:
        raise req.error
    return req.result


def _offline(eng, prompt, max_new, temperature=0.0, rng=None):
    return T.generate(eng.params, prompt, max_new, eng.cfg,
                      temperature=temperature, rng=rng,
                      flash=eng.use_flash)[0]


def _assert_twin(got, off):
    got = np.asarray(got)
    assert len(got) >= 1
    np.testing.assert_array_equal(got, off[:len(got)])


def _engine(**kw):
    """The JAX kv-tier suite's engine: 2 slots, 16 pages of 8, a 2-page
    index and a 4 MB host tier."""
    args = dict(slots=2, pages=16, page_size=8, max_prompt=16,
                max_new_bound=16, prefix_share=2, kv_host_mb=4,
                device='cpu')
    args.update(kw)
    return DecodeEngine(PARAMS, CFG, **args)


def _serve(eng, prompt, max_new=6, temp=0.0, rng=None):
    return _wait_ok(eng.submit_direct(prompt, max_new=max_new,
                                      temperature=temp, rng=rng))


def _key(i, nbytes=64):
    """A prefix-index key: (model version, pad width, logical page, exact
    padded token span bytes)."""
    return (0, 0, int(i), bytes([i % 251]) * nbytes)


def _np_rows(seed, shape=(2, 8, 4, 8)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _rows(seed, shape=(2, 8, 4, 8)):
    return tuple(torch.from_numpy(a) for a in _np_rows(seed, shape))


def _prime_and_evict(eng, rng, s0=16, n=2, max_new=6):
    """Serve a prompt A (published), then ``n`` cold prompts that push A's
    pages out of the 2-page index; returns A and its offline stream."""
    a = rng.randint(0, 64, (1, s0)).astype(np.int32)
    off = _offline(eng, a, max_new)
    _assert_twin(_serve(eng, a, max_new), off)
    for _ in range(n):
        f = rng.randint(0, 64, (1, s0)).astype(np.int32)
        _assert_twin(_serve(eng, f, max_new), _offline(eng, f, max_new))
    return a, off


# --- the tail prefill --------------------------------------------------------

@pytest.mark.parametrize('w_pad', [0, 3])
@pytest.mark.parametrize('tail', [1, 2, 8])
def test_tail_prefill_matches_jax_and_own_full_prefill(tail, w_pad):
    rng = np.random.RandomState(7 + tail)
    s0b = 16
    padded = np.pad(rng.randint(0, 64, (1, s0b - w_pad)).astype(np.int32),
                    ((0, 0), (w_pad, 0)))
    t0 = s0b - tail
    jks, jvs, _ = JT.prefill_kv(JPARAMS, padded, np.int32(w_pad), JCFG)
    jt = JT.prefill_tail_kv(JPARAMS, jks[:, :, :t0], jvs[:, :, :t0],
                            padded[:, t0:], np.int32(w_pad), JCFG)
    toks = torch.from_numpy(padded)
    with torch.inference_mode():
        ks, vs, lg = T.prefill_kv(PARAMS, toks, w_pad, CFG)
        got = T.prefill_tail_kv(PARAMS, toks, t0, w_pad, CFG)
    assert got[0].shape == (2, 1, tail, 4, 8)
    for g, want in zip(got, jt):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    # the stream-twin contract: bitwise the rows of the whole prompt
    assert torch.equal(got[0], ks[:, :, t0:])
    assert torch.equal(got[1], vs[:, :, t0:])
    assert torch.equal(got[2], lg)


@pytest.mark.parametrize('tier', ['bf16', 'int8'])
def test_tail_prefill_bitwise_on_the_quantized_tiers(tier):
    cfg = T.TransformerConfig(**dict(KW, dtype=torch.bfloat16))
    params = quantize.quantize_lm_tree(PARAMS, tier,
                                       out_dtype=torch.bfloat16)
    toks = torch.from_numpy(
        np.random.RandomState(3).randint(0, 64, (1, 32)).astype(np.int64))
    with torch.inference_mode():
        ks, vs, lg = T.prefill_kv(params, toks, 0, cfg)
        for t0 in (8, 24, 31):
            got = T.prefill_tail_kv(params, toks, t0, 0, cfg)
            assert torch.equal(got[0], ks[:, :, t0:])
            assert torch.equal(got[1], vs[:, :, t0:])
            assert torch.equal(got[2], lg)


# --- the spill record format against the JAX package -------------------------

def _bf16_pair(seed):
    import ml_dtypes
    hk, hv = _np_rows(seed)
    nk, nv = (a.astype(ml_dtypes.bfloat16) for a in (hk, hv))
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (hk, hv))
    return (nk, nv), (tk, tv)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_record_bytes_equal_jax_and_decode_each_other(dtype):
    if dtype == 'float32':
        (nk, nv), (tk, tv) = _np_rows(5), _rows(5)
    else:
        (nk, nv), (tk, tv) = _bf16_pair(5)
    for key in (_key(3), (7, 5, 2, b'\x01\x02' * 9), ('v9', 0, 0, b'x')):
        blob = encode_record(key, tk, tv)
        assert blob == jencode_record(key, nk, nv)
        jk, jv = jdecode_record(blob, key)
        assert str(jk.dtype) == dtype
        np.testing.assert_array_equal(jk.view(np.uint8), nk.view(np.uint8))
        np.testing.assert_array_equal(jv.view(np.uint8), nv.view(np.uint8))
        rk, rv = decode_record(jencode_record(key, nk, nv), key)
        assert rk.dtype == tk.dtype and torch.equal(rk, tk)
        assert torch.equal(rv, tv)
    # numpy rows in: the same bytes
    if dtype == 'float32':
        assert encode_record(_key(3), nk, nv) == \
            encode_record(_key(3), tk, tv)


@pytest.mark.parametrize('key', [
    (0, 0, 0, b''), (3, 7, 11, bytes(range(64))), ('ckpt', 2, 1, b'ab'),
    (2 ** 40, 0, 5, b'\x00' * 128)])
def test_key_digest_equals_jax(key):
    assert key_digest(key) == jkey_digest(key)


@pytest.mark.parametrize('other', [
    (1, 0, 3, _key(3)[3]), (0, 3, 3, _key(3)[3]), (0, 0, 4, _key(3)[3]),
    _key(4)], ids=['version', 'pad', 'page', 'span'])
def test_record_key_mismatch_rejected(other):
    blob = encode_record(_key(3), *_rows(1))
    with pytest.raises(ValueError, match='key mismatch'):
        decode_record(blob, other)
    with pytest.raises(ValueError, match='key mismatch'):
        jdecode_record(blob, other)


def test_record_truncated_and_bad_magic_rejected():
    blob = encode_record(_key(1), *_rows(2))
    with pytest.raises(ValueError):
        decode_record(blob[:-8], _key(1))
    with pytest.raises(ValueError, match='magic'):
        decode_record(b'JUNK' + blob, _key(1))
    assert key_digest(_key(5)) != key_digest(_key(6))


def test_store_files_equal_jax_and_cross_package_adoption(tmp_path):
    """The same spills through both packages' stores write the same
    record and sidecar bytes under the same names; each package adopts
    the other's records from a shared dir."""
    share = str(tmp_path / 'shared')
    port = KVStore(str(tmp_path / 'p'), 1 << 20, share_dir=share)
    jax_ = JKVStore(str(tmp_path / 'j'), 1 << 20)
    try:
        for i in range(3):
            assert port.spill(_key(i), *_rows(i))
            assert jax_.spill(_key(i), *_np_rows(i))
        assert port.flush(10) and jax_.flush(10)
        names = sorted(os.listdir(tmp_path / 'p'))
        assert names == sorted(os.listdir(tmp_path / 'j'))
        assert len(names) == 6
        for n in names:
            assert (tmp_path / 'p' / n).read_bytes() == \
                (tmp_path / 'j' / n).read_bytes()
        assert port.stats.get('published') == 3
    finally:
        port.close(10)
        jax_.close(10)
    # a JAX replica adopts the port's shared records, and back
    jrep = JKVStore(str(tmp_path / 'j2'), 1 << 20, share_dir=share)
    try:
        jk, jv = jrep.load(_key(1))
        np.testing.assert_array_equal(jk, _np_rows(1)[0])
        assert jrep.stats.get('adopts') == 1
    finally:
        jrep.close(10)
    jshare = str(tmp_path / 'jshared')
    jpub = JKVStore(str(tmp_path / 'j3'), 1 << 20, share_dir=jshare)
    prep = KVStore(str(tmp_path / 'p2'), 1 << 20, share_dir=jshare)
    try:
        jpub.spill(_key(9), *_np_rows(9))
        assert jpub.flush(10)
        rk, rv = prep.load(_key(9))
        assert torch.equal(rv, _rows(9)[1])
        assert prep.stats.get('adopts') == 1
        assert os.path.exists(prep.record_path(_key(9)))
    finally:
        jpub.close(10)
        prep.close(10)


# --- tier 1 against the JAX package ------------------------------------------

def _tier_script(mod_cache, mod_store, rows, root):
    """One sequence of tier operations; returns the counters, bytes and
    LRU order it leaves."""
    per = sum(int(np.prod(r.shape)) * 4 for r in rows(0))
    store = None if root is None else mod_store(root, 1 << 20)
    cache = mod_cache(host_bytes=per * 2, store=store,
                      stats=None if store is None else store.stats)
    try:
        for i in (0, 1, 2, 0, 3):
            cache.demote(_key(i), *rows(i))
        got = [cache.take(_key(i)) is not None for i in (0, 1, 2)]
        ent = cache.take(_key(3))
        cache.put_back(_key(3), *ent)
        cache.demote(_key(4), *rows(4))
        if store is not None:
            assert cache.flush(10)
            got.append(cache.prefetch([_key(1), _key(2), _key(9)]))
            got.append(cache.prefetch([_key(5)]))
        order = [k[2] for k in cache._host]
        counters = {k: cache.stats.get(k) for k in (
            'demote_pages', 'host_evicted', 'promote_pages', 'spills',
            'disk_promote_pages', 'spill_dedup', 'inflight_hits')}
        return got, order, cache.host_bytes(), cache.host_entries(), \
            counters
    finally:
        cache.close(10)


@pytest.mark.parametrize('with_store', [False, True])
def test_tiered_cache_counters_and_lru_equal_jax(with_store, tmp_path):
    got = _tier_script(TieredKVCache, KVStore, _rows,
                       str(tmp_path / 'p') if with_store else None)
    want = _tier_script(JTieredKVCache, JKVStore, _np_rows,
                        str(tmp_path / 'j') if with_store else None)
    assert got == want


def test_host_tier_lru_eviction_order_and_byte_budget():
    per = sum(r.numel() * 4 for r in _rows(0))
    cache = TieredKVCache(host_bytes=per * 2)
    for i in range(3):
        cache.demote(_key(i), *_rows(i))
    assert cache.take(_key(0)) is None
    assert cache.host_entries() == 2 and cache.host_bytes() <= 2 * per
    assert cache.stats.get('demote_pages') == 3
    assert cache.stats.get('host_evicted') == 1
    hk, hv = cache.take(_key(2))
    assert torch.equal(hk, _rows(2)[0]) and torch.equal(hv, _rows(2)[1])
    # a re-demote touches: k1 becomes the victim
    cache.demote(_key(2), *_rows(2))
    cache.demote(_key(1), *_rows(1))
    cache.demote(_key(2), *_rows(2))
    cache.demote(_key(3), *_rows(3))
    assert cache.take(_key(1)) is None and cache.take(_key(2)) is not None
    assert list(cache._host) == [_key(3)]


def test_zero_host_cap_spills_straight_to_store(tmp_path):
    stats = StatSet()
    store = KVStore(str(tmp_path / 'r'), 1 << 20, stats=stats)
    cache = TieredKVCache(host_bytes=0, store=store, stats=stats)
    try:
        cache.demote(_key(0), *_rows(0))
        assert cache.flush(10)
        assert stats.get('spills') == 1 and cache.host_entries() == 0
        assert cache.prefetch([_key(0)]) == 1
        assert cache.take(_key(0)) is not None
    finally:
        cache.close(10)


# --- tier 2 ------------------------------------------------------------------

def test_store_spill_load_roundtrip_and_ledger(tmp_path):
    st = KVStore(str(tmp_path / 'root'), 1 << 20)
    try:
        key = _key(1)
        hk, hv = _rows(4)
        assert st.spill(key, hk, hv) and st.flush(10)
        assert st.disk_entries() == 1
        assert st.disk_bytes() == os.path.getsize(st.record_path(key))
        assert os.path.exists(st.record_path(key) + '.crc32')
        rk, rv = st.load(key)
        assert torch.equal(rk, hk) and torch.equal(rv, hv)
        assert st.stats.get('spill_ms') == 0.0   # a distribution, not a count
        assert 'kv-spill_ms.p50' in st.stats.print('kv')
    finally:
        st.close(10)


def test_store_byte_budget_evicts_coldest(tmp_path):
    size = len(encode_record(_key(0), *_rows(0)))
    st = KVStore(str(tmp_path / 'root'), int(size * 2.5))
    try:
        for i in range(2):
            st.spill(_key(i), *_rows(i))
        assert st.flush(10)
        for i in range(2):
            old = time.time() - 1000 + i
            os.utime(st.record_path(_key(i)), (old, old))
        st.spill(_key(2), *_rows(2))
        assert st.flush(10)
        assert st.stats.get('disk_evicted') >= 1
        assert st.disk_bytes() <= int(size * 2.5)
        assert st.load(_key(0)) is None and st.load(_key(2)) is not None
    finally:
        st.close(10)


def test_store_corrupt_record_quarantined_reads_as_miss(tmp_path):
    st = KVStore(str(tmp_path / 'root'), 1 << 20)
    try:
        key = _key(7)
        st.spill(key, *_rows(7))
        assert st.flush(10)
        path = st.record_path(key)
        with open(path, 'r+b') as f:
            f.truncate(os.path.getsize(path) // 2)
        assert st.load(key) is None
        assert st.stats.get('corrupt_quarantined') == 1
        assert os.path.exists(path + '.quarantine')
        assert not os.path.exists(path) and st.disk_entries() == 0
        kinds = [r.kind for r in faults.global_failure_log().records()]
        assert 'kv_corrupt_record' in kinds
    finally:
        st.close(10)


def test_store_share_publish_and_adopt(tmp_path):
    share = str(tmp_path / 'shared')
    s1 = KVStore(str(tmp_path / 'l1'), 1 << 20, share_dir=share)
    s2 = KVStore(str(tmp_path / 'l2'), 1 << 20, share_dir=share)
    try:
        key = _key(9)
        hk, hv = _rows(9)
        s1.spill(key, hk, hv)
        assert s1.flush(10) and s1.stats.get('published') == 1
        rk, rv = s2.load(key)
        assert torch.equal(rk, hk) and torch.equal(rv, hv)
        assert s2.stats.get('adopts') == 1
        assert os.path.exists(s2.record_path(key))
        assert s2.disk_entries() == 1
        assert s2.load(key) is not None and s2.stats.get('adopts') == 1
    finally:
        s1.close(10)
        s2.close(10)


# --- chaos: corrupt_kv -------------------------------------------------------

def test_corrupt_kv_truncates_one_committed_record(tmp_path):
    plan = faults.FaultPlan.parse('seed=3;corrupt_kv=1;corrupt_kv@every=5')
    assert plan.describe() == jfaults.FaultPlan.parse(
        'seed=3;corrupt_kv=1;corrupt_kv@every=5').describe()
    faults.install_plan(faults.FaultPlan(corrupt_kv=(1,)))
    try:
        st = KVStore(str(tmp_path / 'r'), 1 << 20)
        try:
            st.spill(_key(1), *_rows(2))
            assert st.flush(10)
            assert faults.active_plan().fired() == ['corrupt_kv=1']
            assert st.load(_key(1)) is None
            assert st.stats.get('corrupt_quarantined') == 1
            assert os.path.exists(st.record_path(_key(1)) + '.quarantine')
            st.spill(_key(2), *_rows(3))
            assert st.flush(10) and st.load(_key(2)) is not None
        finally:
            st.close(10)
    finally:
        faults.clear_plan()


def test_poisoned_record_never_reaches_a_stream(tmp_path):
    faults.install_plan(faults.FaultPlan(corrupt_kv=(1,)))
    try:
        eng = _engine(kv_host_mb=0, kv_disk_mb=4,
                      kv_dir=str(tmp_path / 'kv'))
        try:
            a, off = _prime_and_evict(eng, np.random.RandomState(14))
            assert eng._kv.flush(10)
            assert faults.active_plan().fired() == ['corrupt_kv=1']
            _assert_twin(_serve(eng, a.copy()), off)
            assert eng.kv_stats.get('corrupt_quarantined') == 1
        finally:
            eng.close(30)
    finally:
        faults.clear_plan()


# --- prefix sharing in the engine --------------------------------------------

def _share_work(rng):
    base = rng.randint(0, 64, (1, 16)).astype(np.int32)      # w=0
    base13 = np.concatenate([base[:, :12], rng.randint(0, 64, (1, 1))],
                            axis=1).astype(np.int32)         # w=3
    return [
        (base.copy(), 8, 0.0, None), (base.copy(), 6, 0.0, None),
        (base13.copy(), 8, 0.0, None), (base13.copy(), 8, 0.9, 5),
        (np.concatenate([base[:, :8], rng.randint(0, 64, (1, 4))],
                        axis=1).astype(np.int32), 8, 0.0, None)]


def _share_engine(mod_engine, params, cfg, **kw):
    args = dict(slots=4, pages=64, page_size=8, max_prompt=16,
                max_new_bound=32, prefix_share=16)
    args.update(kw)
    return mod_engine(params, cfg, **args)


@pytest.mark.parametrize('flash', [0, 1])
def test_shared_streams_equal_unshared_equal_offline(flash):
    """Greedy and sampled, staggered joins, mixed prefix lengths, w in
    {0, 3}: shared == unshared == offline, bitwise."""
    work = _share_work(np.random.RandomState(11))
    shared = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu',
                           flash_decode=flash)
    unshared = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu',
                             flash_decode=flash, prefix_share=0)
    try:
        got = {}
        for name, eng in (('on', shared), ('off', unshared)):
            reqs = []
            for i, (p, mn, temp, seed) in enumerate(work):
                reqs.append(eng.submit_direct(p, max_new=mn,
                                              temperature=temp, rng=seed))
                if i % 2:
                    time.sleep(0.02)
            got[name] = [np.asarray(_wait_ok(r)) for r in reqs]
        for (p, mn, temp, seed), g_on, g_off in zip(work, got['on'],
                                                   got['off']):
            _assert_twin(g_on, _offline(shared, p, mn, temp, seed))
            np.testing.assert_array_equal(g_on, g_off)
        assert shared.stats.get('prefix_hits') >= 2
        assert shared.stats.get('prefix_published') >= 2
        assert shared.stats.get('tail_rows') < \
            shared.stats.get('prefill_rows')
        assert unshared.stats.get('prefix_hits') == 0
    finally:
        shared.close(30)
        unshared.close(30)


def _near_tie_ok(prompt, got, want):
    """Equal, or equal up to a pick whose top-2 logits are a near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return True
    n = int(diff[0])
    toks = torch.from_numpy(np.concatenate([prompt[0], got[:n]])[None]
                            .astype(np.int64))
    with torch.inference_mode():
        logits = T.prefill_kv(PARAMS, toks, 0, CFG)[2][0].numpy()
    top = np.argsort(logits)[::-1][:2]
    return ({int(got[n]), int(want[n])} == {int(t) for t in top}
            and logits[top[0]] - logits[top[1]] <= NEAR_TIE)


def test_greedy_shared_streams_and_counters_equal_jax_engine():
    """The same greedy traffic, one request at a time, through both
    packages' engines: the streams agree up to a near-tie and the prefix
    counters are equal."""
    work = [w for w in _share_work(np.random.RandomState(11))
            if w[2] == 0.0]
    keys = ('prefix_hits', 'prefix_hit_pages', 'prefix_published',
            'prefix_misses', 'cow_copies')
    out = {}
    for name, mod, params, cfg, extra in (
            ('jax', JDecodeEngine, JPARAMS, JCFG, {}),
            ('port', DecodeEngine, PARAMS, CFG, {'device': 'cpu'})):
        eng = _share_engine(mod, params, cfg, **extra)
        try:
            streams = [np.asarray(_wait_ok(eng.submit_direct(
                p, max_new=mn))) for p, mn, _, _ in work]
            out[name] = (streams, {k: eng.stats.get(k) for k in keys})
        finally:
            eng.close(30)
    assert out['port'][1] == out['jax'][1]
    assert out['port'][1]['prefix_hits'] >= 1
    for (p, _, _, _), g, w in zip(work, out['port'][0], out['jax'][0]):
        assert _near_tie_ok(p, g, w), (g, w)


def test_hits_never_cross_prompt_buckets():
    """An 8-token prompt's page computed at 8 rows is not the 16-row
    prefill's page 0 bit for bit (not guaranteed): a 16-token prompt with
    the same first 8 tokens does not hit it, and both stream twins."""
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu')
    try:
        rng = np.random.RandomState(21)
        short = rng.randint(0, 64, (1, 8)).astype(np.int32)
        long = np.concatenate([short, rng.randint(0, 64, (1, 8))],
                              axis=1).astype(np.int32)
        _assert_twin(_serve(eng, short, 6), _offline(eng, short, 6))
        _assert_twin(_serve(eng, long, 6), _offline(eng, long, 6))
        assert eng.stats.get('prefix_hits') == 0
        _assert_twin(_serve(eng, long.copy(), 6), _offline(eng, long, 6))
        assert eng.stats.get('prefix_hits') == 1
    finally:
        eng.close(30)


def test_resident_bytes_counts_shared_pages_once():
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu',
                        max_new_bound=8)
    try:
        p = np.arange(16, dtype=np.int32)[None]
        rb_zero = eng.resident_bytes()
        _wait_ok(eng.submit_direct(p, max_new=8))
        rb_one = eng.resident_bytes()
        _wait_ok(eng.submit_direct(p.copy(), max_new=8))
        assert eng.resident_bytes() == rb_one == rb_zero
        assert eng.stats.get('prefix_hits') == 1
        with eng._cond:
            used = eng.n_pages - 1 - len(eng._free_pages)
        assert used == 2
    finally:
        eng.close(30)


def test_preemption_never_frees_shared_pages_and_replay_twin():
    eng = DecodeEngine(PARAMS, CFG, slots=2, pages=8, page_size=8,
                       max_prompt=16, max_new_bound=32, prefix_share=4,
                       device='cpu')
    try:
        p = np.arange(16, dtype=np.int32)[None]
        off = _offline(eng, p, 24)
        # submit_direct admits in the caller: r1 holds its pages and is
        # decoding when r2 joins, so both grow until the pool runs dry
        r1 = eng.submit_direct(p, max_new=24)
        r2 = eng.submit_direct(p.copy(), max_new=24)
        _assert_twin(_wait_ok(r1), off)
        with pytest.raises(DecodePagesExhaustedError):
            _wait_ok(r2)
        assert eng.stats.get('prefix_hits') == 1
        assert eng.stats.get('shed_pages') == 1
        _assert_twin(_wait_ok(eng.submit_direct(p.copy(), max_new=24)), off)
        with eng._cond:
            refs = eng._page_refs.copy()
            free = set(eng._free_pages)
        assert all(refs[pg] == 0 for pg in free)
    finally:
        eng.close(30)


def test_pool_dry_reclaim_never_frees_probed_hit_pages():
    eng = DecodeEngine(PARAMS, CFG, slots=2, pages=10, page_size=4,
                       max_prompt=16, max_new_bound=5, prefix_share=8,
                       device='cpu')
    try:
        a = np.arange(16, dtype=np.int32)[None]
        _assert_twin(_wait_ok(eng.submit_direct(a, max_new=4)),
                     _offline(eng, a, 4))
        b = np.arange(16, 32, dtype=np.int32)[None]
        rb = eng.submit_direct(b, max_new=5)
        got = _wait_ok(eng.submit_direct(a.copy(), max_new=5))
        _assert_twin(got, _offline(eng, a, 5))
        _assert_twin(_wait_ok(rb), _offline(eng, b, 5))
        assert eng.stats.get('prefix_hits') >= 1
    finally:
        eng.close(30)


def test_index_eviction_frees_pages_and_full_error_recorded():
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu',
                        prefix_share=1)
    try:
        _wait_ok(eng.submit_direct(np.arange(16, dtype=np.int32)[None],
                                   max_new=4))
        assert eng.stats.get('prefix_index_full') == 1
        assert eng.stats.get('prefix_published') == 0
        kinds = [r.kind for r in faults.global_failure_log().records()]
        assert 'prefix_index_full' in kinds
        _wait_ok(eng.submit_direct(np.arange(8, dtype=np.int32)[None],
                                   max_new=4))
        assert eng.stats.get('prefix_published') == 1
        _wait_ok(eng.submit_direct(np.arange(8, 16, dtype=np.int32)[None],
                                   max_new=4))
        assert eng.stats.get('prefix_published') == 2
        with eng._cond:
            assert len(eng._prefix) == 1
            assert (eng._page_refs[1:] > 0).sum() == 1
    finally:
        eng.close(30)
    err = PrefixIndexFullError(3, 1)
    assert err.needed == 3 and err.cap == 1


def test_swap_drains_and_clears_prefix_index():
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu')
    try:
        p = np.arange(16, dtype=np.int32)[None]
        _wait_ok(eng.submit_direct(p, max_new=4))
        with eng._cond:
            assert len(eng._prefix) >= 1
        new = T.init_params(np.random.RandomState(9), CFG)
        eng.swap_params(new, version=9)
        with eng._cond:
            assert len(eng._prefix) == 0
            assert (eng._page_refs[1:] == 0).all()
            assert len(eng._free_pages) == eng.n_pages - 1
        got = _wait_ok(eng.submit_direct(p.copy(), max_new=6))
        _assert_twin(got, T.generate(new, p, 6, CFG)[0])
        assert eng.stats.get('prefix_hits') == 0
    finally:
        eng.close(30)


def test_prefill_cost_prices_hits_at_their_tail():
    """The port's hit walks the whole prompt (its tail is the full
    prefill's rows), so a hit is priced at the rows it walks: its bucket,
    as a miss is; JAX's prices its tail alone."""
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu')
    try:
        p = np.arange(16, dtype=np.int32)[None]
        assert eng.prefill_cost(ServeRequest(p, 30.0)) == 16
        _wait_ok(eng.submit_direct(p, max_new=4))
        assert eng.stats.get('prefix_published') == 2
        assert eng.prefill_cost(ServeRequest(p, 30.0)) == 16
        _wait_ok(eng.submit_direct(p.copy(), max_new=4))
        assert eng.stats.get('prefix_hits') == 1
        assert eng.stats.get('prefill_rows') == 32
        assert eng.prefill_cost(ServeRequest(p[:, :5], 30.0)) == 8
    finally:
        eng.close(30)


def test_report_exports_pool_and_prefix_gauges():
    eng = _share_engine(DecodeEngine, PARAMS, CFG, device='cpu')
    try:
        _wait_ok(eng.submit_direct(np.arange(16, dtype=np.int32)[None],
                                   max_new=4))
        line = eng.report('px')
        for key in ('px-free_pages', 'px-free_pages_min', 'px-pages_used',
                    'px-pages_shared', 'px-prefix_index_pages',
                    'px-prefix_published'):
            assert key in line, line
    finally:
        eng.close(30)
    # the host mirrors' copy is timed where the tiers need them
    eng = _engine()
    try:
        _serve(eng, np.arange(16, dtype=np.int32)[None], 4)
        assert 'px-publish_copy_ms' in eng.report('px')
    finally:
        eng.close(30)


def test_batcher_cost_budget_closes_window():
    executed = []
    gate = threading.Event()

    class Stub:
        buckets = (8,)

        def predict_scores(self, data):
            gate.wait(5)
            executed.append(data.shape[0])
            return np.zeros((data.shape[0], 1), np.float32)

    b = DynamicBatcher(Stub(), max_wait=0.2, deadline=10.0,
                       cost_fn=lambda r: int(r.meta['cost']), max_cost=10)
    try:
        reqs = [b.submit_async(np.zeros((1, 1), np.float32),
                               meta={'cost': c}) for c in (6, 3, 9, 1)]
        gate.set()
        for r in reqs:
            b.wait(r)
        assert executed[0] == 2 and sum(executed) == 4
        assert b.stats.get('cost_closed') >= 1
    finally:
        b.close(10)
    with pytest.raises(ValueError, match='cost_fn'):
        DynamicBatcher(Stub(), max_cost=5)


# --- the tiers in the engine -------------------------------------------------

@pytest.mark.parametrize('s0', [16, 13])
def test_demote_promote_bitwise_twin(s0):
    eng = _engine()
    try:
        a, off = _prime_and_evict(eng, np.random.RandomState(7), s0)
        assert eng.kv_stats.get('demote_pages') >= 1
        before = eng.stats.get('kv_promoted_pages')
        _assert_twin(_serve(eng, a.copy()), off)
        assert eng.stats.get('kv_promoted_pages') > before
        assert eng.kv_stats.get('hits') >= 1
        host, disk = eng.kv_occupancy()
        assert host > 0 and disk == 0
        # the promoted page is indexed again, with the prompt's own rows
        _assert_indexed_own_rows(eng, a)
        eng.report()
        assert eng.kv_stats.get('host_entries') >= 1
    finally:
        eng.close(30)


def _page0_entry(eng, prompt):
    """The index entry of ``prompt``'s first page (the engine's own key,
    its bucket included), or None."""
    s0b = _prompt_bucket(prompt.shape[1])
    w = s0b - prompt.shape[1]
    padded = np.pad(prompt, ((0, 0), (w, 0)))
    with eng._cond:
        return eng._prefix.get(eng._prefix_keys(padded, w, 1, s0b)[0]), \
            padded, w


def _assert_indexed_own_rows(eng, prompt):
    ent, padded, w = _page0_entry(eng, prompt)
    assert ent is not None
    with torch.inference_mode():
        ks, vs, _ = T.prefill_kv(eng.params, torch.from_numpy(padded), w,
                                 eng.cfg)
    assert torch.equal(ent['hk'], ks[:, 0, :8])
    assert torch.equal(ent['hv'], vs[:, 0, :8])
    with eng._cond:
        page = ent['page']
        assert torch.equal(eng._kpool[:, page], ks[:, 0, :8])
        assert torch.equal(eng._vpool[:, page], vs[:, 0, :8])


def test_promoted_record_rows_never_reach_a_stream():
    """A record planted in the host tier under a prompt's first-page key
    (the tiers' key, JAX's, names no bucket: rows from another bucket's
    prefill, or another package's, sit under the same key) is promoted,
    but the page holds the prompt's own rows and the stream twins."""
    eng = _engine()
    try:
        rng = np.random.RandomState(17)
        a = rng.randint(0, 64, (1, 16)).astype(np.int32)
        off = _offline(eng, a, 6)
        bad = tuple(torch.full((2, 8, 4, 8), 1e3) for _ in range(2))
        with eng._cond:
            key = eng._prefix_keys(a, 0, 1, 16)[0][:4]
            eng._kv.demote(key, *bad)
        _assert_twin(_serve(eng, a), off)
        assert eng.stats.get('kv_promoted_pages') == 1
        _assert_indexed_own_rows(eng, a)
    finally:
        eng.close(30)


def test_cross_bucket_disk_record_promotes_own_rows(tmp_path):
    """Multi-turn chat's pattern: a 16-token prompt whose first 8 tokens
    are an earlier 8-token prompt has the same first-page tier key, so it
    promotes the 8-row prefill's disk record; its page holds its own
    16-row prefill's rows, and both streams twin."""
    eng = _engine(kv_host_mb=0, kv_disk_mb=4, kv_dir=str(tmp_path / 'kv'))
    try:
        rng = np.random.RandomState(18)
        short = rng.randint(0, 64, (1, 8)).astype(np.int32)
        long = np.concatenate([short, rng.randint(0, 64, (1, 8))],
                              axis=1).astype(np.int32)
        _assert_twin(_serve(eng, short), _offline(eng, short, 6))
        for _ in range(2):
            f = rng.randint(0, 64, (1, 16)).astype(np.int32)
            _assert_twin(_serve(eng, f), _offline(eng, f, 6))
        assert eng._kv.flush(10)
        assert eng.kv_stats.get('spills') >= 1
        _assert_twin(_serve(eng, long), _offline(eng, long, 6))
        assert eng.kv_stats.get('disk_promote_pages') >= 1
        assert eng.stats.get('kv_promoted_pages') >= 1
        assert eng.stats.get('prefix_hits') == 0
        _assert_indexed_own_rows(eng, long)
    finally:
        eng.close(30)


def test_sampled_promote_twin():
    eng = _engine()
    try:
        rng = np.random.RandomState(8)
        a = rng.randint(0, 64, (1, 16)).astype(np.int32)
        off = _offline(eng, a, 6, 0.9, 5)
        _assert_twin(_serve(eng, a, temp=0.9, rng=5), off)
        for _ in range(2):
            _serve(eng, rng.randint(0, 64, (1, 16)).astype(np.int32))
        _assert_twin(_serve(eng, a.copy(), temp=0.9, rng=5), off)
        assert eng.stats.get('kv_promoted_pages') >= 1
    finally:
        eng.close(30)


def test_mid_stream_join_promote_twin():
    eng = _engine(slots=3)
    try:
        rng = np.random.RandomState(9)
        a, off = _prime_and_evict(eng, rng)
        long = rng.randint(0, 64, (1, 16)).astype(np.int32)
        r_long = eng.submit_direct(long, max_new=16)
        time.sleep(0.05)
        r_a = eng.submit_direct(a.copy(), max_new=6)
        _assert_twin(_wait_ok(r_a), off)
        _assert_twin(_wait_ok(r_long), _offline(eng, long, 16))
        assert eng.stats.get('kv_promoted_pages') >= 1
    finally:
        eng.close(30)


def test_disk_tier_promote_twin(tmp_path):
    eng = _engine(kv_host_mb=0, kv_disk_mb=4, kv_dir=str(tmp_path / 'kv'))
    try:
        a, off = _prime_and_evict(eng, np.random.RandomState(10))
        assert eng._kv.flush(10)
        assert eng.kv_stats.get('spills') >= 1
        _assert_twin(_serve(eng, a.copy()), off)
        assert eng.kv_stats.get('disk_promote_pages') >= 1
        assert eng.stats.get('kv_promoted_pages') >= 1
        assert eng.kv_occupancy()[1] > 0
    finally:
        eng.close(30)


def test_refcount_promote_never_eviction_victim():
    eng = _engine(slots=2, pages=10)
    try:
        rng = np.random.RandomState(11)
        a, off_a = _prime_and_evict(eng, rng, max_new=8)
        prompts = [a.copy()] + [rng.randint(0, 64, (1, 16)).astype(np.int32)
                                for _ in range(3)]
        outs = [None] * len(prompts)

        def drive(i):
            outs[i] = _wait_ok(eng.submit_direct(prompts[i], max_new=8))
        ts = [threading.Thread(target=drive, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        _assert_twin(outs[0], off_a)
        for i in range(1, len(prompts)):
            _assert_twin(outs[i], _offline(eng, prompts[i], 8))
        with eng._cond:
            refs = eng._page_refs.copy()
            free = set(eng._free_pages)
        assert all(refs[p] == 0 for p in free)
    finally:
        eng.close(30)


@pytest.mark.parametrize('kw,match', [
    (dict(prefix_share=0, kv_host_mb=1), 'prefix_share'),
    (dict(prefix_share=2, kv_disk_mb=1), 'kv_dir'),
    (dict(prefix_share=2, kv_host_mb=1, kv_share_dir='x'), 'kv_share_dir'),
    (dict(prefix_share=2, kv_host_mb=-1), '>= 0'),
    (dict(prefix_share=-1), '>= 0')])
def test_kv_kwargs_validation_equals_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        DecodeEngine(PARAMS, CFG, device='cpu', **kw)
    with pytest.raises(ValueError, match=match):
        JDecodeEngine(JPARAMS, JCFG, **kw)


# --- cross-replica adoption --------------------------------------------------

def test_two_engines_adopt_via_share_dir(tmp_path):
    share = str(tmp_path / 'shared')
    e1 = _engine(kv_host_mb=0, kv_disk_mb=4, kv_dir=str(tmp_path / 'l1'),
                 kv_share_dir=share)
    e2 = _engine(kv_host_mb=0, kv_disk_mb=4, kv_dir=str(tmp_path / 'l2'),
                 kv_share_dir=share)
    try:
        a, off = _prime_and_evict(e1, np.random.RandomState(13))
        assert e1._kv.flush(10)
        assert e1.kv_stats.get('published') >= 1
        _assert_twin(_serve(e2, a.copy()), off)
        assert e2.kv_stats.get('adopts') >= 1
        assert e2.stats.get('kv_promoted_pages') >= 1
    finally:
        e1.close(30)
        e2.close(30)


def test_port_engine_adopts_a_jax_engines_records(tmp_path):
    """A JAX replica publishes tier-2 records; a port replica of the same
    weights adopts them (the records' key, name and bytes are common) and
    its stream is the port's own offline twin."""
    share = str(tmp_path / 'shared')
    jeng = JDecodeEngine(JPARAMS, JCFG, slots=2, pages=16, page_size=8,
                         max_prompt=16, max_new_bound=16, prefix_share=2,
                         kv_disk_mb=4, kv_dir=str(tmp_path / 'j'),
                         kv_share_dir=share)
    try:
        rng = np.random.RandomState(15)
        a = rng.randint(0, 64, (1, 16)).astype(np.int32)
        _wait_ok(jeng.submit_direct(a, max_new=6))
        for _ in range(2):
            _wait_ok(jeng.submit_direct(
                rng.randint(0, 64, (1, 16)).astype(np.int32), max_new=6))
        assert jeng._kv.flush(10)
        assert jeng.kv_stats.get('published') >= 1
    finally:
        jeng.close(30)
    eng = _engine(kv_host_mb=0, kv_disk_mb=4, kv_dir=str(tmp_path / 'p'),
                  kv_share_dir=share)
    try:
        _assert_twin(_serve(eng, a.copy()), _offline(eng, a, 6))
        assert eng.kv_stats.get('adopts') >= 1
        assert eng.stats.get('kv_promoted_pages') >= 1
    finally:
        eng.close(30)


def test_two_process_lm_serve_adopt(tmp_path):
    """Two processes of the port's ``LMServe`` on one share dir: the
    second adopts the first's records; both streams equal the offline
    twin computed here."""
    share = str(tmp_path / 'shared')
    spec = ('vocab=64;d_model=32;heads=4;d_ff=48;stages=2;seq=32;seed=0;'
            'slots=2;pages=16;page_size=8;max_prompt=16;max_new=8;'
            'prefix_share=2;kv_host_mb=0;kv_disk_mb=4;dev=cpu;'
            'kv_share_dir=' + share + ';kv_dir=')
    script = (
        'import sys, numpy as np\n'
        'from cxxnet_tpu_torch.wrapper import LMServe\n'
        'spec, mode = sys.argv[1], sys.argv[2]\n'
        'h = LMServe.from_spec(spec)\n'
        'a = (np.arange(16, dtype=np.int32) % 64)[None]\n'
        'toks = h.generate(a, 6)\n'
        'if mode == "publish":\n'
        '    rng = np.random.RandomState(99)\n'
        '    for _ in range(2):\n'
        '        h.generate(rng.randint(0, 64, (1, 16)).astype(np.int32), 6)\n'
        '    h.engine._kv.flush(10)\n'
        'print("STREAM " + " ".join(str(int(t)) for t in toks))\n'
        'print("ADOPTS %d PROMOTED %d" % (h.engine.kv_stats.get("adopts"),'
        ' h.engine.stats.get("kv_promoted_pages")))\n'
        'h.close(30)\n')
    outs = []
    for i, mode in enumerate(('publish', 'adopt')):
        r = subprocess.run([sys.executable, '-c', script,
                            spec + str(tmp_path / f'l{i}'), mode],
                           capture_output=True, text=True, timeout=300,
                           cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    a = (np.arange(16, dtype=np.int32) % 64)[None]
    off = T.generate(T.init_params(np.random.RandomState(0), CFG), a, 6,
                     CFG)[0]
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith('STREAM')][0]
        _assert_twin(np.array([int(t) for t in line.split()[1:]]), off)
    tail = [ln for ln in outs[1].splitlines()
            if ln.startswith('ADOPTS')][0].split()
    assert int(tail[1]) >= 1 and int(tail[3]) >= 1, tail


# --- disaggregated prefill ---------------------------------------------------

def _prefill_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith('cxxnet-prefill-')]


def test_worker_prefill_streams_are_twins():
    svc = DecodeService(PARAMS, CFG, slots=4, pages=64, page_size=8,
                        max_prompt=16, max_new_bound=16, prefill_workers=2,
                        prefix_share=8, device='cpu')
    try:
        assert len(_prefill_threads()) == 2
        rng = np.random.RandomState(7)
        base = rng.randint(0, 64, (1, 16)).astype(np.int32)
        prompts = [rng.randint(0, 64, (1, int(rng.randint(1, 12))))
                   .astype(np.int32) for _ in range(6)] + [base, base.copy()]
        reqs = [svc.submit_async(p, 5) for p in prompts]
        for p, r in zip(prompts, reqs):
            svc.batcher.wait(r)
            assert r.error is None, r.error
            _assert_twin(r.result, _offline(svc.engine, p, 5))
        assert 'prefill_workers:2' in svc.report()
    finally:
        svc.close(30)
    time.sleep(0.3)
    assert not _prefill_threads()


def test_oversize_prompt_fails_typed_through_worker():
    eng = DecodeEngine(PARAMS, CFG, slots=2, pages=16, page_size=8,
                       max_prompt=16, max_new_bound=8, prefill_workers=1,
                       device='cpu')
    try:
        req = eng.submit_direct(np.arange(5, dtype=np.int32)[None],
                                max_new=500)
        assert req.event.wait(30)
        assert isinstance(req.error, DecodeSlotsExhaustedError)
    finally:
        eng.close(30)


def test_close_drains_the_prefill_queue_typed():
    """Requests still queued at close fail with ``ServeError``; no worker
    thread is left."""
    eng = DecodeEngine(PARAMS, CFG, slots=1, pages=16, page_size=8,
                       max_prompt=16, max_new_bound=16, prefill_workers=1,
                       device='cpu')
    reqs = []
    try:
        with eng._cond:               # hold admission while we queue
            for i in range(4):
                req = ServeRequest(np.arange(1, 4 + i,
                                             dtype=np.int32)[None], 30.0,
                                   meta={'max_new': 4})
                eng._prefillq.append(req)
                reqs.append(req)
            eng._closed = True
            eng._cond.notify_all()
    finally:
        assert eng.close(30)
    for r in reqs:
        assert r.event.wait(10)
        assert isinstance(r.error, ServeError)
    assert not _prefill_threads()


# --- the surface -------------------------------------------------------------

DEC_CONF = """task = serve
serve.mode = decode
serve.lm = "vocab=64;d_model=32;heads=4;d_ff=48;stages=2;seq=32"
serve.slots = 4
serve.pages = 64
serve.page_size = 8
serve.max_prompt = 16
serve.max_new = 8
serve.requests = 12
pred = toks.txt
"""


def test_cli_drive_with_tiers_and_prefill_workers(tmp_path, monkeypatch,
                                                  capsys):
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    assert port_main.main(['dec.conf', 'dev=cpu', 'serve.prefix_share=2',
                           'serve.kv_host_mb=1', 'serve.kv_disk_mb=4',
                           f'serve.kv_dir={tmp_path / "kv"}',
                           'serve.prefill_workers=2']) == 0
    out = capsys.readouterr()
    assert 'prefix_share=2, spec_k=0, prefill_workers=2)' in out.out
    assert 'decode twin check: 3 streams equal their offline generate ' \
        'calls' in out.out
    assert '[serve]\tdecode-' in out.err
    assert len((tmp_path / 'toks.txt').read_text().splitlines()) == 12


def test_lm_serve_from_spec_takes_the_keys(tmp_path):
    h = LMServe.from_spec(
        'vocab=64;d_model=32;heads=4;d_ff=48;stages=2;slots=2;pages=16;'
        'page_size=8;max_prompt=16;max_new=8;prefix_share=4;'
        f'kv_host_mb=1;kv_disk_mb=2;kv_dir={tmp_path / "kv"};'
        'prefill_workers=1;dev=cpu')
    try:
        eng = h.engine
        assert eng._prefix_cap == 4 and len(eng._prefill_threads) == 1
        assert eng._kv.store is not None
        a = np.arange(16, dtype=np.int32)[None]
        _assert_twin(h.generate(a, 5), _offline(eng, a, 5))
        _assert_twin(h.generate(a.copy(), 5), _offline(eng, a, 5))
        assert eng.stats.get('prefix_hits') == 1
    finally:
        h.close(30)


def test_c_abi_lm_serve_start_takes_the_keys():
    from cxxnet_tpu_torch import capi
    svc = capi.lm_serve_start(
        'vocab=64;d_model=32;heads=4;d_ff=48;stages=2;slots=2;pages=16;'
        'page_size=8;max_prompt=16;max_new=8;prefix_share=4;'
        'prefill_workers=1;dev=cpu')
    try:
        a = np.arange(16, dtype=np.int32)
        want = _offline(svc.engine, a[None], 5)
        for _ in range(2):
            toks = capi.lm_serve_generate(svc, memoryview(a.tobytes()), 16,
                                          5)
            np.testing.assert_array_equal(toks, want)
        assert svc.engine.stats.get('prefix_hits') == 1
        assert 'decode-prefix_hits:1' in capi.lm_serve_stats(svc)
    finally:
        capi.lm_serve_stop(svc)
