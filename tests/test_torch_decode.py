"""The decode-serving slice: the TransformerLM's inference half, the paged
attention kernels' plain versions and the continuous decode engine.

Held against the JAX package on the CPU (same numpy-seeded inputs):
``init_params`` is bitwise JAX's; the plain ``paged_flash_decode``
matches JAX's Pallas kernel (interpret mode) and the plain
``paged_flash_verify`` JAX's dense ``verify_step`` attention (rtol 1e-5,
atol 1e-6: one softmax-weighted sum, the same f32 ops in another
library); prefill, decode and verify logits and K/V rows match (rtol
1e-4, atol 1e-5: two blocks of projections and layer norms); greedy
``generate`` is token-equal over three seeds, and a JAX-written ``.lm``
file serves JAX's greedy stream.

Inside the port (bitwise): the paged step equals gather + dense step;
engine streams equal the port's ``generate`` under staggered joins,
mixed lengths, sampling, ``max_new=1`` and speculative decoding; EOS,
a dry pool, inadmissible requests and a mid-decode swap end as the JAX
engine's do; the CLI drives ``task=serve serve.mode=decode dev=cpu``;
every option not ported yet raises ``NotPortedError`` naming a
ROADMAP.md item that exists.
"""

import math
import os
import re
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cxxnet_tpu.models import transformer as JT
from cxxnet_tpu.ops import pallas_kernels as JPK
from cxxnet_tpu.serve.decode import save_lm_params as jax_save_lm_params
import torch

from cxxnet_tpu_torch import LMServe
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.interop import lm_params_from_jax
from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.ops import attention as A
from cxxnet_tpu_torch.ops.kernels import launch_counts
from cxxnet_tpu_torch.runtime.faults import (DecodePagesExhaustedError,
                                             DecodeSlotsExhaustedError,
                                             NotPortedError,
                                             TokenDeadlineExceededError)
from cxxnet_tpu_torch.serve.decode import (DecodeEngine, DecodeService,
                                           load_lm_params, save_lm_params)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, d_model=32, num_heads=4, d_ff=48, num_stages=2,
          seq_len=32, attn='local')
DKW = dict(vocab_size=64, d_model=16, num_heads=2, d_ff=24, num_stages=1,
           attn='local')
CFG, JCFG = T.TransformerConfig(**KW), JT.TransformerConfig(**KW)
DCFG = T.TransformerConfig(**DKW)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
HD = KW['d_model'] // KW['num_heads']


def _params(seed=0, cfg=CFG):
    return T.init_params(np.random.RandomState(seed), cfg)


def _jparams(seed=0):
    return JT.init_params(np.random.RandomState(seed), JCFG)


def _prompt(rng, lo=1, hi=12):
    return rng.randint(0, 64, (1, int(rng.randint(lo, hi)))).astype(np.int32)


def _wait_ok(req, timeout=60):
    assert req.event.wait(timeout), 'request never completed'
    if req.error is not None:
        raise req.error
    return req.result


def _offline(eng, prompt, max_new, temperature=0.0, rng=None, eos_id=None):
    return T.generate(eng.params, prompt, max_new, eng.cfg,
                      temperature=temperature, rng=rng, eos_id=eos_id,
                      flash=eng.use_flash)[0]


def _assert_twin(got, off):
    """Engine streams stop at the first EOS; offline keeps emitting it."""
    got = np.asarray(got)
    assert len(got) >= 1
    np.testing.assert_array_equal(got, off[:len(got)])
    if len(got) < len(off):
        assert (off[len(got):] == off[len(got) - 1]).all()


def _engine(flash=1, **kw):
    args = dict(slots=4, pages=64, page_size=8, max_prompt=16,
                max_new_bound=32, device='cpu', flash_decode=flash)
    args.update(kw)
    return DecodeEngine(_params(), CFG, **args)


def _pool(rng, n_slots, pp, ps, cache):
    """Scatter dense (stages, b, T, H, hd) rows into a shuffled pool."""
    n_phys = n_slots * pp + 3
    pool = np.zeros((cache.shape[0], n_phys, ps) + cache.shape[3:],
                    np.float32)
    table = rng.permutation(np.arange(1, n_phys))[:n_slots * pp] \
        .reshape(n_slots, pp).astype(np.int32)
    for b in range(n_slots):
        for lp in range(pp):
            pool[:, table[b, lp]] = cache[:, b, lp * ps:(lp + 1) * ps]
    return pool, table


# --- against the JAX package --------------------------------------------------

@pytest.mark.parametrize('kw', [KW, DKW], ids=['target', 'draft'])
def test_init_params_bitwise_equal_jax(kw):
    jp = JT.init_params(np.random.RandomState(7), JT.TransformerConfig(**kw))
    tp = T.init_params(np.random.RandomState(7), T.TransformerConfig(**kw))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 2 + len(tp['stages'])
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        got = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


@pytest.mark.parametrize('w_pad', [0, 3])
def test_plain_paged_decode_matches_jax_kernel(w_pad):
    rng = np.random.RandomState(11 + w_pad)
    S, H, ps, pp = 3, 4, 8, 4
    cache = rng.randn(1, S, pp * ps, H, HD).astype(np.float32)
    vcache = rng.randn(1, S, pp * ps, H, HD).astype(np.float32)
    kpool, table = _pool(np.random.RandomState(1), S, pp, ps, cache)
    vpool, _ = _pool(np.random.RandomState(1), S, pp, ps, vcache)
    q = rng.randn(S, H, HD).astype(np.float32)
    pos = np.array([w_pad, 13, pp * ps - 1], np.int32)
    w = np.full(S, w_pad, np.int32)
    scale = 1.0 / math.sqrt(HD)
    ref = np.asarray(JPK.paged_flash_decode(q, kpool[0], vpool[0], table,
                                            pos, w, scale))
    got = A.paged_flash_decode(*(torch.from_numpy(a) for a in (
        q, kpool[0], vpool[0], table, pos, w)), scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize('w_pad', [0, 3])
def test_plain_paged_verify_matches_jax_dense_verify(w_pad):
    # JAX's own flash verify misses its dense twin on this tree (ROADMAP
    # queue C), so the reference is verify_step's dense attention
    rng = np.random.RandomState(21 + w_pad)
    S, K, H, ps, pp = 3, 3, 4, 8, 4
    T_ = pp * ps
    kc = rng.randn(S, T_, H, HD).astype(np.float32)
    vc = rng.randn(S, T_, H, HD).astype(np.float32)
    kpool, table = _pool(np.random.RandomState(2), S, pp, ps, kc[None])
    vpool, _ = _pool(np.random.RandomState(2), S, pp, ps, vc[None])
    q = rng.randn(S, K, H, HD).astype(np.float32)
    pos = np.array([w_pad, 6, T_ - K], np.int32)      # 6..8 crosses a page
    w = np.full(S, w_pad, np.int32)
    scale = 1.0 / math.sqrt(HD)
    ar = jnp.arange(T_)
    tq = pos[:, None] + jnp.arange(K)[None, :]
    live = ((ar[None, None, :] <= tq[:, :, None])
            & (ar[None, None, :] >= w[:, None, None]))[:, None]
    s_ = jnp.einsum('bqhd,bkhd->bhqk', q, kc) * scale
    s_ = jnp.where(live, s_, -jnp.inf)
    ref = np.asarray(jnp.einsum('bhqk,bkhd->bqhd',
                                jax.nn.softmax(s_.astype(jnp.float32),
                                               axis=-1), vc))
    got = A.paged_flash_verify(*(torch.from_numpy(a) for a in (
        q, kpool[0], vpool[0], table, pos, w)), scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)


def _jax_state(w_pad, b=2, s0=8, total=32):
    params = _jparams()
    prompt = np.random.RandomState(3).randint(0, 64, (b, s0)).astype(
        np.int32)
    ks, vs, logits0 = JT.prefill_kv(params, prompt, np.int32(w_pad), JCFG)
    kc = np.zeros((JCFG.num_stages, b, total, JCFG.num_heads, HD),
                  np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :s0] = np.asarray(ks)
    vc[:, :, :s0] = np.asarray(vs)
    return params, prompt, ks, vs, logits0, kc, vc


@pytest.mark.parametrize('w_pad', [0, 3])
def test_prefill_decode_verify_match_jax(w_pad):
    jp, prompt, jks, jvs, jl0, kc, vc = _jax_state(w_pad)
    tp = _params()
    ks, vs, l0 = T.prefill_kv(tp, torch.from_numpy(prompt), w_pad, CFG)
    for got, ref in ((ks, jks), (vs, jvs), (l0, jl0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    tok = np.asarray(jl0).argmax(-1).astype(np.int32)
    t = np.array([8, 8], np.int32)
    w = np.array([w_pad, w_pad], np.int32)
    jd = JT.decode_step(jp, JCFG, tok, jnp.asarray(kc), jnp.asarray(vc), t,
                        w)
    td = T.decode_step(tp, CFG, torch.from_numpy(tok),
                       torch.from_numpy(kc.copy()),
                       torch.from_numpy(vc.copy()), torch.from_numpy(t),
                       torch.from_numpy(w))
    for i in (0, 3, 4):
        np.testing.assert_allclose(td[i].numpy(), np.asarray(jd[i]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    toks = np.random.RandomState(4).randint(0, 64, (2, 3)).astype(np.int32)
    jv = JT.verify_step(jp, JCFG, toks, jnp.asarray(kc), jnp.asarray(vc),
                        t, w)
    tv = T.verify_step(tp, CFG, torch.from_numpy(toks),
                       torch.from_numpy(kc.copy()),
                       torch.from_numpy(vc.copy()), torch.from_numpy(t),
                       torch.from_numpy(w))
    for i in (0, 3, 4):
        np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv[i]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_greedy_generate_token_equal_jax(seed):
    rng = np.random.RandomState(100 + seed)
    prompt = rng.randint(0, 64, (2, int(rng.randint(1, 12)))).astype(
        np.int32)
    ref = np.asarray(JT.generate(_jparams(seed), prompt, 16, JCFG))
    np.testing.assert_array_equal(
        T.generate(_params(seed), prompt, 16, CFG), ref)


def test_jax_written_lm_file_serves_the_same_greedy_stream(tmp_path):
    jp = _jparams(5)
    path = str(tmp_path / '0001.lm')
    jax_save_lm_params(path, jp)
    assert os.path.exists(path + '.crc32')
    tree = load_lm_params(path)
    for path_, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path_]
        got = tree[keys[0]] if len(keys) == 1 else tree[keys[0]][keys[1]]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    prompt = np.random.RandomState(6).randint(0, 64, (1, 7)).astype(
        np.int32)
    ref = np.asarray(JT.generate(jp, prompt, 12, JCFG))[0]
    svc = DecodeService(tree, CFG, slots=2, pages=16, page_size=8,
                        max_prompt=16, max_new_bound=16, device='cpu')
    try:
        np.testing.assert_array_equal(svc.generate(prompt, 12), ref)
    finally:
        svc.close(30)


def test_lm_params_from_jax_and_port_file_roundtrip(tmp_path):
    jp = _jparams(8)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    np.testing.assert_array_equal(tp['stages']['w1'].numpy(),
                                  np.asarray(jp['stages']['w1']))
    path = str(tmp_path / '0002.lm')
    save_lm_params(path, tp)
    back = load_lm_params(path)
    assert sorted(back['stages']) == sorted(tp['stages'])
    np.testing.assert_array_equal(back['head'], tp['head'].numpy())


# --- inside the port ----------------------------------------------------------

@pytest.mark.parametrize('w_pad', [0, 3])
def test_paged_step_bitwise_equal_gather_then_dense(w_pad):
    tp = _params()
    prompt = np.random.RandomState(3).randint(0, 64, (2, 8)).astype(np.int32)
    ks, vs, l0 = T.prefill_kv(tp, torch.from_numpy(prompt), w_pad, CFG)
    total, ps = 32, 8
    kc = torch.zeros((2, 2, total, 4, HD))
    vc = torch.zeros_like(kc)
    kc[:, :, :8], vc[:, :, :8] = ks, vs
    kpool, table = _pool(np.random.RandomState(9), 2, total // ps, ps,
                         kc.numpy())
    vpool, _ = _pool(np.random.RandomState(9), 2, total // ps, ps,
                     vc.numpy())
    kpool, vpool = torch.from_numpy(kpool), torch.from_numpy(vpool)
    table = torch.from_numpy(table)
    tok = l0.argmax(-1)
    t = torch.full((2,), 8, dtype=torch.int32)
    w = torch.full((2,), w_pad, dtype=torch.int32)
    paged = T.decode_step_paged(tp, CFG, tok, kpool, vpool, table, t, w)[0]
    kg = torch.stack([A.gather_pages(kpool[i], table) for i in range(2)])
    vg = torch.stack([A.gather_pages(vpool[i], table) for i in range(2)])
    dense = T.decode_step(tp, CFG, tok, kc, vc, t, w)
    assert torch.equal(paged, dense[0])
    assert torch.equal(kg, kc) and torch.equal(vg, vc)   # rows landed alike


@pytest.fixture(scope='module')
def engine():
    eng = _engine()
    yield eng
    eng.close(30)


@pytest.mark.parametrize('flash', [0, 1])
def test_greedy_streams_staggered_mixed_lengths(flash):
    eng = _engine(flash)
    try:
        rng = np.random.RandomState(0)
        jobs = []
        for i in range(10):
            prompt = _prompt(rng)
            mn = int(rng.randint(2, 20))
            jobs.append((prompt, mn, eng.submit_direct(prompt, max_new=mn)))
            time.sleep(0.003 * (i % 3))
        for prompt, mn, req in jobs:
            got = _wait_ok(req)
            assert len(got) == mn
            _assert_twin(got, _offline(eng, prompt, mn))
        assert launch_counts()['paged_flash_decode'] == 0   # CPU: plain
    finally:
        eng.close(30)


def test_sampled_streams_follow_their_seeds(engine):
    rng = np.random.RandomState(1)
    jobs = [(p, engine.submit_direct(p, max_new=12, temperature=0.8,
                                     rng=40 + i))
            for i, p in enumerate(_prompt(rng) for _ in range(4))]
    outs = []
    for i, (p, req) in enumerate(jobs):
        got = _wait_ok(req)
        _assert_twin(got, _offline(engine, p, 12, 0.8, 40 + i))
        outs.append(got)
    with pytest.raises(ValueError):
        _wait_ok(engine.submit_direct(jobs[0][0], max_new=4,
                                      temperature=0.8))


def test_mixed_greedy_and_sampled_share_steps(engine):
    rng = np.random.RandomState(2)
    jobs = []
    for i in range(6):
        p = _prompt(rng)
        temp = 0.7 if i % 2 else 0.0
        seed = 9 + i if temp else None
        jobs.append((p, temp, seed, engine.submit_direct(
            p, max_new=10, temperature=temp, rng=seed)))
    for p, temp, seed, req in jobs:
        _assert_twin(_wait_ok(req), _offline(engine, p, 10, temp, seed))


def test_max_new_one_is_prefill_only(engine):
    p = _prompt(np.random.RandomState(3))
    steps = engine.stats.get('decode_steps')
    got = _wait_ok(engine.submit_direct(p, max_new=1))
    assert len(got) == 1
    _assert_twin(got, _offline(engine, p, 1))
    assert engine.stats.get('decode_steps') == steps


def test_eos_frees_slot_and_pages():
    probe = _engine()
    p = _prompt(np.random.RandomState(4), 4, 9)
    off = _offline(probe, p, 16)
    probe.close(30)
    eos = int(off[3])
    eng = _engine(eos_id=eos)
    try:
        got = _wait_ok(eng.submit_direct(p, max_new=16))
        assert got[-1] == eos and len(got) <= 4
        _assert_twin(got, _offline(eng, p, 16, eos_id=eos))
        deadline = time.time() + 5
        while eng.busy() and time.time() < deadline:
            time.sleep(0.01)
        assert not eng.busy()
        assert len(eng._free_pages) == eng.n_pages - 1
        assert not eng._table.any()
    finally:
        eng.close(30)


def test_dry_pool_preempts_youngest_stream():
    # 6 allocatable pages of 4 positions: both streams are admitted (3
    # pages each) but cannot both grow, so the younger one is shed when
    # the older one needs its fourth page
    eng = _engine(pages=7, page_size=4, max_prompt=8, max_new_bound=12)
    try:
        rng = np.random.RandomState(5)
        with eng._cond:      # both join at one token boundary
            a = eng.submit_direct(_prompt(rng, 6, 8), max_new=12)
            b = eng.submit_direct(_prompt(rng, 6, 8), max_new=12)
        assert a.event.wait(60) and b.event.wait(60)
        errs = [r.error for r in (a, b)]
        assert any(isinstance(e, DecodePagesExhaustedError) for e in errs)
        assert a.error is None and len(a.result) == 12
        assert 0 < b.error.tokens_emitted < 12
        assert eng.stats.get('shed_pages') >= 1
    finally:
        eng.close(30)


def test_token_deadline_mid_stream_keeps_the_partial_count(engine):
    p = _prompt(np.random.RandomState(12))
    with engine._cond:       # hold the loop past the deadline
        req = engine.submit_direct(p, max_new=30, deadline=0.01)
        time.sleep(0.05)
    assert req.event.wait(30)
    assert isinstance(req.error, TokenDeadlineExceededError)
    assert 1 <= req.error.tokens_emitted < 30


def test_inadmissible_requests_fail_typed(engine):
    too_long = np.zeros((1, 40), np.int32)
    r = engine.submit_direct(too_long, max_new=4)
    assert r.event.wait(5) and isinstance(r.error, DecodeSlotsExhaustedError)
    r = engine.submit_direct(np.zeros((1, 3), np.int32), max_new=99)
    assert r.event.wait(5) and isinstance(r.error, DecodeSlotsExhaustedError)
    r = engine.submit_direct(np.full((1, 3), 64, np.int32), max_new=4)
    assert r.event.wait(5) and isinstance(r.error, ValueError)


@pytest.mark.parametrize('flash', [0, 1])
def test_spec_decode_token_equal_target_alone(flash):
    eng = _engine(flash, spec_k=3, draft=(_params(1, DCFG), DCFG))
    try:
        rng = np.random.RandomState(6)
        jobs = [(p, eng.submit_direct(p, max_new=14))
                for p in (_prompt(rng) for _ in range(6))]
        for p, req in jobs:
            _assert_twin(_wait_ok(req), _offline(eng, p, 14))
        assert eng.stats.get('spec_steps') > 0
    finally:
        eng.close(30)
    twin = _engine(flash, spec_k=4, draft=(_params(), CFG))
    try:
        p = _prompt(np.random.RandomState(7))
        _assert_twin(_wait_ok(twin.submit_direct(p, max_new=20)),
                     _offline(twin, p, 20))
        assert twin.stats.get('spec_accepted') > 0
    finally:
        twin.close(30)


def test_swap_params_mid_decode_drains_on_old_params():
    eng = _engine()
    try:
        old, new = _params(0), _params(1)
        p = _prompt(np.random.RandomState(8))
        first = eng.submit_direct(p, max_new=30)
        while not first.tokens:
            time.sleep(0.001)
        swapper = threading.Thread(target=eng.swap_params, args=(new, 1))
        swapper.start()
        while eng._pending_params is None and swapper.is_alive():
            time.sleep(0.001)
        second = eng.submit_direct(p, max_new=30)
        swapper.join(60)
        np.testing.assert_array_equal(
            _wait_ok(first), T.generate(old, p, 30, CFG, flash=1)[0])
        np.testing.assert_array_equal(
            _wait_ok(second), T.generate(new, p, 30, CFG, flash=1)[0])
        assert eng.swap_count == 1 and eng.version == 1
        with pytest.raises(ValueError):
            eng.swap_params(_params(0, T.TransformerConfig(
                **dict(KW, d_ff=40))))
    finally:
        eng.close(30)


def test_lmserve_from_spec_and_device_default():
    lm = LMServe.from_spec('vocab=64;d_model=32;heads=4;d_ff=48;stages=2;'
                           'slots=2;pages=16;page_size=8;max_prompt=16;'
                           'max_new=8;dev=cpu')
    try:
        p = np.arange(5, dtype=np.int32)[None]
        np.testing.assert_array_equal(
            lm.generate(p, 8), T.generate(lm.engine.params, p, 8, CFG)[0])
        assert lm.engine.device.type == 'cpu' and not lm.engine.use_flash
    finally:
        lm.close(30)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='dev=cpu'):
            LMServe.from_spec('vocab=64;d_model=32;heads=4;d_ff=48;'
                              'stages=1')
        with pytest.raises(RuntimeError, match='dev=cpu'):
            DecodeEngine(_params(), CFG)


DEC_CONF = """task = serve
serve.mode = decode
serve.lm = "vocab=64;d_model=32;heads=4;d_ff=48;stages=2"
serve.slots = 4
serve.pages = 32
serve.page_size = 8
serve.max_prompt = 12
serve.max_new = 8
serve.requests = 6
pred = toks.txt
"""


def test_cli_decode_drive_on_the_cpu(tmp_path, monkeypatch, capsys):
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    assert port_main.main(['dec.conf', 'dev=cpu', 'serve.spec_k=3',
                           'serve.draft=d_model=16;heads=2;d_ff=24;'
                           'stages=1;seed=1']) == 0
    out = capsys.readouterr()
    assert 'decode twin check: 3 streams equal their offline generate ' \
        'calls' in out.out
    assert '[serve]\tdecode-' in out.err
    lines = (tmp_path / 'toks.txt').read_text().splitlines()
    assert len(lines) == 6 and all(len(ln.split()) == 8 for ln in lines)
    # greedy streams are the JAX drive's: same prompts, same weights
    rng = np.random.RandomState(0)
    jp = _jparams(0)
    for ln in lines[:2]:
        prompt = rng.randint(0, 64, (1, int(rng.randint(1, 12)))).astype(
            np.int32)
        ref = np.asarray(JT.generate(jp, prompt, 8, JCFG))[0]
        assert [int(v) for v in ln.split()] == ref.tolist()


def _roadmap_items():
    with open(os.path.join(ROOT, 'ROADMAP.md')) as f:
        text = f.read()
    queue_a = text.split('### A.')[1].split('### B.')[0]
    return {int(n) for n in re.findall(r'^(\d+)\. ', queue_a, re.M)}


@pytest.mark.parametrize('pairs,item', [
    # serve.dtype itself is ported: the tier with a hot reload is not
    ([('serve.dtype', 'bf16'), ('serve.reload', '0.5')], 8),
    ([('serve.shard', 'tp:2')], 9),
    ([('serve.prefix_share', '8')], 7), ([('serve.kv_host_mb', '4')], 7),
    ([('serve.kv_disk_mb', '4')], 7), ([('serve.kv_dir', 'kv')], 7),
    ([('serve.prefill_workers', '2')], 7),
    ([('serve.scenario', 'shape=flash')], 10),
    ([('serve.autoscale', 'min_slots=1')], 10),
    ([('serve.models', 'a=b')], 8), ([('serve.mem_budget', '100')], 8),
    ([('serve.mode', 'predict'), ('serve.fold_bn', '1')], 4),
    ([('serve.lm', 'vocab=64;d_model=32;heads=4;d_ff=48;experts=2')], 9),
], ids=['dtype', 'shard', 'prefix_share', 'kv_host', 'kv_disk', 'kv_dir',
        'prefill_workers', 'scenario', 'autoscale', 'models', 'mem_budget',
        'predict_mode', 'moe'])
def test_refused_keys_name_an_existing_roadmap_item(tmp_path, monkeypatch,
                                                    pairs, item):
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    if item == 8:
        # the fleet keys are ported (queue A item 8) for predict mode; in
        # decode mode, where JAX ignores them, the port refuses them
        with pytest.raises(ValueError, match='serve.mode=predict only'):
            port_main.main(['dec.conf', 'dev=cpu']
                           + [f'{k}={v}' for k, v in pairs])
        assert item in _roadmap_items()
        return
    if item == 4:
        # serve.fold_bn is ported (queue A item 4): predict mode takes it
        task = port_main.LearnTask()
        for k, v in pairs:
            task.set_param(k, v)
        assert (task.serve_mode, task.serve_fold_bn) == ('predict', 1)
        return
    args = ['dec.conf', 'dev=cpu'] + [f'{k}={v}' for k, v in pairs]
    if item == 7:
        # ported (queue A item 7): the key reaches the engine with its
        # value, beside what it needs (a cap for the tiers, a dir for disk)
        seen = {}

        class Spy(DecodeService):
            def __init__(self, *a, **kw):
                seen.update(kw)
                super().__init__(*a, **kw)

        import cxxnet_tpu_torch.serve.decode as tdecode
        monkeypatch.setattr(tdecode, 'DecodeService', Spy)
        keys = {k for k, _ in pairs}
        if 'serve.prefix_share' not in keys:
            args.append('serve.prefix_share=8')
        if 'serve.kv_dir' not in keys:
            args.append(f'serve.kv_dir={tmp_path / "kvd"}')
        assert port_main.main(args) == 0
        for k, v in pairs:
            want = v if k == 'serve.kv_dir' else int(v)
            assert seen[k.split('.', 1)[1]] == want
        assert item in _roadmap_items()
        return
    with pytest.raises(NotPortedError) as e:
        port_main.main(args)
    assert e.value.roadmap == f'queue A item {item}'
    assert item in _roadmap_items()


@pytest.mark.parametrize('key,val', [('dtype', 'int8'), ('shard', 'tp:2'),
                                     ('prefix_share', 4),
                                     ('prefill_workers', 1)])
def test_engine_refuses_unported_options(key, val):
    # the int8 tier is served (tests/test_torch_quantize.py); its
    # tensor-parallel placement (co-sharded q and scale) is queue A item 9
    extra = {'shard': 'tp:2'} if key == 'dtype' else {}
    if key in ('prefix_share', 'prefill_workers'):
        # ported (queue A item 7): the option reaches the engine
        svc = DecodeService(_params(), CFG, device='cpu', **{key: val})
        try:
            eng = svc.engine
            if key == 'prefix_share':
                assert eng._prefix_cap == val
                assert svc.batcher.cost_fn == eng.prefill_cost
                assert svc.batcher.max_cost == 2 * eng.max_prompt
            else:
                assert [t.name for t in eng._prefill_threads] == \
                    ['cxxnet-prefill-lm-0']
        finally:
            svc.close(10)
        return
    with pytest.raises(NotPortedError):
        DecodeService(_params(), CFG, device='cpu', **{key: val}, **extra)


def test_full_f32_blocks_on_many_threads_restore_the_flags():
    # the engine's loop and admitting threads open full_f32 blocks at
    # once: the flags stay off while any block is open and come back to
    # the caller's values after the last one closes
    import sys
    from cxxnet_tpu_torch.ops.precision import full_f32
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    seen = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(300):
                with full_f32():
                    seen.append(torch.backends.cuda.matmul.allow_tf32
                                or torch.backends.cudnn.allow_tf32)
        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(seen) == 300 * len(threads) and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        sys.setswitchinterval(old)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
