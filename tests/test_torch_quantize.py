"""The quantized serving tiers of the port (``serve.dtype=bf16|int8``):
``nnet/quantize.py``, the int8 GEMM's plain version, the transformer's
quantized call sites, the decode and predict engines' tiers, the CLI.

Held against the JAX package on the CPU, on numpy-seeded inputs:

* ``quantize_leaf`` / ``quantize_tree`` / ``tree_nbytes``: ``q`` and
  ``scale`` bitwise, the same leaves quantized, the same byte counts;
* ``int8_matmul_plain``: bitwise ``lax.dot_general`` (and JAX's Pallas
  kernel in interpret mode) — integer sums carry no rounding;
* ``qdot`` / ``qtake`` on f32 and bf16 inputs: bitwise (the same ops in
  the same order: one f32 division per element, round half to even, an
  exact product, two f32 multiplies, one cast);
* ``prefill_kv`` logits on the same quantized tree (carried by
  ``interop``): max |port - jax| <= 0.05 (int8) / 0.03 (bf16) of the
  largest logit, top-1 equal.  The two frameworks round bf16 at other
  points (XLA may keep f32 inside a fused chain of bf16 ops where
  PyTorch rounds after each op), so the two runs are a few bf16 ulps
  (2^-8 relative each) apart after two blocks; an
  int8 activation that lands one ulp off a rounding boundary moves by a
  whole quantization step (1/127 of its row's largest value), hence the
  wider int8 bound.  Measured on these seeds: <= 0.03 / 0.012.
* The JAX package's own pinned bounds against f32 hold for the port:
  int8 rel < 0.05, top-1 equal, greedy agreement >= 0.5; bf16 rel < 0.02.

Inside the port (bitwise): decode streams on every tier and attention
leg equal ``generate`` over the engine's own tree and config; a hot swap
re-quantizes; the resident ladder; predict tiers equal an f32 engine fed
the dequantized tree, within 1e-4 (bf16) / 1e-3 (int8) of f32.
"""

import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cxxnet_tpu.models import transformer as JT
from cxxnet_tpu.nnet import quantize as JQ
from cxxnet_tpu.ops import pallas_kernels as JPK
import torch

from cxxnet_tpu_torch import LMServe, Net
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.interop import lm_params_from_jax
from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.nnet import quantize as Q
from cxxnet_tpu_torch.ops import launches
from cxxnet_tpu_torch.ops.kernels import (int8_matmul, int8_matmul_plain,
                                          launch_counts)
from cxxnet_tpu_torch.ops.precision import full_f32
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from cxxnet_tpu_torch.serve import PredictEngine
from cxxnet_tpu_torch.serve.decode import DecodeEngine

pytestmark = pytest.mark.torch_port

KW = dict(vocab_size=64, d_model=32, num_heads=4, d_ff=48, num_stages=2,
          seq_len=32, attn='local')
CFG, JCFG = T.TransformerConfig(**KW), JT.TransformerConfig(**KW)
CFG_BF16 = T.TransformerConfig(**dict(KW, dtype=torch.bfloat16))
JCFG_BF16 = JT.TransformerConfig(**dict(KW, dtype=jnp.bfloat16))
# max |port - jax| / max |jax| of the prefill logits on the same tree
# (module docstring)
JAX_PREFILL_REL = {'int8': 0.05, 'bf16': 0.03}
# the JAX package's pinned bounds against f32 (tests/test_quantize.py)
F32_PREFILL_REL = {'int8': 0.05, 'bf16': 0.02}
PREDICT_BOUND = {'bf16': 1e-4, 'int8': 1e-3}

NET_CFG = """
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 16
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 4
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
dev = cpu
"""


def _params(seed=0):
    return T.init_params(np.random.RandomState(seed), CFG)


def _jparams(seed=0):
    return JT.init_params(np.random.RandomState(seed), JCFG)


def _jax_tier(jp, mode):
    return JQ.quantize_tree(jp, mode, out_dtype=jnp.bfloat16,
                            quant_key=JQ.lm_quant_key)


def _host(jtree):
    """A JAX tree with host numpy children, QuantLeaf kept."""
    def one(n):
        if isinstance(n, JQ.QuantLeaf):
            return JQ.QuantLeaf(np.asarray(n.q), np.asarray(n.scale),
                                n.out_dtype)
        return np.asarray(n)
    return jax.tree.map(one, jtree,
                        is_leaf=lambda n: isinstance(n, JQ.QuantLeaf))


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def _padded(prompt):
    s0 = prompt.shape[1]
    w = T._size_class(s0, floor=8) - s0
    return np.pad(prompt, ((0, 0), (w, 0))), w


# --- quantize_leaf / quantize_tree / tree_nbytes ----------------------------

@pytest.mark.parametrize('shape,dead', [((64, 48), None), ((3, 16, 8), None),
                                        ((16, 4), 0), ((2, 7, 5), 3)],
                         ids=['per_channel', 'stacked', 'dead',
                              'stacked_dead'])
def test_quantize_leaf_bitwise_equal_jax(shape, dead):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * rng.uniform(0.1, 5.0, shape[-1])).astype(
        np.float32)
    if dead is not None:
        x[..., dead] = 0.0
    want = JQ.quantize_leaf(x)
    got = Q.quantize_leaf(x)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize(jnp.float32)))
    assert got.nbytes == want.nbytes
    if dead is not None:
        assert (got.scale[..., dead] == 1.0).all()
        assert (got.q[..., dead] == 0).all()


def test_quantize_leaf_roundtrip_error_bound():
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 48) * rng.uniform(0.1, 5.0, 48)).astype(np.float32)
    leaf = Q.quantize_leaf(x)
    deq = leaf.dequantize().numpy()
    assert (np.abs(deq - x) <= leaf.scale.numpy()[None, :] / 2 + 1e-7).all()


def test_stacked_quantleaf_stage_slicing():
    x = np.random.RandomState(2).randn(3, 16, 8).astype(np.float32)
    sliced = Q.quantize_leaf(x)[1]
    direct = Q.quantize_leaf(x[1])
    assert torch.equal(sliced.q, direct.q)
    assert torch.equal(sliced.scale, direct.scale)


def test_quantize_tree_modes_and_keys_match_jax():
    jp, tp = _jparams(), _params()
    bf, jbf = Q.quantize_tree(tp, 'bf16'), JQ.quantize_tree(jp, 'bf16')
    for key in ('embed', 'head'):
        assert bf[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(bf[key]), _np(jbf[key]))
    q8, jq8 = Q.quantize_lm_tree(tp, 'int8', out_dtype=torch.bfloat16), \
        _jax_tier(jp, 'int8')
    for key in ('embed', 'head'):
        assert isinstance(q8[key], Q.QuantLeaf)
        np.testing.assert_array_equal(q8[key].q.numpy(),
                                      np.asarray(jq8[key].q))
    for key, leaf in q8['stages'].items():
        jleaf = jq8['stages'][key]
        assert isinstance(leaf, Q.QuantLeaf) == isinstance(jleaf,
                                                           JQ.QuantLeaf)
        if isinstance(leaf, Q.QuantLeaf):
            assert leaf.out_dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          np.asarray(jleaf.q))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(jleaf.scale))
        else:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(leaf), _np(jleaf))
    assert Q.quantize_tree(tp, 'f32') is tp
    for text, want in (('float32', 'f32'), ('', 'f32'), ('BF16', 'bf16'),
                       ('bfloat16', 'bf16'), ('int8', 'int8')):
        assert Q.parse_serve_dtype(text) == JQ.parse_serve_dtype(text) == want
    with pytest.raises(ValueError):
        Q.parse_serve_dtype('fp8')


@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_tree_nbytes_equal_jax(mode):
    jp, tp = _jparams(), _params()
    got = Q.tree_nbytes(Q.quantize_lm_tree(tp, mode,
                                           out_dtype=torch.bfloat16))
    assert got == JQ.tree_nbytes(_jax_tier(jp, mode))
    f32 = Q.tree_nbytes(tp)
    if mode == 'bf16':
        assert got * 2 == f32
    if mode == 'int8':
        assert got * 3 < f32


def test_dequantize_tree_equal_jax():
    rng = np.random.RandomState(3)
    tree = {'fc1': {'wmat': rng.randn(8, 16).astype(np.float32),
                    'bias': rng.randn(16).astype(np.float32)}}
    got = Q.dequantize_tree(Q.quantize_tree(tree, 'int8'), torch.float32)
    want = JQ.dequantize_tree(JQ.quantize_tree(tree, 'int8'), jnp.float32)
    for f in ('wmat', 'bias'):
        np.testing.assert_array_equal(got['fc1'][f].numpy(),
                                      np.asarray(want['fc1'][f]))


# --- the int8 product and qdot -----------------------------------------------

@pytest.mark.parametrize('m,k,n', [(5, 33, 17), (128, 256, 128), (1, 7, 300),
                                   (3, 4096, 5)])
def test_int8_matmul_plain_bitwise_equal_jax(m, k, n):
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    if k == 4096:          # the deepest path contraction at its extreme
        a[0], b[:, 0] = 127, 127
    ref = np.asarray(jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    got = int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if k == 4096:
        assert got[0, 0] == 4096 * 127 * 127
    else:                  # JAX's Pallas kernel, interpret mode on the CPU
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JPK.pallas_int8_matmul(
                jnp.asarray(a), jnp.asarray(b))))


def test_int8_matmul_wrapper_on_cpu_counts_nothing_and_checks():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randint(-127, 128, (4, 9)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (9, 6)).astype(np.int8))
    before = launch_counts()['int8_matmul']
    assert torch.equal(int8_matmul(a, b), int8_matmul_plain(a, b))
    assert launch_counts()['int8_matmul'] == before
    with pytest.raises(RuntimeError, match='no kernel'):
        int8_matmul(a.to('meta'), b.to('meta'))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(6, 32), (2, 3, 32)], ids=['2d', '3d'])
def test_qdot_bitwise_equal_jax(dtype, shape):
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    x.reshape(-1, 32)[1] = 0.0          # a zero row: scale 1, q 0
    w = rng.randn(32, 24).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == 'f32'
                else (torch.bfloat16, jnp.bfloat16))
    jw = JQ.quantize_leaf(w, out_dtype=jdt)
    tw = Q.quantize_leaf(w, out_dtype=tdt)
    want = JQ.qdot(jnp.asarray(x, jdt), jw)
    got = Q.qdot(torch.from_numpy(x).to(tdt), tw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_qdot_plain_tensor_is_native_matmul():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    assert torch.equal(Q.qdot(x, w), x @ w)


def test_qtake_bitwise_equal_jax():
    emb = np.random.RandomState(7).randn(64, 32).astype(np.float32)
    idx = np.array([[3, 0, 63], [5, 5, 1]], np.int32)
    want = JQ.qtake(JQ.quantize_leaf(emb, jnp.bfloat16), idx)
    got = Q.qtake(Q.quantize_leaf(emb, torch.bfloat16),
                  torch.from_numpy(idx).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_lm_params_from_jax_carries_quantized_trees_bitwise():
    jq = _jax_tier(_jparams(), 'int8')
    tq = lm_params_from_jax(_host(jq))
    assert isinstance(tq['head'], Q.QuantLeaf)
    assert tq['head'].out_dtype == torch.bfloat16
    np.testing.assert_array_equal(tq['head'].q.numpy(),
                                  np.asarray(jq['head'].q))
    np.testing.assert_array_equal(tq['stages']['wq'].scale.numpy(),
                                  np.asarray(jq['stages']['wq'].scale))
    ln = tq['stages']['ln1_scale']
    assert ln.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ln), _np(jq['stages']['ln1_scale']))


# --- the transformer on the quantized trees ----------------------------------

@pytest.mark.parametrize('mode', ['int8', 'bf16'])
def test_quantized_prefill_logits_match_jax(mode):
    jq = _jax_tier(_jparams(), mode)
    tq = lm_params_from_jax(_host(jq))
    prompt = np.random.RandomState(6).randint(0, 64, (1, 7)).astype(np.int32)
    padded, w = _padded(prompt)
    _, _, want = JT.prefill_kv(jq, padded, jnp.int32(w), JCFG_BF16)
    ks, _, got = T.prefill_kv(tq, torch.from_numpy(padded), w, CFG_BF16)
    assert ks.dtype == torch.bfloat16 and got.dtype == torch.float32
    want, got = np.asarray(want), got.numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= JAX_PREFILL_REL[mode], rel
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _prefill_logits(params, cfg, prompt):
    padded, w = _padded(prompt)
    return T.prefill_kv(params, torch.from_numpy(padded), w, cfg)[2].numpy()


def test_int8_tolerance_twin_vs_f32():
    params = _params()
    prompt = np.random.RandomState(6).randint(0, 64, (1, 7)).astype(np.int32)
    q8 = Q.quantize_lm_tree(params, 'int8', out_dtype=torch.bfloat16)
    l32 = _prefill_logits(params, CFG, prompt)
    l8 = _prefill_logits(q8, CFG_BF16, prompt)
    rel = np.abs(l8 - l32).max() / np.abs(l32).max()
    assert rel < F32_PREFILL_REL['int8'], rel
    assert (l8.argmax(-1) == l32.argmax(-1)).all()
    s32 = T.generate(params, prompt, 12, CFG)[0]
    s8 = T.generate(q8, prompt, 12, CFG_BF16)[0]
    assert s32[0] == s8[0]
    assert (s32 == s8).mean() >= 0.5


def test_bf16_tolerance_twin_vs_f32():
    params = _params()
    prompt = np.random.RandomState(7).randint(0, 64, (1, 9)).astype(np.int32)
    p16 = Q.quantize_lm_tree(params, 'bf16')
    l32 = _prefill_logits(params, CFG, prompt)
    l16 = _prefill_logits(p16, CFG_BF16, prompt)
    rel = np.abs(l16 - l32).max() / np.abs(l32).max()
    assert rel < F32_PREFILL_REL['bf16'], rel
    assert (l16.argmax(-1) == l32.argmax(-1)).all()


@pytest.mark.parametrize('mode', ['int8', 'bf16'])
def test_quantized_paged_step_bitwise_equal_dense_step(mode):
    # the bf16 builds' plain versions: the paged decode step equals
    # gather + the dense step on the quantized tree, bitwise
    from cxxnet_tpu_torch.ops.attention import gather_pages
    tq = Q.quantize_lm_tree(_params(), mode, out_dtype=torch.bfloat16)
    prompt = np.random.RandomState(8).randint(0, 64, (2, 8)).astype(np.int32)
    ks, vs, l0 = T.prefill_kv(tq, torch.from_numpy(prompt), 0, CFG_BF16)
    kc = torch.zeros((2, 2, 16, 4, 8), dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    kc[:, :, :8], vc[:, :, :8] = ks, vs
    # pool page p + 1 holds slot p's rows; page 0 is scratch
    kpool = torch.cat([torch.zeros_like(kc[:, :1]), kc], dim=1)
    vpool = torch.cat([torch.zeros_like(vc[:, :1]), vc], dim=1)
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    tok = l0.argmax(-1)
    t = torch.full((2,), 8, dtype=torch.int32)
    w = torch.zeros(2, dtype=torch.int32)
    paged = T.decode_step_paged(tq, CFG_BF16, tok, kpool, vpool, table, t,
                                w)[0]
    dense = T.decode_step(tq, CFG_BF16, tok, kc, vc, t, w)[0]
    assert torch.equal(paged, dense)
    assert torch.equal(torch.stack([gather_pages(kpool[i], table)
                                    for i in range(2)]), kc)


# --- the decode engine's tiers -----------------------------------------------

def _engine(dtype, flash, **kw):
    args = dict(slots=4, pages=64, page_size=8, max_prompt=16,
                max_new_bound=32, device='cpu', dtype=dtype,
                flash_decode=flash)
    args.update(kw)
    return DecodeEngine(_params(), CFG, **args)


@pytest.mark.parametrize('flash', [0, 1])
@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_exact_stream_twins_every_tier(dtype, flash):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 64, (1, int(rng.randint(1, 12))))
               .astype(np.int32) for _ in range(4)]
    temps, seeds = [0.0, 0.0, 0.8, 1.2], [None, None, 9, 10]
    eng = _engine(dtype, flash)
    try:
        want_dtype = torch.float32 if dtype == 'f32' else torch.bfloat16
        assert eng.serve_dtype == dtype and eng.cfg.dtype == want_dtype
        assert eng._kpool.dtype == want_dtype
        reqs = [eng.submit_direct(p, max_new=10, temperature=tp, rng=k)
                for p, tp, k in zip(prompts, temps, seeds)]
        for r, p, tp, k in zip(reqs, prompts, temps, seeds):
            assert r.event.wait(60) and r.error is None, r.error
            want = T.generate(eng.params, p, 10, eng.cfg, temperature=tp,
                              rng=k, flash=eng.use_flash)[0]
            np.testing.assert_array_equal(r.result, want)
    finally:
        eng.close(30)


def test_resident_ladder():
    residents = {}
    for dtype in ('f32', 'bf16', 'int8'):
        eng = _engine(dtype, 1)
        residents[dtype] = eng.resident_bytes()
        if dtype == 'int8':
            assert isinstance(eng.params['head'], Q.QuantLeaf)
            pools = 2 * eng._kpool.numel() * eng._kpool.element_size()
            assert residents[dtype] == Q.tree_nbytes(eng.params) + pools
        eng.close(30)
    assert residents['bf16'] < residents['f32'] * 0.55
    assert residents['int8'] < residents['bf16']


@pytest.mark.parametrize('flash', [0, 1])
def test_int8_spec_decode_token_equal_target_alone(flash):
    eng = _engine('int8', flash, spec_k=4, draft=(_params(), CFG))
    try:
        assert eng._draft_cfg.dtype == torch.bfloat16
        assert isinstance(eng._draft_params['head'], Q.QuantLeaf)
        rng = np.random.RandomState(9)
        jobs = [(p, eng.submit_direct(p, max_new=14))
                for p in (rng.randint(0, 64, (1, int(rng.randint(1, 12))))
                          .astype(np.int32) for _ in range(4))]
        for p, req in jobs:
            assert req.event.wait(60) and req.error is None, req.error
            np.testing.assert_array_equal(
                req.result, T.generate(eng.params, p, 14, eng.cfg,
                                       flash=eng.use_flash)[0])
        assert eng.stats.get('spec_accepted') > 0
    finally:
        eng.close(30)


def test_quantized_hot_swap_requantizes_and_keeps_twin():
    eng = _engine('int8', 1, slots=2, pages=32, max_new_bound=16)
    try:
        old_head = eng.params['head'].q.clone()
        eng.swap_params(_params(1), version=1)
        assert eng.version == 1
        new = Q.quantize_lm_tree(_params(1), 'int8',
                                 out_dtype=torch.bfloat16)
        assert torch.equal(eng.params['head'].q, new['head'].q)
        assert not torch.equal(eng.params['head'].q, old_head)
        p = np.random.RandomState(8).randint(0, 64, (1, 5)).astype(np.int32)
        r = eng.submit_direct(p, max_new=6)
        assert r.event.wait(60) and r.error is None
        np.testing.assert_array_equal(
            r.result, T.generate(eng.params, p, 6, eng.cfg, flash=1)[0])
        # the contract stays the f32 tree: shapes are checked, dtypes not
        eng.swap_params({k: (v.double() if k == 'head' else v)
                         for k, v in _params(2).items()}, version=2)
        assert eng.version == 2
        with pytest.raises(ValueError, match='shape'):
            eng.swap_params(T.init_params(np.random.RandomState(0),
                                          T.TransformerConfig(**dict(
                                              KW, d_ff=40))))
        with pytest.raises(ValueError, match='structure'):
            eng.swap_params({'embed': _params()['embed']})
    finally:
        eng.close(30)


def test_f32_tier_still_refuses_other_dtypes():
    eng = _engine('f32', 1, slots=2, pages=32, max_new_bound=16)
    try:
        with pytest.raises(ValueError, match='float32'):
            eng.swap_params({k: (v.double() if k == 'head' else v)
                             for k, v in _params(2).items()})
    finally:
        eng.close(30)


# --- the predict engine's tiers ----------------------------------------------

def _net(seed=3):
    net = Net(dev='cpu', cfg=NET_CFG)
    net.set_param('seed', seed)
    net.init_model()
    return net


@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
def test_predict_tiers_exact_and_tolerance_twins(dtype):
    e32 = PredictEngine(_net().trainer, (1, 4))
    data = np.random.RandomState(9).randn(11, 1, 1, 8).astype(np.float32)
    s32 = e32.predict_scores(data)
    eq = PredictEngine(_net().trainer, (1, 4), dtype=dtype)
    assert eq.serve_dtype == dtype
    sq = eq.predict_scores(data)
    # exact twin: an f32 engine over the dequantized tree
    et = PredictEngine(_net().trainer, (1, 4))
    et.swap_params(Q.dequantize_tree(Q.quantize_tree(e32.params, dtype),
                                     torch.float32))
    np.testing.assert_array_equal(sq, et.predict_scores(data))
    assert float(np.abs(sq - s32).max()) < PREDICT_BOUND[dtype]
    assert (sq.argmax(-1) == s32.argmax(-1)).all()
    if dtype == 'bf16':
        assert eq.resident_bytes() * 2 == e32.resident_bytes()
    else:
        assert isinstance(eq.params['0']['wmat'], Q.QuantLeaf)
        assert eq.resident_bytes() * 2 < e32.resident_bytes()
    assert eq.compile_count <= 2


def test_predict_tier_swap_requantizes_the_f32_contract():
    eq = PredictEngine(_net(3).trainer, (1, 4), dtype='int8')
    host = {k: {f: v.numpy() for f, v in fs.items()}
            for k, fs in _net(5).trainer.params.items()}
    eq.swap_params(host, version=7)
    assert eq.version == 7
    data = np.random.RandomState(10).randn(3, 1, 1, 8).astype(np.float32)
    et = PredictEngine(_net(0).trainer, (1, 4))
    et.swap_params(Q.dequantize_tree(Q.quantize_tree(host, 'int8'),
                                     torch.float32))
    np.testing.assert_array_equal(eq.predict_scores(data),
                                  et.predict_scores(data))
    with pytest.raises(ValueError, match='structure'):
        eq.swap_params({'nope': {'w': np.zeros((2, 2), np.float32)}})


def test_wrapper_serve_start_dtype():
    net = _net()
    net.serve_start(buckets='1,4', dtype='int8', warm=False)
    try:
        assert net.engine.serve_dtype == 'int8'
        out = net.serve_scores(np.random.RandomState(11).randn(3, 1, 1, 8)
                               .astype(np.float32))
        assert out.shape == (3, 4)
    finally:
        net.serve_stop()


# --- entry points -------------------------------------------------------------

def test_lmserve_from_spec_dtype():
    spec = ('vocab=64;d_model=32;heads=4;d_ff=48;stages=2;slots=2;pages=32;'
            'page_size=8;max_prompt=12;max_new=6;flash_decode=1;dev=cpu')
    for lm, want in ((LMServe.from_spec(spec + ';dtype=bf16'), 'bf16'),
                     (LMServe.from_spec(spec, dtype='int8'), 'int8')):
        try:
            assert lm.engine.serve_dtype == want
            assert lm.engine.cfg.dtype == torch.bfloat16
            p = np.arange(5, dtype=np.int32)[None]
            np.testing.assert_array_equal(
                lm.generate(p, 4), T.generate(lm.engine.params, p, 4,
                                              lm.engine.cfg, flash=1)[0])
        finally:
            lm.close(30)


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


@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
def test_cli_serves_the_quantized_tiers(tmp_path, monkeypatch, capsys, dtype):
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    assert port_main.main(['dec.conf', 'dev=cpu', f'serve.dtype={dtype}',
                           'serve.flash_decode=1']) == 0
    out = capsys.readouterr()
    assert f'dtype={dtype}' in out.out
    assert 'decode twin check: 3 streams equal their offline generate ' \
        'calls' in out.out
    lines = (tmp_path / 'toks.txt').read_text().splitlines()
    assert len(lines) == 6 and all(len(ln.split()) == 8 for ln in lines)


@pytest.mark.parametrize('key,val', [('serve.mem_budget', '100'),
                                     ('serve.models', 'a=b'),
                                     ('serve.replicas', '2'),
                                     ('serve.reload', '0.5')])
def test_cli_fleet_keys_still_raise_with_int8(tmp_path, monkeypatch, key,
                                              val):
    # the fleet keys are ported (queue A item 8) for serve.mode=predict;
    # the JAX CLI reads and ignores them in decode mode, the port refuses
    # them there (a deliberate divergence, ROADMAP queue C)
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=f'{key} apply to '
                       'serve.mode=predict only'):
        port_main.main(['dec.conf', 'dev=cpu', 'serve.dtype=int8',
                        f'{key}={val}'])


# --- satellites: launch counts under threads, the precision guard ------------

def test_launch_counts_are_exact_under_eight_threads():
    launches.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(5000):
                launches.add('int8_matmul')
                launches.add('paged_flash_decode_bf16')
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        counts = launch_counts()
        assert counts['int8_matmul'] == counts[
            'paged_flash_decode_bf16'] == 8 * 5000
        assert set(counts) == set(launches.KERNELS)
    finally:
        sys.setswitchinterval(old)
        launches.reset()


def test_full_f32_holds_bf16_reduced_precision_reduction_off():
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with full_f32():
            assert not torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction
            with full_f32():
                pass
            assert not torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction
        assert torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag

