"""cxxnet_tpu_torch's TransformerLM training step against the JAX package,
on the CPU.

* ``reference_loss``, its gradients and one ``make_multi_train_step``
  step against JAX's at f32 (loss rtol 1e-5; gradients and updated
  params 1e-5 of each leaf's largest value: f32 sums in another order)
  and bf16.  bf16 rounds at every op, in another order in each package,
  so the bf16 rule is measured against the truth: the f32 gradient of
  the same bf16 weights (JAX, f32).  The port's bf16 gradient lies no
  further from it than 1.5x JAX's bf16 gradient does (+ 2^-8 of the
  leaf's largest value), and so do the updated params from JAX's f32
  step on the same bf16 weights; the loss within rtol 1e-3 of JAX's.
* K steps of the multi step equal K single steps, bitwise.
* The mesh step at ``pipe = model = 1``, one stage, ``(dp, sp)`` in (1,
  4), (2, 2), (4, 1), over 4 gloo ranks (ONE ``torch.multiprocessing.spawn``
  runs every multi-rank case, a ``file://`` rendezvous under the tmp
  dir), against JAX's ``make_train_step`` on 4 of conftest's 8 CPU
  devices, at JAX's own bounds of ``test_transformer_step_matches_oracle``
  (loss rtol 1e-4 atol 1e-5; params rtol 2e-3 atol 2e-4); the replicas
  equal across ranks, bitwise.  The mesh step against the multi step
  (rtol 1e-5; params rtol 2e-5 atol 2e-6, JAX's
  ``test_multi_train_step_matches_mesh_step``); ``remat`` against no
  ``remat`` (rtol 1e-6); the loss falling over 10 steps; one bf16 ring
  case at ``sp = 2``, head dim 8 (its scale ``1/sqrt(8)`` is no power of
  two), under the bf16 rule above against JAX's f32 step; the refusals.
* The ``train_lm.py`` twin over 4 spawned gloo ranks: its loss falls.

JAX is imported inside the test functions only, so the spawned ranks
start without it.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.parallel import distributed as D
from cxxnet_tpu_torch.parallel.pipeline import (pipeline_stage_loop,
                                                split_microbatches)
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-5
BF16_LOSS_RTOL, BF16_FACTOR, BF16_FLOOR = 1e-3, 1.5, 2.0 ** -8
MESH_LOSS_RTOL, MESH_LOSS_ATOL = 1e-4, 1e-5
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 2e-3, 2e-4
MULTI_LOSS_RTOL, MULTI_PARAM_RTOL, MULTI_PARAM_ATOL = 1e-5, 2e-5, 2e-6
REMAT_RTOL = 1e-6

# the JAX step test's config (num_stages = pipe = 1), batch 8 so that
# every (dp, sp) keeps two microbatches a data rank
STEP = dict(vocab_size=32, d_model=16, num_heads=4, d_ff=32, num_stages=1,
            seq_len=16, num_microbatches=2, attn='ring')
STEP_BATCH, STEP_LR = 8, 0.1
MESHES = {'dp1_sp4': (1, 4), 'dp2_sp2': (2, 2), 'dp4_sp1': (4, 1)}
# test_transformer_loss_decreases' config, one stage
DECREASE = dict(vocab_size=16, d_model=16, num_heads=2, d_ff=32,
                num_stages=1, seq_len=8, num_microbatches=2)
# test_multi_train_step_matches_mesh_step's config, one stage
MULTI = dict(vocab_size=32, d_model=16, num_heads=2, d_ff=32, num_stages=1,
             seq_len=8, num_microbatches=2)
# head dim 8: 1/sqrt(8) rounds in bf16
BF16_RING = dict(STEP, num_heads=2)
# two stages on the single device
SINGLE = dict(vocab_size=32, d_model=16, num_heads=4, d_ff=32,
              num_stages=2, seq_len=16)
REFUSALS = {
    'local_on_seq': (dict(STEP, attn='local'), (1, 2, 2, 1), ValueError,
                     'block-diagonal'),
    'stages_ne_pipe': (dict(STEP, num_stages=2), (1, 2, 2, 1), ValueError,
                       'one stage per pipe rank'),
    'heads': (dict(STEP, num_heads=2), (1, 1, 1, 4), ValueError,
              'num_heads must divide model axis'),
    'pipe': (dict(STEP, num_stages=2), (2, 2, 1, 1), NotPortedError,
             'pipe=2'),
    'model': (STEP, (1, 1, 1, 4), NotPortedError, 'model=4'),
    'moe': (dict(STEP, num_experts=2), (1, 2, 2, 1), NotPortedError,
            'MoE'),
}


def _inputs(vocab, batch, seq, seed=3):
    """test_transformer_parallel._make_inputs' tokens and labels."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (batch, seq)),
            rng.randint(0, vocab, (batch, seq)))


def _params(kw, seed, dtype=torch.float32):
    return T.init_params(np.random.RandomState(seed),
                         T.TransformerConfig(dtype=dtype, **kw))


def _flat(tree, prefix=''):
    """{path: float32 numpy} of a torch or JAX param tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}/'))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _jax_cfg(kw, dtype='float32'):
    import jax.numpy as jnp
    from cxxnet_tpu.models import transformer as J
    return J.TransformerConfig(dtype=getattr(jnp, dtype), **kw)


def _jax_params(kw, seed, dtype='float32'):
    from cxxnet_tpu.models import transformer as J
    return J.init_params(np.random.RandomState(seed), _jax_cfg(kw, dtype))


def _jax_mesh(dp, sp):
    import jax
    from cxxnet_tpu.models import transformer as J
    return J.build_transformer_mesh(N_RANKS, 1, dp, sp, 1,
                                    devices=jax.devices()[:N_RANKS])


def _jax_step(kw, seed, dp, sp, tokens, labels, lr, dtype='float32'):
    """JAX's make_train_step on 4 CPU devices: (loss, {path: params})."""
    import jax.numpy as jnp
    from cxxnet_tpu.models import transformer as J
    step = J.make_train_step(_jax_cfg(kw, dtype), _jax_mesh(dp, sp), lr=lr)
    new, loss, _ = step(_jax_params(kw, seed, dtype),
                        jnp.asarray(tokens, jnp.int32),
                        jnp.asarray(labels, jnp.int32))
    return float(loss), _flat(new)


def _bf16_rule(got, jax16, truth):
    """Per leaf: the port's bf16 result lies no further from the f32 truth
    than 1.5x JAX's bf16 result does, + 2^-8 of the leaf's largest value
    (the truth: JAX in f32 on the same bf16 weights)."""
    for k, t in truth.items():
        err = np.abs(got[k] - t).max()
        bound = (BF16_FACTOR * np.abs(jax16[k] - t).max()
                 + BF16_FLOOR * np.abs(t).max())
        assert err <= bound, (k, err, bound)


def _as_f32(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


# --- the single-device oracle and the K-step loop ---------------------------

def _port_value_and_grad(params, cfg, tokens, labels):
    leaves = T._leaves(params)
    loss, _, grads = T._value_and_grad(leaves, lambda: (T.reference_loss(
        params, torch.from_numpy(tokens).long(),
        torch.from_numpy(labels).long(), cfg), None))
    names = list(_flat(params))
    return float(loss), {n: g.float().numpy() for n, g in zip(names, grads)}


def _jax_value_and_grad(kw, dtype, tokens, labels, params=None):
    import jax
    import jax.numpy as jnp
    from cxxnet_tpu.models import transformer as J
    params = _jax_params(kw, 4, dtype) if params is None else params
    loss, grads = jax.value_and_grad(J.reference_loss)(
        params, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(labels, jnp.int32), _jax_cfg(kw, dtype))
    return float(loss), _flat(grads)


def _f32_truth(kw, tokens, labels):
    """JAX's f32 loss and gradient of the bf16 weights of seed 4."""
    import jax
    import jax.numpy as jnp
    return _jax_value_and_grad(kw, 'float32', tokens, labels,
                               _as_f32(_jax_params(kw, 4, 'bfloat16')))


def test_reference_loss_and_gradients_match_jax_f32():
    tokens, labels = _inputs(32, 4, 16)
    loss, grads = _port_value_and_grad(_params(SINGLE, 4),
                                       T.TransformerConfig(**SINGLE),
                                       tokens, labels)
    want_loss, want = _jax_value_and_grad(SINGLE, 'float32', tokens, labels)
    assert loss == pytest.approx(want_loss, rel=F32_LOSS_RTOL)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(
            g, want[k], rtol=0,
            atol=F32_GRAD_TOL * np.abs(want[k]).max(), err_msg=k)


def test_reference_loss_and_gradients_match_jax_bf16():
    tokens, labels = _inputs(32, 4, 16)
    cfg = T.TransformerConfig(dtype=torch.bfloat16, **SINGLE)
    loss, grads = _port_value_and_grad(_params(SINGLE, 4, torch.bfloat16),
                                       cfg, tokens, labels)
    jax_loss, jax16 = _jax_value_and_grad(SINGLE, 'bfloat16', tokens, labels)
    _, ref32 = _f32_truth(SINGLE, tokens, labels)
    assert loss == pytest.approx(jax_loss, rel=BF16_LOSS_RTOL)
    _bf16_rule(grads, jax16, ref32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_one_multi_step_matches_jax(dtype):
    import jax.numpy as jnp
    from cxxnet_tpu.models import transformer as J
    lr = 0.1
    tokens, labels = _inputs(32, 4, 16)
    tdt = getattr(torch, dtype)
    params, loss = T.make_multi_train_step(
        T.TransformerConfig(dtype=tdt, **SINGLE), 1, lr=lr)(
        _params(SINGLE, 4, tdt), tokens[None], labels[None])
    assert loss.dtype == torch.float32 and loss.dim() == 0
    got = _flat(params)
    new, want_loss = J.make_multi_train_step(
        _jax_cfg(SINGLE, dtype), 1, lr=lr)(
        _jax_params(SINGLE, 4, dtype), jnp.asarray(tokens[None], jnp.int32),
        jnp.asarray(labels[None], jnp.int32))
    want = _flat(new)
    if dtype == 'float32':
        assert float(loss) == pytest.approx(float(want_loss),
                                            rel=F32_LOSS_RTOL)
        # the update's difference is lr times the gradient's
        _, grads = _jax_value_and_grad(SINGLE, dtype, tokens, labels)
        for k, w in got.items():
            np.testing.assert_allclose(
                w, want[k], rtol=0,
                atol=lr * F32_GRAD_TOL * np.abs(grads[k]).max() + 1e-7,
                err_msg=k)
        return
    assert float(loss) == pytest.approx(float(want_loss),
                                        rel=BF16_LOSS_RTOL)
    truth, _ = J.make_multi_train_step(_jax_cfg(SINGLE), 1, lr=lr)(
        _as_f32(_jax_params(SINGLE, 4, dtype)),
        jnp.asarray(tokens[None], jnp.int32),
        jnp.asarray(labels[None], jnp.int32))
    _bf16_rule(got, want, _flat(truth))


def test_k_steps_equal_k_single_steps():
    """A 5-step call over a stack of 2 equals 5 one-step calls, bitwise:
    one step, cycled round-robin, with the same loss at the end."""
    cfg = T.TransformerConfig(**SINGLE)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 32, (2, 4, 16))
    labs = rng.randint(0, 32, (2, 4, 16))
    multi, loss_k = T.make_multi_train_step(cfg, 5, lr=0.1)(
        _params(SINGLE, 4), toks, labs)
    single = _params(SINGLE, 4)
    one = T.make_multi_train_step(cfg, 1, lr=0.1)
    for t in range(5):
        single, loss_1 = one(single, toks[t % 2][None], labs[t % 2][None])
    assert torch.equal(loss_k, loss_1)
    for k, w in _flat(multi).items():
        np.testing.assert_array_equal(w, _flat(single)[k], err_msg=k)


def test_multi_step_updates_in_place_and_keeps_requires_grad():
    params = _params(SINGLE, 4)
    before = params['stages']['wq'].clone()
    tokens, labels = _inputs(32, 4, 16)
    out, _ = T.make_multi_train_step(T.TransformerConfig(**SINGLE), 1)(
        params, tokens[None], labels[None])
    assert out is params
    assert not torch.equal(params['stages']['wq'], before)
    assert not any(w.requires_grad for w in T._leaves(params))


def test_param_specs_match_jax():
    from cxxnet_tpu.models import transformer as J
    want = J.param_specs(_jax_cfg(SINGLE))
    got = T.param_specs(T.TransformerConfig(**SINGLE))
    T._map_with_specs(lambda spec, jspec: _eq(spec, tuple(jspec)), got, want)
    assert T.AXES == J.AXES


def _eq(a, b):
    assert a == b, (a, b)


def test_pipeline_stage_loop_at_one_stage_matches_jax():
    """JAX's pipeline loop on a 1-device ``pipe`` mesh and the port's at
    one stage: the same tanh stage over 4 microbatches, with the aux
    average."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from cxxnet_tpu.parallel import pipeline as JP
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    rng = np.random.RandomState(0)
    w = rng.randn(1, 8, 8).astype(np.float32) * 0.3
    x = rng.randn(8, 8).astype(np.float32)

    def jstage(p, h):
        y = jnp.tanh(h @ p['w'])
        return y, {'s': y.sum()}

    fn = shard_map(functools.partial(JP.pipeline_stage_loop, jstage,
                                     axis_name='pipe', num_stages=1,
                                     has_aux=True),
                   mesh=Mesh(np.asarray(jax.devices()[:1]), ('pipe',)),
                   in_specs=({'w': P('pipe')}, P()), out_specs=(P(), P()),
                   check_vma=False)
    want, want_aux = fn({'w': jnp.asarray(w)},
                        JP.split_microbatches(jnp.asarray(x), 4))
    got, aux = pipeline_stage_loop(
        lambda p, h: (torch.tanh(h @ p['w']),
                      {'s': torch.tanh(h @ p['w']).sum()}),
        {'w': torch.from_numpy(w)}, split_microbatches(torch.from_numpy(x),
                                                      4),
        num_stages=1, has_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert float(aux['s']) == pytest.approx(float(want_aux['s']), rel=1e-5)
    with pytest.raises(NotPortedError, match='queue A item 9'):
        pipeline_stage_loop(lambda p, h: h, {'w': torch.zeros(2, 1)},
                            torch.zeros(1, 1), num_stages=2)
    with pytest.raises(ValueError, match='not divisible by microbatches'):
        split_microbatches(torch.zeros(6, 2), 4)


def test_build_transformer_mesh_checks_the_device_count():
    with pytest.raises(ValueError, match=r'pp\*dp\*sp\*tp = 4 != 8'):
        T.build_transformer_mesh(8, 1, 2, 2, 1)


def test_one_rank_mesh_step_equals_the_multi_step(tmp_path):
    """A 1-rank gloo world, its (1, 1, 1, 1) mesh: one mesh step and one
    multi step from the same params agree (no collective runs)."""
    D.init_distributed(f'file://{tmp_path}/rdv', 1, 0, device='cpu')
    try:
        mesh = T.build_transformer_mesh(1, 1, 1, 1, 1)
        assert mesh.mesh_dim_names == T.AXES
        cfg = T.TransformerConfig(**MULTI)
        tokens, labels = _inputs(32, 4, 8, seed=7)
        a, loss_a, aux = T.make_train_step(cfg, mesh, lr=0.05)(
            _params(MULTI, 0), tokens, labels)
        b, loss_b = T.make_multi_train_step(cfg, 1, lr=0.05)(
            _params(MULTI, 0), tokens[None], labels[None])
        assert float(loss_a) == pytest.approx(float(loss_b),
                                              rel=MULTI_LOSS_RTOL)
        assert set(aux) == {'balance_loss', 'drop_frac'}
        assert float(aux['balance_loss']) == 0.0
        fb = _flat(b)
        for k, w in _flat(a).items():
            np.testing.assert_allclose(w, fb[k], rtol=MULTI_PARAM_RTOL,
                                       atol=MULTI_PARAM_ATOL, err_msg=k)
        with pytest.raises(ValueError, match='not divisible by micro'):
            T.make_train_step(cfg, mesh)(_params(MULTI, 0), tokens[:3],
                                         labels[:3])
    finally:
        torch.distributed.destroy_process_group()


# --- the mesh step across 4 gloo ranks --------------------------------------

def _save(out, case, loss, params):
    out[f'{case}/loss'] = np.asarray(float(loss))
    for k, v in _flat(params).items():
        out[f'{case}/{k}'] = v


def _rank_main(rank, world, tmp):
    """One gloo rank: every mesh case; losses and this rank's replica of
    the updated params go to ``tmp/rank<r>.npz``."""
    D.init_distributed(f'file://{tmp}/rendezvous', world, rank,
                       timeout=60, device='cpu')
    try:
        out = {}
        tokens, labels = _inputs(32, STEP_BATCH, 16)
        for case, (dp, sp) in MESHES.items():
            mesh = T.build_transformer_mesh(world, 1, dp, sp, 1)
            step = T.make_train_step(T.TransformerConfig(**STEP), mesh,
                                     lr=STEP_LR)
            params, loss, _ = step(_params(STEP, 4), tokens, labels)
            _save(out, case, loss, params)
        mesh = T.build_transformer_mesh(world, 1, 2, 2, 1)
        for remat in (False, True):
            step = T.make_train_step(T.TransformerConfig(remat=remat, **STEP),
                                     mesh, lr=0.1)
            params, loss, _ = step(_params(STEP, 11), *_inputs(32, 4, 16))
            _save(out, f'remat_{remat}', loss, params)
        params = _params(DECREASE, 5)
        tok, _ = _inputs(16, 4, 8)
        step = T.make_train_step(T.TransformerConfig(**DECREASE), mesh,
                                 lr=0.2)
        losses = []
        for _ in range(10):
            params, loss, _ = step(params, tok, tok)
            losses.append(float(loss))
        out['decrease/losses'] = np.asarray(losses)
        tok, lab = _inputs(32, 4, 8, seed=7)
        step = T.make_train_step(T.TransformerConfig(**MULTI), mesh, lr=0.05)
        params, loss, _ = step(_params(MULTI, 0), tok, lab)
        _save(out, 'mesh_vs_multi', loss, params)
        step = T.make_train_step(
            T.TransformerConfig(dtype=torch.bfloat16, **BF16_RING), mesh,
            lr=STEP_LR)
        params, loss, _ = step(_params(BF16_RING, 4, torch.bfloat16),
                               *_inputs(32, 4, 16))
        _save(out, 'bf16_ring', loss, params)
        try:
            step(params, tok[:3], lab[:3])
            out['refusal/split'] = np.asarray('')
        except ValueError as e:
            out['refusal/split'] = np.asarray(f'{type(e).__name__}: {e}')
        for name, (kw, shape, _, _) in REFUSALS.items():
            try:
                T.make_train_step(T.TransformerConfig(**kw),
                                  T.build_transformer_mesh(world, *shape))
                out[f'refusal/{name}'] = np.asarray('')
            except (ValueError, NotPortedError) as e:
                out[f'refusal/{name}'] = np.asarray(
                    f'{type(e).__name__}: {e}')
        np.savez(os.path.join(tmp, f'rank{rank}.npz'), **out)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every multi-rank case, run once across 4 spawned gloo ranks."""
    tmp = str(tmp_path_factory.mktemp('lm_gloo4'))
    torch.multiprocessing.spawn(_rank_main, args=(N_RANKS, tmp),
                                nprocs=N_RANKS, join=True)
    return [dict(np.load(os.path.join(tmp, f'rank{r}.npz')))
            for r in range(N_RANKS)]


def _case(ranks, case):
    """Rank 0's loss and params of ``case``; every rank's are equal."""
    keys = [k for k in ranks[0] if k.startswith(f'{case}/')]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    n = len(case) + 1
    params = {k[n:]: ranks[0][k] for k in keys if k != f'{case}/loss'}
    return float(ranks[0][f'{case}/loss']), params


@pytest.mark.parametrize('case', list(MESHES))
def test_mesh_step_matches_jax(ranks, case):
    dp, sp = MESHES[case]
    loss, params = _case(ranks, case)
    tokens, labels = _inputs(32, STEP_BATCH, 16)
    want_loss, want = _jax_step(STEP, 4, dp, sp, tokens, labels, STEP_LR)
    np.testing.assert_allclose(loss, want_loss, rtol=MESH_LOSS_RTOL,
                               atol=MESH_LOSS_ATOL)
    assert params.keys() == want.keys()
    for k, w in params.items():
        np.testing.assert_allclose(w, want[k], rtol=MESH_PARAM_RTOL,
                                   atol=MESH_PARAM_ATOL, err_msg=k)


def test_mesh_step_matches_multi_step(ranks):
    """The port's mirror-contract guard: one multi step equals the
    (1, 2, 2, 1) mesh step from the same params."""
    loss, params = _case(ranks, 'mesh_vs_multi')
    tok, lab = _inputs(32, 4, 8, seed=7)
    new, want_loss = T.make_multi_train_step(
        T.TransformerConfig(**MULTI), 1, lr=0.05)(_params(MULTI, 0),
                                                  tok[None], lab[None])
    assert loss == pytest.approx(float(want_loss), rel=MULTI_LOSS_RTOL)
    want = _flat(new)
    for k, w in params.items():
        np.testing.assert_allclose(w, want[k], rtol=MULTI_PARAM_RTOL,
                                   atol=MULTI_PARAM_ATOL, err_msg=k)


def test_remat_matches_no_remat(ranks):
    loss0, p0 = _case(ranks, 'remat_False')
    loss1, p1 = _case(ranks, 'remat_True')
    assert loss1 == pytest.approx(loss0, rel=REMAT_RTOL)
    for k, w in p0.items():
        np.testing.assert_allclose(p1[k], w, rtol=REMAT_RTOL, err_msg=k)


def test_mesh_loss_decreases(ranks):
    losses = ranks[0]['decrease/losses']
    assert losses[-1] < losses[0] * 0.7, losses


def test_bf16_ring_step_matches_jax(ranks):
    """bf16 at sp = 2 and head dim 8: loss within rtol 1e-3 of JAX's bf16
    step, the updated params under the bf16 rule against JAX's f32 step on
    the same bf16 weights."""
    import jax.numpy as jnp
    from cxxnet_tpu.models import transformer as J
    loss, params = _case(ranks, 'bf16_ring')
    tokens, labels = _inputs(32, 4, 16)
    want_loss, want = _jax_step(BF16_RING, 4, 2, 2, tokens, labels, STEP_LR,
                                'bfloat16')
    assert loss == pytest.approx(want_loss, rel=BF16_LOSS_RTOL)
    step32 = J.make_train_step(_jax_cfg(BF16_RING), _jax_mesh(2, 2),
                               lr=STEP_LR)
    truth, _, _ = step32(_as_f32(_jax_params(BF16_RING, 4, 'bfloat16')),
                         jnp.asarray(tokens, jnp.int32),
                         jnp.asarray(labels, jnp.int32))
    _bf16_rule(params, want, _flat(truth))


@pytest.mark.parametrize('name', list(REFUSALS) + ['split'])
def test_mesh_step_refusals(ranks, name):
    _, _, exc, words = REFUSALS.get(name, (None, None, ValueError,
                                           'do not split over data=2'))
    for r in ranks:
        msg = str(r[f'refusal/{name}'])
        assert msg.startswith(exc.__name__) and words in msg, msg


# --- the train_lm.py twin ----------------------------------------------------

def test_train_lm_example_runs_and_loss_falls():
    """``--pp 1 --tp 1`` at dp 2, sp 2: 4 gloo ranks, 6 steps."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'cxxnet_tpu_torch', 'example',
                                      'train_lm.py'),
         '--pp', '1', '--tp', '1', '--steps', '6', '--seq', '32',
         '--batch', '4', '--device', 'cpu', '--generate', '4'],
        capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "mesh: {'pipe': 1, 'data': 2, 'seq': 2, 'model': 1}" in r.stdout
    losses = re.findall(r'loss ([0-9.]+)', r.stdout)
    assert len(losses) >= 2 and float(losses[-1]) < float(losses[0])
    assert len(re.findall(r'-> decoded \[', r.stdout)) == 2


# --ckpt_dir is ported (tests/test_torch_exact_resume.py runs it); beside
# a refused flag it writes nothing
@pytest.mark.parametrize('flag', [['--pp', '2'], ['--tp', '2'],
                                  ['--experts', '4'],
                                  ['--pp', '2', '--ckpt_dir', 'x']])
def test_train_lm_example_refuses_what_is_not_ported(flag):
    from cxxnet_tpu_torch.example import train_lm
    with pytest.raises(NotPortedError):
        train_lm.main(['--device', 'cpu', '--pp', '1', '--tp', '1', *flag])
