"""cxxnet_tpu_torch's flash attention and sequence parallelism against the
JAX package, on the CPU.

* The plain flash versions (the CPU leg of ``ops/flash.flash_attention``:
  forward, and the dq / dk,dv backward through its autograd function)
  against JAX's ``flash_attention`` (Pallas in interpret mode) and
  ``jax.grad`` at ``tests/test_pallas_kernels.py``'s shapes: atol 1e-5
  forward, 2e-5 gradients (f32 sums in another order).
* Ring and Ulysses attention across 4 gloo ranks (one
  ``torch.multiprocessing.spawn`` for every multi-rank case, a
  ``file://`` rendezvous under the test's tmp dir) against the JAX
  functions on 4 of conftest's 8 CPU devices at
  ``tests/test_sequence_parallel.py``'s shapes: rtol 2e-4, atol 2e-5;
  the ring gradient at rtol 2e-3, atol 2e-4 (JAX's own test's bounds).
* The bf16 backward: the plain forward, dq and dk/dv on bf16 tensors
  against JAX's kernel calls and ``jax.vjp`` on the same bf16 values,
  and a torch model of the bf16 kernels' rounding (p and ds split into
  hi + lo bf16) against the plain versions, each output within one bf16
  step element by element.
* The f32 kernels' numeric design on the TF32 tensor cores is modelled
  in ``tests/test_torch_tf32.py``.
* ``init_distributed``'s typed errors, a 1-rank world with its mesh,
  ``maybe_init_distributed``'s contract and the CLI's refusal of
  ``param_server=dist``.

JAX is imported inside the test functions only, so the spawned ranks
start without it.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import flash as F
from cxxnet_tpu_torch.parallel import distributed as D
from cxxnet_tpu_torch.parallel import sequence as S
from cxxnet_tpu_torch.parallel.mesh import build_mesh
from cxxnet_tpu_torch.runtime import faults
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

N_RANKS = 4
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-5
SEQ_RTOL, SEQ_ATOL = 2e-4, 2e-5
RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-3, 2e-4


def _rand(b, s, h, d, seed):
    """TestFlashAttention._rand's q, k, v."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def _make_qkv(b=2, s=32, h=4, d=16, seed=0):
    """test_sequence_parallel.make_qkv's q, k, v."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def _cos_loss_weights(shape):
    return np.cos(np.arange(int(np.prod(shape))).reshape(shape)
                  ).astype(np.float32)


# --- single-device flash attention ------------------------------------------

@pytest.mark.parametrize('causal', [False, True])
def test_flash_forward_matches_jax(causal):
    import jax.numpy as jnp
    from cxxnet_tpu.ops.pallas_kernels import flash_attention
    q, k, v = _rand(2, 32, 2, 16, 0)
    want = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=causal, block_q=16, block_k=16)
    got = F.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_gradients_match_jax(causal):
    import jax
    import jax.numpy as jnp
    from cxxnet_tpu.ops.pallas_kernels import flash_attention
    q, k, v = _rand(1, 24, 2, 8, 1)
    w = _cos_loss_weights(q.shape)

    def loss(q, k, v):
        return jnp.sum(flash_attention(q, k, v, causal=causal, block_q=8,
                                       block_k=8) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (F.flash_attention(*ts, causal=causal) * torch.from_numpy(w)).sum() \
        .backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL)


def test_flash_ragged_causal_matches_jax():
    import jax.numpy as jnp
    from cxxnet_tpu.ops.pallas_kernels import flash_attention
    q, k, v = _rand(1, 21, 2, 8, 2)
    want = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=True, block_q=8, block_k=8)
    got = F.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def test_flash_cross_attention_matches_jax():
    import jax.numpy as jnp
    from cxxnet_tpu.ops.pallas_kernels import flash_attention
    rng = np.random.RandomState(3)
    q = rng.randn(2, 12, 2, 8).astype(np.float32)
    k = rng.randn(2, 40, 2, 8).astype(np.float32)
    v = rng.randn(2, 40, 2, 8).astype(np.float32)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           block_q=8, block_k=8)
    got = F.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_lse_and_backward_kernels_match_jax(causal):
    """The three plain versions one by one against JAX's kernel calls
    (``_flash_fwd_impl`` and the vjp of ``_flash_bhsd``) on (bh, s, d),
    ragged s = 21: out and lse, then dq, dk, dv from the same cotangent."""
    import jax
    import jax.numpy as jnp
    from cxxnet_tpu.ops import pallas_kernels as pk
    rng = np.random.RandomState(5)
    q, k, v, g = (rng.randn(4, 21, 8).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j = pk._flash_fwd_impl(jq, jk, jv, causal, 8, 8)
    _, vjp = jax.vjp(lambda a, b, c: pk._flash_bhsd(a, b, c, causal, 8, 8),
                     jq, jk, jv)
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = F.flash_fwd(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=FWD_ATOL)
    delta = (tg * out).sum(-1)
    dq = F.flash_dq(tq, tk, tv, tg, lse, delta, causal)
    dk, dv = F.flash_dkv(tq, tk, tv, tg, lse, delta, causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)


# --- the bf16 backward ------------------------------------------------------

#: one bf16 step of a bf16 output: |got - ref| <= BF16_STEP |ref| +
#: BF16_FLOOR mean |ref|, element by element.  Both sides sum in f32 from
#: the same bf16 values and round each output once to bf16, so they differ
#: by at most one rounding step; the floor covers elements that cancel to
#: near zero, where the two f32 sum orders show
BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3

#: (bh, sq, sk, d, causal, JAX block): ragged s = 21 causal and not, a
#: cross shape, and one d = 64 shape
BF16_CASES = {'causal_s21': (4, 21, 21, 8, True, 8),
              's21': (4, 21, 21, 8, False, 8),
              'cross_21x40': (2, 21, 40, 8, False, 8),
              'causal_s48_d64': (2, 48, 48, 64, True, 16)}


def _bf16_excess(got, ref):
    """max over elements of |got - ref| / (one bf16 step of ref): at most
    1 where ``got`` is within one bf16 step everywhere."""
    g = torch.as_tensor(np.asarray(got, dtype=np.float32))
    r = torch.as_tensor(np.asarray(ref, dtype=np.float32))
    lim = BF16_STEP * r.abs() + BF16_FLOOR * r.abs().mean()
    return ((g - r).abs() / lim).max().item()


def _bf16_inputs(bh, sq, sk, d, seed):
    """numpy-seeded q, k, v and cotangent, rounded to bf16, as float32
    numpy arrays holding bf16 values exactly."""
    rng = np.random.RandomState(seed)
    shapes = ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))
    return [torch.from_numpy(rng.randn(*sh).astype(np.float32))
            .bfloat16().float().numpy() for sh in shapes]


def _jax_bf16(x):
    import jax.numpy as jnp
    return jnp.asarray(x).astype(jnp.bfloat16)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


@pytest.mark.parametrize('case', list(BF16_CASES))
def test_flash_bf16_backward_kernels_match_jax(case):
    """The plain bf16 forward, dq and dk/dv one by one against JAX's
    kernel calls (``_flash_fwd_impl`` and the backward rule of
    ``_flash_bhsd``, Pallas in interpret mode) on the same bf16 values:
    the backward from JAX's out and lse on both sides, so each kernel
    sees identical inputs.  Every output within one bf16 step."""
    from cxxnet_tpu.ops import pallas_kernels as pk
    bh, sq, sk, d, causal, blk = BF16_CASES[case]
    q, k, v, g = _bf16_inputs(bh, sq, sk, d, 11)
    jq, jk, jv, jg = (_jax_bf16(x) for x in (q, k, v, g))
    out_j, lse_j = pk._flash_fwd_impl(jq, jk, jv, causal, blk, blk)
    dq_j, dk_j, dv_j = pk._flash_bhsd_bwd(causal, blk, blk,
                                          (jq, jk, jv, out_j, lse_j), jg)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    out, lse = F.flash_fwd(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    assert _bf16_excess(_np32(out), _np32(out_j)) <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=FWD_ATOL)
    out_jt = torch.from_numpy(_np32(out_j)).bfloat16()
    lse_jt = torch.from_numpy(np.array(lse_j, dtype=np.float32))
    delta = (tg.float() * out_jt.float()).sum(-1)
    dq = F.flash_dq(tq, tk, tv, tg, lse_jt, delta, causal)
    dk, dv = F.flash_dkv(tq, tk, tv, tg, lse_jt, delta, causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.bfloat16
        assert _bf16_excess(_np32(got), _np32(want)) <= 1.0


@pytest.mark.parametrize('causal', [False, True])
def test_flash_bf16_autograd_matches_jax_vjp(causal):
    """``_FlashBHSD`` on bf16 tensors (the plain forward, then one dq and
    one dk/dv call from its own out and lse) against ``jax.vjp`` of
    ``_flash_bhsd`` on the same bf16 values: each gradient within one
    bf16 step."""
    import jax
    from cxxnet_tpu.ops import pallas_kernels as pk
    bh, sq, sk, d, _, blk = BF16_CASES['causal_s21']
    q, k, v, g = _bf16_inputs(bh, sq, sk, d, 12)
    _, vjp = jax.vjp(lambda a, b, c: pk._flash_bhsd(a, b, c, causal, blk,
                                                    blk),
                     *(_jax_bf16(x) for x in (q, k, v)))
    want = vjp(_jax_bf16(g))
    ts = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = F._FlashBHSD.apply(*ts, causal)
    out.backward(torch.from_numpy(g).bfloat16())
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        assert _bf16_excess(_np32(t.grad), _np32(w)) <= 1.0


def _split(x):
    """x as hi + lo bf16, each held as float32: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _bwd_model(q, k, v, do, lse, delta, causal, split=True):
    """What the bf16 backward kernels round, one slice at a time: S and dP
    from bf16 operands in f32 (exact products), p = 2^(s scale log2(e) -
    lse log2(e)), ds = p (dp - delta), then p and ds as hi + lo bf16 (or
    bf16 alone when not ``split``) times bf16 operands, summed in f32,
    and each output rounded once to bf16."""
    sq, d = q.shape[1:]
    scale = 1.0 / np.sqrt(d)
    log2e = 1.4426950408889634
    halves = _split if split else (lambda x: (x.bfloat16().float(),))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for i in range(q.shape[0]):
        qi, ki, vi, oi = (x[i].float() for x in (q, k, v, do))
        s = qi @ ki.T
        if causal:
            s = s.masked_fill(~torch.ones_like(s, dtype=torch.bool).tril(),
                              -np.inf)
        p = torch.exp2(s * (scale * log2e) - lse[i][:, None] * log2e)
        ds = p * (oi @ vi.T - delta[i][:, None])
        dq[i] = (sum(h @ ki for h in halves(ds)) * scale).bfloat16()
        dv[i] = sum(h.T @ oi for h in halves(p)).bfloat16()
        dk[i] = (sum(h.T @ qi for h in halves(ds)) * scale).bfloat16()
    return dq, dk, dv


@pytest.mark.parametrize('case', list(BF16_CASES))
def test_flash_bf16_split_rounding_model(case):
    """The numeric design of the bf16 backward kernels, checked before any
    card time: a torch model of what they round (``_bwd_model``) is
    within one bf16 step of the plain dq, dk and dv on the same inputs,
    and the same model without the lo halves is not."""
    bh, sq, sk, d, causal, _ = BF16_CASES[case]
    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in _bf16_inputs(bh, sq, sk, d, 13))
    out, lse = F.flash_fwd(q, k, v, causal)
    delta = (g.float() * out.float()).sum(-1)
    want = (F.flash_dq(q, k, v, g, lse, delta, causal),
            *F.flash_dkv(q, k, v, g, lse, delta, causal))
    got = _bwd_model(q, k, v, g, lse, delta, causal)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert _bf16_excess(_np32(a), _np32(b)) <= 1.0, name
    # the bound tells the split from bf16 p and ds alone, which miss it
    coarse = _bwd_model(q, k, v, g, lse, delta, causal, split=False)
    assert max(_bf16_excess(_np32(a), _np32(b))
               for a, b in zip(coarse, want)) > 1.0


def test_flash_rejects_causal_with_unequal_lengths():
    q, k, v = (torch.zeros(1, n, 2, 8) for n in (4, 6, 6))
    with pytest.raises(ValueError, match='equal length'):
        F.flash_attention(q, k, v, causal=True)


def test_attn_use_flash_gate_mirrors_jax():
    """The JAX gate's cases (test_pallas_kernels.py:236-253), with the
    device in place of ``_interpret``: ``auto`` engages on a CUDA device
    at >= 4 GiB of dense f32 scores, never on the CPU; on/off force."""
    assert not F.attn_use_flash(16384, batch=2, heads=8, device='cpu')
    assert F.attn_use_flash(16384, batch=2, heads=8, device='cuda')
    assert F.attn_use_flash(4096, batch=64, heads=16, device='cuda')
    assert not F.attn_use_flash(4096, batch=2, heads=8, device='cuda')
    assert not F.attn_use_flash(16384, device='cuda')
    # the slice path's shape sits exactly on the budget, >= engages
    assert F.attn_use_flash(8192, batch=1, heads=16, device='cuda')
    assert not F.attn_use_flash(4096, batch=1, heads=16, device='cuda')
    assert F.attn_use_flash(64, mode='on')
    assert F.attn_use_flash(64, mode='1', device='cpu')
    assert not F.attn_use_flash(16384, batch=2, heads=8, mode='off',
                                device='cuda')
    assert not F.attn_use_flash(16384, batch=2, heads=8, mode='0',
                                device='cuda')


# --- 4 gloo ranks against JAX's 4 CPU devices --------------------------------

#: the multi-rank cases: name -> (fn, qkv kwargs, causal, mode, loss)
CASES = {
    'ring': ('ring', dict(), False, None, None),
    'ring_causal': ('ring', dict(), True, None, None),
    'ring_grad': ('ring', dict(s=16), False, None, 'square'),
    'ulysses_dense': ('ulysses', dict(h=8), False, 'auto', None),
    'ulysses_dense_causal': ('ulysses', dict(h=8), True, 'auto', None),
    'ulysses_flash': ('ulysses', dict(h=8), False, 'on', None),
    'ulysses_flash_causal': ('ulysses', dict(h=8), True, 'on', 'cos'),
}


def _rank_main(rank, world, tmp):
    """One gloo rank: every case on this rank's sequence shard; the
    output and gradient shards go to ``tmp/rank<r>.npz``."""
    D.init_distributed(f'file://{tmp}/rendezvous', world, rank,
                       timeout=60, device='cpu')
    try:
        mesh = build_mesh()
        assert mesh.mesh_dim_names == ('data', 'model')
        assert tuple(mesh.shape) == (world, 1)
        saved = {}
        for name, (fn, kw, causal, mode, loss) in CASES.items():
            qkv = _make_qkv(**kw)
            sl = qkv[0].shape[1] // world
            ts = [torch.from_numpy(x[:, rank * sl:(rank + 1) * sl].copy())
                  .requires_grad_() for x in qkv]
            if fn == 'ring':
                out = S.ring_attention(*ts, mesh, 'data', causal=causal)
            else:
                out = S.ulysses_attention(*ts, mesh, 'data', causal=causal,
                                          mode=mode)
            saved[name] = out.detach().numpy()
            if loss is not None:
                # this rank's part of the global loss: the collectives'
                # backwards carry the other ranks' parts in
                if loss == 'square':
                    (out ** 2).sum().backward()
                else:
                    w = _cos_loss_weights(qkv[0].shape)[
                        :, rank * sl:(rank + 1) * sl]
                    (out * torch.from_numpy(w.copy())).sum().backward()
                for tag, t in zip('qkv', ts):
                    saved[f'{name}_d{tag}'] = t.grad.numpy()
        try:
            S.ulysses_attention(*(torch.zeros(1, 2, 6, 4),) * 3, mesh)
            saved['heads_error'] = np.array('')
        except ValueError as e:
            saved['heads_error'] = np.array(str(e))
        np.savez(os.path.join(tmp, f'rank{rank}.npz'), **saved)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every multi-rank case, run once across 4 spawned gloo ranks; the
    shards concatenated back along the sequence."""
    tmp = str(tmp_path_factory.mktemp('gloo4'))
    torch.multiprocessing.spawn(_rank_main, args=(N_RANKS, tmp),
                                nprocs=N_RANKS, join=True)
    shards = [np.load(os.path.join(tmp, f'rank{r}.npz'))
              for r in range(N_RANKS)]
    out = {key: np.concatenate([s[key] for s in shards], axis=1)
           for key in shards[0].files if key != 'heads_error'}
    out['heads_error'] = [str(s['heads_error']) for s in shards]
    return out


def _jax_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:N_RANKS]), ('data',))


@pytest.mark.parametrize('name', ['ring', 'ring_causal'])
def test_ring_attention_matches_jax(ranks, name):
    import jax.numpy as jnp
    from cxxnet_tpu.parallel.sequence import ring_attention
    _, kw, causal, _, _ = CASES[name]
    want = ring_attention(*(jnp.asarray(x) for x in _make_qkv(**kw)),
                          _jax_mesh(), causal=causal)
    np.testing.assert_allclose(ranks[name], np.asarray(want),
                               rtol=SEQ_RTOL, atol=SEQ_ATOL)


def test_ring_attention_gradient_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from cxxnet_tpu.parallel.sequence import ring_attention
    mesh = _jax_mesh()
    q, k, v = (jnp.asarray(x) for x in _make_qkv(s=16))

    def loss(q, k, v):
        return jnp.sum(ring_attention(q, k, v, mesh) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(ranks['ring_grad'],
                               np.asarray(ring_attention(q, k, v, mesh)),
                               rtol=SEQ_RTOL, atol=SEQ_ATOL)
    for tag, g in zip('qkv', want):
        np.testing.assert_allclose(ranks[f'ring_grad_d{tag}'], np.asarray(g),
                                   rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL)


@pytest.mark.parametrize('name', ['ulysses_dense', 'ulysses_dense_causal',
                                  'ulysses_flash', 'ulysses_flash_causal'])
def test_ulysses_attention_matches_jax(ranks, name, monkeypatch):
    """``mode='auto'`` stays dense on the CPU, as JAX's gate does off a
    TPU; ``mode='on'`` runs the plain flash versions, against JAX with
    ``CXXNET_PALLAS=1`` (its flash kernel in interpret mode)."""
    import jax.numpy as jnp
    from cxxnet_tpu.parallel.sequence import ulysses_attention
    _, kw, causal, mode, _ = CASES[name]
    if mode == 'on':
        monkeypatch.setenv('CXXNET_PALLAS', '1')
    else:
        monkeypatch.delenv('CXXNET_PALLAS', raising=False)
    want = ulysses_attention(*(jnp.asarray(x) for x in _make_qkv(**kw)),
                             _jax_mesh(), causal=causal)
    np.testing.assert_allclose(ranks[name], np.asarray(want),
                               rtol=SEQ_RTOL, atol=SEQ_ATOL)


def test_ulysses_flash_gradient_matches_single_device_jax(ranks):
    """The gradient through both all-to-alls and the plain flash backward
    against ``jax.grad`` of the single-device reference."""
    import jax
    import jax.numpy as jnp
    from cxxnet_tpu.parallel.sequence import attention_reference
    _, kw, causal, _, _ = CASES['ulysses_flash_causal']
    qkv = [jnp.asarray(x) for x in _make_qkv(**kw)]
    w = _cos_loss_weights(qkv[0].shape)
    want = jax.grad(lambda q, k, v: jnp.sum(
        attention_reference(q, k, v, causal=causal) * w),
        argnums=(0, 1, 2))(*qkv)
    for tag, g in zip('qkv', want):
        np.testing.assert_allclose(ranks[f'ulysses_flash_causal_d{tag}'],
                                   np.asarray(g), rtol=RING_GRAD_RTOL,
                                   atol=RING_GRAD_ATOL)


def test_ulysses_refuses_heads_that_do_not_divide_the_axis(ranks):
    assert ranks['heads_error'] == \
        ['ulysses: heads must divide the mesh axis'] * N_RANKS


# --- the world, the mesh and the CLI ----------------------------------------

@pytest.mark.parametrize('nproc,rank', [(0, 0), (4, 4), (4, -1)])
def test_init_distributed_rejects_a_bad_world(nproc, rank, tmp_path):
    with pytest.raises(faults.DistInitError):
        D.init_distributed(f'file://{tmp_path}/rdv', nproc, rank,
                           device='cpu')
    assert not torch.distributed.is_initialized()


def test_one_rank_world_mesh_and_sequence_attention(tmp_path):
    """A 1-rank gloo world, its (1, 1) mesh, and both strategies at n = 1
    against the reference; ``fresh=True`` rebuilds the world."""
    D.init_distributed(f'file://{tmp_path}/rdv0', 1, 0, device='cpu')
    try:
        assert torch.distributed.get_backend() == 'gloo'
        D.init_distributed(f'file://{tmp_path}/rdv1', 1, 0, device='cpu',
                           fresh=True)
        mesh = build_mesh()
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ('data', 'model')
        q, k, v = (torch.from_numpy(x) for x in _make_qkv(h=2, s=12))
        ref = S.attention_reference(q, k, v, causal=True)
        for got in (S.ring_attention(q, k, v, mesh, causal=True),
                    S.ulysses_attention(q, k, v, mesh, causal=True),
                    S.ulysses_attention(q, k, v, mesh, causal=True,
                                        mode='on')):
            torch.testing.assert_close(got, ref, rtol=SEQ_RTOL,
                                       atol=SEQ_ATOL)
        with pytest.raises(ValueError, match='must divide'):
            build_mesh(tp=2)
    finally:
        torch.distributed.destroy_process_group()


def test_maybe_init_distributed_env_contract(monkeypatch, capsys):
    for var in ('CXXNET_COORDINATOR', 'COORDINATOR_ADDRESS',
                'CXXNET_NUM_WORKER', 'PS_RANK'):
        monkeypatch.delenv(var, raising=False)
    assert not D.maybe_init_distributed([('param_server', 'local')])
    # param_server=dist with a multi-process world needs a coordinator
    with pytest.raises(faults.DistInitError, match='coordinator'):
        D.maybe_init_distributed([('param_server', 'dist'),
                                  ('dist_num_worker', '2')])
    # a coordinator with a 1-process world says so and stays solo
    monkeypatch.setenv('CXXNET_COORDINATOR', '127.0.0.1:1')
    assert not D.maybe_init_distributed([])
    assert 'running single-process' in capsys.readouterr().err
    # a bad rank is a typed error before any connect
    monkeypatch.setenv('CXXNET_NUM_WORKER', '2')
    monkeypatch.setenv('PS_RANK', '5')
    with pytest.raises(faults.DistInitError, match='out of range'):
        D.maybe_init_distributed([('dev', 'cpu')])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize('var', ['CXXNET_NUM_WORKER', 'PS_RANK'])
def test_malformed_world_env_is_a_typed_error(tmp_path, monkeypatch, var):
    """The CLI's refusal and ``maybe_init_distributed`` read the world
    through one parser, which names the malformed variable."""
    from cxxnet_tpu_torch.main import LearnTask
    for name in ('COORDINATOR_ADDRESS', 'CXXNET_NUM_WORKER', 'PS_RANK'):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv('CXXNET_COORDINATOR', '127.0.0.1:1')
    monkeypatch.setenv(var, 'two')
    with pytest.raises(faults.DistInitError, match=var):
        D.maybe_init_distributed([('dev', 'cpu')])
    conf = tmp_path / 'x.conf'
    conf.write_text('task = train\n')
    with pytest.raises(faults.DistInitError, match=var):
        LearnTask().run([str(conf), 'dev=cpu'])
    # nothing asks for a world: the environment's counts are not read
    monkeypatch.delenv('CXXNET_COORDINATOR')
    assert D.requested_world([('param_server', 'local')]) is None


def test_retry_policy_retries_then_gives_up():
    calls = []
    policy = faults.RetryPolicy(max_attempts=3, sleep=calls.append)

    def flaky():
        calls.append('try')
        if calls.count('try') < 3:
            raise OSError('not yet')
        return 'up'
    assert policy.call(flaky, 'op') == 'up'
    assert calls.count('try') == 3 and len(calls) == 5   # two sleeps
    assert policy.delays('op') == policy.delays('op')
    with pytest.raises(faults.RetryError) as e:
        faults.RetryPolicy(max_attempts=2, sleep=lambda _t: None).call(
            lambda: (_ for _ in ()).throw(TimeoutError('down')), 'x')
    assert e.value.attempts == 2
    assert isinstance(e.value.__cause__, TimeoutError)


@pytest.mark.parametrize('key,val', [('param_server', 'dist'),
                                     ('dist_num_worker', '2'),
                                     ('dist_worker_rank', '1')])
def test_cli_refuses_a_distributed_run(key, val):
    """The JAX CLI joins a multi-process world for these
    (``maybe_init_distributed``); the port refuses them instead of
    training solo on every host."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.runtime.faults import NotPortedError
    with pytest.raises(NotPortedError, match='queue A item 9'):
        LearnTask().set_param(key, val)


def test_cli_keeps_solo_distributed_keys():
    from cxxnet_tpu_torch.main import LearnTask
    task = LearnTask()
    for key, val in (('param_server', 'local'), ('dist_num_worker', '1'),
                     ('dist_worker_rank', '0')):
        task.set_param(key, val)
    assert ('param_server', 'local') in task.cfg


def test_cli_refuses_a_world_from_the_environment(tmp_path, monkeypatch):
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.runtime.faults import NotPortedError
    conf = tmp_path / 'x.conf'
    conf.write_text('task = train\n')
    monkeypatch.setenv('CXXNET_COORDINATOR', '127.0.0.1:1')
    monkeypatch.setenv('CXXNET_NUM_WORKER', '2')
    with pytest.raises(NotPortedError, match='queue A item 9'):
        LearnTask().run([str(conf), 'dev=cpu'])
