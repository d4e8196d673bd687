"""JAX's random stream in the port against ``jax.random``, on the CPU.

The port draws initial weights and train-time noise as the JAX package
does: ``PRNGKey(seed)``, ``fold_in`` for init (``0xC0FFEE``, then the
layer) and for each step (``1 + sample_counter * 131 + round``, then the
layer), and ``jax.random.uniform`` / ``normal`` in the draw's own shape
and dtype (``utils/prng.py``, ``ops/threefry.py`` with its plain version
here).  Checked:

* ``fold_in`` and the float32 and bfloat16 uniforms bitwise, over
  several keys, shapes (odd n included) and ranges;
* the normals within ``NORMAL_TOL``: ``|port - jax| <= 2^-21 max(|jax|,
  1)``, i.e. a few float32 ulps.  The uniforms under them are bitwise;
  XLA's ``erf_inv`` polynomial runs in torch, whose ``log1p`` and Horner
  steps round apart from XLA's (measured: at most 3 ulps over 200000
  draws; ``torch.erfinv`` would be ~90 ulps off in the tails);
* ``tests/fixtures/torch_jax_draws.json``, the draws the card tests and
  ``chip_smoke.py`` hold the kernel to (the card has no JAX), equal to
  JAX's;
* a ``Trainer`` built from one conf and ``seed`` in both packages,
  without ``params_from_jax``: uniform-drawn weights (xavier, prelu's
  random slope) bitwise, gaussian and kaiming ones within ``NORMAL_TOL``
  of their scale;
* the draws of a train step through the layers, bitwise in float32 and
  bfloat16: dropout masks (and outputs), insanity relu, insanity max
  pooling and prelu's slope noise;
* three updates of a dropout-0.5 MLP from the same seed in both
  packages (rounds 0 and 1): parameters within rtol 1e-5, atol 1e-6 (f32
  sums in other orders; one wrong mask would move a column by its whole
  update).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cxxnet_tpu.layers as jl
import cxxnet_tpu_torch.layers as tl
from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.ops import threefry
from cxxnet_tpu_torch.ops.kernels import launch_counts
from cxxnet_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'torch_jax_draws.json')
NORMAL_TOL = 2.0 ** -21
SEEDS = [0, 1, 42, 2 ** 31 + 7, -3]
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16),
          'float16': (torch.float16, jnp.float16)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jkey(key):
    return jnp.asarray(np.asarray(key, np.uint32))


def _normal_close(got, want, scale=1.0):
    got, want = _f32(got), _f32(want)
    lim = NORMAL_TOL * scale * np.maximum(np.abs(want) / scale, 1.0)
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


# --- the draws ----------------------------------------------------------------

@pytest.mark.parametrize('seed', SEEDS)
def test_fold_in_matches_jax(seed):
    key = prng.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 0xC0FFEE, 1 + 5 * 131 + 2, 2 ** 32 - 1):
        got = prng.fold_in(key, data)
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got,
                                      np.asarray(jax.random.fold_in(jkey,
                                                                    data)))
    # fold_in of a fold_in: the per-layer keys of a step
    np.testing.assert_array_equal(
        prng.fold_in(prng.fold_in(key, 132), 5),
        np.asarray(jax.random.fold_in(jax.random.fold_in(jkey, 132), 5)))


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', [(1,), (7,), (4099,), (3, 5, 7, 2),
                                   (64, 1000)],
                         ids=['n1', 'n7', 'n4099', 'nhwc', 'mat'])
@pytest.mark.parametrize('lo,hi', [(0.0, 1.0), (-0.0123, 0.0123),
                                   (0.37, 5.1)],
                         ids=['unit', 'xavier', 'offset'])
def test_uniforms_match_jax_bitwise(dtype, shape, lo, hi):
    tdt, jdt = DTYPES[dtype]
    for seed in SEEDS[:3]:
        key = prng.fold_in(prng.prng_key(seed), 3)
        want = jax.random.uniform(_jkey(key), shape, jdt, lo, hi)
        got = threefry.uniform(key, shape, tdt, 'cpu', lo, hi)
        assert got.dtype == tdt and tuple(got.shape) == shape
        np.testing.assert_array_equal(_f32(got).view(np.uint32),
                                      _f32(want).view(np.uint32))
        if dtype == 'float32':    # the numpy version decode sampling uses
            np.testing.assert_array_equal(
                prng.uniform(key, shape, lo, hi).view(np.uint32),
                _f32(want).view(np.uint32))


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('pkeep', [0.5, 0.7, 0.9])
def test_keep_mask_is_jax_s_compare(dtype, pkeep):
    tdt, jdt = DTYPES[dtype]
    key = prng.fold_in(prng.prng_key(11), 2)
    want = (jax.random.uniform(_jkey(key), (33, 65), jdt) < pkeep).astype(
        jdt)
    got = threefry.keep_mask(key, (33, 65), tdt, 'cpu', pkeep)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize('seed', SEEDS)
def test_normals_match_jax_within_a_few_ulps(seed):
    key = prng.fold_in(prng.prng_key(seed), 9)
    for shape in [(1,), (7,), (20000,), (5, 5, 3, 16)]:
        want = jax.random.normal(_jkey(key), shape, jnp.float32)
        got = threefry.normal(key, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        _normal_close(got, want)
    # the uniforms under them are JAX's bitwise
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    assert lo == prng.normal_lo(torch.float32)
    np.testing.assert_array_equal(
        _f32(threefry.uniform(key, (999,), minval=lo, maxval=1.0)),
        _f32(jax.random.uniform(_jkey(key), (999,), jnp.float32, lo, 1.0)))


def test_erf_inv_edges_are_xla_s():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999, 0.999999])
    got = prng.erf_inv(x)
    want = jax.scipy.special.erfinv(jnp.asarray(x.numpy()))
    assert torch.isinf(got[:2]).all() and (got[:2].sign() == x[:2]).all()
    _normal_close(got[2:], want[2:])


def _pinned_draws():
    """The card's reference draws: uniforms in f32, bf16 and f16 over the
    unit range, normals in f32, as JAX computes them."""
    out = []
    for seed, fold in ((20261016, 0xC0FFEE), (0, 1), (7, 131 * 3 + 2)):
        key = prng.fold_in(prng.prng_key(seed), fold)
        for dtype, kind in (('float32', 'uniform'), ('bfloat16', 'uniform'),
                            ('float16', 'uniform'), ('float32', 'normal')):
            jdt = DTYPES[dtype][1]
            fn = jax.random.uniform if kind == 'uniform' else \
                jax.random.normal
            vals = _f32(fn(_jkey(key), (37,), jdt))
            out.append({'seed': seed, 'fold': fold, 'dtype': dtype,
                        'kind': kind, 'values': [float(v) for v in vals]})
    return out


def test_pinned_fixture_holds_jax_s_draws():
    """tests/fixtures/torch_jax_draws.json (read by tests/test_torch_cuda.py
    and chip_smoke.py on the card, which has no JAX) holds JAX's draws,
    and the port's plain versions reproduce them."""
    with open(FIXTURE) as f:
        pinned = json.load(f)
    assert pinned['normal_tol'] == NORMAL_TOL
    assert pinned['draws'] == _pinned_draws()
    for d in pinned['draws']:
        key = prng.fold_in(prng.prng_key(d['seed']), d['fold'])
        dt = DTYPES[d['dtype']][0]
        fn = threefry.uniform if d['kind'] == 'uniform' else threefry.normal
        got = fn(key, (len(d['values']),), dt)
        if d['kind'] == 'uniform':
            np.testing.assert_array_equal(_f32(got), np.float32(d['values']))
        else:
            _normal_close(got, np.float32(d['values']))


def test_cpu_draws_launch_no_kernel():
    before = launch_counts()
    threefry.uniform(prng.prng_key(3), (100,))
    threefry.keep_mask(prng.prng_key(3), (100,), torch.bfloat16, 'cpu', 0.5)
    assert launch_counts() == before


# --- a trainer's initial weights ----------------------------------------------

INIT_CONF = """
netconfig=start
layer[0->1] = conv:c1
  nchannel = 6
  kernel_size = 3
  init_sigma = 0.05
layer[1->2] = conv:c2
  nchannel = 8
  ngroup = 2
  kernel_size = 3
  random_type = xavier
layer[2->3] = flatten
layer[3->4] = fullc:f1
  nhidden = 24
  random_type = kaiming
layer[4->4] = prelu
  random_slope = 1
  init_slope = 0.3
layer[4->5] = fullc:f2
  nhidden = 10
  random_type = xavier
  init_uniform = 0.2
layer[5->5] = softmax
netconfig=end
input_shape = 4,9,9
batch_size = 2
"""


@pytest.mark.parametrize('seed', [0, 20261016])
def test_trainer_initial_weights_are_jax_s(seed):
    """Both packages' trainers from one conf and seed, no weights carried
    across: xavier and prelu's random slope bitwise, gaussian (c1) and
    kaiming (f1) within NORMAL_TOL of their scale."""
    jnet = JNet(dev='cpu', cfg=INIT_CONF + f'seed = {seed}\n')
    jnet.init_model()
    tnet = Net(dev='cpu', cfg=INIT_CONF + f'seed = {seed}\n')
    tnet.init_model()
    jp, tp = jnet._trainer.params, tnet.trainer.params
    assert sorted(jp) == sorted(tp)
    for lk in jp:
        assert sorted(jp[lk]) == sorted(tp[lk])
        for fk in jp[lk]:
            got, want = tp[lk][fk], jp[lk][fk]
            assert tuple(got.shape) == tuple(want.shape)
            layer = tnet.trainer.net.layers[int(lk)]
            drawn = fk == 'wmat' or layer.type_name == 'prelu'
            gaussian = drawn and layer.param.random_type in (0, 2) \
                and layer.type_name != 'prelu'
            if gaussian:
                _normal_close(got, want, float(np.abs(_f32(want)).max()))
            else:
                np.testing.assert_array_equal(_f32(got), _f32(want),
                                              err_msg=f'{lk}/{fk}')


# --- the draws of a train step ------------------------------------------------

def _step_key(seed, sample_counter, round_):
    return 1 + sample_counter * 131 + round_


def _both_train(type_name, pairs, x, layer_index, seed, t, params=None,
                round_=0):
    """One layer of each package at train time on the same input, with
    the trainer's key of step t: the outputs as float32 numpy."""
    fold = _step_key(seed, t, round_)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    key = prng.fold_in(prng.prng_key(seed), fold)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    spec = (jl.NodeSpec(1, 1, x.shape[1]) if x.ndim == 2 else
            jl.NodeSpec(x.shape[3], x.shape[1], x.shape[2]))
    tspec = (tl.NodeSpec(1, 1, x.shape[1]) if x.ndim == 2 else
             tl.NodeSpec(x.shape[3], x.shape[1], x.shape[2]))
    jlayer = jl.create_layer(jl.get_layer_type(type_name))
    tlayer = tl.create_layer(tl.get_layer_type(type_name))
    for k, v in pairs:
        jlayer.set_param(k, v)
        tlayer.set_param(k, v)
    jlayer.infer_shapes([spec])
    tlayer.infer_shapes([tspec])
    params = params or {}
    jout = jlayer.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [x], jl.ForwardContext(is_train=True, rng=jkey,
                                                 layer_index=layer_index,
                                                 round=round_))[0]
    tout = tlayer.forward({k: torch.from_numpy(np.asarray(v))
                           for k, v in params.items()},
                          [torch.from_numpy(np.array(_f32(x))).to(
                              DTYPES[str(x.dtype)][0])],
                          tl.ForwardContext(is_train=True, rng_key=key,
                                            layer_index=layer_index,
                                            round=round_))[0]
    assert str(tout.dtype).split('.')[-1] == str(jout.dtype)
    return _f32(tout), _f32(jout)


def _x(shape, dtype, seed=5, negative=False):
    v = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if negative:
        v = -np.abs(v) - 0.1
    return jnp.asarray(v).astype(DTYPES[dtype][1])


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape,threshold', [((16, 300), '0.5'),
                                             ((2, 5, 5, 8), '0.3')],
                         ids=['fc', 'nhwc'])
@pytest.mark.parametrize('t', [0, 3])
def test_dropout_of_step_t_is_jax_s_bitwise(dtype, shape, threshold, t):
    x = _x(shape, dtype)
    got, want = _both_train('dropout', [('threshold', threshold)], x, 13,
                            20261016, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got != 0, want != 0)    # the mask


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_insanity_noise_is_jax_s_bitwise(dtype):
    x = _x((8, 3, 3, 5), dtype, negative=True)
    got, want = _both_train('insanity', [('lb', '3'), ('ub', '8')], x, 4,
                            7, 2, round_=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_insanity_pooling_jitter_is_jax_s_bitwise(dtype):
    x = _x((2, 9, 9, 3), dtype)
    got, want = _both_train('insanity_max_pooling',
                            [('kernel_size', '3'), ('stride', '2'),
                             ('keep', '0.5')], x, 5, 3, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_prelu_slope_noise_is_jax_s_bitwise(dtype):
    x = _x((6, 40), dtype, negative=True)
    slope = np.linspace(0.05, 0.6, 40).astype(np.float32)
    got, want = _both_train('prelu', [('random', '0.5')], x, 2, 11, 4,
                            {'bias': slope})
    np.testing.assert_array_equal(got, want)


# --- three updates of a dropout MLP -------------------------------------------

MLP_CONF = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 64
  init_sigma = 0.1
layer[1->1] = relu
layer[1->1] = dropout
  threshold = 0.5
layer[1->2] = fullc:fc2
  nhidden = 32
  random_type = xavier
layer[2->2] = relu
layer[2->2] = dropout
  threshold = 0.5
layer[2->3] = fullc:fc3
  nhidden = 10
  random_type = kaiming
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,40
batch_size = 8
eta = 0.1
momentum = 0.9
wd = 0.0001
seed = 20261016
"""
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6


def test_dropout_mlp_three_updates_match_jax():
    rng = np.random.RandomState(3)
    batches = [(rng.randn(8, 1, 1, 40).astype(np.float32),
                rng.randint(0, 10, 8).astype(np.float32)) for _ in range(3)]
    nets = []
    for cls in (JNet, Net):
        net = cls(dev='cpu', cfg=MLP_CONF)
        net.init_model()
        for i, (x, y) in enumerate(batches):
            net.start_round(0 if i < 2 else 1)
            net.update(x, y)
        nets.append(net)
    jp, tp = nets[0]._trainer.params, nets[1].trainer.params
    for lk in jp:
        for fk in jp[lk]:
            np.testing.assert_allclose(_f32(tp[lk][fk]), _f32(jp[lk][fk]),
                                       rtol=MLP_RTOL, atol=MLP_ATOL,
                                       err_msg=f'{lk}/{fk}')
    # the masks matter: with another seed the port lands elsewhere
    other = Net(dev='cpu', cfg=MLP_CONF.replace('seed = 20261016',
                                                'seed = 5'))
    other.init_model()
    assert not np.allclose(_f32(other.trainer.params['0']['wmat']),
                           _f32(jp['0']['wmat']), atol=1e-3)
