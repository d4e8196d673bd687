"""``compute_type=float16`` in ``cxxnet_tpu_torch`` against the JAX package,
on the CPU (the kernels' plain versions), on the same numpy inputs.

(a) JAX's f16 random stream: ``jax.random.uniform(key, shape,
float16, lo, hi)`` bitwise, odd counts and counts off any block size
included, subnormal bounds too; the f16 dropout mask and normal draw; and
the dropout masks of an f16 net's train step, which drop the same hidden
units in both packages.  (b) Three updates of the narrow AlexNet and the
narrow GoogLeNet at f16 under ``auto``, ``use_pallas=1`` and
``use_pallas=0 fuse=0``, and one step of a narrow Inception-BN
(``batch_norm`` in f16), held by the 1.5x rule of the bf16 tests
(``tests/test_torch_mixed_precision.py``): each weight's change lies no
further from JAX's f32 run than 1.5x JAX's own f16 run does, plus 2^-8
of the change.  The kernel legs are held against JAX's f16 run with its
Pallas kernels forced on (interpret mode), the stock leg against JAX's
stock composition at f16.  (c) ``PredictEngine`` at f16 compute under
``serve.dtype=f32|bf16|int8`` against JAX's engine, by the same rule.
(d) The CLI's ``task=train`` on the MNIST conv conf at f16.

There is no loss scaling in either package: the nets here stay well
inside f16's range (65504), and the rule compares what both compute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.serve.engine import PredictEngine as JEngine
from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.interop import opt_state_from_jax, params_from_jax
from cxxnet_tpu_torch.ops import threefry
from cxxnet_tpu_torch.serve import PredictEngine
from cxxnet_tpu_torch.utils import prng

from test_torch_layer_zoo import _narrow
from test_torch_tasks import _read_model
from test_torch_train import NARROW_TRAIN, _write_idx
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 1.5x rule of (b) and (c)
RULE_FACTOR, RULE_FLOOR = 1.5, 2.0 ** -8


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


# --- (a) the f16 random stream ------------------------------------------------

# (lo, hi): the unit range, a shifted one, the normal's, one whose draws
# are f16 subnormals (a sum that rounds to zero from below is -0 in both),
# and one near f16's largest values
BOUNDS = [(0.0, 1.0), (-0.3, 0.7), (prng.normal_lo(torch.float16), 1.0),
          (-2e-5, 3e-5), (-2e4, 3e4)]


@pytest.mark.parametrize('n', [1, 7, 37, 255, 257, 4099, 65537])
def test_f16_uniform_is_jax_s_bitwise(n):
    jkey = jax.random.fold_in(jax.random.PRNGKey(20261026), n)
    key = prng.fold_in(prng.prng_key(20261026), n)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for lo, hi in BOUNDS:
        want = jax.random.uniform(jkey, (n,), jnp.float16, lo, hi)
        got = threefry.uniform(key, (n,), torch.float16, 'cpu', lo, hi)
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=str((lo, hi)))
    mask = threefry.keep_mask(key, (n,), torch.float16, 'cpu', 0.7)
    want = np.asarray(jax.random.uniform(jkey, (n,), jnp.float16)
                      < np.float16(0.7))
    np.testing.assert_array_equal(mask.numpy() == 1, want)
    normal = threefry.normal(key, (n,), torch.float16)
    np.testing.assert_array_equal(
        _bits(normal.numpy()), _bits(jax.random.normal(jkey, (n,),
                                                       jnp.float16)))


DROPOUT_MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 64
  init_sigma = 0.1
layer[1->2] = relu
layer[2->3] = dropout
  threshold = 0.5
layer[3->4] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[4->4] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 8
eta = 0.5
compute_type = float16
"""


def test_dropout_masks_through_an_f16_net_are_jax_s():
    """One f16 train step of an MLP with dropout 0.5 in both packages from
    the same weights: a hidden unit dropped for every row leaves fc2's row
    of weights unmoved, and the unmoved rows are the same in both (the
    masks are JAX's f16 draws, bitwise); the moved weights agree to one
    f16 step of the change's scale."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 1, 1, 16).astype(np.float32)
    y = rng.randint(0, 4, 8)
    jnet = JNet(dev='cpu', cfg=DROPOUT_MLP)
    jnet.init_model()
    params0 = _host(jnet._trainer.params)
    jnet.update(x, y)
    net = Net(dev='cpu', cfg=DROPOUT_MLP)
    net.init_model()
    net.trainer.params = params_from_jax(params0)
    net.update(x, y)
    jmoved = np.asarray(jnet._trainer.params['3']['wmat']) \
        - params0['3']['wmat']
    tmoved = net.trainer.params['3']['wmat'].detach().numpy() \
        - params0['3']['wmat']
    jstill = np.all(jmoved == 0, axis=1)
    assert 0 < jstill.sum() < len(jstill)
    np.testing.assert_array_equal(np.all(tmoved == 0, axis=1), jstill)
    assert np.abs(tmoved - jmoved).max() <= 2.0 ** -9 * np.abs(jmoved).max()


# --- (b) narrow nets, three updates at f16 ------------------------------------

def _batches(n=3, seed=0, hw=67, bs=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bs, 3, hw, hw).astype(np.float32),
             rng.randint(0, 10, bs)) for _ in range(n)]


NETS = {'alexnet': (NARROW_TRAIN, dict(hw=67, bs=4)),
        'googlenet': (_narrow('googlenet'), dict(hw=32, bs=8))}
#: the port's legs: net params, and the JAX f16 run each is held against
MODES = {'auto': ('', 'pallas'),
         'use_pallas_1': ('use_pallas = 1\n', 'pallas'),
         'stock': ('use_pallas = 0\nfuse = 0\n', 'stock')}


@pytest.fixture(scope='module')
def jax_f16_runs():
    """Per net: the start (params, optimizer state after one f32 step on
    other data) and the params after 3 updates of JAX runs: f32 and f16
    with its Pallas kernels forced on (interpret mode), and f16 on its
    stock composition (``use_pallas=0 fuse=0``)."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, (cfg, shape) in NETS.items():
            runs = {}
            start = None
            for leg, dt, extra in (('float32', 'float32', ''),
                                   ('pallas', 'float16', ''),
                                   ('stock', 'float16', 'fuse = 0\n')):
                mp.setenv('CXXNET_PALLAS', '0' if extra else '1')
                net = JNet(dev='cpu', cfg=cfg + f'compute_type = {dt}\n'
                           + extra)
                net.init_model()
                tr = net._trainer
                if start is None:
                    params0 = _host(tr.params)
                    x, y = _batches(1, seed=9, **shape)[0]
                    net.update(x, y)
                    start = (params0, _host(tr.opt_state))
                tr.params = jax.tree.map(jnp.asarray, start[0])
                tr.opt_state = jax.tree.map(jnp.asarray, start[1])
                for x, y in _batches(**shape):
                    net.update(x, y)
                runs[leg] = _host(tr.params)
            out[name] = (start, runs)
        return out
    finally:
        mp.undo()


def rule_distances(got, f32, jf16, start):
    """Per weight: (port's distance, JAX f16's distance, floor), the
    distances between each run's weight change and JAX's f32 run's."""
    out = {}
    for k, fields in f32.items():
        for f, v in fields.items():
            moved = v - start[k][f]
            d_port = float(np.abs((got[k][f] - start[k][f]) - moved).max())
            d_jax = float(np.abs((jf16[k][f] - start[k][f]) - moved).max())
            out[f'{k}/{f}'] = (d_port, d_jax,
                               RULE_FLOOR * float(np.abs(moved).max()))
    return out


def _assert_rule(dist, tag):
    print(f'{tag} (port, jax f16, floor) from jax f32:', dist)
    bad = {k: d for k, d in dist.items()
           if not d[0] <= RULE_FACTOR * d[1] + d[2]}
    assert not bad, bad


def _weights(tr):
    got = {k: {f: v.detach().numpy() for f, v in fs.items()}
           for k, fs in tr.params.items()}
    assert all(v.dtype == np.float32 for fs in got.values()
               for v in fs.values())
    return got


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('name', list(NETS))
def test_narrow_twins_train_in_f16_by_the_rule(jax_f16_runs, name, mode):
    (params0, state), runs = jax_f16_runs[name]
    cfg, shape = NETS[name]
    extra, jleg = MODES[mode]
    net = Net(dev='cpu', cfg=cfg + 'compute_type = float16\n' + extra)
    net.init_model()
    tr = net.trainer
    assert tr.dtype == torch.float16
    tr.params = params_from_jax(params0)
    tr.opt_state = opt_state_from_jax(state)
    for x, y in _batches(**shape):
        net.update(x, y)
    assert np.isfinite(float(tr.last_loss))
    _assert_rule(rule_distances(_weights(tr), runs['float32'], runs[jleg],
                                params0), f'{name}[{mode}]')


def test_inception_bn_step_in_f16_by_the_rule():
    """One step of a narrow Inception-BN (conv + batch_norm + relu units,
    ``batch_norm``'s statistics and formula in f32, its output f16) under
    ``auto``, against JAX's f32 and f16 steps from the same weights."""
    cfg = _narrow('inception_bn')
    x, y = _batches(1, seed=4, hw=32, bs=8)[0]
    runs, params0 = {}, None
    for dt in ('float32', 'float16'):
        jnet = JNet(dev='cpu', cfg=cfg + f'compute_type = {dt}\n')
        jnet.init_model()
        if params0 is None:
            params0 = _host(jnet._trainer.params)
        jnet._trainer.params = jax.tree.map(jnp.asarray, params0)
        jnet.update(x, y)
        runs[dt] = _host(jnet._trainer.params)
    net = Net(dev='cpu', cfg=cfg + 'compute_type = float16\n')
    net.init_model()
    net.trainer.params = params_from_jax(params0)
    net.update(x, y)
    assert np.isfinite(float(net.trainer.last_loss))
    _assert_rule(rule_distances(_weights(net.trainer), runs['float32'],
                                runs['float16'], params0), 'inception_bn')


# --- (c) PredictEngine at f16 compute ------------------------------------------

@pytest.mark.parametrize('serve_dtype', ['f32', 'bf16', 'int8'])
def test_predict_engine_at_f16_compute_matches_jax(serve_dtype):
    """The port's engine at ``compute_type=float16`` (weights stored in
    the serving tier, expanded to f32, cast by the layers) against JAX's
    engine on the same weights: the scores lie no further from JAX's f32
    compute engine than 1.5x JAX's f16 compute engine's, plus 2^-8 of the
    largest score."""
    cfg = NARROW_TRAIN + 'inference_only = 1\n'
    jnets = {}
    for dt in ('float32', 'float16'):
        jnets[dt] = JNet(dev='cpu', cfg=cfg + f'compute_type = {dt}\n')
        jnets[dt].init_model()
    params = _host(jnets['float32']._trainer.params)
    jnets['float16']._trainer.params = jax.tree.map(jnp.asarray, params)
    data = np.random.RandomState(42).randn(6, 3, 67, 67).astype(np.float32)
    want = {dt: np.asarray(JEngine(n._trainer, (1, 4, 8),
                                   dtype=serve_dtype).predict_scores(data))
            for dt, n in jnets.items()}
    net = Net(dev='cpu', cfg=cfg + 'compute_type = float16\n')
    net.init_model()
    net.trainer.params = params_from_jax(params)
    eng = PredictEngine(net.trainer, (1, 4, 8), dtype=serve_dtype)
    got = eng.predict_scores(data)
    assert got.dtype == np.float32 and got.shape == (6, 10)
    d_port = float(np.abs(got - want['float32']).max())
    d_jax = float(np.abs(want['float16'] - want['float32']).max())
    floor = RULE_FLOOR * float(np.abs(want['float32']).max())
    print(f'serve {serve_dtype}: port {d_port}, jax f16 {d_jax}, floor '
          f'{floor}')
    assert d_port <= RULE_FACTOR * d_jax + floor
    assert eng.compile_count <= 2


# --- (d) the CLI ----------------------------------------------------------------

def test_cli_trains_the_mnist_conv_conf_in_f16(tmp_path, capsys,
                                                monkeypatch):
    """``task=train`` from the MNIST conv conf with ``compute_type =
    float16`` added, in both packages' CLIs from the same seed: three
    rounds learn the synthetic digits (test error at most 5 % in round
    3), each round's metrics lie within 1 % (error) and 1e-3 relative
    (logloss) of JAX's f16 run, and the model file holds finite f32
    weights."""
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu_torch.main import main as tmain
    os.makedirs(tmp_path / 'data')
    _write_idx(str(tmp_path / 'data'), 'train', 600, 1)
    _write_idx(str(tmp_path / 'data'), 't10k', 230, 2)
    with open(os.path.join(ROOT, 'example', 'MNIST', 'MNIST_CONV.conf')) as f:
        conf = f.read().replace('threshold = 0.5', 'threshold = 0.0')
    (tmp_path / 'conv.conf').write_text(conf + 'metric = logloss\n'
                                        'compute_type = float16\n')
    monkeypatch.chdir(tmp_path)
    args = ['conv.conf', 'dev=cpu', 'num_round=3', 'max_round=3',
            'save_model=1', 'silent=1']
    lines = {}
    for pkg, fn in (('j', jmain), ('t', tmain)):
        capsys.readouterr()
        assert fn(args + [f'model_dir=m{pkg}']) == 0
        lines[pkg] = [{t.split(':')[0]: float(t.split(':')[1])
                       for t in ln.split('\t')[1:]}
                      for ln in capsys.readouterr().err.splitlines()
                      if ln.startswith('[')]
    assert len(lines['t']) == len(lines['j']) == 3
    for got, want in zip(lines['t'], lines['j']):
        for key, w in want.items():
            if key.endswith('error'):
                assert abs(got[key] - w) <= 0.01, (key, got, want)
            elif key.endswith('logloss'):
                assert got[key] == pytest.approx(w, rel=1e-3), (key, got)
    assert lines['t'][-1]['test-error'] <= 0.05, lines['t']
    _, epoch, raw = _read_model(tmp_path / 'mt' / '0003.model')
    assert epoch == 18          # 3 rounds of 6 batches
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for fs in raw.values() for v in fs.values())
