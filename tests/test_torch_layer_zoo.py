"""The layer zoo and the reference's Inception nets in ``cxxnet_tpu_torch``
against the JAX package, on the CPU, on the same numpy inputs.

* every layer type the port gained (bias, xelu, insanity, prelu, split,
  concat / ch_concat with 2-4 inputs, maxout, fixconn, batch_norm,
  relu_max_pooling, insanity_max_pooling, pairtest): forward and
  gradients (``jax.vjp`` against ``torch.autograd``, the same cotangents)
  at rtol 1e-5 / atol 1e-6.  batch_norm normalizes with the batch's own
  statistics at eval too.  The random layers draw other numbers than
  JAX's, so their eval paths match JAX and their train paths are held
  to their range and to the seed;
* the node shapes of ``example/ImageNet/GoogLeNet.conf`` and
  ``Inception-BN.conf`` (built, not run) equal JAX ``Net.node_specs``,
  and the port's ``models/builders.py`` emits JAX's conf text;
* the dispatch sets: the conv+relu pairs, the solo convs of ``fuse=1``
  and the sibling groups equal JAX ``Net``'s, on both confs and on
  AlexNet (32 pairs and nine sibling groups of three on GoogLeNet);
* three updates of a narrow GoogLeNet and a narrow Inception-BN against
  JAX ``Net(dev='cpu')``, with ``fuse_siblings`` on and off, at
  ``tests/test_torch_train.py``'s tolerances (parameters rtol 1e-4 /
  atol 1e-6, each weight change within ``DW_TOL`` of its largest value,
  train-metric lines 1e-4 relative); JAX with its Pallas kernels forced
  on (interpret mode), the port with its kernels forced on and in
  ``auto``;
* ``create_layer`` builds every type JAX registers, and the three
  options that were left of ROADMAP.md queue A item 2 run as JAX's;
* the CLI on a small MNIST conf with a ``fixconn`` layer (its sparse
  weight file written here) and a ``pairtest-fullc-fullc`` layer prints
  the JAX CLI's per-round eval lines, to ``test_cli_matches_jax_cli``'s
  bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cxxnet_tpu.layers as jl
import cxxnet_tpu.models.builders as jb
import cxxnet_tpu_torch.layers as tl
import cxxnet_tpu_torch.models.builders as tb
from cxxnet_tpu.nnet.net import Net as JGraph
from cxxnet_tpu.nnet.net_config import NetConfig as JNetConfig
from cxxnet_tpu.utils import config as jconfig
from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.interop import opt_state_from_jax, params_from_jax
from cxxnet_tpu_torch.nnet.net import Net as TGraph
from cxxnet_tpu_torch.nnet.net_config import NetConfig as TNetConfig
from cxxnet_tpu_torch.ops.kernels import launch_counts
from cxxnet_tpu_torch.utils import prng

from test_torch_train import DW_TOL, _metric_numbers, _write_idx
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _spec(lib, x):
    return (lib.NodeSpec(1, 1, x.shape[1]) if x.ndim == 2 else
            lib.NodeSpec(x.shape[3], x.shape[1], x.shape[2]))


def _layer(lib, type_name, pairs, xs, n_out=None):
    layer = lib.create_layer(lib.get_layer_type(type_name))
    for k, v in pairs:
        layer.set_param(k, v)
    if n_out is not None:
        layer.set_num_outputs(n_out)
    return layer, layer.infer_shapes([_spec(lib, x) for x in xs])


def _both(type_name, pairs, xs, params=None, is_train=False, round_=0,
          n_out=None):
    """One layer of each package on the same inputs and params: outputs,
    then the gradients of inputs and params under the same seeded
    cotangents, held at RTOL / ATOL.  Returns the port's outputs."""
    params = params or {}
    jlayer, jspecs = _layer(jl, type_name, pairs, xs, n_out)
    tlayer, tspecs = _layer(tl, type_name, pairs, xs, n_out)
    assert tspecs == jspecs
    jctx = jl.ForwardContext(is_train=is_train, round=round_)
    jout, vjp = jax.vjp(
        lambda p, v: jlayer.forward(p, v, jctx),
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x) for x in xs])
    cots = [_np(90 + i, o.shape) for i, o in enumerate(jout)]
    jdp, jdx = vjp([jnp.asarray(c) for c in cots])
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    tout = tlayer.forward(tp, tx, tl.ForwardContext(is_train=is_train,
                                                    round=round_))
    leaves = list(tp.values()) + tx
    grads = torch.autograd.grad(tout, leaves,
                                [torch.from_numpy(c) for c in cots],
                                allow_unused=True)
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL)
    want = [jdp[k] for k in tp] + list(jdx)
    for name, g, w in zip(list(tp) + [f'x{i}' for i in range(len(xs))],
                          grads, want):
        got = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    return [t.detach() for t in tout]


# --- (a) every newly ported layer type ---------------------------------------

def test_bias_matches_jax():
    _both('bias', [], [_np(1, (4, 7))], {'bias': _np(2, (7,))})


@pytest.mark.parametrize('is_train', [False, True], ids=['eval', 'train'])
def test_xelu_matches_jax(is_train):
    _both('xelu', [('b', '3')], [_np(3, (2, 3, 3, 5))], is_train=is_train)


@pytest.mark.parametrize('round_', [0, 3, 9], ids=['r0', 'r3', 'r9'])
def test_insanity_eval_and_its_anneal_match_jax(round_):
    # eval divides the negative side by the bounds' midpoint; calm_start /
    # calm_end anneal both bounds toward it by the round
    _both('insanity', [('lb', '3'), ('ub', '8'), ('calm_start', '2'),
                       ('calm_end', '6')], [_np(4, (3, 11))],
          round_=round_)


def test_insanity_train_draws_in_its_bounds_from_the_seed():
    x = torch.from_numpy(-np.abs(_np(5, (64, 50))) - 0.1)
    layer, _ = _layer(tl, 'insanity', [('lb', '3'), ('ub', '8')], [x.numpy()])
    outs = [layer.forward({}, [x], tl.ForwardContext(
        is_train=True, rng_key=prng.prng_key(seed), layer_index=2))[0]
        for seed in (7, 7, 8)]
    slope = x / outs[0]                       # the drawn denominators
    assert slope.min() >= 3.0 - 1e-5 and slope.max() <= 8.0 + 1e-5
    assert slope.std() > 1.0                  # spread over [3, 8]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    pos = torch.from_numpy(np.abs(_np(6, (4, 5))))
    assert torch.equal(layer.forward({}, [pos], tl.ForwardContext(
        is_train=True, rng_key=prng.prng_key(1), layer_index=2))[0],
        pos)


@pytest.mark.parametrize('shape', [(4, 6), (2, 3, 3, 6)], ids=['mat', 'img'])
@pytest.mark.parametrize('is_train', [False, True], ids=['eval', 'train'])
def test_prelu_matches_jax(shape, is_train):
    slope = np.linspace(-0.2, 1.3, shape[-1]).astype(np.float32)
    _both('prelu', [('init_slope', '0.3')], [_np(7, shape)],
          {'bias': slope}, is_train=is_train)


def test_prelu_slope_noise_stays_clipped_and_follows_the_seed():
    x = torch.from_numpy(-np.abs(_np(8, (32, 40))) - 0.1)
    layer, _ = _layer(tl, 'prelu', [('random', '0.5')], [x.numpy()])
    p = {'bias': torch.full((40,), 0.4)}
    outs = [layer.forward(p, [x], tl.ForwardContext(
        is_train=True, rng_key=prng.prng_key(seed), layer_index=1))[0]
        for seed in (3, 3, 4)]
    mask = outs[0] / x
    assert mask.min() >= 0.4 * 0.5 - 1e-6 and mask.max() <= 0.4 * 1.5 + 1e-6
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    _both('prelu', [('random', '0.5')], [x.numpy()],
          {'bias': p['bias'].numpy()})        # eval: no noise


@pytest.mark.parametrize('n_out', [2, 3])
def test_split_copies_and_sums_its_gradients_like_jax(n_out):
    x = _np(9, (2, 3, 3, 4))
    outs = _both('split', [], [x], n_out=n_out)
    assert len(outs) == n_out
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), x)


@pytest.mark.parametrize('n', [2, 3, 4])
@pytest.mark.parametrize('kind,layout', [('concat', 'mat'),
                                         ('concat', 'img'),
                                         ('ch_concat', 'img')])
def test_concat_matches_jax(kind, layout, n):
    if layout == 'mat':
        xs = [_np(10 + i, (3, 2 + i)) for i in range(n)]
    elif kind == 'concat':
        xs = [_np(10 + i, (2, 3, 1 + i, 4)) for i in range(n)]
    else:
        xs = [_np(10 + i, (2, 3, 4, 1 + i)) for i in range(n)]
    outs = _both(kind, [], xs)
    axis = 1 if layout == 'mat' else (2 if kind == 'concat' else 3)
    np.testing.assert_array_equal(outs[0].numpy(),
                                  np.concatenate(xs, axis=axis))


@pytest.mark.parametrize('shape', [(4, 12), (2, 3, 3, 12)], ids=['mat', 'img'])
def test_maxout_matches_jax(shape):
    x = _np(14, shape)
    x[..., 1] = x[..., 0]                     # a tie splits its gradient
    _both('maxout', [('ngroup', '3')], [x])


def test_fixconn_matches_jax(tmp_path):
    path = tmp_path / 'w.txt'
    path.write_text('5 7 4\n0 0 0.5\n2 6 -1.25\n4 3 2\n2 1 0.1\n')
    _both('fixconn', [('nhidden', '5'), ('fixconn_weight', str(path))],
          [_np(15, (3, 7))])


@pytest.mark.parametrize('shape', [(6, 7), (4, 3, 3, 5)], ids=['mat', 'img'])
@pytest.mark.parametrize('is_train', [True, False], ids=['train', 'eval'])
def test_batch_norm_matches_jax_with_batch_statistics(shape, is_train):
    x = _np(16, shape, 2.0) + 1.5
    params = {'wmat': _np(17, shape[-1:]), 'bias': _np(18, shape[-1:])}
    out = _both('batch_norm', [], [x], params, is_train=is_train)[0]
    # the eval forward normalizes with this batch's statistics too
    axes = tuple(range(x.ndim - 1))
    xhat = (x - x.mean(axes)) / np.sqrt(x.var(axes) + 1e-10)
    np.testing.assert_allclose(out.numpy(),
                               xhat * params['wmat'] + params['bias'],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('hw,k,stride,pad', [(8, 3, 2, 0), (7, 3, 2, 0),
                                             (6, 3, 1, 1)],
                         ids=['ragged8', 'exact7', 'pad1'])
def test_relu_max_pooling_matches_jax(hw, k, stride, pad):
    _both('relu_max_pooling', [('kernel_size', str(k)),
                               ('stride', str(stride)), ('pad', str(pad))],
          [_np(19, (2, hw, hw, 3))])


@pytest.mark.parametrize('keep', ['1.0', '0.6'])
def test_insanity_max_pooling_eval_matches_jax(keep):
    _both('insanity_max_pooling', [('kernel_size', '3'), ('stride', '2'),
                                   ('keep', keep)],
          [_np(20, (2, 9, 9, 3))])


def test_insanity_max_pooling_train_jitters_from_the_seed():
    xn = _np(21, (2, 9, 9, 3))
    x = torch.from_numpy(xn)
    layer, _ = _layer(tl, 'insanity_max_pooling',
                      [('kernel_size', '3'), ('stride', '2'),
                       ('keep', '0.5')], [xn])
    outs = [layer.forward({}, [x], tl.ForwardContext(
        is_train=True, rng_key=prng.prng_key(seed), layer_index=5))[0]
        for seed in (2, 2, 3)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    # every output is an input value within one pixel of its window
    exact = _both('insanity_max_pooling', [('kernel_size', '3'),
                                           ('stride', '2')], [xn])[0]
    assert np.isin(outs[0].numpy(), xn).all()
    wide = _both('max_pooling', [('kernel_size', '5'), ('stride', '2'),
                                 ('pad', '1')], [xn])[0]
    assert (outs[0] <= wide).all() and not torch.equal(outs[0], exact)
    kept = layer.forward({}, [x], tl.ForwardContext(is_train=False))[0]
    assert torch.equal(kept, exact)


def test_pairtest_runs_master_and_slave_and_reports_a_mismatch(capsys):
    x = _np(22, (3, 6))
    params = {'wmat': _np(23, (6, 4)), 'bias': _np(24, (4,))}
    out = _both('pairtest-fullc-fullc', [('nhidden', '4')], [x], params)[0]
    np.testing.assert_allclose(out.numpy(), x @ params['wmat']
                               + params['bias'], rtol=1e-5, atol=1e-6)
    assert 'MISMATCH' not in capsys.readouterr().out
    # the slave alone takes another slope: reported; the output is the
    # master's
    layer, _ = _layer(tl, 'pairtest-xelu-xelu', [('slave:b', '2')], [x])
    got = layer.forward({}, [torch.from_numpy(x)],
                        tl.ForwardContext(is_train=False))[0]
    np.testing.assert_array_equal(got.numpy(), np.where(x > 0, x, x / 5))
    assert 'PairTest MISMATCH pairtest-xelu-xelu out[0]' in \
        capsys.readouterr().out
    assert layer.param_fields == () and layer.type_id == 19 * 1024 + 19


# --- (b), (c), (d): the full confs, the builders, the dispatch sets ----------

CONFS = {'googlenet': 'example/ImageNet/GoogLeNet.conf',
         'inception_bn': 'example/ImageNet/Inception-BN.conf',
         'alexnet': 'example/ImageNet/ImageNet.conf',
         'alexnet_port': 'cxxnet_tpu_torch/example/ImageNet.conf'}


def _graphs(name, *extra):
    with open(os.path.join(ROOT, CONFS[name])) as f:
        pairs = [p for p in jconfig.parse_config_string(f.read())
                 if p[0] not in ('dev', 'compute_type')] + list(extra)
    jc, tc = JNetConfig(), TNetConfig()
    jc.configure(pairs)
    tc.configure(pairs)
    return JGraph(jc), TGraph(tc)


@pytest.mark.parametrize('name', ['googlenet', 'inception_bn'])
def test_full_confs_build_with_jax_node_shapes(name):
    jn, tn = _graphs(name)
    assert len(tn.node_specs) == len(jn.node_specs)
    for t, j in zip(tn.node_specs, jn.node_specs):
        assert (t.c, t.y, t.x) == (j.c, j.y, j.x)


@pytest.mark.parametrize('builder', ['mlp_conf', 'lenet_conf',
                                     'alexnet_conf', 'inception_bn_conf',
                                     'googlenet_conf', 'vgg16_conf'])
def test_builders_emit_the_jax_conf_text(builder):
    assert getattr(tb, builder)() == getattr(jb, builder)()
    if builder == 'googlenet_conf':
        assert tb.googlenet_conf(10, aux_heads=False) == \
            jb.googlenet_conf(10, aux_heads=False)


@pytest.mark.parametrize('fuse', ['auto', '1', '0'])
@pytest.mark.parametrize('name', list(CONFS))
def test_dispatch_sets_match_jax(name, fuse):
    # the layers the conv kernel gets are JAX's: sibling 1x1 convs are
    # grouped and left out of the conv+relu pairing (net.py:554)
    jn, tn = _graphs(name, ('fuse', fuse))
    assert tn._convact_pairs == jn._convact_pairs
    assert tn._convact_solo == jn._convact_solo
    assert tn._sibling_groups == jn._sibling_groups
    groups = {tuple(g) for g in tn._sibling_groups.values()}
    if name == 'googlenet' and fuse == 'auto':
        assert len(tn._convact_pairs) == 32
        assert sorted(len(g) for g in groups) == [3] * 9
    if name == 'alexnet_port' and fuse == 'auto':
        assert len(tn._convact_pairs) == 5 and not groups


def test_fuse_siblings_0_pairs_the_siblings_like_jax():
    jn, tn = _graphs('googlenet', ('fuse_siblings', '0'))
    assert tn._sibling_groups == jn._sibling_groups == {}
    assert tn._convact_pairs == jn._convact_pairs
    assert len(tn._convact_pairs) == 59


# --- (e) three updates of the narrow Inception nets --------------------------

def _narrow(kind):
    """Two inception modules (ch_concat of 4 and of 3 inputs), one aux
    head at grad_scale 0.3, a handful of channels, 32 x 32 input,
    dropout 0, built with the JAX package's builder helpers."""
    lines = ['netconfig=start']
    if kind == 'googlenet':
        top = jb._conv_relu(lines, '0', 'conv1', 8, 7, stride=2, pad=3)
        jb._pool(lines, top, 'pool1', 'max_pooling', 3, 2)
        lines += ['layer[pool1->pool1] = lrn', '  local_size = 5']
        top = jb._conv_relu(lines, 'pool1', 'conv2r', 8, 1)
        top = jb._conv_relu(lines, top, 'conv2', 12, 3, pad=1)
        lines += [f'layer[{top}->{top}] = lrn', '  local_size = 5']
        jb._pool(lines, top, 'pool2', 'max_pooling', 3, 2)
        top = jb._inception_v1(lines, 'pool2', 'in3a', 4, 4, 6, 2, 3, 3)
        aux = top
        b3 = jb._conv_relu(lines, jb._conv_relu(lines, top, 'in3b_3x3r', 4,
                                                1), 'in3b_3x3', 6, 3, pad=1)
        b5 = jb._conv_relu(lines, jb._conv_relu(lines, top, 'in3b_5x5r', 2,
                                                1), 'in3b_5x5', 4, 5, pad=2)
        bp = jb._pool(lines, top, 'in3b_pool', 'max_pooling', 3, 1, pad=1)
        bpp = jb._conv_relu(lines, bp, 'in3b_proj', 4, 1)
        lines.append(f'layer[{b3},{b5},{bpp}->in3b_out] = ch_concat')
    else:
        top = jb._conv_bn_relu(lines, '0', 'conv1', 'conv1', 8, 7, stride=2,
                               pad=3)
        jb._pool(lines, top, 'pool1', 'max_pooling', 3, 2)
        top = jb._conv_bn_relu(lines, 'pool1', 'conv2r', 'conv2r', 8, 1)
        top = jb._conv_bn_relu(lines, top, 'conv2', 'conv2', 12, 3, pad=1)
        jb._pool(lines, top, 'pool2', 'max_pooling', 3, 2)
        top = jb._inception(lines, 'pool2', 'in3a', 4, 4, 4, 4, 6, 3)
        aux = top
        jb._inception(lines, top, 'in3b', 0, 4, 6, 4, 6, 0,
                      pool='max_pooling', stride=2)
    jb._pool(lines, aux, 'aux1_pool', 'avg_pooling', 2, 2)
    jb._conv_relu(lines, 'aux1_pool', 'aux1_conv', 8, 1)
    lines += ['layer[aux1_conv->aux1_flat] = flatten',
              'layer[aux1_flat->aux1_fc1] = fullc:aux1_fc1', '  nhidden = 16',
              'layer[aux1_fc1->aux1_fc1] = relu',
              'layer[aux1_fc1->aux1_fc1] = dropout', '  threshold = 0.0',
              'layer[aux1_fc1->aux1_fc2] = fullc:aux1_fc2', '  nhidden = 10',
              'layer[aux1_fc2->aux1_fc2] = softmax', '  grad_scale = 0.3']
    hw = 4 if kind == 'googlenet' else 2
    jb._pool(lines, 'in3b_out', 'gpool', 'avg_pooling', hw, 1)
    lines += ['layer[gpool->flat] = flatten',
              'layer[flat->flat] = dropout', '  threshold = 0.0',
              'layer[flat->fc] = fullc:fc1', '  nhidden = 10',
              'layer[fc->fc] = softmax', 'netconfig=end',
              'input_shape = 3,32,32']
    return '\n'.join(lines) + """
wmat:lr = 0.01
bias:lr = 0.02
momentum = 0.9
wmat:wd = 0.0005
bias:wd = 0
metric = error
metric = logloss
batch_size = 8
random_type = xavier
"""


def _batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 3, 32, 32).astype(np.float32),
             rng.randint(0, 10, 8)) for _ in range(n)]


@pytest.fixture(scope='module')
def jax_runs():
    """JAX runs with the Pallas kernels forced on, keyed by (net,
    fuse_siblings): the start (params, optimizer state after one step on
    other data, counters) and, after 3 updates, the params, the
    train-metric line and the counters."""
    def host(tree):
        return jax.tree.map(np.asarray, tree)
    mp = pytest.MonkeyPatch()
    mp.setenv('CXXNET_PALLAS', '1')
    try:
        out = {}
        for kind in ('googlenet', 'inception_bn'):
            for sib in ('1', '0'):
                net = JNet(dev='cpu', cfg=_narrow(kind)
                           + f'fuse_siblings = {sib}\n')
                net.init_model()
                tr = net._trainer
                params0 = host(tr.params)
                x, y = _batches(1, seed=9)[0]
                net.update(x, y)
                tr.evaluate(None, 'train')
                tr.params = jax.tree.map(jnp.asarray, params0)
                start = (params0, host(tr.opt_state), tr.sample_counter,
                         tr.epoch_counter)
                for x, y in _batches():
                    net.update(x, y)
                out[kind, sib] = (start, host(tr.params),
                                  tr.evaluate(None, 'train'),
                                  (tr.sample_counter, tr.epoch_counter))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize('mode', ['1', 'auto'])
@pytest.mark.parametrize('sib', ['1', '0'], ids=['siblings', 'no_siblings'])
@pytest.mark.parametrize('kind', ['googlenet', 'inception_bn'])
def test_narrow_inception_training_matches_jax(jax_runs, kind, sib, mode):
    (params0, state, sc0, ec0), want, line, counters = jax_runs[kind, sib]
    net = Net(dev='cpu', cfg=_narrow(kind) + f'fuse_siblings = {sib}\n'
              f'use_pallas = {mode}\n')
    net.init_model()
    tr = net.trainer
    groups = {tuple(g) for g in tr.net._sibling_groups.values()}
    assert sorted(len(g) for g in groups) == ([] if sib == '0' else [2, 3])
    tr.params = params_from_jax(params0)
    tr.opt_state = opt_state_from_jax(state)
    tr.sample_counter, tr.epoch_counter = sc0, ec0
    before = launch_counts()
    for x, y in _batches():
        net.update(x, y)
    assert launch_counts() == before              # CPU: plain versions
    assert (tr.sample_counter, tr.epoch_counter) == counters
    gaps = {}
    for k, d in want.items():
        for f, v in d.items():
            got = tr.params[k][f].detach().numpy()
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-6,
                                       err_msg=f'layer {k} {f}')
            moved = v - params0[k][f]
            gaps[f'{k}/{f}'] = float(np.abs((got - params0[k][f]) - moved)
                                     .max() / np.abs(moved).max())
    assert max(gaps.values()) <= DW_TOL, gaps
    got = tr.evaluate(None, 'train')
    assert [t.split(':')[0] for t in got.split('\t')] == \
        [t.split(':')[0] for t in line.split('\t')]
    np.testing.assert_allclose(_metric_numbers(got), _metric_numbers(line),
                               rtol=1e-4)


@pytest.mark.parametrize('kind', ['googlenet', 'inception_bn'])
def test_replayed_decisions_match_the_kernel_step_on_narrow_nets(kind):
    # chip_smoke.py's stock comparison at a narrow size: the kernel step
    # records its relu and max-pooling choices, the stock composition
    # (use_pallas=0 fuse=0) replays them from the same weights and batch.
    # A relu whose input is exactly 0 (an all-zero patch into a conv with
    # a zero bias, common after a narrow sibling conv) keeps the tie's
    # half gradient in both legs, as JAX's jnp.maximum does
    from cxxnet_tpu_torch.layers import Decisions
    x, y = _batches(1)[0]
    decisions = Decisions()

    def step(extra=''):
        net = Net(dev='cpu', cfg=_narrow(kind) + extra)
        net.init_model()
        net.trainer.decisions = decisions
        tr = net.trainer
        w0 = {(k, f): v.detach().clone()
              for k, d in tr.params.items() for f, v in d.items()}
        net.update(x, y)
        return {key: tr.params[key[0]][key[1]].detach() - w
                for key, w in w0.items()}

    kernel = step('fuse = 1\n' if kind == 'inception_bn' else '')
    decisions.replay = True
    stock = step('use_pallas = 0\nfuse = 0\n')
    gaps = {key: float((stock[key] - d).abs().max() / d.abs().max())
            for key, d in kernel.items() if d.abs().max() > 0}
    assert max(gaps.values()) <= 1e-4, gaps


def test_replayed_relu_splits_the_gradient_where_the_recorded_input_was_0():
    # the recording relu (jnp.maximum's tie) passed half the gradient
    # where its input was exactly 0; the replaying one does so there
    # whatever its own input, and passes none where the recorded input
    # was < 0 even if its own is exactly 0 (an x - mean of batch_norm
    # can round to 0 in one composition and not in the other)
    ref = torch.tensor([[1.0, 0.0, -1e-6, 0.0, -2.0]])
    x = torch.tensor([[2.0, 3e-7, 0.0, 0.0, -1.0]], requires_grad=True)
    decisions = tl.Decisions()
    decisions.inputs[2] = ref
    decisions.replay = True
    layer = tl.create_layer(tl.get_layer_type('relu'))
    out = layer.forward({}, [x], tl.ForwardContext(
        is_train=True, decisions=decisions).for_layer(2))[0]
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[1.0, 0.5, 0.0, 0.5,
                                                    0.0]])
    np.testing.assert_allclose(out.detach().numpy(),
                               [[2.0, 1.5e-7, 0.0, 0.0, 0.0]])


def test_batch_norm_params_carry_across_and_score_alike_at_eval():
    # interop carries batch_norm's (C,) slope and shift; the eval forward
    # of both packages normalizes each batch with its own statistics
    text = _narrow('inception_bn')
    jnet = JNet(dev='cpu', cfg=text)
    jnet.init_model()
    params = {k: {f: np.asarray(v) for f, v in d.items()}
              for k, d in jnet._trainer.params.items()}
    rng = np.random.RandomState(3)
    for d in params.values():
        for f in d:
            d[f] = d[f] + rng.randn(*d[f].shape).astype(np.float32) * 0.1
    jnet._trainer.params = jax.tree.map(jnp.asarray, params)
    net = Net(dev='cpu', cfg=text)
    net.init_model()
    net.trainer.params = params_from_jax(params)
    bn = [i for i, layer in enumerate(net.trainer.net.layers)
          if layer.type_name == 'batch_norm']
    assert bn and all(net.trainer.params[str(i)]['wmat'].shape ==
                      net.trainer.params[str(i)]['bias'].shape
                      for i in bn)
    x = _batches(1, seed=4)[0][0]
    np.testing.assert_allclose(net.predict_scores(x),
                               np.asarray(jnet.extract(x, 'top[-1]')),
                               rtol=1e-4, atol=1e-5)
    # batch statistics: the scores of half the batch differ from the
    # first half of the whole batch's
    assert not np.allclose(net.predict_scores(x[:4]),
                           net.predict_scores(x)[:4], atol=1e-6)


def test_params_from_jax_carries_prelu_bias_and_pairtest_fields():
    text = """
netconfig=start
layer[0->1] = pairtest-fullc-fullc:fc1
  nhidden = 8
layer[1->1] = bias
layer[1->2] = prelu
layer[2->3] = fullc:fc2
  nhidden = 5
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,12
random_type = xavier
"""
    jnet = JNet(dev='cpu', cfg=text)
    jnet.init_model()
    rng = np.random.RandomState(6)
    params = {k: {f: np.asarray(v) + rng.randn(*np.shape(v)).astype(
        np.float32) * 0.2 for f, v in d.items()}
        for k, d in jnet._trainer.params.items()}
    assert sorted((k, f) for k, d in params.items() for f in d) == [
        ('0', 'bias'), ('0', 'wmat'), ('1', 'bias'), ('2', 'bias'),
        ('3', 'bias'), ('3', 'wmat')]
    jnet._trainer.params = jax.tree.map(jnp.asarray, params)
    net = Net(dev='cpu', cfg=text)
    net.init_model()
    net.trainer.params = params_from_jax(params)
    x = _np(25, (6, 1, 1, 12))
    np.testing.assert_allclose(net.predict_scores(x),
                               np.asarray(jnet.extract(x, 'top[-1]')),
                               rtol=1e-5, atol=1e-6)


# --- (f) create_layer and the refusals ---------------------------------------

def test_create_layer_builds_every_type_jax_registers():
    ids = sorted(jl.base.LAYER_REGISTRY) + [
        tl.get_layer_type('pairtest-conv-conv')]
    for type_id in ids:
        layer = tl.create_layer(type_id, name='x')
        assert layer.type_id == type_id
        assert layer.type_name == jl.create_layer(type_id).type_name
    assert sorted(tl.base.LAYER_REGISTRY) == sorted(jl.base.LAYER_REGISTRY)


@pytest.mark.parametrize('key,val', [
    ('conv_lowering', 'im2col'), ('conv_lowering', 's2d'),
    ('conv_lowering', 'split'), ('micro_batch', '2'),
    ('extra_data_num', '1')])
def test_the_rest_of_item_2_still_refuses(key, val):
    """Named for the refusal these keys met before the port ran them;
    queue A item 2 is done, so each key now builds the narrow GoogLeNet
    with JAX's conv pairing and scores it as JAX's ``Net`` does from the
    same weights (an ``extra_data_num`` net on a side input it does not
    read, which both packages still require)."""
    from cxxnet_tpu.io.data import DataBatch as JBatch
    text = _narrow('googlenet')
    if key == 'extra_data_num':
        # extra data nodes are named ahead of the netconfig
        text = f'{key} = {val}\nextra_data_shape[1] = 1,1,4\n' + text
    jnet, net = JNet(dev='cpu', cfg=text), Net(dev='cpu', cfg=text)
    for n in (jnet, net):
        n.set_param(key, val)
        n.init_model()
    jt, tt = jnet._trainer, net.trainer
    assert tt.net._convact_pairs == jt.net._convact_pairs
    assert tt.net._sibling_groups == jt.net._sibling_groups
    tt.params = params_from_jax({k: {f: np.asarray(v) for f, v in d.items()}
                                 for k, d in jt.params.items()})
    x = _np(27, (4, 3, 32, 32))
    extras = [_np(28, (4, 1, 1, 4))] if key == 'extra_data_num' else []
    top = jt.net.cfg.layers[-1].nindex_out[-1]
    want = np.asarray(jt._forward_nodes(
        JBatch(x, np.zeros((4, 1), np.float32), extra_data=extras),
        [top])[0])
    np.testing.assert_allclose(tt.predict_scores(x, extra_data=extras), want,
                               rtol=RTOL, atol=ATOL)


# --- fixconn and pairtest through the CLI ------------------------------------

_CLI_CONF = """
data = train
iter = mnist
    path_img = "./data/train-images-idx3-ubyte.gz"
    path_label = "./data/train-labels-idx1-ubyte.gz"
    shuffle = 1
iter = end
eval = test
iter = mnist
    path_img = "./data/t10k-images-idx3-ubyte.gz"
    path_label = "./data/t10k-labels-idx1-ubyte.gz"
iter = end
netconfig=start
layer[0->1] = fixconn:fx
  nhidden = 64
  fixconn_weight = fix.txt
layer[1->2] = sigmoid
layer[2->3] = pairtest-fullc-fullc:fc
  nhidden = 4
  init_sigma = 0
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 100
eta = 0.5
momentum = 0.9
metric = error
metric = logloss
"""


def test_cli_runs_fixconn_and_pairtest_like_jax(tmp_path, capsys,
                                                monkeypatch):
    # every weight starts alike in both packages with no model file between
    # them (a pairtest layer's weights are in no model file, as in JAX):
    # the fixconn projection comes from its file and the pairtest fullc
    # starts at zero (init_sigma 0), which a softmax layer learns from
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu_torch.main import main as tmain
    os.makedirs(tmp_path / 'data')
    _write_idx(str(tmp_path / 'data'), 'train', 2000, 1)
    _write_idx(str(tmp_path / 'data'), 't10k', 500, 2)
    # a sparse 64 x 784 projection: output r sums 24 pixels of quadrant
    # r % 4, where the blobs of class r % 4 lie
    rng = np.random.RandomState(5)
    entries = []
    for r in range(64):
        y0, x0 = ((r % 4) // 2) * 14, ((r % 4) % 2) * 14
        for p in rng.choice(196, 24, replace=False):
            entries.append((r, (y0 + p // 14) * 28 + x0 + p % 14, 0.1))
    (tmp_path / 'fix.txt').write_text(
        f'64 784 {len(entries)}\n'
        + ''.join(f'{r} {c} {v}\n' for r, c, v in entries))
    (tmp_path / 'fix.conf').write_text(_CLI_CONF)
    monkeypatch.chdir(tmp_path)
    common = ['fix.conf', 'dev=cpu', 'num_round=2', 'max_round=2',
              'save_model=1', 'silent=1']
    capsys.readouterr()
    assert jmain(common + ['model_dir=mj']) == 0
    jlines = [ln for ln in capsys.readouterr().err.splitlines()
              if ln.startswith('[')]
    assert tmain(common + ['model_dir=mt']) == 0
    captured = capsys.readouterr()
    tlines = [ln for ln in captured.err.splitlines() if ln.startswith('[')]
    assert 'PairTest MISMATCH' not in captured.out
    assert len(jlines) == len(tlines) == 2
    for jline, tline in zip(jlines, tlines):
        jt, tt = jline.split('\t'), tline.split('\t')
        assert [t.split(':')[0] for t in tt] == [t.split(':')[0] for t in jt]
        for a, b in zip(jt[1:], tt[1:]):
            key, ja, tb_ = a.split(':')[0], float(a.split(':')[1]), \
                float(b.split(':')[1])
            if key.endswith('error'):
                n = 2000 if key.startswith('train') else 500
                assert abs(ja - tb_) * n <= 1.0 + 1e-9, (key, ja, tb_)
            else:
                assert tb_ == pytest.approx(ja, rel=1e-4), (key, ja, tb_)
    assert float(tlines[-1].split('test-error:')[1].split('\t')[0]) <= 0.05
    for name in ('0002.model', '0002.model.crc32'):
        assert os.path.exists(tmp_path / 'mt' / name)
