"""The train slice of ``cxxnet_tpu_torch`` against the JAX package, on
the CPU, on the same numpy inputs.

* updaters: ``sgd`` / ``nag`` / ``adam`` with tag-scoped hyperparameters,
  every ``lr:schedule``, ``start_epoch``, the momentum cap and
  ``clip_gradient`` (NaN gradients included), against ``apply_updates``
  — rtol 1e-6: the same f32 arithmetic, only the elementwise order of a
  few operations differs;
* metrics: ``MetricSet`` print strings equal to the JAX package's;
* the slice: the narrow AlexNet of ``test_torch_slice.py`` (dropout
  threshold 0 here: these runs start from weights carried across with
  ``params_from_jax``; ``test_torch_prng.py`` and ``test_torch_slice.py``
  train from the seed with dropout on) trained 3 updates at
  ``update_period`` 1 and 2, JAX
  ``Net(dev='cpu')`` against the port's, started from the same weights
  and, for a mid-run start, the same optimizer state; JAX with its Pallas
  kernels forced on (interpret mode, as its own tests run them), the
  port with its kernels forced on and in ``auto``.  Parameters agree to
  rtol 1e-4 / atol 1e-6, the weight change of each parameter to
  ``DW_TOL`` of its largest value, and the train-metric lines to 1e-4
  relative: f32 through eight layers and three updates whose sums run in
  different orders;
* the CLI: ``cxxnet_tpu.main`` and ``cxxnet_tpu_torch.main`` on a copy of
  ``example/MNIST/MNIST_CONV.conf`` over synthetic idx files (dropout
  0, 2 rounds, the port starting from the JAX run's initial model file):
  the per-round eval lines agree, error within one instance and logloss
  within 1e-4 relative.

The JAX trainer's ``use_pallas`` writes ``CXXNET_PALLAS`` into the
process environment; these tests set it only through ``monkeypatch``,
which restores it, so later JAX tests on the same worker are unchanged.
"""

import gzip
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.updater import updaters as jup
from cxxnet_tpu.utils import metric as jmetric
from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.interop import opt_state_from_jax, params_from_jax
from cxxnet_tpu_torch.ops.kernels import launch_counts
from cxxnet_tpu_torch.runtime.faults import DivergenceError, NotPortedError
from cxxnet_tpu_torch.updater import updaters as tup
from cxxnet_tpu_torch.utils import metric as tmetric
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed, shapes):
    rng = np.random.RandomState(seed)
    return {lk: {fk: rng.randn(*shp).astype(np.float32)
                 for fk, shp in fields.items()}
            for lk, fields in shapes.items()}


_SHAPES = {'0': {'wmat': (3, 4), 'bias': (4,)}, '2': {'wmat': (5, 2)}}


@pytest.mark.parametrize('updater,cfg', [
    ('sgd', [('wmat:lr', '0.1'), ('bias:lr', '0.2'), ('momentum', '0.8'),
             ('wmat:wd', '0.01'), ('bias:wd', '0')]),
    ('sgd', [('lr', '0.3'), ('lr:schedule', 'expdecay'), ('lr:gamma', '0.5'),
             ('lr:step', '3'), ('lr:minimum_lr', '0.05')]),
    ('sgd', [('lr', '0.3'), ('lr:schedule', 'polydecay'), ('lr:gamma', '0.7'),
             ('lr:alpha', '0.6'), ('lr:step', '2'), ('lr:start_epoch', '5')]),
    ('sgd', [('eta', '0.3'), ('eta:schedule', 'factor'), ('eta:factor', '0.3'),
             ('eta:step', '4'), ('clip_gradient', '0.5'), ('wd', '0.02')]),
    ('sgd', [('momentum_schedule', '1'), ('saturation_epoch', '10'),
             ('base_momentum', '0.5'), ('final_momentum', '0.7'),
             ('momentum', '0.1')]),
    ('nag', [('lr', '0.05'), ('momentum', '0.95'), ('bias:wd', '0.1'),
             ('lr:schedule', 'expdecay'), ('lr:gamma', '0.9')]),
    ('adam', [('lr', '0.01'), ('beta1', '0.2'), ('beta2', '0.01'),
              ('wmat:wd', '0.05')]),
], ids=['sgd_tagged', 'expdecay_floor', 'polydecay_start', 'factor_clip',
        'momentum_schedule_cap', 'nag', 'adam_wd_sign'])
def test_updaters_match_jax_apply_updates(updater, cfg):
    params = _tree(1, _SHAPES)
    layercfg = {'0': [('bias:lr', '0.25')], '2': []}
    jh = {lk: {fk: jup.create_updater_hyper(updater, fk, cfg, layercfg[lk])
               for fk in f} for lk, f in _SHAPES.items()}
    th = {lk: {fk: tup.create_updater_hyper(updater, fk, cfg, layercfg[lk])
               for fk in f} for lk, f in _SHAPES.items()}
    jp = {lk: {fk: jnp.asarray(v) for fk, v in f.items()}
          for lk, f in params.items()}
    js = jup.init_opt_state(updater, jp)
    tp = params_from_jax(params)
    ts = tup.init_opt_state(updater, tp)
    for step, epoch in enumerate((0, 7, 250)):
        grads = _tree(10 + step, _SHAPES)
        grads['0']['wmat'][0, 0] = np.nan        # the clip zeroes NaN
        if 'clip_gradient' not in dict(cfg):
            grads['0']['wmat'][0, 0] = 0.0
        for lk in jh:
            for fk in jh[lk]:
                assert th[lk][fk].schedule(epoch) == pytest.approx(
                    tuple(float(v) for v in jh[lk][fk].schedule(epoch)),
                    rel=1e-6)
        jp, js = jup.apply_updates(
            updater, jh, jp,
            {lk: {fk: jnp.asarray(v) for fk, v in f.items()}
             for lk, f in grads.items()}, js, epoch)
        tup.apply_updates(updater, th, tp, params_from_jax(grads), ts, epoch)
    for lk, f in jp.items():
        for fk, v in f.items():
            np.testing.assert_allclose(tp[lk][fk].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7)
    for slot, tree in js.items():
        for lk, f in tree.items():
            for fk, v in f.items():
                np.testing.assert_allclose(ts[slot][lk][fk].numpy(),
                                           np.asarray(v), rtol=1e-6,
                                           atol=1e-7)


def test_tag_scoped_keys_reach_only_their_tag():
    h = tup.create_updater_hyper('sgd', 'bias', [('wmat:lr', '0.5'),
                                                 ('bias:wd', '0.3'),
                                                 ('lr', '0.2')], [])
    assert (h.base_lr, h.wd) == (0.2, 0.3)
    with pytest.raises(ValueError):
        tup.create_updater_hyper('rmsprop', 'wmat', [], [])


def test_metric_set_prints_like_jax():
    rng = np.random.RandomState(2)
    pred = rng.rand(20, 6)
    label = np.stack([rng.randint(0, 6, 20), rng.randint(0, 6, 20)], 1)
    lines = []
    for mod in (jmetric, tmetric):
        ms = mod.MetricSet()
        for name, field in (('error', 'label'), ('logloss', 'label'),
                            ('rec@1', 'label'), ('rec@3', 'extra'),
                            ('rmse', 'label')):
            ms.add_metric(name, field)

        class _Info:
            def field(self, name):
                return label[:, :1] if name == 'label' else label

        preds = [pred, pred, pred, pred, pred[:, :1]]
        ms.add_eval(preds, _Info())
        ms.add_eval([p[:7] for p in preds], type('I', (), {
            'field': lambda self, n: (label[:7, :1] if n == 'label'
                                      else label[:7])})())
        lines.append(ms.print('test'))
    assert lines[1] == lines[0]
    assert '\ttest-rec@3[extra]:' in lines[1]
    with pytest.raises(ValueError):
        tmetric.MetricSet().add_metric('auc')


NARROW_TRAIN = open(os.path.join(ROOT, 'tests', 'test_torch_slice.py')
                    ).read().split('NARROW_ALEXNET = """')[1].split('"""')[0] \
    .replace('threshold = 0.5', 'threshold = 0.0') + """
wmat:lr = 0.01
bias:lr = 0.02
momentum = 0.9
wmat:wd = 0.0005
bias:wd = 0
lr:schedule = expdecay
lr:gamma = 0.1
lr:step = 100000
metric = error
metric = logloss
batch_size = 4
"""


def _batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 3, 67, 67).astype(np.float32),
             rng.randint(0, 10, 4)) for _ in range(n)]


# max |dw_port - dw_jax| / max |dw_jax| per weight over the 3 updates:
# measured at most 3.3e-5 (conv1's weights at update_period 2, whose one
# applied update moves the weights least); a gradient off by 1 % in any
# layer lands near 1e-2
DW_TOL = 1e-4


def _metric_numbers(line):
    return [float(tok.split(':')[1]) for tok in line.split('\t') if tok]


@pytest.fixture(scope='module')
def jax_runs():
    """JAX runs with the Pallas kernels forced on, keyed by update_period:
    the start (params, optimizer state, counters) and, after 3 updates,
    the params, the train-metric line and the counters."""
    import jax

    def host(tree):
        return jax.tree.map(np.asarray, tree)
    mp = pytest.MonkeyPatch()
    mp.setenv('CXXNET_PALLAS', '1')
    try:
        out = {}
        for period in (1, 2):
            net = JNet(dev='cpu', cfg=NARROW_TRAIN
                       + f'update_period = {period}\n')
            net.init_model()
            tr = net._trainer
            params0 = host(tr.params)
            # a mid-run start: the optimizer state and counters after one
            # step on other data, the initial weights, nothing accumulated
            x, y = _batches(1, seed=9)[0]
            net.update(x, y)
            tr.evaluate(None, 'train')            # drop that step's metrics
            tr.params = jax.tree.map(jnp.asarray, params0)
            tr.grad_acc = jax.tree.map(jnp.zeros_like, tr.grad_acc)
            start = (params0, host(tr.opt_state), tr.sample_counter,
                     tr.epoch_counter)
            for x, y in _batches():
                net.update(x, y)
            out[period] = (start, host(tr.params),
                           tr.evaluate(None, 'train'),
                           (tr.sample_counter, tr.epoch_counter))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize('period', [1, 2])
@pytest.mark.parametrize('mode', ['1', 'auto'])
def test_port_training_matches_jax(jax_runs, period, mode):
    (params0, state, sc0, ec0), want, line, counters = jax_runs[period]
    net = Net(dev='cpu', cfg=NARROW_TRAIN + f'update_period = {period}\n'
              f'use_pallas = {mode}\n')
    net.init_model()
    tr = net.trainer
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
            # the weight change itself, against JAX's
            moved = v - params0[k][f]
            gaps[f'{k}/{f}'] = float(np.abs((got - params0[k][f]) - moved)
                                     .max() / np.abs(moved).max())
    assert max(gaps.values()) <= DW_TOL, gaps
    got = tr.evaluate(None, 'train')
    assert [t.split(':')[0] for t in got.split('\t')] == \
        [t.split(':')[0] for t in line.split('\t')]
    np.testing.assert_allclose(_metric_numbers(got), _metric_numbers(line),
                               rtol=1e-4)


def test_decisions_recorded_in_one_step_replay_in_another():
    # chip_smoke.py's one-step comparison at a narrow size: the kernel
    # composition records its relu and max-pooling choices (recording
    # changes nothing), the stock composition (use_pallas=0 fuse=0)
    # replays them, from the same weights, batch and dropout masks
    from cxxnet_tpu_torch.layers import Decisions
    cfg = NARROW_TRAIN.replace('threshold = 0.0', 'threshold = 0.5')
    x, y = _batches(1)[0]

    def step(extra='', decisions=None):
        net = Net(dev='cpu', cfg=cfg + extra)
        net.init_model()
        net.trainer.decisions = decisions
        tr = net.trainer
        w0 = {(k, f): v.detach().clone()
              for k, d in tr.params.items() for f, v in d.items()}
        net.update(x, y)
        return net, {key: tr.params[key[0]][key[1]].detach() - w
                     for key, w in w0.items()}

    _, plain = step()
    decisions = Decisions()
    net, recorded = step(decisions=decisions)
    for key, d in plain.items():
        assert torch.equal(recorded[key], d), key
    layers = net.trainer.net.layers
    assert sorted(decisions.inputs) == [
        i for i, layer in enumerate(layers)
        if layer.type_name in ('relu', 'max_pooling')]
    decisions.replay = True
    _, stock = step('use_pallas = 0\nfuse = 0\n', decisions)
    gaps = {key: float((stock[key] - d).abs().max() / d.abs().max())
            for key, d in plain.items() if d.abs().max() > 0}
    # the two compositions differ at most in the order of their f32 sums
    # (on the CPU builds tried, not even that): 1e-4 of the largest
    # change, chip_smoke.py's full-size figure on the card
    assert max(gaps.values()) <= 1e-4, gaps


def test_update_period_accumulates_then_applies():
    net = Net(dev='cpu', cfg=NARROW_TRAIN + 'update_period = 2\n')
    net.init_model()
    tr = net.trainer
    w0 = tr.params['0']['wmat'].detach().clone()
    (x, y), (x2, y2) = _batches(2)
    net.update(x, y)
    assert torch.equal(tr.params['0']['wmat'].detach(), w0)
    assert tr.grad_acc['0']['wmat'].abs().sum() > 0
    assert (tr.epoch_counter, tr.sample_counter) == (0, 1)
    net.update(x2, y2)
    assert not torch.equal(tr.params['0']['wmat'].detach(), w0)
    assert tr.grad_acc['0']['wmat'].abs().sum() == 0
    assert (tr.epoch_counter, tr.sample_counter) == (1, 2)


def test_dropout_masks_follow_the_seed_and_the_step():
    cfg = NARROW_TRAIN.replace('threshold = 0.0', 'threshold = 0.5')
    runs = []
    for seed in (3, 3, 4):
        net = Net(dev='cpu', cfg=cfg + f'seed = {seed}\n')
        net.init_model()
        for x, y in _batches(2):
            net.update(x, y)
        params = net.trainer.params
        runs.append(params[max(params, key=int)]['wmat'].detach())   # fc8
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_nan_action_skip_and_halt():
    x, y = _batches(1)[0]
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    # without weight decay a zeroed gradient from fresh momentum moves no
    # weight (with it, the decay term still applies, as in the JAX trainer)
    net = Net(dev='cpu', cfg=NARROW_TRAIN.replace('wmat:wd = 0.0005',
                                                  'wmat:wd = 0')
              + 'nan_action = skip\n')
    net.init_model()
    w0 = {k: {f: v.detach().clone() for f, v in d.items()}
          for k, d in net.trainer.params.items()}
    net.update(bad, y)
    assert not np.isfinite(float(net.trainer.last_loss))
    for k, d in w0.items():
        for f, v in d.items():
            assert torch.equal(net.trainer.params[k][f].detach(), v), (k, f)
    halt = Net(dev='cpu', cfg=NARROW_TRAIN + 'nan_action = halt\n')
    halt.init_model()
    halt.update(bad, y)                     # checked one step late
    with pytest.raises(DivergenceError):
        halt.update(x, y)


def test_inference_only_and_unported_train_options_refuse():
    net = Net(dev='cpu', cfg=NARROW_TRAIN + 'inference_only = 1\n')
    net.init_model()
    x, y = _batches(1)[0]
    with pytest.raises(RuntimeError, match='inference_only'):
        net.update(x, y)
    tr = net.trainer
    # the K-step window is ported (tests/test_torch_execution.py); on an
    # inference-only trainer it refuses as update does
    fn = tr.compile_multi_step(4)
    with pytest.raises(RuntimeError, match='inference_only'):
        tr.update_staged_window(fn, [tr.stage_batch(DataBatch(
            x, y.astype(np.float32)[:, None]))] * 4)
    # the exact-resume state is ported (tests/test_torch_exact_resume.py);
    # an inference-only trainer holds no optimizer state and refuses it
    for fn in (tr.save_training_state, tr.load_training_state):
        with pytest.raises(RuntimeError, match='inference_only'):
            fn('exact_state', 0)
    with pytest.raises(RuntimeError, match='inference_only'):
        tr.snapshot_training_state()
    with pytest.raises(NotPortedError):
        Net(dev='cpu', cfg=NARROW_TRAIN + 'test_on_server = 1\n') \
            .init_model()


# --- the data path and the CLI ----------------------------------------------

def _write_idx(d, name, n, seed):
    """4 quadrant-blob classes of 28x28 uint8 images, idx.gz format."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 4, n).astype(np.uint8)
    img = np.zeros((n, 28, 28), np.uint8)
    for i, c in enumerate(lab):
        y0, x0 = (c // 2) * 14, (c % 2) * 14
        img[i, y0 + 2:y0 + 12, x0 + 2:x0 + 12] = rng.randint(128, 256,
                                                             (10, 10))
    with gzip.open(os.path.join(d, f'{name}-images-idx3-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>iiii', 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(d, f'{name}-labels-idx1-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>ii', 2049, n) + lab.tobytes())


@pytest.fixture(scope='module')
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('mnist')
    os.makedirs(d / 'data')
    _write_idx(str(d / 'data'), 'train', 2000, 1)
    _write_idx(str(d / 'data'), 't10k', 500, 2)
    with open(os.path.join(ROOT, 'example', 'MNIST', 'MNIST_CONV.conf')) as f:
        conf = f.read().replace('threshold = 0.5', 'threshold = 0.0')
    with open(d / 'conv.conf', 'w') as f:
        f.write(conf + 'metric = logloss\n')
    return d


def test_mnist_batches_match_jax(mnist_dir):
    from cxxnet_tpu.io.data import create_iterator as jcreate
    from cxxnet_tpu_torch.io.data import create_iterator as tcreate
    cfg = [('iter', 'mnist'),
           ('path_img', str(mnist_dir / 'data/train-images-idx3-ubyte.gz')),
           ('path_label', str(mnist_dir / 'data/train-labels-idx1-ubyte.gz')),
           ('shuffle', '1'), ('seed_data', '7'), ('input_flat', '0'),
           ('batch_size', '300'), ('silent', '1'), ('iter', 'threadbuffer'),
           ('iter', 'end')]
    its = [jcreate(cfg), tcreate(cfg)]
    for it in its:
        it.init()
    try:
        jb, tb = list(its[0]), list(its[1])
        assert len(jb) == len(tb) == 6                # the tail is dropped
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.data, a.data)
            np.testing.assert_array_equal(b.label, a.label)
    finally:
        for it in its:
            it.close(5.0)


@pytest.mark.parametrize('source', ['imgbin_stream', 'attachtxt'])
def test_unported_iterators_raise(source, mnist_dir, tmp_path, monkeypatch):
    """Both sources are ported now: ``imgbin_stream`` (queue A item 12's
    second part, ``tests/test_torch_stream.py`` holds the rest) gives
    JAX's batches over one appended file, and ``attachtxt``, ported with
    item 2's ``extra_data_num``, attaches JAX's rows to the MNIST chain's
    batches (``tests/test_torch_attach.py`` holds the rest)."""
    from cxxnet_tpu.io.data import create_iterator as jcreate
    from cxxnet_tpu_torch.io.data import create_iterator
    if source == 'imgbin_stream':
        import io as _io

        from PIL import Image

        from cxxnet_tpu.runtime import native as jnative
        from cxxnet_tpu_torch.io.iter_stream import append_records
        monkeypatch.setattr(jnative, 'native_available', lambda: False)
        monkeypatch.setattr(jnative, 'native_order_available', lambda: False)
        rng = np.random.RandomState(4)
        recs = []
        for i in range(12):
            buf = _io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (10, 10, 3)).astype(
                np.uint8)).save(buf, format='PNG')
            recs.append((i, [i % 3], buf.getvalue()))
        binp, lst = str(tmp_path / 's.bin'), str(tmp_path / 's.lst')
        append_records(binp, lst, recs)
        cfg = [('iter', source), ('image_list', lst), ('image_bin', binp),
               ('rand_crop', '1'), ('input_shape', '3,8,8'),
               ('batch_size', '4'), ('silent', '1'), ('iter', 'end')]
        its = [jcreate(cfg), create_iterator(cfg)]
        for it in its:
            it.init()
        jb, tb = list(its[0]), list(its[1])
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.data, a.data)
            np.testing.assert_array_equal(b.label, a.label)
        return
    np.savetxt(tmp_path / 'side.txt',
               np.random.RandomState(3).rand(2000, 3), fmt='%.6f')
    cfg = [('iter', 'mnist'),
           ('path_img', str(mnist_dir / 'data/train-images-idx3-ubyte.gz')),
           ('path_label', str(mnist_dir / 'data/train-labels-idx1-ubyte.gz')),
           ('shuffle', '1'), ('batch_size', '500'), ('silent', '1'),
           ('iter', source), ('attach_file', str(tmp_path / 'side.txt')),
           ('iter', 'end')]
    its = [jcreate(cfg), create_iterator(cfg)]
    for it in its:
        it.init()
    jb, tb = list(its[0]), list(its[1])
    assert len(jb) == len(tb) == 4
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.inst_index, a.inst_index)
        assert len(b.extra_data) == len(a.extra_data) == 1
        np.testing.assert_array_equal(b.extra_data[0], a.extra_data[0])


def test_data_iter_drives_update_and_evaluate(mnist_dir):
    from cxxnet_tpu_torch.wrapper import DataIter
    it = DataIter(f"""
iter = mnist
    path_img = "{mnist_dir}/data/t10k-images-idx3-ubyte.gz"
    path_label = "{mnist_dir}/data/t10k-labels-idx1-ubyte.gz"
    input_flat = 0
    silent = 1
iter = threadbuffer
iter = end
batch_size = 100
""")
    net = Net(dev='cpu', cfg=_netconfig(mnist_dir) + 'batch_size = 100\n'
              'eta = 0.1\nmomentum = 0.9\nmetric = error\n')
    net.init_model()
    try:
        net.start_round(1)
        it.before_first()
        steps = 0
        while it.next():
            net.update(it)
            steps += 1
        assert steps == 5 and it.tail
        line = net.evaluate(it, 'test')
        assert line.startswith('\ttrain-error:') and '\ttest-error:' in line
        assert net.trainer.round == 1
    finally:
        it.close(5.0)


def _netconfig(mnist_dir):
    conf = open(mnist_dir / 'conv.conf').read()
    body = conf.split('netconfig=start')[1].split('netconfig=end')[0]
    return f'netconfig=start{body}netconfig=end\ninput_shape = 1,28,28\n'


def _eval_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith('[')]


def test_cli_matches_jax_cli(mnist_dir, capsys, monkeypatch):
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu_torch.main import main as tmain
    monkeypatch.chdir(mnist_dir)
    common = ['conv.conf', 'dev=cpu', 'num_round=2', 'max_round=2',
              'save_model=1', 'silent=1']
    capsys.readouterr()
    assert jmain(common + ['model_dir=mj']) == 0
    jlines = _eval_lines(capsys.readouterr().err)
    assert tmain(common + ['model_dir=mt', 'model_in=mj/0000.model']) == 0
    tlines = _eval_lines(capsys.readouterr().err)
    assert len(jlines) == len(tlines) == 2
    for jl, tl in zip(jlines, tlines):
        jt, tt = jl.split('\t'), tl.split('\t')
        assert [t.split(':')[0] for t in tt] == [t.split(':')[0] for t in jt]
        for a, b in zip(jt[1:], tt[1:]):
            key, ja, tb = a.split(':')[0], float(a.split(':')[1]), \
                float(b.split(':')[1])
            if key.endswith('error'):
                n = 2000 if key.startswith('train') else 500
                assert abs(ja - tb) * n <= 1.0 + 1e-9, (key, ja, tb)
            else:
                assert tb == pytest.approx(ja, rel=1e-4), (key, ja, tb)
    assert float(tlines[-1].split('test-error:')[1].split('\t')[0]) <= 0.05
    for name in ('0001.model', '0002.model', '0002.model.crc32'):
        assert os.path.exists(mnist_dir / 'mt' / name)
    # the port's model file loads in the JAX package and predicts alike
    for pkg, fn in (('j', jmain), ('t', tmain)):
        with open(mnist_dir / f'pred_{pkg}.conf', 'w') as f:
            f.write(f"""pred = {pkg}.txt
iter = mnist
    input_flat = 0
    path_img = "./data/t10k-images-idx3-ubyte.gz"
    path_label = "./data/t10k-labels-idx1-ubyte.gz"
iter = end
{_netconfig(mnist_dir)}batch_size = 100
""")
        assert fn([f'pred_{pkg}.conf', 'dev=cpu', 'task=pred', 'silent=1',
                   'model_in=mt/0002.model']) == 0
    capsys.readouterr()
    jp = np.loadtxt(mnist_dir / 'j.txt')
    tp = np.loadtxt(mnist_dir / 't.txt')
    assert len(tp) == 500
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize('arg', [
    'task=online', 'serve.reload=2', 'serve.fold_bn=1', 'train.supervise=1',
    'save_async=1', 'steps_per_dispatch=4', 'obs.port=0', 'dist.hosts=2',
    'exact_ckpt=1', 'profile_dir=prof', 'obs.fleet_port=0',
    'obs.trace_merge=fleet.json'])
def test_cli_refuses_what_it_does_not_run(mnist_dir, monkeypatch, arg):
    from cxxnet_tpu_torch.main import LearnTask, main as tmain
    monkeypatch.chdir(mnist_dir)
    if arg == 'task=online':
        # ported (queue A item 10.3): the CLI takes the task and its
        # online.* keys as JAX's does; the runs are
        # tests/test_torch_online.py's
        from cxxnet_tpu.main import LearnTask as JTask
        got, want = LearnTask(), JTask()
        pairs = [('task', 'online'), ('online.save_every', '5'),
                 ('online.freshness_slo', '2.5'),
                 ('online.freshness_strict', '1'), ('online.reload', '0.1'),
                 ('online.qps', '20')]
        for task in (got, want):
            for k, v in pairs:
                task.set_param(k, v)
        assert got.cfg[-len(pairs):] == want.cfg[-len(pairs):] == pairs
        for attr in ('task', 'online_save_every', 'online_freshness_slo',
                     'online_freshness_strict', 'online_reload',
                     'online_qps'):
            assert getattr(got, attr) == getattr(want, attr), attr
        with pytest.raises(ValueError, match='unknown online key'):
            got.set_param('online.colour', 'red')
        return
    if arg in ('obs.port=0', 'profile_dir=prof'):
        # ported (queue A item 10.1): the CLI takes the key as JAX's
        # does; the runs are tests/test_torch_obs.py's and
        # tests/test_torch_programs.py's
        from cxxnet_tpu.main import LearnTask as JTask
        got, want = LearnTask(), JTask()
        for task in (got, want):
            task.set_param(*arg.split('='))
        assert got.cfg[-1] == want.cfg[-1] == tuple(arg.split('='))
        assert got.obs_port == want.obs_port == (0 if arg.startswith('obs')
                                                 else -1)
        return
    if arg.startswith(('obs.fleet_port', 'obs.trace_merge')):
        # the elastic launcher's merged scrape moved to item 9
        with pytest.raises(NotPortedError, match='queue A item 9'):
            tmain(['conv.conf', 'dev=cpu', arg])
        return
    if arg == 'serve.reload=2':
        # ported (queue A item 8): the CLI takes the key and sets it; the
        # runs are tests/test_torch_serve_fleet.py's
        task = LearnTask()
        task.set_param('serve.reload', '2')
        assert task.serve_reload == 2.0
        return
    if arg in ('serve.fold_bn=1', 'steps_per_dispatch=4'):
        # ported (queue A item 4): the CLI takes the key and sets it; the
        # runs themselves are tests/test_torch_execution.py's and
        # tests/test_torch_fold.py's
        task = LearnTask()
        task.set_param(*arg.split('='))
        assert (task.serve_fold_bn, task.steps_per_dispatch) == \
            ((1, 1) if arg.startswith('serve') else (0, 4))
        return
    if arg in ('train.supervise=1', 'save_async=1', 'exact_ckpt=1'):
        # ported (queue A item 5): the CLI takes the key and sets it; the
        # runs are tests/test_torch_runtime.py's, test_torch_async_ckpt.py's
        # and test_torch_exact_resume.py's
        task = LearnTask()
        task.set_param(*arg.split('='))
        assert (task.supervise, task.save_async, task.exact_ckpt) == tuple(
            int(arg.startswith(k)) for k in ('train.', 'save', 'exact'))
        return
    with pytest.raises(NotPortedError, match='ROADMAP.md queue A'):
        tmain(['conv.conf', 'dev=cpu', arg])
