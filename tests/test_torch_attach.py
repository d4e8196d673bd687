"""``iter = attachtxt`` and ``extra_data_num`` in ``cxxnet_tpu_torch``
against the JAX package, on the CPU, on the same files.

* the ``attachtxt`` stage over the ``img`` chain: every batch (data,
  label, instance indices, padding and the attached extras) bitwise
  JAX's, with a wrapped (``round_batch = 1``) and a synthetic
  (``round_batch = 0``) tail;
* JAX's CLI conf (``tests/test_e2e_cli.py:406-456``, labels a function of
  the attached vector only) through both CLIs: 0 train error in both,
  the port's parameters within the train tolerance of
  ``tests/test_torch_train.py`` (rtol 1e-4, atol 1e-6) of the JAX CLI's;
* extras through ``evaluate``, ``predict``, ``extract`` and the streams
  across prediction buckets (a net reading the image and the side vector
  and joining them by ``concat``), against JAX's from the same weights
  (rtol 1e-5, atol 1e-6; metric lines and predictions equal); too few
  extras raise JAX's ``ValueError``;
* a model file with ``extra_data_num`` round-trips between the packages
  (header and weights bitwise, scores alike);
* an ``attachtxt`` round under ``steps_per_dispatch = 4`` demotes that
  round only (the plan keeps K = 4, the next round's stepper starts
  undemoted) and is bitwise the per-step run.
"""

import io
import re

import numpy as np
import pytest
import torch
from PIL import Image

from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.io.data import create_iterator as jcreate
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.data import create_iterator as tcreate
from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def attach_dir(tmp_path_factory):
    """JAX's fixture: 15 noise images, labels a function of the attached
    6-vector only (``tests/test_e2e_cli.py:406-425``)."""
    d = tmp_path_factory.mktemp('attach')
    rng = np.random.RandomState(11)
    lines, rows = [], []
    for i in range(15):
        c = rng.randint(0, 4)
        img = rng.randint(0, 255, (8, 8, 3), np.uint8)
        Image.fromarray(img).save(d / f'x{i}.png')
        vec = rng.rand(6) * 0.1
        vec[c] += 2.0
        rows.append(' '.join(f'{v:.5f}' for v in vec))
        lines.append(f'{i}\t{c}\tx{i}.png')
    (d / 'a.lst').write_text('\n'.join(lines) + '\n')
    (d / 'attach.txt').write_text('\n'.join(rows) + '\n')
    return d


def _section(d, extra=()):
    return [('iter', 'img'), ('image_list', str(d / 'a.lst')),
            ('image_root', str(d) + '/'), ('silent', '1'),
            ('input_shape', '3,8,8'),
            ('iter', 'attachtxt'), ('attach_file', str(d / 'attach.txt')),
            *extra, ('iter', 'end')]


@pytest.mark.parametrize('round_batch', ['1', '0'])
def test_attach_batches_bitwise_jax(attach_dir, round_batch):
    cfg = _section(attach_dir, (('batch_size', '4'),
                                ('round_batch', round_batch),
                                ('extra_data_num', '2')))
    its = [jcreate(cfg), tcreate(cfg)]
    for it in its:
        it.init()
    jb, tb = list(its[0]), list(its[1])
    assert len(jb) == len(tb) == 4
    assert tb[-1].num_batch_padd == jb[-1].num_batch_padd == 1
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.label, a.label)
        np.testing.assert_array_equal(b.inst_index, a.inst_index)
        assert b.num_batch_padd == a.num_batch_padd
        assert b.pad_synthetic == a.pad_synthetic
        assert len(b.extra_data) == len(a.extra_data) == 2
        for x, y in zip(b.extra_data, a.extra_data):
            assert x.dtype == y.dtype == np.float32
            assert x.shape == y.shape == (4, 1, 1, 6)
            np.testing.assert_array_equal(x, y)


def test_attach_without_a_file_or_indices_raises_like_jax(attach_dir):
    cfg = [c for c in _section(attach_dir, (('batch_size', '4'),))
           if c[0] != 'attach_file']
    it = tcreate(cfg)
    with pytest.raises(ValueError, match='must set attach_file'):
        it.init()
    with pytest.raises(ValueError, match='must specify input of attachtxt'):
        tcreate([('iter', 'attachtxt'), ('iter', 'end')])


# --- JAX's CLI conf through both CLIs ----------------------------------------

CLI_CONF = """
data = train
iter = img
  image_list = a.lst
  image_root = ./
iter = attachtxt
  attach_file = attach.txt
iter = end
eval = trainset
iter = img
  image_list = a.lst
  image_root = ./
iter = attachtxt
  attach_file = attach.txt
iter = end
extra_data_num = 1
extra_data_shape[0] = 1,1,6
netconfig = start
layer[in_1->2] = fullc:fx
  nhidden = 4
layer[2->2] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 5
dev = cpu
eta = 0.5
momentum = 0.9
num_round = 30
metric = error
silent = 1
"""


def _final_error(err, name):
    vals = re.findall(rf'{name}-error:([0-9.eE+-]+)', err)
    assert vals, err[-500:]
    return float(vals[-1])


def _load(path, conf_text):
    tr = NetTrainer(parse_config_string(conf_text))
    with open(path, 'rb') as f:
        f.read(4)
        tr.load_model(f)
    return tr


def test_cli_attachtxt_trains_like_the_jax_cli(attach_dir, capsys,
                                                monkeypatch):
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu_torch.main import main as tmain
    monkeypatch.chdir(attach_dir)
    (attach_dir / 'extra.conf').write_text(CLI_CONF)
    capsys.readouterr()
    assert jmain(['extra.conf', 'model_dir=mj']) == 0
    jerr = capsys.readouterr().err
    assert tmain(['extra.conf', 'model_dir=mt']) == 0
    terr = capsys.readouterr().err
    assert _final_error(jerr, 'trainset') == 0.0
    assert _final_error(terr, 'trainset') == 0.0
    want = _load(attach_dir / 'mj' / '0030.model', CLI_CONF)
    got = _load(attach_dir / 'mt' / '0030.model', CLI_CONF)
    assert got.net_cfg.extra_data_num == want.net_cfg.extra_data_num == 1
    for k, d in want.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(
                got.params[k][f].numpy(), v.numpy(), rtol=TRAIN_RTOL,
                atol=TRAIN_ATOL, err_msg=f'{k}/{f}')


# --- extras through evaluate, predict and extract ----------------------------

# the image and the side vector, each through a fullc, joined by concat
JOIN_CONF = """
extra_data_num = 1
extra_data_shape[0] = 1,1,6
netconfig = start
layer[0->img] = flatten
layer[img->hi] = fullc:fi
  nhidden = 5
layer[in_1->he] = fullc:fe
  nhidden = 3
layer[hi,he->cat] = concat
layer[cat->out] = fullc:fo
  nhidden = 4
layer[out->out] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 4
dev = cpu
metric = error
random_type = xavier
"""


def _twins(extra=''):
    jt = JTrainer(jparse(JOIN_CONF + extra))
    jt.init_model()
    tt = NetTrainer(parse_config_string(JOIN_CONF + extra))
    tt.init_model()
    tt.params = params_from_jax({k: {f: np.asarray(v) for f, v in d.items()}
                                 for k, d in jt.params.items()})
    tt._post_params_init()
    return jt, tt


def _rows(n, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 8, 8).astype(np.float32),
            np.zeros((n, 1), np.float32),
            rng.rand(n, 1, 1, 6).astype(np.float32))


@pytest.mark.parametrize('buckets', ['', '2,4'])
def test_extras_through_predict_and_extract_match_jax(buckets):
    extra = f'pred_buckets = {buckets}\n' if buckets else ''
    jt, tt = _twins(extra)
    x, y, e = _rows(7)
    jbatch = JBatch(x, y, extra_data=[e])
    tbatch = DataBatch(x, y, extra_data=[e])
    for node in ('top[-1]', 'he', 'cat'):
        np.testing.assert_allclose(tt.extract_feature(tbatch, node),
                                   jt.extract_feature(jbatch, node),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tt.predict(x, extra_data=[e]),
                                  jt.predict(jbatch))
    np.testing.assert_allclose(tt.predict_scores(x, extra_data=[e]),
                               jt.extract_feature(jbatch, 'top[-1]'),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match='requires 1 extra_data inputs'):
        tt.predict(x)


def test_extras_through_evaluate_and_the_streams_match_jax(attach_dir):
    jt, tt = _twins()
    cfg = _section(attach_dir, (('batch_size', '4'), ('round_batch', '0')))
    its = [jcreate(cfg), tcreate(cfg)]
    for it in its:
        it.init()
    assert tt.evaluate(iter(its[1]), 'attach') == \
        jt.evaluate(iter(its[0]), 'attach')
    got = np.concatenate(list(tt.predict_stream(iter(its[1]))))
    want = np.concatenate(list(jt.predict_stream(iter(its[0]))))
    assert len(got) == 15
    np.testing.assert_array_equal(got, want)
    nid = tt.net.node_index('cat')
    got = np.concatenate(list(tt.forward_stream(iter(its[1]), nid)))
    want = np.concatenate(list(jt.forward_stream(iter(its[0]), nid)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_extras_train_like_jax():
    """Three updates of the joined net, the side vector among the
    inputs, against the JAX trainer from the same weights."""
    jt, tt = _twins('eta = 0.1\nmomentum = 0.9\n')
    for seed in range(3):
        x, _, e = _rows(4, seed)
        y = np.arange(4, dtype=np.float32)[:, None]
        jt.update(JBatch(x, y, extra_data=[e]))
        tt.update(DataBatch(x, y, extra_data=[e]))
    for k, d in jt.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(
                tt.params[k][f].detach().numpy(), np.asarray(v),
                rtol=TRAIN_RTOL, atol=TRAIN_ATOL, err_msg=f'{k}/{f}')


# --- the model file ----------------------------------------------------------

def test_model_file_with_extra_data_round_trips_between_packages():
    jt, tt = _twins()
    x, y, e = _rows(4)
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jt.save_model(jbuf)
    tt.save_model(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    # the port's file loads in JAX and JAX's in the port; both replay the
    # conf's extra_data_shape after the header's, alike
    jt2 = JTrainer(jparse(JOIN_CONF))
    jt2.load_model(io.BytesIO(tbuf.getvalue()))
    tt2 = NetTrainer(parse_config_string(JOIN_CONF))
    tt2.load_model(io.BytesIO(jbuf.getvalue()))
    assert tt2.net_cfg.extra_data_num == jt2.net_cfg.extra_data_num == 1
    assert [int(v) for v in tt2.net_cfg.extra_shape] == \
        [int(v) for v in jt2.net_cfg.extra_shape]
    assert [int(v) for v in tt2.net_cfg.extra_shape[:3]] == [1, 1, 6]
    for k, d in jt.params.items():
        for f, v in d.items():
            np.testing.assert_array_equal(np.asarray(jt2.params[k][f]),
                                          np.asarray(v))
            np.testing.assert_array_equal(tt2.params[k][f].numpy(),
                                          np.asarray(v))
    np.testing.assert_allclose(
        tt2.extract_feature(DataBatch(x, y, extra_data=[e]), 'top[-1]'),
        jt2.extract_feature(JBatch(x, y, extra_data=[e]), 'top[-1]'),
        rtol=RTOL, atol=ATOL)


# --- the K-step window -------------------------------------------------------

def test_attach_round_demotes_the_window_for_that_round_only(attach_dir):
    cfg = _section(attach_dir, (('batch_size', '4'), ('round_batch', '1')))

    def run(k):
        _, tr = _twins('eta = 0.1\nmomentum = 0.9\n')
        plan = ExecutionPlan.resolve(requested_k=k, silent=True)
        it = tcreate(cfg)
        it.init()
        demotions = []
        for _ in range(2):          # two rounds
            stepper = plan.round_stepper(tr)
            stepper.on_demote = demotions.append
            assert not stepper.demoted
            for batch in it:
                stepper.feed(batch)
            stepper.finish()
            assert stepper.demoted == (k > 1)
        assert plan.k == k          # the plan keeps its K
        return tr, demotions

    windowed, demotions = run(4)
    per_step, none = run(1)
    assert demotions == ['extra_data', 'extra_data'] and none == []
    assert windowed.sample_counter == per_step.sample_counter == 8
    for k, d in per_step.params.items():
        for f, v in d.items():
            assert torch.equal(windowed.params[k][f], v), (k, f)
