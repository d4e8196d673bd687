"""The CLI's other tasks in ``cxxnet_tpu_torch`` against the JAX package's,
on the CPU, from one model file the JAX CLI wrote.

The net is a copy of ``example/MNIST/MNIST_CONV.conf`` (dropout 0) over
synthetic idx files of four quadrant classes, trained two rounds by
``cxxnet_tpu.main``; every run below reads that file.

* ``task=pred_raw``: the rows against the JAX CLI's, within ``RTOL`` /
  ``ATOL``: f32 through five layers whose sums run in another order
  (~1e-6 relative), printed ``%g`` (six digits: 5e-6 relative);
* ``task=extract`` at ``top[-1]``, ``top[-3]`` and the node ``4``, as
  ``%g`` text and as raw ``<f4``, against JAX's at the same tolerance;
* ``task=serve``: the port's prediction file byte-equal to its own
  ``task=pred``'s, three buckets warmed, a ``[serve]`` stderr line (the
  contract ``tests/test_serve.py`` pins for the JAX CLI), and byte-equal
  to the JAX CLI's ``task=serve`` file from the same model;
* ``task=finetune`` into a net whose head is renamed and resized: the
  ``Copying layer`` lines equal JAX's; after ``init`` the copied layers
  bitwise the source file's and the fresh head equal to JAX's init from
  the seed (within ``NORMAL_TOL`` of its scale: the head is a gaussian
  draw, ``tests/test_torch_prng.py``); the epoch counter restarts at 0;
  after one round the eval lines agree as ``test_torch_train.py``'s CLI
  test holds them (error within one instance, logloss 1e-4 relative) and
  the saved epoch counter is that round's updates in both;
* the kaggle_bowl workflow on the port (``gen_img_list.py``, the port's
  ``im2bin``, train, ``task=pred_raw``, ``make_submission.py``), as
  ``tests/test_e2e_cli.py`` runs it for the JAX package.
"""

import csv
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from cxxnet_tpu.main import LearnTask as JLearnTask
from cxxnet_tpu.main import main as jmain
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.main import main as tmain
from cxxnet_tpu_torch.nnet import checkpoint
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from tests.test_torch_train import _write_idx
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-6
NORMAL_TOL = 2.0 ** -21
N_TRAIN, N_TEST = 600, 230     # 6 train batches a round; 2 test batches

PRED_SECTION = """pred = {out}
iter = mnist
    input_flat = 0
    path_img = "./data/t10k-images-idx3-ubyte.gz"
    path_label = "./data/t10k-labels-idx1-ubyte.gz"
iter = end
"""


@pytest.fixture(scope='module')
def work(tmp_path_factory):
    """The data, the conf, and ``mj/0002.model`` from the JAX CLI."""
    d = tmp_path_factory.mktemp('tasks')
    os.makedirs(d / 'data')
    _write_idx(str(d / 'data'), 'train', N_TRAIN, 1)
    _write_idx(str(d / 'data'), 't10k', N_TEST, 2)
    with open(os.path.join(ROOT, 'example', 'MNIST', 'MNIST_CONV.conf')) as f:
        conf = f.read().replace('threshold = 0.5', 'threshold = 0.0')
    (d / 'conv.conf').write_text(conf + 'metric = logloss\n')
    body = conf.split('data = train', 1)[0] + conf.split('iter = end\n', 2)[2]
    (d / 'pred.conf').write_text(PRED_SECTION.format(out='pred.txt') + body)
    old = os.getcwd()
    os.chdir(d)
    try:
        assert jmain(['conv.conf', 'dev=cpu', 'num_round=2', 'max_round=2',
                      'save_model=1', 'silent=1', 'model_dir=mj']) == 0
    finally:
        os.chdir(old)
    return d


def _run(fn, args):
    assert fn(list(args)) == 0


def _both(work, monkeypatch, args):
    monkeypatch.chdir(work)
    _run(jmain, ['pred.conf', 'dev=cpu', 'silent=1',
                 'model_in=mj/0002.model', *args, 'pred=j.out'])
    _run(tmain, ['pred.conf', 'dev=cpu', 'silent=1',
                 'model_in=mj/0002.model', *args, 'pred=t.out'])
    return work / 'j.out', work / 't.out'


def test_pred_raw_matches_jax(work, monkeypatch):
    jp, tp = _both(work, monkeypatch, ['task=pred_raw'])
    want, got = np.loadtxt(jp), np.loadtxt(tp)
    assert got.shape == want.shape == (200, 10)   # mnist drops the tail
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize('fmt', ['txt', 'bin'])
@pytest.mark.parametrize('node,width', [('top[-1]', 10), ('top[-3]', 100),
                                        ('4', 100)])
def test_extract_matches_jax(work, monkeypatch, node, width, fmt):
    jp, tp = _both(work, monkeypatch, ['task=extract',
                                       f'extract_node_name={node}',
                                       f'output_format={fmt}'])
    if fmt == 'txt':
        want, got = np.loadtxt(jp), np.loadtxt(tp)
    else:
        assert os.path.getsize(tp) == os.path.getsize(jp) == 200 * width * 4
        want = np.fromfile(jp, '<f4').reshape(200, width)
        got = np.fromfile(tp, '<f4').reshape(200, width)
    assert got.shape == want.shape == (200, width)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_extract_top_matches_pred_raw(work, monkeypatch):
    """``top[-1]`` in text is the ``pred_raw`` file, byte for byte."""
    monkeypatch.chdir(work)
    common = ['pred.conf', 'dev=cpu', 'silent=1', 'model_in=mj/0002.model']
    _run(tmain, common + ['task=pred_raw', 'pred=raw.out'])
    _run(tmain, common + ['task=extract', 'pred=ext.out'])
    assert (work / 'ext.out').read_bytes() == (work / 'raw.out').read_bytes()


def test_serve_matches_pred(work, monkeypatch, capsys):
    monkeypatch.chdir(work)
    common = ['pred.conf', 'dev=cpu', 'model_in=mj/0002.model']
    capsys.readouterr()
    _run(tmain, common + ['task=serve', 'serve.buckets=1,32,100',
                          'serve.deadline=60', 'silent=1',
                          'pred=serve.out'])
    out = capsys.readouterr()
    assert 'compiled 3 programs for 3 buckets' in out.out
    assert 'finished serving 200 instances' in out.out
    assert '[serve]' in out.err and 'serve-requests:' in out.err
    _run(tmain, common + ['task=pred', 'silent=1', 'pred=pred.out'])
    assert (work / 'serve.out').read_text() == (work / 'pred.out').read_text()
    assert len((work / 'pred.out').read_text().splitlines()) == 200


def test_serve_matches_jax(work, monkeypatch, capsys):
    """Both CLIs' ``task=serve`` on the same model file write the same
    predictions, and both warm the same three buckets."""
    capsys.readouterr()
    jp, tp = _both(work, monkeypatch, ['task=serve', 'serve.buckets=1,32,100',
                                       'serve.deadline=60'])
    out = capsys.readouterr().out
    assert out.count('compiled 3 programs for 3 buckets') == 2
    assert tp.read_text() == jp.read_text()
    assert len(tp.read_text().splitlines()) == 200


def _init_task(cls, conf, work, task):
    """A LearnTask of ``cls`` over ``conf`` at ``task``, through init()."""
    from cxxnet_tpu_torch.utils.config import parse_config_file
    lt = cls()
    pairs = [(k, v) for k, v in parse_config_file(str(work / conf))
             if k != 'dev']
    for k, v in pairs + [('dev', 'cpu'), ('task', task),
                         ('model_in', 'mj/0002.model'), ('silent', '1')]:
        lt.set_param(k, v)
    lt.init()
    return lt


def test_serve_builds_an_inference_only_trainer(work, monkeypatch):
    monkeypatch.chdir(work)
    tr = _init_task(LearnTask, 'pred.conf', work, 'serve').net_trainer
    assert tr.inference_only == 1
    assert tr.opt_state is None and tr.grad_acc is None


def _finetune_conf(work):
    conf = (work / 'conv.conf').read_text()
    conf = conf.replace('layer[5->6] = fullc:fc2\n  nhidden = 10',
                        'layer[5->6] = fullc:fc2_ft\n  nhidden = 4')
    assert 'fc2_ft' in conf
    (work / 'ft.conf').write_text(conf)
    return 'ft.conf'


def _read_model(path):
    """(NetConfig, epoch counter, disk-layout records) of a model file."""
    with open(path, 'rb') as f:
        f.read(4)
        cfg = NetConfig()
        cfg.load_net(f)
        (epoch,) = struct.unpack('<q', f.read(8))
        (n,) = struct.unpack('<Q', f.read(8))
        return cfg, epoch, checkpoint.blob_to_raw(cfg.layers, f.read(n))


def test_finetune_init_matches_jax(work, monkeypatch, capsys):
    monkeypatch.chdir(work)
    conf = _finetune_conf(work)
    capsys.readouterr()
    jt = _init_task(JLearnTask, conf, work, 'finetune')
    jout = capsys.readouterr().out
    tt = _init_task(LearnTask, conf, work, 'finetune')
    tout = capsys.readouterr().out
    copies = [ln for ln in tout.splitlines() if ln.startswith('Copying')]
    assert copies == ['Copying layer cv1', 'Copying layer fc1']
    assert copies == [ln for ln in jout.splitlines()
                      if ln.startswith('Copying')]
    assert tt.net_trainer.epoch_counter == jt.net_trainer.epoch_counter == 0
    src_cfg, src_epoch, src = _read_model(work / 'mj' / '0002.model')
    assert src_epoch == 12
    tp, jp = tt.net_trainer.params, jt.net_trainer.params
    names = {info.name: i for i, info in enumerate(src_cfg.layers)}
    for name in ('cv1', 'fc1'):
        i = names[name]
        layer = tt.net_trainer.net.layers[i]
        for f, arr in src[str(i)].items():
            got = tp[str(i)][f].numpy()
            want = checkpoint.from_disk_layout(src_cfg.layers[i].type, f,
                                               arr, layer)
            np.testing.assert_array_equal(got, want, err_msg=name)
            np.testing.assert_array_equal(got, np.asarray(jp[str(i)][f]))
    head = tt.net_trainer.net_cfg.get_layer_index('fc2_ft')
    got, want = tp[str(head)]['wmat'].numpy(), np.asarray(
        jp[str(head)]['wmat'])
    assert got.shape == want.shape == (100, 4)
    scale = float(np.abs(want).max())
    lim = NORMAL_TOL * scale * np.maximum(np.abs(want) / scale, 1.0)
    assert (np.abs(got - want) <= lim).all()
    np.testing.assert_array_equal(tp[str(head)]['bias'].numpy(),
                                  np.asarray(jp[str(head)]['bias']))


def _eval_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith('[')]


def test_finetune_round_matches_jax(work, monkeypatch, capsys):
    monkeypatch.chdir(work)
    conf = _finetune_conf(work)
    common = [conf, 'dev=cpu', 'task=finetune', 'model_in=mj/0002.model',
              'num_round=1', 'max_round=1', 'start_counter=1', 'save_model=1',
              'silent=1']
    capsys.readouterr()
    _run(jmain, common + ['model_dir=fj'])
    jerr = capsys.readouterr().err
    _run(tmain, common + ['model_dir=ft'])
    terr = capsys.readouterr().err
    jl, tl = _eval_lines(jerr), _eval_lines(terr)
    assert len(jl) == len(tl) == 1 and tl[0].startswith('[1]\t')
    for a, b in zip(jl[0].split('\t')[1:], tl[0].split('\t')[1:]):
        key, ja, tb = a.split(':')[0], float(a.split(':')[1]), \
            float(b.split(':')[1])
        assert b.split(':')[0] == key
        if key.endswith('error'):
            n = N_TRAIN if key.startswith('train') else 200
            assert abs(ja - tb) * n <= 1.0 + 1e-9, (key, ja, tb)
        else:
            assert tb == pytest.approx(ja, rel=1e-4), (key, ja, tb)
    _, tepoch, traw = _read_model(work / 'ft' / '0001.model')
    _, jepoch, jraw = _read_model(work / 'fj' / '0001.model')
    assert tepoch == jepoch == N_TRAIN // 100
    assert sorted(traw) == sorted(jraw)


def test_kaggle_bowl_workflow(tmp_path, monkeypatch):
    """gen_img_list over a class folder tree -> the port's im2bin ->
    train -> task=pred_raw score rows -> make_submission.py csv."""
    bowl = os.path.join(ROOT, 'example', 'kaggle_bowl')
    rng = np.random.RandomState(1)
    classes = ['acantharia', 'copepod', 'diatom']
    for ci, cls in enumerate(classes):
        d = tmp_path / 'train' / cls
        d.mkdir(parents=True)
        for k in range(6):
            img = np.zeros((24, 24, 3), np.uint8)
            img[ci * 8:(ci + 1) * 8, :, :] = rng.randint(130, 255, (8, 24, 3))
            Image.fromarray(img).save(d / f'{cls}{k}.png')
    with open(tmp_path / 'sample_submission.csv', 'w') as f:
        f.write('image,' + ','.join(classes) + '\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')

    def run(*cmd):
        subprocess.check_call([sys.executable, *cmd], cwd=str(tmp_path),
                              env=env)

    run(os.path.join(bowl, 'gen_img_list.py'), 'train',
        'sample_submission.csv', str(tmp_path / 'train'), 'img.lst')
    run('-m', 'cxxnet_tpu_torch.io.im2bin', 'img.lst', './', 'train.bin')
    conf = tmp_path / 'bowl_mini.conf'
    conf.write_text("""
data = train
iter = imgbin
  image_list = img.lst
  image_bin = train.bin
iter = end
netconfig = start
layer[0->1] = flatten
layer[1->2] = fullc:f1
  nhidden = 16
layer[2->3] = relu
layer[3->4] = fullc:f2
  nhidden = 3
layer[4->4] = softmax
netconfig = end
input_shape = 3,24,24
batch_size = 6
dev = cpu
eta = 0.05
momentum = 0.9
num_round = 6
metric = error
divideby = 256
silent = 1
""")
    monkeypatch.chdir(tmp_path)
    _run(tmain, [str(conf)])
    pred_conf = tmp_path / 'predraw.conf'
    pred_conf.write_text(conf.read_text().replace(
        'data = train', 'pred = test.txt', 1)
        + '\ntask = pred_raw\nmodel_in = ./models/0006.model\n')
    _run(tmain, [str(pred_conf)])
    rows = np.loadtxt(tmp_path / 'test.txt')
    assert rows.shape == (18, 3)
    np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=1e-4)
    run(os.path.join(bowl, 'make_submission.py'), 'sample_submission.csv',
        'img.lst', 'test.txt', 'out.csv')
    with open(tmp_path / 'out.csv', newline='') as f:
        got = list(csv.reader(f))
    assert got[0] == ['image'] + classes
    assert len(got) == 19
    lst = {os.path.basename(ln.rstrip('\n').split('\t')[2]):
           int(ln.split('\t')[1]) for ln in open(tmp_path / 'img.lst')}
    hits = sum(int(np.argmax([float(v) for v in row[1:]])) == lst[row[0]]
               for row in got[1:])
    assert hits >= 14, hits


@pytest.mark.parametrize('conf,pairs', [
    ('example/ImageNet/ImageNet.conf', 0),
    ('cxxnet_tpu_torch/example/ImageNet.conf', 5)])
def test_reference_conf_pairs_no_conv_under_auto(conf, pairs):
    """The reference ImageNet.conf's relus are out of place (``layer[1->2]
    = relu``): under ``auto`` neither package pairs a conv with such a
    relu, so its eval forward runs no conv kernel; the port's example
    conf (in-place relus) pairs all five."""
    from cxxnet_tpu.nnet.net import Net as JGraph
    from cxxnet_tpu.nnet.net_config import NetConfig as JNetConfig
    from cxxnet_tpu_torch.nnet.net import Net as TGraph
    from cxxnet_tpu_torch.utils.config import parse_config_file
    pairs_cfg = [p for p in parse_config_file(os.path.join(ROOT, conf))
                 if p[0] not in ('dev', 'compute_type')]
    jc, tc = JNetConfig(), NetConfig()
    jc.configure(pairs_cfg)
    tc.configure(pairs_cfg)
    jn, tn = JGraph(jc), TGraph(tc)
    assert tn._convact_pairs == jn._convact_pairs
    assert tn._convact_solo == jn._convact_solo == set()
    assert len(tn._convact_pairs) == pairs
