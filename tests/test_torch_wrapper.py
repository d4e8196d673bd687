"""The port's ``wrapper`` (``Net.extract``, ``predict_stream``,
``extract_stream``, ``get_weight`` / ``set_weight``, the module-level
``train`` and ``train_iter``) against the JAX package's, on the CPU.

* weights: both packages read one model file the JAX package wrote;
  ``get_weight`` is bitwise JAX's for every layer and tag, a grouped
  conv's disk layout included (``to_disk_layout`` / ``from_disk_layout``
  held against JAX's at ``ngroup`` 1, 2 and 3), and after the same
  ``set_weight`` calls the two packages save byte-identical model files;
* forwards (``extract`` at named and ``top[-k]`` nodes, ``predict``,
  the streams and their C-ABI glue ``capi.net_*_iter``): within ``RTOL``
  / ``ATOL`` of JAX's (f32, the same weights, sums in another order);
* training: ``train`` and ``train_iter`` from a xavier init (bitwise the
  same in both packages) for a few updates: the weights within
  ``test_torch_train.py``'s rtol 1e-4 / atol 1e-6, the ``train_iter``
  eval lines within one instance;
* ``cxxnet_tpu_torch/example/mnist.py`` runs on synthetic idx files, as
  ``tests/test_wrapper.py`` runs the JAX package's.
"""

import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu import capi as jcapi
from cxxnet_tpu import wrapper as jw
from cxxnet_tpu.nnet import checkpoint as jckpt
from cxxnet_tpu_torch import capi as tcapi
from cxxnet_tpu_torch import wrapper as tw
from cxxnet_tpu_torch.layers.base import kConv
from cxxnet_tpu_torch.nnet import checkpoint as tckpt
from cxxnet_tpu_torch.runtime import faults as tfaults
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from tests.test_io import write_mnist

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6

MLP_CFG = """
netconfig=start
layer[+1:f1] = fullc:fc1
  nhidden = 16
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 3
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 10
dev = cpu
eta = 0.3
momentum = 0.9
metric = error
random_type = xavier
"""

CONV_CFG = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 4
layer[1->2] = relu
layer[2->3] = conv:cv2
  kernel_size = 3
  nchannel = 6
  ngroup = 2
layer[3->4] = relu
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 3
  init_bias = 0.5
layer[6->6] = softmax
netconfig=end
input_shape = 4,6,6
batch_size = 5
dev = cpu
random_type = xavier
"""


def _pair(cfg, tmp_path):
    """A JAX ``Net`` with its seeded init saved to a file, and the port's
    ``Net`` loaded from that file."""
    jnet = jw.Net(dev='cpu', cfg=cfg)
    jnet.init_model()
    path = str(tmp_path / 'j.model')
    jnet.save_model(path)
    tnet = tw.Net(dev='cpu', cfg=cfg)
    tnet.load_model(path)
    return jnet, tnet


@pytest.mark.parametrize('groups', [1, 2, 3])
def test_disk_layout_matches_jax(groups):
    rng = np.random.RandomState(groups)
    kh, kw, cin_g, cout = 3, 2, 4, 6
    hwio = rng.randn(kh, kw, cin_g, cout).astype(np.float32)
    want = jckpt.to_disk_layout(kConv, 'wmat', hwio, groups)
    got = tckpt.to_disk_layout(kConv, 'wmat', hwio, groups)
    assert got.shape == want.shape == (groups, cout // groups,
                                       cin_g * kh * kw)
    np.testing.assert_array_equal(got, want)

    class Layer:
        class param:
            kernel_height, kernel_width = kh, kw
    back = tckpt.from_disk_layout(kConv, 'wmat', got, Layer)
    np.testing.assert_array_equal(back, jckpt.from_disk_layout(
        kConv, 'wmat', want, Layer))
    np.testing.assert_array_equal(back, hwio)


@pytest.mark.parametrize('cfg', ['mlp', 'conv'])
def test_get_weight_matches_jax(cfg, tmp_path):
    cfg, layers = {'mlp': (MLP_CFG, ('fc1', 'fc2')),
                   'conv': (CONV_CFG, ('cv1', 'cv2', 'fc'))}[cfg]
    jnet, tnet = _pair(cfg, tmp_path)
    for layer in layers:
        for tag in ('wmat', 'bias'):
            want = jnet.get_weight(layer, tag)
            got = tnet.get_weight(layer, tag)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=(layer, tag))
    if 'cv2' in layers:   # (ngroup, nchannel / ngroup, cin / ngroup * 3 * 3)
        assert tnet.get_weight('cv2', 'wmat').shape == (2, 3, 2 * 3 * 3)


def test_set_weight_matches_jax(tmp_path):
    jnet, tnet = _pair(CONV_CFG, tmp_path)
    rng = np.random.RandomState(7)
    for layer in ('cv1', 'cv2', 'fc'):
        for tag in ('wmat', 'bias'):
            w = rng.randn(*jnet.get_weight(layer, tag).shape).astype(
                np.float32)
            jnet.set_weight(w, layer, tag)
            tnet.set_weight(w, layer, tag)
            np.testing.assert_array_equal(tnet.get_weight(layer, tag), w)
    with pytest.raises(ValueError, match='shape'):
        tnet.set_weight(np.zeros((2, 2), np.float32), 'fc', 'wmat')
    with pytest.raises(ValueError, match='bias or wmat'):
        tnet.get_weight('fc', 'gamma')
    jnet.save_model(str(tmp_path / 'js.model'))
    tnet.save_model(str(tmp_path / 'ts.model'))
    assert (tmp_path / 'ts.model').read_bytes() == \
        (tmp_path / 'js.model').read_bytes()
    x = rng.randn(5, 4, 6, 6).astype(np.float32)
    np.testing.assert_allclose(tnet.predict_scores(x),
                               np.asarray(jnet.extract(x, 'top[-1]')),
                               rtol=RTOL, atol=ATOL)


def test_set_weight_leaves_a_live_engine_alone(tmp_path):
    _, tnet = _pair(MLP_CFG, tmp_path)
    x = np.random.RandomState(0).randn(4, 1, 1, 64).astype(np.float32)
    tnet.serve_start(buckets='4', warm=False)
    try:
        before = tnet.serve_scores(x)
        tnet.set_weight(np.zeros((3, 16), np.float32), 'fc2', 'wmat')
        np.testing.assert_array_equal(tnet.serve_scores(x), before)
        np.testing.assert_allclose(tnet.predict_scores(x), 1.0 / 3,
                                   rtol=0, atol=1e-6)
    finally:
        tnet.serve_stop()


@pytest.mark.parametrize('node', ['f1', 'top[-1]', 'top[-2]', 'top[-3]'])
def test_extract_matches_jax(node, tmp_path):
    jnet, tnet = _pair(MLP_CFG, tmp_path)
    x = np.random.RandomState(3).randn(10, 1, 1, 64).astype(np.float32)
    want = np.asarray(jnet.extract(x, node))
    got = tnet.extract(x, node)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))


def _mnist_iters(tmp_path, mod, batch_size=16):
    pi, pl, _, _ = write_mnist(str(tmp_path))
    return mod.DataIter(f"""
iter = mnist
  path_img = "{pi}"
  path_label = "{pl}"
  batch_size = {batch_size}
  silent = 1
iter = end
""")


def test_streams_match_jax(tmp_path):
    jnet, tnet = _pair(MLP_CFG.replace('batch_size = 10', 'batch_size = 16'),
                       tmp_path)
    jit, tit = _mnist_iters(tmp_path, jw), _mnist_iters(tmp_path, tw)
    tchunks = list(tnet.predict_stream(tit))
    assert [len(c) for c in tchunks] == [16, 16, 16]   # O(batch) chunks
    np.testing.assert_array_equal(np.concatenate(tchunks),
                                  np.concatenate(list(
                                      jnet.predict_stream(jit))))
    for node in ('top[-3]', 'top[-1]'):
        want = np.concatenate(list(jnet.extract_stream(jit, node)))
        got = np.concatenate(list(tnet.extract_stream(tit, node)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the C ABI's whole-iterator glue, rewinding the iterator itself
    np.testing.assert_array_equal(tcapi.net_predict_iter(tnet, tit),
                                  jcapi.net_predict_iter(jnet, jit))
    got = tcapi.net_extract_iter(tnet, tit, 'top[-3]')
    assert got.shape == (48, 1, 1, 16)
    np.testing.assert_allclose(got, jcapi.net_extract_iter(jnet, jit,
                                                           'top[-3]'),
                               rtol=RTOL, atol=ATOL)
    # the iterator's current batch, as extract reads it
    tit.before_first()
    jit.before_first()
    assert tit.next() and jit.next()
    np.testing.assert_allclose(tnet.extract(tit, 'top[-3]'),
                               jnet.extract(jit, 'top[-3]'),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError):
        next(tnet.extract_stream(np.zeros((1, 1, 1, 64)), 'top[-1]'))


def _close_weights(tnet, jnet, layers):
    for layer in layers:
        for tag in ('wmat', 'bias'):
            np.testing.assert_allclose(tnet.get_weight(layer, tag),
                                       jnet.get_weight(layer, tag),
                                       rtol=1e-4, atol=1e-6)


def test_train_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(10, 1, 1, 64).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    jnet = jw.train(MLP_CFG, x, y, 3, {'eta': 0.1})
    tnet = tw.train(MLP_CFG, x, y, 3, {'eta': 0.1, 'dev': 'cpu'})
    assert tnet.trainer.device.type == 'cpu'
    assert tnet.trainer.epoch_counter == 3
    _close_weights(tnet, jnet, ('fc1', 'fc2'))
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    assert tnet.extract(x, 'f1').shape == (10, 16)


def test_train_iter_matches_jax(tmp_path, capsys):
    cfg = MLP_CFG.replace('batch_size = 10', 'batch_size = 16')
    jit, tit = _mnist_iters(tmp_path, jw), _mnist_iters(tmp_path, tw)
    param = [('eta', '0.1'), ('seed', '3')]
    capsys.readouterr()
    jnet = jw.train_iter(cfg, jit, 2, param, eval_data=jit)
    jerr = capsys.readouterr().err
    tnet = tw.train_iter(cfg, tit, 2, param + [('dev', 'cpu')],
                         eval_data=tit)
    terr = capsys.readouterr().err
    assert tnet.trainer.epoch_counter == jnet._trainer.epoch_counter == 6
    _close_weights(tnet, jnet, ('fc1', 'fc2'))
    jl, tl = jerr.strip().splitlines(), terr.strip().splitlines()
    assert len(jl) == len(tl) == 2
    for a, b in zip(jl, tl):
        ka = [t.split(':')[0] for t in a.split('\t')]
        assert [t.split(':')[0] for t in b.split('\t')] == ka
        for ta, tb in zip(a.split('\t')[1:], b.split('\t')[1:]):
            assert abs(float(ta.split(':')[1])
                       - float(tb.split(':')[1])) * 48 <= 1.0 + 1e-9


def test_train_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device exists')
    x = np.zeros((10, 1, 1, 64), np.float32)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tw.train(MLP_CFG, x, np.zeros(10, np.float32), 1, {})


def test_serve_reload_is_not_ported(tmp_path):
    # ported (queue A item 8): Net.serve_reload and capi.net_serve_reload
    # verify, load, warm and swap a JAX-written checkpoint into the live
    # engine, whose scores are then JAX's on that file; a corrupt file is
    # refused and the old version keeps serving
    _, tnet = _pair(MLP_CFG, tmp_path)
    jnew = jw.Net(dev='cpu', cfg=MLP_CFG)
    jnew.set_param('seed', '5')
    jnew.init_model()
    path = str(tmp_path / 'new.model')
    jnew.save_model(path)
    jckpt.write_model_digest(path)
    x = np.random.RandomState(3).randn(4, 1, 1, 64).astype(np.float32)
    tnet.serve_start(buckets='1,8')
    try:
        before = tnet.serve_scores(x)
        tnet.serve_reload(path)
        assert tnet.engine.version == path and tnet.engine.swap_count == 1
        np.testing.assert_allclose(
            tnet.serve_scores(x), jnew.extract(x, 'top[-1]').reshape(4, -1),
            rtol=RTOL, atol=ATOL)
        tcapi.net_serve_reload(tnet, str(tmp_path / 'j.model'))
        np.testing.assert_allclose(tnet.serve_scores(x), before, rtol=RTOL,
                                   atol=ATOL)
        with open(path, 'r+b') as f:          # bytes flipped after digest
            f.seek(120)
            f.write(b'\xde\xad')
        with pytest.raises(tfaults.CheckpointCorruptError):
            tcapi.net_serve_reload(tnet, path)
        np.testing.assert_allclose(tnet.serve_scores(x), before, rtol=RTOL,
                                   atol=ATOL)
    finally:
        tnet.serve_stop()


def test_mnist_wrapper_example_runs(tmp_path):
    """``cxxnet_tpu_torch/example/mnist.py`` end to end on the CPU over
    synthetic idx files."""
    rng = np.random.RandomState(0)
    d = tmp_path / 'data'
    d.mkdir()
    for name, n in (('train', 300), ('t10k', 100)):
        img = np.zeros((n, 28, 28), np.uint8)
        y = rng.randint(0, 10, n).astype(np.uint8)
        for i in range(n):
            img[i, y[i] * 2:(y[i] + 1) * 2, :] = 200
        with gzip.open(d / f'{name}-images-idx3-ubyte.gz', 'wb') as f:
            f.write(struct.pack('>iiii', 2051, n, 28, 28))
            f.write(img.tobytes())
        with gzip.open(d / f'{name}-labels-idx1-ubyte.gz', 'wb') as f:
            f.write(struct.pack('>ii', 2049, n))
            f.write(y.tobytes())
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, 'cxxnet_tpu_torch', 'example', 'mnist.py'),
         'cpu'], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert 'fc1.wmat: (100, 784)' in r.stdout
    assert 'iter-vs-raw predict diff: 0.0' in r.stdout
    assert 'iter-vs-raw extract diff: 0.0' in r.stdout
    first = float(r.stdout.split('eval-error=')[1].splitlines()[0])
    after = float(r.stdout.split('eval-error-after=')[1].splitlines()[0])
    assert after <= first
