"""Conv+BN folding of ``cxxnet_tpu_torch`` (``serve.fold_bn``,
``nnet/fold.py``) on the CPU, against the JAX package's
(``tests/test_cnn_fused.py:261-299``).

* the same foldable pairs as JAX's ``plan_conv_bn_pairs``, on a small
  BN net, the reference Inception-BN conf (no pair: its convs have no
  bias, which the fold needs) and the same conf with conv biases;
* folded weights against JAX's ``fold_params`` on the same weights and
  calibration batch, within the pinned ``FOLD_RTOL`` / ``FOLD_ATOL``
  (the JAX package's values, asserted equal here);
* a ``fold_bn=1`` ``PredictEngine``'s scores against the unfolded
  engine's and against JAX's folded engine on the calibration batch,
  within the same tolerances; the re-fold on a hot swap, the guard
  against folding the engine's own tree twice, ``FoldError`` when the
  proof fails, the bf16 tier served unfolded, and ``serve.fold_bn=1``
  through the wrapper, the C API's option and the CLI.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.nnet import fold as jfold
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.serve.engine import PredictEngine as JEngine
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.nnet import fold
from cxxnet_tpu_torch.nnet.fold import FOLD_ATOL, FOLD_RTOL, FoldError
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve.engine import PredictEngine
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


# JAX tests/test_cnn_fused.py's conv+BN net
FOLD_CONF = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = conv:c2
  kernel_size = 3
  pad = 1
  stride = 2
  nchannel = 16
layer[4->5] = batch_norm:bn2
layer[5->6] = relu
layer[6->7] = flatten
layer[7->8] = fullc:fc1
  nhidden = 10
layer[8->9] = softmax
netconfig = end

input_shape = 3,12,12
batch_size = 8
random_type = xavier
"""


def _calib(n=8):
    return np.random.RandomState(3).randn(n, 3, 12, 12).astype(np.float32)


def _pair(conf=FOLD_CONF):
    """A JAX trainer and a port trainer on the same weights."""
    jt = JTrainer(jparse(conf + 'dev = cpu\n'))
    jt.init_model()
    tt = NetTrainer(parse_config_string(conf + 'dev = cpu\n'))
    tt.init_model()
    tt.params = params_from_jax(
        {k: {f: np.asarray(v) for f, v in d.items()}
         for k, d in jt.params.items()})
    return jt, tt


def test_pinned_tolerances_are_jax():
    assert (FOLD_RTOL, FOLD_ATOL) == (jfold.FOLD_RTOL, jfold.FOLD_ATOL)


def _with_biases(conf: str) -> str:
    return conf.replace('  no_bias = 1\n', '')


@pytest.mark.parametrize('which', ['small', 'inception_bn',
                                   'inception_bn_biases'])
def test_plans_the_same_pairs_as_jax(which):
    from cxxnet_tpu.nnet.net import Net as JGraph
    from cxxnet_tpu.nnet.net_config import NetConfig as JConfig
    from cxxnet_tpu_torch.models.builders import inception_bn_conf
    from cxxnet_tpu_torch.nnet.net import Net as TGraph
    from cxxnet_tpu_torch.nnet.net_config import NetConfig as TConfig
    conf = {'small': FOLD_CONF, 'inception_bn': inception_bn_conf(),
            'inception_bn_biases': _with_biases(inception_bn_conf())}[which]
    jc, tc = JConfig(), TConfig()
    jc.configure(jparse(conf))
    tc.configure(parse_config_string(conf))
    got = fold.plan_conv_bn_pairs(TGraph(tc))
    assert got == jfold.plan_conv_bn_pairs(JGraph(jc))
    assert len(got) == {'small': 2, 'inception_bn': 0,
                        'inception_bn_biases': 69}[which]


def test_folded_weights_match_jax_fold_params():
    import jax.numpy as jnp
    jt, tt = _pair()
    calib = _calib()
    jparams, jrep = jfold.fold_params(jt.net, jt.params, jnp.asarray(calib))
    tparams, trep = fold.fold_params(tt.net, tt.params, calib, tt._ctx())
    assert trep['pairs'] == jrep['pairs'] == [('c1', 'bn1'), ('c2', 'bn2')]
    assert trep['bn_layers'] == jrep['bn_layers']
    for k, d in jparams.items():
        for f, v in d.items():
            np.testing.assert_allclose(tparams[k][f].numpy(), np.asarray(v),
                                       rtol=FOLD_RTOL, atol=FOLD_ATOL,
                                       err_msg=f'{k}/{f}')
    assert trep['max_abs_err'] <= FOLD_ATOL + FOLD_RTOL


@pytest.fixture()
def fold_engines():
    jt, tt = _pair()
    calib = _calib()
    plain = PredictEngine(tt, (8,))
    folded = PredictEngine(tt, (8,), fold_bn=1, fold_batch=calib)
    return jt, tt, calib, plain, folded


def test_fold_engine_serves_equal_scores(fold_engines):
    """On the calibration batch (BN normalizes with the batch's own
    statistics, so the frozen fold is exact only there) the folded
    engine's scores equal the unfolded engine's and JAX's folded
    engine's."""
    jt, _, calib, plain, folded = fold_engines
    view = folded.fold_view()
    assert view['pairs'] == [('c1', 'bn1'), ('c2', 'bn2')]
    assert view['bn_layers'] == [1, 4]
    assert view['max_abs_err'] <= FOLD_ATOL + FOLD_RTOL
    assert plain.fold_view() is None
    s_plain = plain.predict_scores(calib)
    s_fold = folded.predict_scores(calib)
    np.testing.assert_allclose(s_fold, s_plain, rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)
    s_jax = JEngine(jt, (8,), fold_bn=1, fold_batch=calib) \
        .predict_scores(calib)
    np.testing.assert_allclose(s_fold, np.asarray(s_jax), rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)
    assert not np.array_equal(folded.params['0']['wmat'].numpy(),
                              plain.params['0']['wmat'].numpy())


def test_fold_hot_swap_refolds(fold_engines):
    """A hot swap hands the engine raw conv+BN weights: they are folded
    again, not served unfolded through the pass-through BNs."""
    _, tt, calib, _, folded = fold_engines
    s0 = folded.predict_scores(calib)
    folded.swap_params(tt.params)
    np.testing.assert_array_equal(folded.predict_scores(calib), s0)
    assert folded.swap_count == 1


def test_fold_double_pass_identity_guard(fold_engines):
    """Re-passing the engine's own placed tree is the identity: folding
    it twice would corrupt the weights."""
    _, tt, calib, _, folded = fold_engines
    s0 = folded.predict_scores(calib)
    placed = folded.place_params(tt.params)
    assert folded.place_params(placed) is placed
    folded.swap_params(placed)
    np.testing.assert_array_equal(folded.predict_scores(calib), s0)


def test_fold_error_when_the_proof_fails(monkeypatch):
    """The proof bites: a fold whose shift is off by 1e-2 raises
    ``FoldError`` instead of serving."""
    _, tt = _pair()
    right = fold.fold_scale_shift

    def wrong(gamma, beta, mean, var, eps):
        scale, shift = right(gamma, beta, mean, var, eps)
        return scale, shift + 1e-2

    monkeypatch.setattr(fold, 'fold_scale_shift', wrong)
    with pytest.raises(FoldError, match='equality proof'):
        PredictEngine(tt, (8,), fold_bn=1, fold_batch=_calib())


@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
def test_quantized_tiers_serve_unfolded(dtype):
    _, tt = _pair()
    calib = _calib()
    eng = PredictEngine(tt, (8,), dtype=dtype, fold_bn=1, fold_batch=calib)
    assert eng.fold_view() is None and not eng._fold_bn_layers
    np.testing.assert_array_equal(
        eng.predict_scores(calib),
        PredictEngine(tt, (8,), dtype=dtype).predict_scores(calib))


def test_fold_proves_itself_on_inception_bn_with_biases():
    """The full-width Inception-BN graph with conv biases (69 pairs, the
    card's ``fold`` phase at batch 256) folds within the pinned
    tolerances here at batch 2.  (Its folded weights are not held to
    JAX's: past the first layer each fold freezes statistics of
    activations that the two packages sum in different orders.)"""
    from cxxnet_tpu_torch.models.builders import inception_bn_conf
    conf = _with_biases(inception_bn_conf(num_class=10)) + 'batch_size = 2\n'
    tt = NetTrainer(parse_config_string(conf + 'dev = cpu\n'))
    tt.init_model()
    calib = np.random.RandomState(5).randn(2, 3, 224, 224).astype(
        np.float32)
    tparams, trep = fold.fold_params(tt.net, tt.params, calib, tt._ctx())
    assert len(trep['pairs']) == 69 and len(trep['bn_layers']) == 69
    assert trep['max_abs_err'] <= FOLD_ATOL + FOLD_RTOL
    assert not torch.equal(tparams['0']['wmat'], tt.params['0']['wmat'])


def test_wrapper_and_c_api_carry_fold_bn():
    from cxxnet_tpu_torch import capi
    _, tt = _pair()
    calib = _calib()
    want = PredictEngine(tt, (8,), fold_bn=1).predict_scores(calib)
    net = Net(dev='cpu', cfg=FOLD_CONF)
    net.init_model()
    net.trainer.params = tt.params
    net.serve_start(buckets='8', fold_bn=1, fold_batch=calib)
    assert net.engine.fold_view()['pairs'] == [('c1', 'bn1'), ('c2', 'bn2')]
    net.serve_stop()
    capi.net_serve_start(net, 'buckets=8;fold_bn=1')
    np.testing.assert_array_equal(net.serve_scores(calib), want)
    net.serve_stop()


def test_cli_serve_fold_bn(tmp_path, capsys, monkeypatch):
    """``task=serve serve.fold_bn=1``: the fold line on stdout and one
    prediction per test image."""
    from cxxnet_tpu_torch.main import main as tmain
    from test_io_perf import _write_mnist
    _write_mnist(tmp_path, n_train=200, n_test=50)
    conf = """
data = train
iter = mnist
  path_img = train-img.gz
  path_label = train-lab.gz
  input_flat = 0
iter = end
pred = pred.txt
iter = mnist
  path_img = test-img.gz
  path_label = test-lab.gz
  input_flat = 0
iter = end
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  stride = 2
  pad = 1
  nchannel = 4
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 4
layer[5->5] = softmax
netconfig = end
input_shape = 1,28,28
batch_size = 50
dev = cpu
eta = 0.1
num_round = 1
"""
    (tmp_path / 'bn.conf').write_text(conf)
    monkeypatch.chdir(tmp_path)
    assert tmain(['bn.conf', 'save_model=1', 'silent=1']) == 0
    capsys.readouterr()
    assert tmain(['bn.conf', 'task=serve', 'model_in=models/0001.model',
                  'serve.buckets=1,50', 'serve.fold_bn=1']) == 0
    out = capsys.readouterr().out
    assert 'serve: folded 1 conv+BN pair(s) [c1+bn1] — proof max_abs_err' \
        in out
    assert len((tmp_path / 'pred.txt').read_text().split()) == 50
