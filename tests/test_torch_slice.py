"""The predict-serving slice end to end: a narrow AlexNet in both packages.

The net keeps AlexNet's layer kinds, order, groups and LRNs (conv k11
s4 → relu → max pool → LRN → grouped conv k5 p2 → relu → pool → LRN →
conv k3 → grouped convs → pool → fc/relu/dropout ×2 → fc → softmax)
with narrow widths (16..48 channels, fc 64/64/10) and a 67×67 input —
the smallest square input for which pool5's 3×3 window still fits (at
35×35 the map before pool5 is 1×1, which the pooling layer refuses).
Checked three ways, on the CPU:

* JAX ``Net(dev='cpu')`` and the port's ``Net(dev='cpu')``, with the
  JAX weights carried by ``interop.params_from_jax``, give the same
  scores — for each of the port's kernel modes (``auto``, forced on,
  forced off / unfused);
* a model file the JAX package wrote loads in the port and scores the
  same, and one the port wrote loads in the JAX package;
* ``serve_start`` / ``serve_scores`` answer requests (concurrently,
  split across buckets) with ``compile_count`` ≤ the number of buckets,
  and hot-swap weights.

Tolerance: rtol 1e-4, atol 1e-5 on the softmax scores (f32 through eight
layers whose sums run in different orders in the two frameworks).

And the slice as the reference AlexNet conf trains it: dropout 0.5 on
fc6 and fc7, ``compute_type=bfloat16`` and ``use_pallas=1``, one step of
each package from the same ``seed`` (no weights carried across: both
draw JAX's initial weights and dropout masks), JAX's Pallas kernels in
interpret mode, the port's plain versions.  Each fullc and conv weight's
change lies within one bf16 step of JAX's (``2^-7 |jax| + 1e-3
mean|jax|``, element by element); a bias, whose gradient JAX sums in
bf16, by the 1.5x rule against JAX's f32 step of the same seed.
"""

import threading
import time

import numpy as np
import pytest

from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.ops import threefry
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.ops.kernels import launch_counts

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-4, 1e-5

NARROW_ALEXNET = """
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 16
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[3->4] = conv:conv2
  ngroup = 2
  nchannel = 32
  kernel_size = 5
  pad = 2
layer[4->4] = relu
layer[4->5] = max_pooling
  kernel_size = 3
  stride = 2
layer[5->6] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[6->7] = conv:conv3
  nchannel = 48
  kernel_size = 3
  pad = 1
layer[7->7] = relu
layer[7->8] = conv:conv4
  nchannel = 48
  ngroup = 2
  kernel_size = 3
  pad = 1
layer[8->8] = relu
layer[8->9] = conv:conv5
  nchannel = 32
  ngroup = 2
  kernel_size = 3
  pad = 1
  init_bias = 0.1
layer[9->9] = relu
layer[9->10] = max_pooling
  kernel_size = 3
  stride = 2
layer[10->11] = flatten
layer[11->12] = fullc:fc6
  nhidden = 64
  init_bias = 0.1
layer[12->13] = relu
layer[13->13] = dropout
  threshold = 0.5
layer[13->14] = fullc:fc7
  nhidden = 64
  init_bias = 0.1
layer[14->15] = relu
layer[15->15] = dropout
  threshold = 0.5
layer[15->16] = fullc:fc8
  nhidden = 10
layer[16->16] = softmax
netconfig=end
input_shape = 3,67,67
random_type = xavier
"""


def _data(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 67, 67).astype(
        np.float32)


@pytest.fixture(scope='module')
def jax_net():
    net = JNet(dev='cpu', cfg=NARROW_ALEXNET)
    net.init_model()
    return net


@pytest.fixture(scope='module')
def jax_params(jax_net):
    return {k: {f: np.asarray(v) for f, v in d.items()}
            for k, d in jax_net._trainer.params.items()}


@pytest.fixture(scope='module')
def jax_scores(jax_net):
    return np.asarray(jax_net.extract(_data(16), 'top[-1]'))


def _port_net(params, **net_params):
    net = Net(dev='cpu', cfg=NARROW_ALEXNET)
    for k, v in net_params.items():
        net.set_param(k, v)
    net.init_model()
    net.trainer.params = params_from_jax(params)
    return net


@pytest.mark.parametrize('net_params', [
    {}, {'use_pallas': '1'}, {'use_pallas': '1', 'fuse': '1'},
    {'use_pallas': '0', 'fuse': '0'}],
    ids=['auto', 'kernels_on', 'fuse1', 'stock'])
def test_port_scores_match_jax(jax_params, jax_scores, net_params):
    net = _port_net(jax_params, **net_params)
    got = net.predict_scores(_data(16))
    assert got.shape == (16, 10)
    assert np.ptp(jax_scores) > 1e-3      # the scores do vary
    np.testing.assert_allclose(got, jax_scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(net.predict(_data(16)),
                                  got.argmax(axis=1).astype(np.float32))


def test_port_takes_the_kernel_path_it_reports():
    net = Net(dev='cpu', cfg=NARROW_ALEXNET)
    net.init_model()
    pairs = net.trainer.net._convact_pairs
    assert sorted(pairs) == [0, 4, 8, 10, 12]       # every conv + its relu
    before = launch_counts()
    net.predict_scores(_data(2))
    assert launch_counts() == before                 # CPU: plain versions


def test_jax_model_file_loads_in_the_port(jax_net, jax_scores, tmp_path):
    path = str(tmp_path / '0001.model')
    jax_net.save_model(path)
    net = Net(dev='cpu', cfg=NARROW_ALEXNET)
    net.load_model(path)
    np.testing.assert_allclose(net.predict_scores(_data(16)), jax_scores,
                               rtol=RTOL, atol=ATOL)


def test_port_model_file_loads_in_jax(jax_params, jax_scores, tmp_path):
    path = str(tmp_path / '0002.model')
    _port_net(jax_params).save_model(path)
    back = JNet(dev='cpu', cfg=NARROW_ALEXNET)
    back.load_model(path)
    np.testing.assert_allclose(np.asarray(back.extract(_data(16),
                                                       'top[-1]')),
                               jax_scores, rtol=RTOL, atol=ATOL)


def test_seeded_init_is_reproducible():
    a = Net(dev='cpu', cfg=NARROW_ALEXNET + 'seed = 5\n')
    b = Net(dev='cpu', cfg=NARROW_ALEXNET + 'seed = 5\n')
    a.init_model()
    b.init_model()
    np.testing.assert_array_equal(a.predict_scores(_data(3)),
                                  b.predict_scores(_data(3)))


def test_serving_answers_requests_within_the_bucket_bound(jax_params):
    net = _port_net(jax_params)
    want = net.predict_scores(_data(40, seed=1))
    net.serve_start(buckets='8,16', deadline=60.0, max_wait=0.01)
    try:
        engine = net.engine
        assert engine.compile_count == 2            # warmed: both buckets
        sizes = [3, 8, 13, 1, 5, 10]                 # 40 rows in all
        offs = np.cumsum([0] + sizes)
        data = _data(40, seed=1)
        got = [None] * len(sizes)

        def client(i):
            got[i] = net.serve_scores(data[offs[i]:offs[i + 1]])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_allclose(np.concatenate(got), want, rtol=RTOL,
                                   atol=ATOL)
        # an oversize request splits into max-bucket chunks
        big = net.serve_scores(data[:37])
        np.testing.assert_allclose(big, want[:37], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(net.serve_predict(data[:4]),
                                      want[:4].argmax(axis=1))
        assert engine.compile_count <= len(engine.buckets)
        stats = net.serve_stats()
        assert 'serve-requests:' in stats
    finally:
        net.serve_stop()


def test_serving_hot_swap_changes_the_answers(jax_params):
    net = _port_net(jax_params)
    net.serve_start(buckets='8', deadline=60.0)
    try:
        x = _data(4, seed=2)
        before = net.serve_scores(x)
        zeroed = {k: dict(d) for k, d in jax_params.items()}
        top = max(zeroed, key=int)
        zeroed[top] = {'wmat': np.zeros_like(zeroed[top]['wmat']),
                       'bias': np.arange(10, dtype=np.float32)}
        net.engine.swap_params(zeroed, version='v2')
        after = net.serve_scores(x)
        assert not np.allclose(before, after)
        np.testing.assert_array_equal(after.argmax(axis=1), [9] * 4)
        assert net.engine.swap_count == 1 and net.engine.version == 'v2'
        with pytest.raises(ValueError):
            net.engine.swap_params({top: zeroed[top]})
    finally:
        net.serve_stop()


class _SlowEngine:
    """A stand-in engine: one score per row, after a fixed delay."""

    buckets = (4, 8)

    def __init__(self, delay):
        self.delay = delay
        self.gate = threading.Event()

    def predict_scores(self, data):
        self.gate.wait(self.delay)
        return np.asarray(data, np.float32).reshape(len(data), -1)[:, :1]


def test_batcher_sheds_typed_and_counts_every_request_once():
    from cxxnet_tpu_torch.runtime.faults import (DeadlineExceededError,
                                                 ServeOverloadError)
    from cxxnet_tpu_torch.serve import DynamicBatcher
    eng = _SlowEngine(delay=5.0)
    b = DynamicBatcher(eng, max_queue=2, max_wait=0.0, deadline=0.2)
    try:
        first = b.submit_async(np.ones((2, 3), np.float32))   # blocks engine
        t_end = time.monotonic() + 10
        while b.depth() and time.monotonic() < t_end:    # worker took it
            time.sleep(0.01)
        queued = [b.submit_async(np.ones((1, 3), np.float32))
                  for _ in range(2)]
        with pytest.raises(ServeOverloadError):
            b.submit_async(np.ones((1, 3), np.float32))
        with pytest.raises(DeadlineExceededError):
            b.wait(queued[0])
        eng.gate.set()                                        # release
        np.testing.assert_array_equal(b.wait(first), np.ones((2, 1)))
    finally:
        assert b.close(10)
    for r in queued:
        assert isinstance(r.error, DeadlineExceededError)
    st = b.stats
    assert st.get('submitted') == 4
    assert st.get('requests') + st.get('expired') + st.get('rejected') \
        + st.get('abandoned') == 4


def test_batcher_coalesces_in_order_without_splitting():
    from cxxnet_tpu_torch.serve import DynamicBatcher
    b = DynamicBatcher(_SlowEngine(delay=0.0), max_wait=0.2, deadline=5.0)
    try:
        reqs = [b.submit_async(np.full((n, 2), i, np.float32))
                for i, n in enumerate((3, 4, 2))]
        for i, (r, n) in enumerate(zip(reqs, (3, 4, 2))):
            np.testing.assert_array_equal(b.wait(r), np.full((n, 1), i))
    finally:
        assert b.close(10)
    # 3 + 4 fill bucket 8's window to 7; the 2-row request would overflow
    # max_batch=8 and rides the next batch instead of being split
    assert b.stats.get('batches[b8]') == 1
    assert b.stats.get('batches[b4]') == 1


# --- the slice as the reference conf trains it: dropout, bf16, kernels ------

BF16_TRAIN = NARROW_ALEXNET + """
wmat:lr = 0.01
bias:lr = 0.02
momentum = 0.9
wmat:wd = 0.0005
bias:wd = 0
metric = error
batch_size = 4
seed = 20261016
use_pallas = 1
"""


def _one_step_change(cls, cfg):
    """One update of a fresh ``cls`` net: SGD's momentum slot (the step's
    weight change, ``-lr (g + wd w)``) by (layer, field), as f32 numpy."""
    import jax.numpy as jnp
    net = cls(dev='cpu', cfg=cfg)
    net.init_model()
    x = _data(4, seed=3)
    y = np.arange(4) % 10
    net.update(x, y)
    tr = net._trainer if cls is JNet else net.trainer
    return {(k, f): np.asarray(jnp.asarray(v).astype(jnp.float32))
            if cls is JNet else v.detach().float().numpy()
            for k, fs in tr.opt_state['m'].items() for f, v in fs.items()}


def test_bf16_kernel_step_with_dropout_matches_jax_from_the_seed(
        monkeypatch):
    monkeypatch.setenv('CXXNET_PALLAS', '1')   # restored after the test
    counts = launch_counts()
    got = _one_step_change(Net, BF16_TRAIN + 'compute_type = bfloat16\n')
    launched = {k: v - counts[k] for k, v in launch_counts().items()}
    assert not any(launched.values()), launched     # plain versions
    jax16 = _one_step_change(JNet, BF16_TRAIN + 'compute_type = bfloat16\n')
    jax32 = _one_step_change(JNet, BF16_TRAIN + 'compute_type = float32\n')
    assert sorted(got) == sorted(jax16)
    for key, want in jax16.items():
        g = got[key]
        if key[1] == 'wmat':
            lim = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).mean()
            assert (np.abs(g - want) <= lim).all(), key
        else:
            ref = jax32[key]
            bound = 1.5 * np.abs(want - ref).max() \
                + 2.0 ** -8 * np.abs(ref).max()
            assert np.abs(g - ref).max() <= bound, key
    # the dropout masks are live: fc6's output is halved in both packages
    assert np.abs(got[('16', 'wmat')]).max() > 0
