"""μ-cuDNN-style conv microbatching (``micro_batch``) in
``cxxnet_tpu_torch`` on the CPU, against its own unsplit conv and the JAX
package (JAX ``tests/test_cnn_fused.py:197-205, 314-394``).

* ``ops/microbatch.microbatched_conv``: the forward, ``dx`` and ``dw``
  bitwise equal to the unsplit conv at splits 2, 4 and 8, on the native
  lowering (grouped, strided and asymmetric-pad convs too) and on
  im2col;
* a training step (forward, backward, momentum update) at ``micro_batch
  = 2, 4, 8`` bitwise equal to the unsplit step, three times over; the
  K-step window at split 2 bitwise equal to the unsplit window and to
  the split per-step run;
* a split that does not divide the batch runs unsplit; ``fuse = 1`` with
  ``micro_batch = 2`` pairs no conv with the fused kernel, as in JAX;
* three steps at ``micro_batch = 2`` against the JAX trainer's, at JAX's
  bound for a conv lowering (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers.conv import (MICRO_BATCHED, conv_im2col,
                                          conv_native)
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops.microbatch import microbatched_conv
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

NET_RTOL, NET_ATOL = 1e-5, 1e-6


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# (x NHWC, w HWIO, strides, pad, groups)
GEOMETRY = {
    'same': ((8, 9, 9, 4), (3, 3, 4, 8), (1, 1), ((1, 1), (1, 1)), 1),
    'grouped': ((8, 9, 9, 4), (3, 3, 2, 6), (1, 1), ((1, 1), (1, 1)), 2),
    'strided': ((8, 19, 19, 3), (11, 11, 3, 4), (4, 4), ((0, 0), (0, 0)),
                1),
    'asym_pad': ((8, 11, 11, 3), (4, 4, 3, 5), (2, 2), ((1, 2), (3, 0)),
                 1),
}


def _cases():
    for split in (2, 4, 8):
        for lowering in ('native', 'im2col'):
            for geo in GEOMETRY:
                if lowering == 'im2col' and GEOMETRY[geo][4] != 1:
                    continue    # the gate sends im2col ungrouped convs only
                yield pytest.param(split, lowering, geo,
                                   id=f'{lowering}-{geo}-{split}')


def _grads(fn, x, w):
    """Output and both gradients of ``sum(sin(fn(x, w)))``."""
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = fn(tx, tw)
    dx, dw = torch.autograd.grad(torch.sin(y).sum(), (tx, tw))
    return y.detach(), dx, dw


@pytest.mark.parametrize('split,lowering,geo', _cases())
def test_microbatched_conv_bitwise(split, lowering, geo):
    xs, ws, strides, pad, groups = GEOMETRY[geo]
    x, w = _np(split, xs), _np(split + 10, ws)
    got = _grads(lambda a, b: microbatched_conv(
        a, b, strides, pad, groups, split, *MICRO_BATCHED[lowering]), x, w)
    if lowering == 'native':
        want = _grads(lambda a, b: conv_native(a, b, strides, pad, groups),
                      x, w)
    else:
        want = _grads(lambda a, b: conv_im2col(a, b, strides, pad), x, w)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_microbatched_conv_refuses_a_split_that_does_not_divide():
    x, w = torch.zeros(6, 5, 5, 2), torch.zeros(3, 3, 2, 2)
    with pytest.raises(ValueError, match='does not divide'):
        microbatched_conv(x, w, (1, 1), ((1, 1), (1, 1)), 1, 4,
                          *MICRO_BATCHED['native'])


# --- the trainer -------------------------------------------------------------

# JAX tests/test_cnn_fused.py's net
CNN_CONF = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = conv:c2
  kernel_size = 3
  pad = 1
  nchannel = 16
layer[3->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 10
layer[5->6] = softmax
netconfig = end

input_shape = 3,12,12
batch_size = 8
eta = 0.01
momentum = 0.9
metric = error
eval_train = 0
random_type = xavier
dev = cpu
"""


def _trainer(extra=''):
    tr = NetTrainer(parse_config_string(CNN_CONF + extra))
    tr.init_model()
    return tr


def _batches(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 3, 12, 12).astype(np.float32),
             rng.randint(0, 10, (8, 1)).astype(np.float32))
            for _ in range(n)]


def _state(tr):
    return {(k, f): v.detach().clone() for k, d in tr.params.items()
            for f, v in d.items()} | \
        {('m', k, f): v.clone() for k, d in tr.opt_state['m'].items()
         for f, v in d.items()}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad


@pytest.mark.parametrize('split', [2, 4, 8])
def test_micro_batch_trainer_step_bitwise(split):
    """Three optimizer steps (fwd + bwd + momentum update) with
    ``micro_batch=k`` bitwise equal to the unsplit steps."""
    runs = []
    for mb in (1, split):
        tr = _trainer(f'fuse = 0\nmicro_batch = {mb}\n')
        for x, y in _batches(1, 3):
            tr.update(DataBatch(x, y))
        runs.append(_state(tr))
    _assert_bitwise(*runs)


def test_micro_batch_composes_with_steps_per_dispatch():
    """A K=4 window at split 2 bitwise equal to the unsplit window, and
    both to the per-step runs (the window is K single steps)."""
    batches = _batches(2, 2)

    def seq_run(mb):
        tr = _trainer(f'fuse = 0\nmicro_batch = {mb}\n')
        for t in range(4):
            tr.update(DataBatch(*batches[t % 2]))
        return tr

    def window_run(mb):
        tr = _trainer(f'fuse = 0\nmicro_batch = {mb}\n')
        fn = tr.compile_multi_step(4)
        tr.update_staged_window(fn, [tr.stage_batch(DataBatch(
            *batches[t % 2])) for t in range(4)])
        return tr

    seq_1, seq_2 = seq_run(1), seq_run(2)
    win_1, win_2 = window_run(1), window_run(2)
    _assert_bitwise(_state(seq_1), _state(seq_2))
    _assert_bitwise(_state(win_1), _state(win_2))
    _assert_bitwise(_state(win_2), _state(seq_2))
    assert win_2.epoch_counter == seq_2.epoch_counter == 4


def test_a_split_that_does_not_divide_the_batch_runs_unsplit():
    tr = _trainer('fuse = 0\nmicro_batch = 3\nbatch_size = 8\n')
    conv = tr.net.layers[0]
    assert conv._micro_split('native', 8) == 1
    assert conv._micro_split('native', 9) == 3
    assert conv._micro_split('im2col', 9) == 3
    assert conv._micro_split('s2d', 9) == 1
    assert conv._micro_split('split', 9) == 1
    ref = _trainer('fuse = 0\n')
    for t in (tr, ref):
        for x, y in _batches(3, 2):
            t.update(DataBatch(x, y))
    _assert_bitwise(_state(tr), _state(ref))


def test_fusion_excluded_under_microbatching():
    """The fused conv has its own tiling: ``micro_batch > 1`` convs leave
    the pairing (JAX ``test_fusion_excluded_under_microbatching``)."""
    tr = _trainer('fuse = 1\nmicro_batch = 2\n')
    assert tr.net._convact_pairs == {}
    assert tr.net._convact_solo == set()
    tr = _trainer('fuse = 1\n')
    assert tr.net._convact_pairs == {0: 1, 3: 4}


def test_micro_batch_steps_match_the_jax_trainer():
    jt = JTrainer(jparse(CNN_CONF + 'fuse = 0\nmicro_batch = 2\n'))
    jt.init_model()
    tt = _trainer('fuse = 0\nmicro_batch = 2\n')
    for x, y in _batches(4, 3):
        jt.update(JBatch(x, y))
        tt.update(DataBatch(x, y))
    for k, d in jt.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(
                tt.params[k][f].detach().numpy(), np.asarray(v),
                rtol=NET_RTOL, atol=NET_ATOL, err_msg=f'{k}/{f}')
