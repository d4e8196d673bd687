"""The conv lowerings of ``cxxnet_tpu_torch`` (``conv_lowering =
im2col|s2d|split``, ``layers/conv.py``) against the JAX package's, on the
CPU, on the same numpy inputs.

* each lowering function against JAX's same function (``conv_im2col``,
  ``conv_s2d``, ``conv_split``, ``conv_native``): the forward and both
  gradients (``jax.vjp`` against ``torch.autograd`` on one cotangent) at
  AlexNet conv1's geometry at narrow width, a grouped conv and an
  asymmetric pad, within ``RTOL`` and ``ATOL_REL`` of the reference's
  largest value (f32 sums in other orders); a bf16 leg by the one-bf16-
  step rule of ``tests/test_torch_mixed_precision.py`` (the forward
  against JAX's, the forward and gradients against JAX's f32 conv on
  the same bf16 values);
* the ``_lowering`` gate equal to JAX's over a grid of mode x groups x
  stride x pads, and an unknown mode refused with JAX's error;
* a three-step net per lowering against the port's native net and
  against the JAX trainer on the same lowering, at JAX's own bound for
  its lowerings (``tests/test_conv_lowering.py:55-62``: rtol 1e-5, atol
  1e-6); an off-target lowering bitwise native;
* the conv+relu pairing equal to JAX's under each mode, and on the
  port's AlexNet conf the row-1 launches a step that JAX's pairing
  predicts (native 5, im2col 3, split 2, s2d 4, ``micro_batch=4`` 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cxxnet_tpu.layers as jl
import cxxnet_tpu.layers.conv as jconv
from cxxnet_tpu.nnet.net import Net as JGraph
from cxxnet_tpu.nnet.net_config import NetConfig as JConfig
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.utils.config import parse_config_string as jparse
import cxxnet_tpu_torch.layers as tl
import cxxnet_tpu_torch.layers.conv as tconv
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.net import Net as TGraph
from cxxnet_tpu_torch.nnet.net_config import NetConfig as TConfig
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the function-level match: f32 sums in other orders, held element by
# element to RTOL plus ATOL_REL of the reference's largest value
RTOL, ATOL_REL = 1e-5, 1e-6
# JAX's own bound for a lowering against native through three steps
NET_RTOL, NET_ATOL = 1e-5, 1e-6
BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))


# (name, x NHWC, w HWIO, strides, pad, groups, lowerings)
SHAPES = [
    ('conv1', (2, 35, 35, 3), (11, 11, 3, 8), (4, 4), ((0, 0), (0, 0)), 1,
     ('native', 'im2col', 's2d')),
    ('grouped', (2, 9, 9, 8), (5, 5, 4, 8), (1, 1), ((2, 2), (2, 2)), 2,
     ('native', 'split')),
    ('asym_pad', (2, 11, 11, 3), (4, 4, 3, 5), (2, 2), ((1, 2), (3, 0)), 1,
     ('native', 'im2col', 's2d')),
]


def _jfn(lowering):
    return {'native': lambda x, w, s, p, g: jconv.conv_native(x, w, s, p, g),
            'im2col': lambda x, w, s, p, g: jconv.conv_im2col(x, w, s, p),
            's2d': lambda x, w, s, p, g: jconv.conv_s2d(x, w, s, p),
            'split': jconv.conv_split}[lowering]


def _tfn(lowering):
    return {'native': tconv.conv_native,
            'im2col': lambda x, w, s, p, g: tconv.conv_im2col(x, w, s, p),
            's2d': lambda x, w, s, p, g: tconv.conv_s2d(x, w, s, p),
            'split': tconv.conv_split}[lowering]


def _cases():
    for name, xs, ws, strides, pad, groups, lowerings in SHAPES:
        for lowering in lowerings:
            yield pytest.param(xs, ws, strides, pad, groups, lowering,
                               id=f'{name}-{lowering}')


@pytest.mark.parametrize('xs,ws,strides,pad,groups,lowering', _cases())
def test_lowering_matches_jax_forward_and_gradients(xs, ws, strides, pad,
                                                    groups, lowering):
    x, w = _np(1, xs), _np(2, ws, 0.1)
    jf, tf = _jfn(lowering), _tfn(lowering)
    jy, vjp = jax.vjp(lambda a, b: jf(a, b, strides, pad, groups),
                      jnp.asarray(x), jnp.asarray(w))
    g = _np(3, jy.shape)
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tf(tx, tw, strides, pad, groups)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    _close(ty.detach(), jy)
    _close(tdx, jdx)
    _close(tdw, jdw)


@pytest.mark.parametrize('xs,ws,strides,pad,groups,lowering', _cases())
def test_lowering_matches_native_in_the_port(xs, ws, strides, pad, groups,
                                             lowering):
    x, w = torch.from_numpy(_np(4, xs)), torch.from_numpy(_np(5, ws, 0.1))
    _close(_tfn(lowering)(x, w, strides, pad, groups),
           tconv.conv_native(x, w, strides, pad, groups))


def _bf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize('xs,ws,strides,pad,groups,lowering', _cases())
def test_lowering_bf16_within_one_bf16_step_of_jax(xs, ws, strides, pad,
                                                   groups, lowering):
    """bf16 operands (the net casts the weight to the activations'
    dtype), f32 sums, one rounding each: the forward within one bf16 step
    of JAX's same function in bf16, and the forward and both gradients
    within one bf16 step of JAX's f32 conv on the same bf16 values
    (``2^-7 |ref| + 1e-3 mean |ref|`` element by element).  JAX's own
    im2col ``dx`` on the CPU sums its taps in bf16 and misses that bound
    (~6 steps at conv1's geometry); the port's sums them in f32."""
    x, w = _bf(_np(6, xs)), _bf(_np(7, ws, 0.1))
    jx, jw = (jnp.asarray(t.float().numpy()) for t in (x, w))
    g = _bf(_np(8, (xs[0],) + tuple(
        _jfn('native')(jx, jw, strides, pad, groups).shape[1:])))
    ref_y, vjp = jax.vjp(
        lambda a, b: jconv.conv_native(a, b, strides, pad, groups), jx, jw)
    ref = (ref_y,) + vjp(jnp.asarray(g.float().numpy()))
    jy = _jfn(lowering)(jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16),
                        strides, pad, groups).astype(jnp.float32)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ty = _tfn(lowering)(tx, tw, strides, pad, groups)
    got = (ty.detach(),) + torch.autograd.grad(ty, (tx, tw), g)
    for t, r in zip((got[0],) + got, (jy,) + ref):
        assert t.dtype == torch.bfloat16
        t, r = t.float().numpy(), np.asarray(r, np.float32)
        lim = BF16_STEP * np.abs(r) + BF16_FLOOR * np.abs(r).mean()
        assert (np.abs(t - r) <= lim).all()


# --- the gate ----------------------------------------------------------------

@pytest.mark.parametrize('mode', ['auto', 'native', 'im2col', 's2d',
                                  'split'])
def test_lowering_gate_matches_jax(mode):
    for groups in (1, 2):
        for stride in (1, 2, 4):
            for pad in (0, 1, 2, 4):
                for pad_x in (pad, pad + 1):
                    got = []
                    for lib in (jl, tl):
                        layer = lib.create_layer(lib.get_layer_type('conv'))
                        for k, v in (('conv_lowering', mode),
                                     ('ngroup', groups), ('stride', stride),
                                     ('pad_y', pad), ('pad_x', pad_x)):
                            layer.set_param(k, str(v))
                        got.append(layer._lowering())
                    assert got[1] == got[0], (mode, groups, stride, pad,
                                              pad_x)


def test_unknown_lowering_and_split_below_one_are_refused():
    for lib in (jl, tl):
        layer = lib.create_layer(lib.get_layer_type('conv'))
        with pytest.raises(ValueError, match='conv_lowering: unknown mode'):
            layer.set_param('conv_lowering', 'imcol')
        with pytest.raises(ValueError, match='micro_batch: must be >= 1'):
            layer.set_param('micro_batch', '0')


# --- a net of three steps ----------------------------------------------------

def _conf(lowering, ngroup, pad=1):
    """JAX ``tests/test_conv_lowering.py``'s net."""
    return f"""
netconfig=start
layer[+1] = conv:cv1
  kernel_size = 5
  stride = 2
  pad = {pad}
  nchannel = 8
  ngroup = {ngroup}
  conv_lowering = {lowering}
  init_sigma = 0.1
layer[+1] = relu:rl1
layer[+1] = flatten:fl1
layer[+1] = fullc:fc1
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = {2 * ngroup},12,12
batch_size = 8
dev = cpu
eta = 0.1
metric[label] = error
"""


def _feed(ngroup, steps):
    rng = np.random.RandomState(0)
    return [(rng.randn(8, 2 * ngroup, 12, 12).astype(np.float32),
             rng.randint(0, 3, (8, 1)).astype(np.float32))
            for _ in range(steps)]


def _run(lowering, ngroup, pad=1, steps=3):
    tr = NetTrainer(parse_config_string(_conf(lowering, ngroup, pad)))
    tr.init_model()
    for x, y in _feed(ngroup, steps):
        tr.update(DataBatch(x, y))
    return {k: {f: v.detach().numpy().copy() for f, v in d.items()}
            for k, d in tr.params.items()}


def _jrun(lowering, ngroup, pad=1, steps=3):
    tr = JTrainer(jparse(_conf(lowering, ngroup, pad)))
    tr.init_model()
    for x, y in _feed(ngroup, steps):
        tr.update(JBatch(x, y))
    return {k: {f: np.asarray(v) for f, v in d.items()}
            for k, d in tr.params.items()}


def _params_close(got, want, rtol=NET_RTOL, atol=NET_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        for f in want[k]:
            np.testing.assert_allclose(got[k][f], want[k][f], rtol=rtol,
                                       atol=atol, err_msg=f'{k}/{f}')


@pytest.mark.parametrize('lowering,ngroup,pad', [
    ('im2col', 1, 1), ('split', 2, 1), ('s2d', 1, 2)])
def test_three_steps_match_native_and_jax(lowering, ngroup, pad):
    got = _run(lowering, ngroup, pad)
    _params_close(got, _run('native', ngroup, pad))
    _params_close(got, _jrun(lowering, ngroup, pad))


@pytest.mark.parametrize('lowering,ngroup', [('im2col', 2), ('s2d', 1),
                                             ('split', 1)])
def test_off_target_lowering_is_native_bitwise(lowering, ngroup):
    """im2col on a grouped conv, s2d at pad 1 % stride 2, split on an
    ungrouped conv: native, bit for bit (JAX
    ``tests/test_conv_lowering.py:66-75``)."""
    got, want = _run(lowering, ngroup, steps=2), _run('native', ngroup,
                                                      steps=2)
    for k in want:
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f])


# --- the pairing -------------------------------------------------------------

def _graphs(conf):
    jc, tc = JConfig(), TConfig()
    jc.configure(jparse(conf))
    tc.configure(parse_config_string(conf))
    return JGraph(jc), TGraph(tc)


def _alexnet_conf(extra):
    with open(os.path.join(ROOT, 'cxxnet_tpu_torch', 'example',
                           'ImageNet.conf')) as f:
        return f.read() + '\ninput_shape = 3,227,227\nbatch_size = 256\n' \
            + extra


# row-1 launches of one AlexNet step (the conv+relu pairs) as JAX's
# pairing gives them: im2col leaves the grouped conv2, conv4, conv5
# native; split the ungrouped conv1, conv3; s2d the stride-1 conv2-conv5
ALEXNET_PAIRS = {'native': 5, 'im2col': 3, 'split': 2, 's2d': 4,
                 'micro_batch': 0}


@pytest.mark.parametrize('mode', sorted(ALEXNET_PAIRS))
def test_alexnet_pairing_matches_jax(mode):
    extra = 'micro_batch = 4\n' if mode == 'micro_batch' \
        else f'conv_lowering = {mode}\n'
    jn, tn = _graphs(_alexnet_conf(extra))
    assert tn._convact_pairs == jn._convact_pairs
    assert tn._convact_solo == jn._convact_solo
    assert len(tn._convact_pairs) == ALEXNET_PAIRS[mode]
    jfuse, tfuse = _graphs(_alexnet_conf(extra + 'fuse = 1\n'))
    assert tfuse._convact_pairs == jfuse._convact_pairs
    assert tfuse._convact_solo == jfuse._convact_solo


@pytest.mark.parametrize('mode', ['im2col', 's2d', 'split'])
def test_googlenet_groups_and_pairs_match_jax(mode):
    from cxxnet_tpu_torch.models.builders import googlenet_conf
    conf = googlenet_conf(num_class=4, aux_heads=False) + \
        f'\nbatch_size = 1\nconv_lowering = {mode}\nfuse_blockdiag = auto\n'
    jn, tn = _graphs(conf)
    assert tn._sibling_groups == jn._sibling_groups
    assert tn._blockdiag_groups == jn._blockdiag_groups
    assert tn._convact_pairs == jn._convact_pairs
