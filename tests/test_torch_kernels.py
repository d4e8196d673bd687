"""The port's kernel modules (``cxxnet_tpu_torch/ops``) against the JAX
package's functions, on the CPU.

On a CPU tensor every kernel wrapper runs its plain version, so these
tests hold each plain version — the arithmetic the CUDA kernel repeats
— against the JAX function on the same numpy inputs:

* conv: the 8 legs of ``test_cnn_fused.py`` plus an AlexNet-conv1-like
  k11 s4 Cin=3 leg, against the XLA composition ``_conv_ref`` + bias +
  activation (the Pallas block itself misses its own 1e-5 twin on two
  legs on this tree, so it is not the reference);
* LRN: ``lrn_pallas`` in interpret mode at c = 96, 256 and an even n;
* GEMM: ``_matmul_impl`` in interpret mode with ragged n;
* the backwards: the conv block's ``(dx, dw, db)`` against ``jax.vjp``
  of the XLA composition (every leg above plus a tie-dense leg), the
  LRN backward kernel's plain version against ``jax.vjp`` of
  ``lrn_pallas`` (the Pallas ``_lrn_bwd_kernel``, interpret mode), the
  hybrid backward against ``lrn_hybrid``'s, and the two fullc backward
  GEMMs against ``_matmul_nt_impl`` / ``_matmul_tn_impl`` (interpret).

Tolerance: ``_FUSED_RTOL`` / ``_FUSED_ATOL`` = 1e-5 (f32; the two sides
sum in different orders), times 10 in atol for the GEMMs whose sums run
600 terms deep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.pallas_cnn import _FUSED_ATOL, _FUSED_RTOL, _conv_ref
from cxxnet_tpu.ops.pallas_kernels import (_matmul_impl, _matmul_nt_impl,
                                           _matmul_tn_impl, lrn_hybrid,
                                           lrn_pallas)
from cxxnet_tpu_torch.ops import cnn, kernels

pytestmark = pytest.mark.torch_port


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


CONV_LEGS = [
    # (stride, pad, groups, act, bias, cin, k, hw)
    (1, 1, 1, 'relu', True, 4, 3, 9),
    (1, 1, 1, 'relu', False, 4, 3, 9),
    (1, 1, 1, 'identity', True, 4, 3, 9),
    (2, 1, 1, 'relu', True, 4, 3, 9),
    (1, 0, 1, 'relu', True, 4, 3, 9),
    (2, 2, 1, 'identity', False, 4, 3, 9),
    (1, 1, 2, 'relu', True, 8, 3, 9),
    (2, 1, 4, 'identity', True, 16, 3, 9),
    (4, 0, 1, 'relu', True, 3, 11, 27),
]
CONV_IDS = ['base', 'nobias', 'identity', 'stride2', 'pad0', 's2p2bare',
            'group2', 'group4s2', 'k11s4cin3']


@pytest.mark.parametrize('stride,pad,groups,act,bias,cin,k,hw', CONV_LEGS,
                         ids=CONV_IDS)
def test_conv_plain_matches_xla_composition(stride, pad, groups, act, bias,
                                            cin, k, hw):
    x = _np(1, (4, hw, hw, cin))
    w = _np(2, (k, k, cin // groups, 8))
    b = _np(3, (8,)) if bias else None
    strides, padding = (stride, stride), ((pad, pad), (pad, pad))
    ref = _conv_ref(jnp.asarray(x), jnp.asarray(w), strides, padding, groups)
    if b is not None:
        ref = ref + b
    if act == 'relu':
        ref = jnp.maximum(ref, 0.0)
    got = cnn.conv_bias_act(_t(x), _t(w), None if b is None else _t(b),
                            strides, padding, groups, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


@pytest.mark.parametrize('k,pad,groups,cin_g,cout,hw', [
    (5, 2, 2, 48, 64, 7),      # conv2's geometry
    (3, 1, 2, 32, 32, 5)],     # conv4's, at cin/g 32
    ids=['conv2_geometry', 'conv4_geometry'])
def test_conv_plain_matches_xla_at_alexnet_geometry(k, pad, groups, cin_g,
                                                    cout, hw):
    # cin/g % 16 == 0: the case the CUDA kernel copies as 16-deep tap runs
    x = _np(90 + k, (2, hw, hw, cin_g * groups))
    w = _np(91 + k, (k, k, cin_g, cout), scale=(k * k * cin_g) ** -0.5)
    b = _np(92 + k, (cout,))
    padding = ((pad, pad), (pad, pad))
    ref = jnp.maximum(_conv_ref(jnp.asarray(x), jnp.asarray(w), (1, 1),
                                padding, groups) + b, 0.0)
    got = cnn.conv_bias_act(_t(x), _t(w), _t(b), (1, 1), padding, groups,
                            'relu')
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def test_conv_plain_asymmetric_padding_matches_xla():
    x, w, b = _np(4, (2, 10, 10, 6)), _np(5, (5, 5, 3, 10)), _np(6, (10,))
    padding = ((1, 2), (0, 3))
    ref = jnp.maximum(_conv_ref(jnp.asarray(x), jnp.asarray(w), (2, 2),
                                padding, 2) + b, 0.0)
    got = cnn.conv_bias_act(_t(x), _t(w), _t(b), (2, 2), padding, 2, 'relu')
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def test_conv_plain_returns_preactivation():
    x, w, b = _np(7, (2, 6, 6, 4)), _np(8, (3, 3, 4, 8)), _np(9, (8,))
    y, z = cnn.conv_bias_act_plain(_t(x), _t(w), _t(b), (1, 1),
                                   ((1, 1), (1, 1)), 1, 'relu')
    ref = _conv_ref(jnp.asarray(x), jnp.asarray(w), (1, 1),
                    ((1, 1), (1, 1))) + b
    np.testing.assert_allclose(z.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)
    np.testing.assert_array_equal(y.numpy(), np.maximum(z.numpy(), 0.0))


def test_conv_backward_is_refused_until_the_train_slice():
    # the train slice is here: the backward computes (it raised
    # NotImplementedError before), and its dw is the XLA composition's
    x, w = _np(11, (1, 5, 5, 4)), _np(10, (3, 3, 4, 8))
    wt = _t(w).requires_grad_()
    y = cnn.conv_bias_act(_t(x), wt, None, (1, 1), ((1, 1), (1, 1)))
    y.sum().backward()

    def f(ww):
        return jnp.maximum(_conv_ref(jnp.asarray(x), ww, (1, 1),
                                     ((1, 1), (1, 1))), 0.0).sum()
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(jax.grad(f)(jnp.asarray(w))),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def _tie_dense_leg():
    """Zero-padded integer image with zero bias: many pre-activations are
    exactly 0 (every tap of an output on the zero border hits 0)."""
    rng = np.random.RandomState(30)
    x = np.zeros((2, 9, 9, 4), np.float32)
    x[:, 3:6, 3:6] = rng.randint(0, 3, (2, 3, 3, 4))
    w = rng.randint(-2, 3, (3, 3, 4, 8)).astype(np.float32)
    return x, w, np.zeros((8,), np.float32)


@pytest.mark.parametrize('leg', list(range(len(CONV_LEGS))) + ['tie_dense'],
                         ids=CONV_IDS + ['tie_dense'])
def test_conv_backward_matches_jax_vjp(leg):
    if leg == 'tie_dense':
        x, w, b = _tie_dense_leg()
        strides, padding, groups, act = (1, 1), ((1, 1), (1, 1)), 1, 'relu'
    else:
        stride, pad, groups, act, bias, cin, k, hw = CONV_LEGS[leg]
        x = _np(40 + leg, (3, hw, hw, cin))
        w = _np(41 + leg, (k, k, cin // groups, 8))
        b = _np(42 + leg, (8,)) if bias else None
        strides, padding = (stride, stride), ((pad, pad), (pad, pad))
    gy_shape = cnn.conv_bias_act(_t(x), _t(w), None if b is None else _t(b),
                                 strides, padding, groups, act).shape
    gy = _np(43, tuple(gy_shape))

    def ref(xx, ww, bb):
        z = _conv_ref(xx, ww, strides, padding, groups)
        if bb is not None:
            z = z + bb
        return jnp.maximum(z, 0.0) if act == 'relu' else z
    jb = None if b is None else jnp.asarray(b)
    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w), jb)
    want = vjp(jnp.asarray(gy))
    if leg == 'tie_dense':
        z = np.asarray(_conv_ref(jnp.asarray(x), jnp.asarray(w), strides,
                                 padding))
        assert (z == 0).mean() > 0.3          # the ties are really there
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    bt = None if b is None else _t(b).requires_grad_()
    cnn.conv_bias_act(xt, wt, bt, strides, padding, groups, act).backward(
        _t(gy))
    got = (xt.grad, wt.grad, None if bt is None else bt.grad)
    for g, r in zip(got, want):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def test_conv_backward_asymmetric_padding_matches_jax_vjp():
    x, w, b = _np(44, (2, 10, 10, 6)), _np(45, (5, 5, 3, 10)), _np(46, (10,))
    padding = ((1, 2), (0, 3))

    def ref(xx, ww, bb):
        return jnp.maximum(_conv_ref(xx, ww, (2, 2), padding, 2) + bb, 0.0)
    y, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = _np(47, y.shape)
    want = vjp(jnp.asarray(gy))
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
    cnn.conv_bias_act(xt, wt, bt, (2, 2), padding, 2, 'relu').backward(
        _t(gy))
    for g, r in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def test_conv_wrapper_counts_no_launch_on_cpu():
    before = kernels.launch_counts()['conv_bias_act']
    cnn.conv_bias_act(_t(_np(12, (1, 5, 5, 4))), _t(_np(13, (3, 3, 4, 8))),
                      None, (1, 1), ((1, 1), (1, 1)))
    assert kernels.launch_counts()['conv_bias_act'] == before


@pytest.mark.parametrize('c,nsize', [(96, 5), (256, 5), (96, 4)],
                         ids=['c96', 'c256', 'even_n4'])
def test_lrn_plain_matches_pallas_interpret(c, nsize):
    x = _np(c + nsize, (2, 3, 3, c), scale=3.0)
    ref = lrn_pallas(jnp.asarray(x), nsize, 0.001, 0.75, 1.0)
    got = kernels.lrn_forward(_t(x), nsize, 0.001, 0.75, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


def _lrn_case(c, nsize):
    x = _np(c + nsize + 50, (2, 3, 3, c), scale=3.0)
    g = _np(c + nsize + 51, (2, 3, 3, c))
    _, norm = kernels.lrn_forward_plain(_t(x), nsize, 0.001, 0.75, 1.0)
    return x, g, norm


@pytest.mark.parametrize('c,nsize', [(96, 5), (256, 5), (96, 4), (20, 6)],
                         ids=['c96', 'c256', 'even_n4', 'even_n6'])
def test_lrn_backward_plain_matches_pallas_vjp(c, nsize):
    x, g, norm = _lrn_case(c, nsize)
    _, vjp = jax.vjp(lambda xx: lrn_pallas(xx, nsize, 0.001, 0.75, 1.0),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = kernels.lrn_backward(_t(x), _t(g), norm, nsize, 0.001, 0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


@pytest.mark.parametrize('c,nsize', [(96, 5), (96, 4)],
                         ids=['c96', 'even_n4'])
def test_lrn_hybrid_backward_matches_jax(c, nsize):
    x, g, norm = _lrn_case(c, nsize)
    _, vjp = jax.vjp(lambda xx: lrn_hybrid(xx, nsize, 0.001, 0.75, 1.0),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = kernels.lrn_hybrid_backward(_t(x), _t(g), norm, nsize, 0.001,
                                      0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL)


@pytest.mark.parametrize('mode,c,kernel_bwd', [
    ('auto', 256, True), ('auto', 96, False), ('on', 96, True)],
    ids=['full_c256', 'hybrid_c96', 'forced_c96'])
def test_lrn_layer_takes_the_backward_of_its_mode(monkeypatch, mode, c,
                                                  kernel_bwd):
    """``full`` runs the backward kernel's wrapper, ``hybrid`` the plain
    cumsum backward; both agree with autograd of the cumsum composition
    (``off``)."""
    import cxxnet_tpu_torch.layers as tl
    calls = []
    real = kernels.lrn_backward

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(kernels, 'lrn_backward', spy)
    x = _np(60 + c, (2, 3, 3, c), scale=3.0)
    g = _np(61 + c, (2, 3, 3, c))
    grads = {}
    for m in (mode, 'off'):
        layer = tl.create_layer(tl.get_layer_type('lrn'))
        for k, v in (('local_size', '5'), ('alpha', '0.001'),
                     ('beta', '0.75'), ('knorm', '1')):
            layer.set_param(k, v)
        xt = _t(x).requires_grad_()
        ctx = tl.ForwardContext(is_train=True, kernel_mode=m)
        layer.forward({}, [xt], ctx)[0].backward(_t(g))
        grads[m] = xt.grad.numpy()
    assert bool(calls) == kernel_bwd
    np.testing.assert_allclose(grads[mode], grads['off'], rtol=_FUSED_RTOL,
                               atol=_FUSED_ATOL)


def test_lrn_plain_norm_is_the_window_sum():
    x = _np(14, (2, 7), scale=2.0)
    _, norm = kernels.lrn_forward_plain(_t(x), 4, 0.4, 0.75, 2.0)
    # even n: window [j-1, j+2] (the _band_matrix convention)
    sq = np.pad(x * x, ((0, 0), (1, 2)))
    want = 2.0 + 0.1 * sum(sq[:, q:q + 7] for q in range(4))
    np.testing.assert_allclose(norm.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize('m,k,n', [(16, 32, 20), (9, 600, 130)],
                         ids=['small_ragged', 'multi_k_slice'])
def test_gemm_plain_matches_pallas_interpret(m, k, n):
    a, b = _np(15, (m, k)), _np(16, (k, n))
    ref = _matmul_impl(jnp.asarray(a), jnp.asarray(b))
    got = kernels.fullc_gemm(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=_FUSED_RTOL, atol=_FUSED_ATOL * 10)


@pytest.mark.parametrize('m,n,k', [(16, 32, 20), (9, 600, 130),
                                   (70, 1000, 45)],
                         ids=['small_ragged', 'multi_slice', 'fc8_like'])
def test_gemm_backward_plains_match_pallas_interpret(m, n, k):
    g, b, a = _np(70, (m, n)), _np(71, (k, n)), _np(72, (m, k))
    nt = kernels.fullc_gemm_nt(_t(g), _t(b))
    tn = kernels.fullc_gemm_tn(_t(a), _t(g))
    np.testing.assert_allclose(
        nt.numpy(), np.asarray(_matmul_nt_impl(jnp.asarray(g),
                                               jnp.asarray(b))),
        rtol=_FUSED_RTOL, atol=_FUSED_ATOL * 10)
    np.testing.assert_allclose(
        tn.numpy(), np.asarray(_matmul_tn_impl(jnp.asarray(a),
                                               jnp.asarray(g))),
        rtol=_FUSED_RTOL, atol=_FUSED_ATOL * 10)


def test_gemm_nt_plain_matches_pallas_interpret_at_fc8_depth():
    # fc8's input gradient contracts 1000 outputs: the depth the CUDA
    # kernel splits into three ranges at batch 256
    g, b = _np(76, (64, 1000)), _np(77, (96, 1000))
    got = kernels.fullc_gemm_nt(_t(g), _t(b))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_matmul_nt_impl(jnp.asarray(g),
                                                jnp.asarray(b))),
        rtol=_FUSED_RTOL, atol=_FUSED_ATOL * 10)


def test_gemm_backward_computes_instead_of_raising():
    a = _t(_np(73, (5, 12))).requires_grad_()
    b = _t(_np(74, (12, 7))).requires_grad_()
    gc = _np(75, (5, 7))
    before = kernels.launch_counts()
    kernels.fullc_gemm(a, b).backward(_t(gc))
    assert kernels.launch_counts() == before    # CPU: plain versions
    np.testing.assert_allclose(a.grad.numpy(), gc @ b.detach().numpy().T,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), a.detach().numpy().T @ gc,
                               rtol=1e-5, atol=1e-5)


def test_gates_mirror_the_jax_auto_on_one_chip():
    assert kernels.lrn_auto_mode(256) == 'full'
    assert kernels.lrn_auto_mode(96) == 'hybrid'
    assert kernels.lrn_auto_mode(64) == 'xla'
    assert kernels.lrn_auto_mode(100) == 'xla'
    assert kernels.lrn_auto_mode(64, 'on') == 'full'
    assert kernels.lrn_auto_mode(256, 'off') == 'xla'
    assert kernels.fullc_use_pallas(256, 4096, 1000, is_train=False)
    assert not kernels.fullc_use_pallas(256, 4096, 1000, is_train=True)
    assert not kernels.fullc_use_pallas(256, 9216, 4096, is_train=False)
    assert kernels.fullc_use_pallas(2, 3, 4, is_train=True, mode='on')
    assert not kernels.fullc_use_pallas(256, 4096, 1000, is_train=False,
                                        mode='off')
    assert cnn.conv_use_fused(None) and cnn.conv_use_fused('auto')
    assert not cnn.conv_use_fused('0') and cnn.conv_use_fused('1', 'off')
    assert not cnn.conv_use_fused(None, 'off')
    assert [kernels.pallas_mode(v) for v in (None, 'auto', '1', '0')] == \
        ['auto', 'auto', 'on', 'off']


def test_jax_side_stays_on_cpu():
    assert jax.default_backend() == 'cpu'
