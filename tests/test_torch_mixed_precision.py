"""Mixed precision (``compute_type=bfloat16``, and the same tests at
``compute_type=float16``) in ``cxxnet_tpu_torch`` against the JAX package,
on the CPU, on the same numpy inputs.

Inputs are made from a seed with numpy and rounded to the 16-bit dtype
once, so both packages start from the same 16-bit values; parameters stay
f32 in both.  Two rules, stated where they are used:

* **bitwise** where both packages round one f32 result once (or, as XLA's
  16-bit ``reduce_window`` add does, round each add of the same
  sequence): the port's 16-bit output equals JAX's output rounded to the
  dtype.  Where JAX promotes a 16-bit node to f32 against an f32 parameter
  (bias, prelu, fixconn) the port does the same, and its f32 output
  equals JAX's;
* **one step** of the dtype where the two sum in f32 in different orders
  (convs, products, window sums, batch statistics) and round once:
  ``|port - jax| <= step |jax| + 1e-3 mean|jax|`` element by element, the
  step 2^-7 in bf16 and 2^-10 in f16 (``chip_smoke.py``'s
  ``step16_excess`` <= 1).  Gradients are held to the same rule, the
  floor taken from the reference gradient's own mean magnitude (the
  cotangent's scale carried through the layer).

Each bf16 test of (a), (b) and (e) has an f16 twin
(``tests/torch_twins.py``): the same body at ``dt='f16'``, named with
``f16`` for ``bf16``.

(a) each layer type's forward and ``jax.vjp`` / ``torch.autograd``
gradients, with the fused conv block's backward at 5x5 stride 1 (its
col2im sums in f32 and rounds once, as XLA's conv transpose) and max
pooling on inputs built to tie; (b) the plain versions of kernel rows
1-5 against the JAX kernels in interpret mode; (c) three updates of a
narrow AlexNet and a narrow GoogLeNet in bf16, under ``auto`` and under
``use_pallas=0 fuse=0``, held by the 1.5x rule of the LM's bf16 step
(``tests/test_torch_lm_train.py``): each weight's change lies no further
from JAX's f32 run than 1.5x JAX's own bf16 run of the same composition
does, plus 2^-8 of the change; (d) the port's mirror of ``tests/test_mixed_precision.py``;
(e) the dtype of every node of the reference nets after a bf16 forward;
(f) ``PredictEngine`` at bf16 compute under ``serve.dtype=f32|bf16|int8``
against JAX's engine, by the same 1.5x rule.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cxxnet_tpu.layers as jl
from cxxnet_tpu.ops import pallas_cnn as jcnn
from cxxnet_tpu.ops import pallas_kernels as jpk
from cxxnet_tpu.serve.engine import PredictEngine as JEngine
from cxxnet_tpu.wrapper import Net as JNet
from cxxnet_tpu_torch import Net
import cxxnet_tpu_torch.layers as tl
from cxxnet_tpu_torch.interop import opt_state_from_jax, params_from_jax
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import cnn, kernels
from cxxnet_tpu_torch.serve import PredictEngine
from cxxnet_tpu_torch.utils.config import parse_config_string

from test_torch_layer_zoo import _narrow
from test_torch_train import NARROW_TRAIN
from torch_threads import one_torch_thread  # noqa: F401
from torch_twins import f16_twin

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3
#: the 16-bit compute dtypes: torch's, JAX's, and one step of each
DT = {'bf16': (torch.bfloat16, jnp.bfloat16, BF16_STEP),
      'f16': (torch.float16, jnp.float16, 2.0 ** -10)}
# the f32 outputs of the bf16 kernels (the conv's z, the LRN's norm):
# f32 sums in other orders, as tests/test_torch_kernels.py holds them
F32_RTOL = 1e-5
# the 1.5x rule of (c) and (f)
RULE_FACTOR, RULE_FLOOR = 1.5, 2.0 ** -8


def _bf(a, dt='bf16'):
    """f32 numpy -> the 16-bit values of ``dt`` (round to nearest even),
    as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        DT[dt][0]).float().numpy()


def _np(seed, shape, scale=1.0, dt='bf16'):
    return _bf(np.random.RandomState(seed).randn(*shape) * scale, dt)


def _jbf(a, dt='bf16'):
    return jnp.asarray(a).astype(DT[dt][1])


def _tbf(a, dt='bf16'):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        DT[dt][0])


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def step_excess(got, ref, dt='bf16'):
    """max |got - ref| / (step |ref| + 1e-3 mean |ref|), ``step`` one step
    of ``dt``: <= 1 where got is within one step of ref everywhere."""
    g, r = _f32(got).astype(np.float64), _f32(ref).astype(np.float64)
    lim = DT[dt][2] * np.abs(r) + BF16_FLOOR * np.abs(r).mean() + 1e-30
    return float((np.abs(g - r) / lim).max())


def assert_bitwise_rounded(got, ref, dt='bf16'):
    """The port's 16-bit ``got`` equals JAX's ``ref`` rounded to ``dt``."""
    assert got.dtype == DT[dt][0], got.dtype
    np.testing.assert_array_equal(_f32(got), _bf(_f32(ref), dt))


# --- (a) each layer type in bf16 ----------------------------------------------

def _spec(lib, x):
    return (lib.NodeSpec(1, 1, x.shape[1]) if x.ndim == 2 else
            lib.NodeSpec(x.shape[3], x.shape[1], x.shape[2]))


def _layer(lib, type_name, pairs, xs, n_out=None):
    layer = lib.create_layer(lib.get_layer_type(type_name))
    for k, v in pairs:
        layer.set_param(k, v)
    if n_out is not None:
        layer.set_num_outputs(n_out)
    layer.infer_shapes([_spec(lib, x) for x in xs])
    return layer


def _both16(type_name, pairs, xs, params=None, rule='step', n_out=None,
            grad_rule='step', sums=(), dt='bf16'):
    """One layer of each package on the same 16-bit inputs (``dt``) and f32
    params, forward and gradients under the same seeded 16-bit cotangents.
    The
    forward is held ``bitwise`` or within one ``step`` (or, for the f32
    softmax, at ``f32``; an f32 node that JAX promotes, ``f32_bitwise``);
    the gradients by ``grad_rule``.  The params in
    ``sums`` (a conv's or a fullc's bias) have the cotangent summed over
    every axis but the last as their gradient, which JAX adds in the 16-bit
    dtype (the transpose of its broadcast add rounds each partial sum) and
    the
    port in f32: there one step is taken of the sum of the magnitudes of
    the terms, the scale of that rounding.  Returns the port's outputs."""
    params = params or {}
    jlayer = _layer(jl, type_name, pairs, xs, n_out)
    tlayer = _layer(tl, type_name, pairs, xs, n_out)
    tdt, jdt, step = DT[dt]
    jctx = jl.ForwardContext(is_train=False, compute_dtype=jdt)

    def jgrads(cast):
        out, vjp = jax.vjp(
            lambda p, v: jlayer.forward(p, v, jctx),
            {k: jnp.asarray(v) for k, v in params.items()},
            [cast(x) for x in xs])
        cots = [_np(90 + i, o.shape, dt=dt) for i, o in enumerate(out)]
        dp, dx = vjp([jnp.asarray(c).astype(o.dtype)
                      for c, o in zip(cots, out)])
        return out, cots, [dp[k] for k in params] + list(dx)
    jout, cots, want = jgrads(lambda x: _jbf(x, dt))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [_tbf(x, dt).requires_grad_() for x in xs]
    tout = tlayer.forward(tp, tx, tl.ForwardContext(is_train=False,
                                                    dtype=tdt))
    assert len(tout) == len(jout)
    # 'rule': JAX's own result at the same values in f32 is the anchor
    j32 = jgrads(jnp.asarray) if 'rule' in (rule, grad_rule) else None
    for i, (t, j) in enumerate(zip(tout, jout)):
        if rule == 'rule':
            assert t.dtype == tdt, t.dtype
            r = _f32(j32[0][i])
            d_port = float(np.abs(_f32(t) - r).max())
            d_jax = float(np.abs(_f32(j) - r).max())
            assert d_port <= RULE_FACTOR * d_jax + step * float(
                np.abs(r).mean()), (type_name, d_port, d_jax)
        elif rule == 'f32':
            assert t.dtype == torch.float32
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=F32_RTOL,
                                       atol=1e-6)
        elif rule == 'f32_bitwise':
            assert t.dtype == torch.float32 and j.dtype == jnp.float32
            np.testing.assert_array_equal(_f32(t), _f32(j))
        elif rule == 'bitwise':
            assert_bitwise_rounded(t, j, dt)
        else:
            assert t.dtype == tdt, t.dtype
            assert step_excess(t, j, dt) <= 1.0, (type_name,
                                                  step_excess(t, j, dt))
    leaves = list(tp.values()) + tx
    grads = torch.autograd.grad(
        tout, leaves, [torch.from_numpy(c).to(t.dtype)
                       for c, t in zip(cots, tout)], allow_unused=True)
    want32 = j32[2] if grad_rule == 'rule' else want
    for name, g, w, w32 in zip(list(tp) + [f'x{i}' for i in range(len(xs))],
                               grads, want, want32):
        got = np.zeros(w.shape, np.float32) if g is None else _f32(g)
        if name in tp:
            assert g is None or g.dtype == torch.float32, (name, g.dtype)
        if name in sums:
            c = np.abs(cots[0]).reshape(-1, cots[0].shape[-1]).sum(0)
            assert (np.abs(got - _f32(w)) <= step * c).all(), name
        elif grad_rule == 'bitwise':
            np.testing.assert_array_equal(got, _bf(_f32(w), dt),
                                          err_msg=name)
        elif grad_rule == 'rule':
            r = _f32(w32)
            d_port = float(np.abs(got - r).max())
            d_jax = float(np.abs(_f32(w) - r).max())
            assert d_port <= RULE_FACTOR * d_jax + step * float(
                np.abs(r).mean()), (type_name, name, d_port, d_jax)
        else:
            assert step_excess(got, w, dt) <= 1.0, (
                type_name, name, step_excess(got, w, dt))
    return tout


@f16_twin(dt='f16')
def test_conv_layer_bf16_matches_jax(dt='bf16'):
    # the unfused layer: cuDNN / oneDNN against XLA, f32 sums, one step
    x = _np(1, (2, 9, 9, 8), dt=dt)
    _both16('conv', [('nchannel', '12'), ('kernel_size', '3'),
                     ('pad', '1'), ('ngroup', '2')], [x],
            {'wmat': _np(2, (3, 3, 4, 12), 0.2, dt),
             'bias': _np(3, (12,), dt=dt)}, sums=('bias',), dt=dt)


@f16_twin(dt='f16')
def test_conv_layer_5x5_stride1_bf16_matches_jax(dt='bf16'):
    x = _np(4, (2, 12, 12, 16), dt=dt)
    _both16('conv', [('nchannel', '24'), ('kernel_size', '5'),
                     ('pad', '2')], [x],
            {'wmat': _np(5, (5, 5, 16, 24), 0.05, dt),
             'bias': _np(6, (24,), dt=dt)}, sums=('bias',), dt=dt)


@f16_twin(dt='f16')
def test_fullc_bf16_matches_jax(dt='bf16'):
    _both16('fullc', [('nhidden', '20')], [_np(7, (6, 40), dt=dt)],
            {'wmat': _np(8, (40, 20), 0.2, dt), 'bias': _np(9, (20,), dt=dt)},
            sums=('bias',), dt=dt)


@f16_twin(dt='f16')
@pytest.mark.parametrize('type_name,pairs', [
    ('relu', []), ('flatten', []), ('xelu', [('b', '3')]),
    ('insanity', []), ('dropout', [('threshold', '0.5')])],
    ids=['relu', 'flatten', 'xelu', 'insanity_eval', 'dropout_eval'])
def test_elementwise_layers_bf16_bitwise_jax(type_name, pairs, dt='bf16'):
    """One f32 result rounded once (or no arithmetic at all): bitwise."""
    _both16(type_name, pairs, [_np(10, (2, 5, 5, 6), dt=dt)], rule='bitwise',
            grad_rule='step', dt=dt)


@f16_twin(dt='f16')
@pytest.mark.parametrize('type_name', ['sigmoid', 'tanh', 'softplus'])
def test_smooth_activations_bf16_match_jax(type_name, dt='bf16'):
    """XLA's 16-bit sigmoid, tanh and softplus and their vjps round at
    other points than torch's, which rounds one f32 result (the vjp's
    ``1 - y^2`` in the 16-bit dtype): forward and gradient by the 1.5x
    rule against JAX's own f32 result at the same values."""
    _both16(type_name, [], [_np(10, (2, 5, 5, 6), dt=dt)], rule='rule',
            grad_rule='rule', dt=dt)


@f16_twin(dt='f16')
@pytest.mark.parametrize('type_name,params', [
    ('bias', {'bias': _np(11, (7,))}),
    ('prelu', {'bias': np.linspace(0.0, 1.0, 7).astype(np.float32)})],
    ids=['bias', 'prelu'])
def test_promoting_layers_keep_jax_f32(type_name, params, dt='bf16'):
    """JAX promotes these 16-bit nodes to f32 against the f32 parameter,
    and so does the port: the same f32 operation, bitwise equal."""
    _both16(type_name, [], [_np(12, (5, 7), dt=dt)], params,
            rule='f32_bitwise', dt=dt)


@f16_twin(dt='f16')
def test_fixconn_keeps_jax_f32_product(tmp_path, dt='bf16'):
    # at most two non-zero products a row, each exact in f32: one order
    path = tmp_path / 'w.txt'
    path.write_text('4 6 5\n0 1 0.5\n1 2 -1.25\n2 0 2.0\n3 5 0.75\n'
                    '3 4 1.5\n')
    _both16('fixconn', [('nhidden', '4'), ('fixconn_weight', str(path))],
            [_np(13, (3, 6), dt=dt)], rule='f32_bitwise', dt=dt)


@f16_twin(dt='f16')
@pytest.mark.parametrize('type_name,k,stride,pad,hw', [
    ('max_pooling', 3, 2, 0, 9), ('sum_pooling', 3, 2, 0, 9),
    ('avg_pooling', 3, 1, 1, 8), ('avg_pooling', 7, 1, 0, 7),
    ('relu_max_pooling', 3, 2, 0, 8)],
    ids=['max', 'sum', 'avg_3x3_pad1', 'avg_7x7_global', 'relu_max'])
def test_pooling_bf16_bitwise_jax(type_name, k, stride, pad, hw, dt='bf16'):
    """XLA's 16-bit ``reduce_window`` add rounds each add in row-major tap
    order, and the port's 16-bit window sum does the same; max is exact.
    (Windows clipped by the right edge sum in another order in XLA: no
    reference net has one.)"""
    _both16(type_name, [('kernel_size', str(k)), ('stride', str(stride)),
                        ('pad', str(pad))],
            [_np(14, (2, hw, hw, 5), 3.0, dt)], rule='bitwise',
            grad_rule='bitwise', dt=dt)


@f16_twin(dt='f16')
def test_max_pooling_ties_route_the_gradient_like_jax(dt='bf16'):
    """16 bits make ties in a window common: integer inputs in {0..3} tie
    in nearly every 3x3 window; the gradient goes to the first maximum in
    row-major order in both packages."""
    x = np.random.RandomState(15).randint(0, 4, (2, 9, 9, 4)).astype(
        np.float32)
    _both16('max_pooling', [('kernel_size', '3'), ('stride', '2')], [x],
            rule='bitwise', grad_rule='bitwise', dt=dt)


@f16_twin(dt='f16')
def test_lrn_composition_bf16_matches_jax(dt='bf16'):
    # c 20: the cumsum composition in both packages, f32 inside
    _both16('lrn', [('local_size', '5'), ('alpha', '0.001'),
                    ('beta', '0.75'), ('knorm', '1')],
            [_np(16, (2, 4, 4, 20), 4.0, dt)], dt=dt)


@f16_twin(dt='f16')
def test_lrn_hybrid_bf16_matches_jax_composition(dt='bf16'):
    # c 96: the port's kernel forward (its plain version here) and plain
    # backward against JAX's composition on the CPU
    _both16('lrn', [('local_size', '5'), ('alpha', '0.001'),
                    ('beta', '0.75'), ('knorm', '1')],
            [_np(17, (2, 3, 3, 96), 4.0, dt)], dt=dt)


@f16_twin(dt='f16')
@pytest.mark.parametrize('shape', [(6, 7), (4, 3, 3, 5)], ids=['mat', 'img'])
def test_batch_norm_bf16_matches_jax(shape, dt='bf16'):
    # f32 statistics and formula in both, rounded once to the 16-bit dtype
    _both16('batch_norm', [], [_np(18, shape, 2.0, dt)],
            {'wmat': _np(19, shape[-1:]) + 1.0, 'bias': _np(20, shape[-1:])},
            dt=dt)


@f16_twin(dt='f16')
def test_structural_layers_bf16_bitwise_jax(dt='bf16'):
    _both16('ch_concat', [], [_np(21, (2, 3, 3, 4), dt=dt),
                              _np(22, (2, 3, 3, 2), dt=dt)],
            rule='bitwise', grad_rule='bitwise', dt=dt)
    _both16('split', [], [_np(23, (3, 5), dt=dt)], rule='bitwise',
            grad_rule='bitwise', n_out=2, dt=dt)
    _both16('maxout', [('ngroup', '2')], [_np(24, (4, 12), dt=dt)],
            rule='bitwise', grad_rule='bitwise', dt=dt)


@f16_twin(dt='f16')
def test_softmax_output_stays_f32(dt='bf16'):
    _both16('softmax', [], [_np(25, (4, 10), 3.0, dt)], rule='f32', dt=dt)


@f16_twin(dt='f16')
def test_fused_conv_block_5x5_stride1_backward_rounds_once(dt='bf16'):
    """The fused block (plain version here) against JAX's
    ``fused_conv_bias_act`` (Pallas in interpret mode, XLA's transposes in
    the backward): y within one step; dx, dw and db within one step of
    JAX's.  At 5x5 stride 1 an element of dx sums 25 taps: the port's
    col2im sums them in f32 and rounds once, as XLA's conv transpose
    does (a 16-bit accumulator rounded after each tap misses the rule)."""
    x, w, b = _np(26, (2, 12, 12, 16), dt=dt), \
        _np(27, (5, 5, 16, 32), 0.05, dt), _np(28, (32,), 0.1, dt)
    pad = ((2, 2), (2, 2))
    cot = _np(29, (2, 12, 12, 32), dt=dt)
    jy, vjp = jax.vjp(lambda xx, ww, bb: jcnn.fused_conv_bias_act(
        xx, ww, bb, (1, 1), pad, 1, 'relu'), _jbf(x, dt), _jbf(w, dt),
        _jbf(b, dt))
    jdx, jdw, jdb = vjp(_jbf(cot, dt))
    tx, tw, tb = (_tbf(v, dt).requires_grad_() for v in (x, w, b))
    ty = cnn.conv_bias_act(tx, tw, tb, (1, 1), pad, 1, 'relu')
    assert ty.dtype == DT[dt][0]
    assert step_excess(ty, jy, dt) <= 1.0
    tdx, tdw, tdb = torch.autograd.grad(ty, (tx, tw, tb), _tbf(cot, dt))
    for name, got, want in (('dx', tdx, jdx), ('dw', tdw, jdw),
                            ('db', tdb, jdb)):
        assert got.dtype == DT[dt][0], name
        assert step_excess(got, want, dt) <= 1.0, (
            name, step_excess(got, want, dt))


# --- (b) the plain versions of rows 1-7 in bf16 and f16 -----------------------

@f16_twin(dt='f16')
@pytest.mark.parametrize('hw,cin,cout,k,stride,p,groups,act', [
    (9, 8, 16, 3, 1, 1, 2, 'relu'), (23, 3, 12, 11, 4, 0, 1, 'relu'),
    (7, 16, 8, 1, 1, 0, 1, 'identity'), (5, 130, 24, 1, 1, 0, 1, 'relu'),
    (6, 16, 208, 3, 1, 1, 1, 'identity'), (7, 6, 48, 5, 2, 2, 2, 'relu'),
    (4, 512, 128, 1, 1, 0, 1, 'relu')],
    ids=['3x3_g2', 'conv1like', '1x1_identity', 'cin_g130_cout_g24',
         'cout_g208', 'k_tail_cin_g3_g2', 'googlenet_aux_4x4'])
def test_conv_plain_bf16_matches_pallas_interpret(hw, cin, cout, k, stride,
                                                  p, groups, act, dt='bf16'):
    """The plain 16-bit conv, which the card holds the tensor-core kernel
    to, against ``_fused_call`` (interpret) at the kernel's edge shapes:
    cin/g 3 and 130 (its 2-byte patch copies), cout/g 24 and 208 (ragged
    channel tiles), a K of 75 (not a multiple of its 32-deep slice) and
    GoogLeNet's 4 x 4 aux conv."""
    x, w, b = _np(30, (2, hw, hw, cin), dt=dt), \
        _np(31, (k, k, cin // groups, cout), (k * k * cin) ** -0.5, dt), \
        _np(32, (cout,), 0.1, dt)
    pad = ((p, p), (p, p))
    jy, jz = jcnn._fused_call(_jbf(x, dt), _jbf(w, dt), _jbf(b, dt),
                              (stride, stride), pad, groups, act)
    ty, tz = cnn.conv_bias_act_plain(_tbf(x, dt), _tbf(w, dt), _tbf(b, dt),
                                     (stride, stride), pad, groups, act)
    assert jy.dtype == DT[dt][1] and ty.dtype == DT[dt][0]
    assert jz.dtype == jnp.float32 and tz.dtype == torch.float32
    assert step_excess(ty, jy, dt) <= 1.0
    np.testing.assert_allclose(_f32(tz), _f32(jz), rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(_f32(jz)).max())


@f16_twin(dt='f16')
@pytest.mark.parametrize('c', [96, 256, 13])
def test_lrn_plains_bf16_match_pallas_interpret(c, dt='bf16'):
    x, g = _np(33, (2, 3, 5, c), 4.0, dt), _np(34, (2, 3, 5, c), dt=dt)
    args = (5, 0.001, 0.75, 1.0)
    jy, jnorm = jpk._lrn_fwd_impl(_jbf(x, dt), *args)
    ty, tnorm = kernels.lrn_forward_plain(_tbf(x, dt), *args)
    assert ty.dtype == DT[dt][0] and tnorm.dtype == torch.float32
    assert step_excess(ty, jy, dt) <= 1.0
    np.testing.assert_allclose(_f32(tnorm).reshape(-1, c), _f32(jnorm),
                               rtol=F32_RTOL)
    (jdx,) = jpk._lrn_vjp_bwd(5, 0.001, 0.75, 1.0,
                              (_jbf(x, dt), jnorm), _jbf(g, dt))
    tdx = kernels.lrn_backward_plain(_tbf(x, dt), _tbf(g, dt), tnorm, 5,
                                     0.001, 0.75)
    assert tdx.dtype == DT[dt][0]
    assert step_excess(tdx, jdx, dt) <= 1.0


@f16_twin(dt='f16')
@pytest.mark.parametrize('m,k,n', [(70, 333, 129), (256, 1024, 1000),
                                   (1, 333, 129), (1, 4096, 1000)])
def test_gemm_plain_bf16_matches_pallas_interpret(m, k, n, dt='bf16'):
    """The plain 16-bit forward GEMM against ``_matmul_impl``
    (interpret), m = 1 and a K tail included."""
    a, b = _np(35, (m, k), dt=dt), _np(36, (k, n), k ** -0.5, dt)
    jc = jpk._matmul_impl(_jbf(a, dt), _jbf(b, dt))
    tc = kernels.fullc_gemm_plain(_tbf(a, dt), _tbf(b, dt))
    assert jc.dtype == DT[dt][1] and tc.dtype == DT[dt][0]
    assert step_excess(tc, jc, dt) <= 1.0


@f16_twin(dt='f16')
@pytest.mark.parametrize('m,n,k', [(70, 333, 129), (37, 16, 65), (1, 17, 5),
                                   (256, 1000, 1024)],
                         ids=['ragged', 'ragged_small', 'tiny', 'ibn_fc'])
def test_backward_gemm_plains_bf16_match_pallas_interpret(m, n, k,
                                                          dt='bf16'):
    """Rows 6 and 7's 16-bit plain versions against ``_matmul_nt_impl`` /
    ``_matmul_tn_impl`` (interpret) on the same 16-bit operands: 16-bit
    outputs, within one step, ragged m, n and k included."""
    g = _np(40, (m, n), dt=dt)
    b = _np(41, (k, n), n ** -0.5, dt)
    a = _np(42, (m, k), dt=dt)
    jda = jpk._matmul_nt_impl(_jbf(g, dt), _jbf(b, dt))
    jdb = jpk._matmul_tn_impl(_jbf(a, dt), _jbf(g, dt))
    da = kernels.fullc_gemm_nt(_tbf(g, dt), _tbf(b, dt))
    db = kernels.fullc_gemm_tn(_tbf(a, dt), _tbf(g, dt))
    assert jda.dtype == jdb.dtype == DT[dt][1]
    assert da.dtype == db.dtype == DT[dt][0]
    assert da.shape == (m, k) and db.shape == (k, n)
    assert step_excess(da, jda, dt) <= 1.0
    assert step_excess(db, jdb, dt) <= 1.0


def test_backward_gemms_refuse_bf16():
    """Rows 6-7 refuse only what no build takes: float64 on every device;
    bf16 and f16 operands run (the plain versions here), with f32 sums
    rounded once to the operands' dtype."""
    for dt in ('bf16', 'f16'):
        g, b = _tbf(_np(37, (4, 6)), dt), _tbf(_np(38, (5, 6)), dt)
        a = _tbf(_np(39, (4, 5)), dt)
        da, db = kernels.fullc_gemm_nt(g, b), kernels.fullc_gemm_tn(a, g)
        assert torch.equal(da, (g.float() @ b.float().t()).to(DT[dt][0]))
        assert torch.equal(db, (a.float().t() @ g.float()).to(DT[dt][0]))
    with pytest.raises(ValueError, match='no kernel build'):
        kernels.fullc_gemm_nt(g.double(), b.double())
    with pytest.raises(ValueError, match='no kernel build'):
        kernels.fullc_gemm_tn(a.double(), g.double())


def test_f16_subnormal_outputs_round_as_jax_s():
    """f16 keeps gradual underflow: products of small multiples of 2^-13
    sum exactly in f32, so the plain GEMM and JAX's ``_matmul_impl``
    (interpret) round the same sums once into f16's subnormal range
    (below 2^-14) and agree bitwise, zero signs included; none is
    flushed."""
    rng = np.random.RandomState(43)
    a = rng.randint(-6, 7, (9, 16)).astype(np.float32) * 2.0 ** -13
    b = rng.randint(-6, 7, (16, 11)).astype(np.float32) * 2.0 ** -13
    jc = np.asarray(jpk._matmul_impl(_jbf(a, 'f16'), _jbf(b, 'f16')))
    tc = kernels.fullc_gemm_plain(_tbf(a, 'f16'), _tbf(b, 'f16')).numpy()
    np.testing.assert_array_equal(tc.view(np.uint16), jc.view(np.uint16))
    sub = (tc != 0) & (np.abs(tc.astype(np.float32)) < 2.0 ** -14)
    assert sub.sum() > 10, sub.sum()


# --- refusals -----------------------------------------------------------------

def test_use_pallas_1_with_bf16_training_is_refused():
    """Refused no longer: rows 6-7 have bf16 builds, so ``use_pallas=1``
    under ``compute_type=bfloat16`` trains (the plain versions here), its
    weights f32 and moved; ``float16`` is taken too, and the trainer's
    activations turn f16 (tests/test_torch_float16.py trains it)."""
    net = Net(dev='cpu', cfg=NARROW_TRAIN + 'use_pallas = 1\n'
              'compute_type = bfloat16\n')
    net.init_model()
    tr = net.trainer
    w0 = tr.params['16']['wmat'].detach().clone()
    x, y = _batches(1)[0]
    net.update(x, y)
    assert np.isfinite(float(tr.last_loss))
    assert tr.params['16']['wmat'].dtype == torch.float32
    assert not torch.equal(tr.params['16']['wmat'].detach(), w0)
    tr.set_param('compute_type', 'float16')
    assert tr.dtype == torch.float16


def test_float16_is_refused_naming_the_rest_of_item_3():
    """Refused no longer (queue A item 3 is done): ``float16`` sets the
    trainer's compute dtype, as JAX's table maps it; an unknown type still
    raises."""
    tr = NetTrainer()
    tr.set_param('compute_type', 'float16')
    assert tr.dtype == torch.float16
    with pytest.raises(ValueError):
        NetTrainer().set_param('compute_type', 'bfloat8')


# --- (c) three updates of narrow twins ----------------------------------------

def _batches(n=3, seed=0, hw=67, bs=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bs, 3, hw, hw).astype(np.float32),
             rng.randint(0, 10, bs)) for _ in range(n)]


NETS = {'alexnet': (NARROW_TRAIN, dict(hw=67, bs=4)),
        'googlenet': (_narrow('googlenet'), dict(hw=32, bs=8))}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def jax_twin_runs():
    """Per net: the start (params, optimizer state after one step on other
    data) and the params after 3 updates of JAX runs: f32 and bf16 with
    its Pallas kernels forced on (interpret mode, as its tests run them),
    and bf16 on its stock composition (``use_pallas=0 fuse=0``: the conv's
    output rounded to bf16 before the bias is added, and again after)."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, (cfg, shape) in NETS.items():
            runs = {}
            start = None
            for leg, dt, extra in (('float32', 'float32', ''),
                                   ('auto', 'bfloat16', ''),
                                   ('stock', 'bfloat16', 'fuse = 0\n')):
                mp.setenv('CXXNET_PALLAS', '0' if extra else '1')
                net = JNet(dev='cpu', cfg=cfg + f'compute_type = {dt}\n'
                           + extra)
                net.init_model()
                tr = net._trainer
                if start is None:
                    params0 = _host(tr.params)
                    x, y = _batches(1, seed=9, **shape)[0]
                    net.update(x, y)
                    start = (params0, _host(tr.opt_state))
                tr.params = jax.tree.map(jnp.asarray, start[0])
                tr.opt_state = jax.tree.map(jnp.asarray, start[1])
                for x, y in _batches(**shape):
                    net.update(x, y)
                runs[leg] = _host(tr.params)
            out[name] = (start, runs)
        return out
    finally:
        mp.undo()


def rule_distances(got, f32, jbf16, start):
    """Per weight: (port's distance, JAX bf16's distance, floor), the
    distances between each run's weight change and JAX's f32 run's."""
    out = {}
    for k, fields in f32.items():
        for f, v in fields.items():
            moved = v - start[k][f]
            d_port = float(np.abs((got[k][f] - start[k][f]) - moved).max())
            d_jax = float(np.abs((jbf16[k][f] - start[k][f]) - moved).max())
            out[f'{k}/{f}'] = (d_port, d_jax,
                               RULE_FLOOR * float(np.abs(moved).max()))
    return out


@pytest.mark.parametrize('mode', ['auto', 'stock'])
@pytest.mark.parametrize('name', list(NETS))
def test_narrow_twins_train_in_bf16_by_the_rule(jax_twin_runs, name, mode):
    (params0, state), runs = jax_twin_runs[name]
    cfg, shape = NETS[name]
    extra = 'use_pallas = 0\nfuse = 0\n' if mode == 'stock' else ''
    net = Net(dev='cpu', cfg=cfg + 'compute_type = bfloat16\n' + extra)
    net.init_model()
    tr = net.trainer
    tr.params = params_from_jax(params0)
    tr.opt_state = opt_state_from_jax(state)
    for x, y in _batches(**shape):
        net.update(x, y)
    got = {k: {f: v.detach().numpy() for f, v in fs.items()}
           for k, fs in tr.params.items()}
    assert all(v.dtype == np.float32 for fs in got.values()
               for v in fs.values())
    # the JAX bf16 run of the same composition: its stock composition
    # rounds each conv twice (before and after the bias), as the port's
    dist = rule_distances(got, runs['float32'], runs[mode], params0)
    print(f'{name}[{mode}] (port, jax bf16, floor) from jax f32:', dist)
    bad = {k: d for k, d in dist.items()
           if not d[0] <= RULE_FACTOR * d[1] + d[2]}
    assert not bad, bad


# --- (d) the mirror of tests/test_mixed_precision.py --------------------------

MLP_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.1
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 32
dev = cpu
eta = 0.5
momentum = 0.9
metric = error
"""


def _synth_batches(n_batches=40, bs=32, dim=16, k=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim).astype(np.float32) * 2
    out = []
    for _ in range(n_batches):
        y = rng.randint(0, k, size=bs)
        x = centers[y] + 0.3 * rng.randn(bs, dim).astype(np.float32)
        out.append(DataBatch(x.reshape(bs, 1, 1, dim).astype(np.float32),
                             y[:, None].astype(np.float32)))
    return out


def test_mlp_trains_in_bfloat16():
    trainer = NetTrainer(parse_config_string(
        MLP_CONF + '\ncompute_type = bfloat16\n'))
    trainer.init_model()
    assert trainer.dtype == torch.bfloat16
    batches = _synth_batches()
    for round_ in range(6):
        trainer.start_round(round_)
        for b in batches:
            trainer.update(b)
    res = trainer.evaluate(iter(batches[:10]), 'test')
    err = float(res.split(':')[-1])
    assert err < 0.05, f'bf16 MLP failed to learn: {res}'
    # params stay float32 (mixed precision: bf16 activations only)
    assert trainer.params['0']['wmat'].dtype == torch.float32
    assert trainer.opt_state['m']['0']['wmat'].dtype == torch.float32


def test_uint8_input_batch_in_bfloat16():
    conf = """
netconfig=start
layer[0->1] = conv:c1
  nchannel = 4
  kernel_size = 3
layer[1->2] = flatten
layer[2->3] = fullc:f1
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 8
dev = cpu
metric = error
compute_type = bfloat16
"""
    trainer = NetTrainer(parse_config_string(conf))
    trainer.init_model()
    rng = np.random.RandomState(0)
    batch = DataBatch(rng.randint(0, 256, (8, 3, 8, 8), dtype=np.uint8),
                      rng.randint(0, 4, (8, 1)).astype(np.float32))
    trainer.update(batch)          # uint8 ships raw, casts on the device
    assert np.isfinite(float(trainer.last_loss))
    pred = trainer.predict(batch.data)
    assert pred.shape == (8,)


def test_f32_batches_are_cast_on_the_host():
    """An f32 host batch reaches the net as the bf16 values of a round to
    nearest even (the JAX trainer's ml_dtypes cast)."""
    net = Net(dev='cpu', cfg=NARROW_TRAIN + 'compute_type = bfloat16\n')
    net.init_model()
    x = np.random.RandomState(40).randn(2, 3, 67, 67).astype(np.float32)
    v0 = net.trainer.forward_values(net.trainer.params, x)[0]
    assert v0.dtype == torch.bfloat16
    want = _bf(x).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(_f32(v0), want)


# --- (e) the dtype of every node --------------------------------------------

DTYPE_NETS = {'alexnet': ('cxxnet_tpu_torch/example/ImageNet.conf', 227),
              'googlenet': ('cxxnet_tpu_torch/example/GoogLeNet.conf', 224),
              'inception_bn': ('cxxnet_tpu_torch/example/Inception-BN.conf',
                               224)}


@f16_twin(dt='f16')
@pytest.mark.parametrize('name', list(DTYPE_NETS))
def test_every_node_is_bf16_after_a_bf16_forward(name, dt='bf16'):
    """A silent promotion does not fail: it runs f32 from there on.  So
    every node of the reference nets is walked after one 16-bit forward:
    all 16-bit but the loss layers' outputs (softmax), which are f32."""
    conf, hw = DTYPE_NETS[name]
    with open(os.path.join(ROOT, conf)) as f:
        net = Net(dev='cpu', cfg=f.read())
    net.set_param('compute_type', str(DT[dt][0]).split('.')[-1])
    net.set_param('batch_size', '1')
    net.init_model()
    tr = net.trainer
    x = np.random.RandomState(41).randn(1, 3, hw, hw).astype(np.float32)
    values = tr.forward_values(tr.params, x)
    loss_nodes = {n for i, info in enumerate(tr.net.cfg.layers)
                  if tr.net.layers[i].type_name == 'softmax'
                  for n in info.nindex_out}
    assert loss_nodes
    wrong = {j: v.dtype for j, v in enumerate(values) if v is not None
             and v.dtype != (torch.float32 if j in loss_nodes
                             else DT[dt][0])}
    assert not wrong, wrong
    assert all(v.dtype == torch.float32 for fs in tr.params.values()
               for v in fs.values())


# --- (f) PredictEngine at bf16 compute --------------------------------------

@pytest.mark.parametrize('serve_dtype', ['f32', 'bf16', 'int8'])
def test_predict_engine_at_bf16_compute_matches_jax(serve_dtype):
    """The port's engine at ``compute_type=bfloat16`` (weights stored in
    the serving tier, expanded to f32, cast by the layers) against JAX's
    engine on the same weights: the scores lie no further from JAX's f32
    compute engine than 1.5x JAX's bf16 compute engine's, plus 2^-8 of
    the largest score."""
    cfg = NARROW_TRAIN + 'inference_only = 1\n'
    jnets = {}
    for dt in ('float32', 'bfloat16'):
        jnets[dt] = JNet(dev='cpu', cfg=cfg + f'compute_type = {dt}\n')
        jnets[dt].init_model()
    params = _host(jnets['float32']._trainer.params)
    jnets['bfloat16']._trainer.params = jax.tree.map(jnp.asarray, params)
    data = np.random.RandomState(42).randn(6, 3, 67, 67).astype(np.float32)
    want = {dt: np.asarray(JEngine(n._trainer, (1, 4, 8),
                                   dtype=serve_dtype).predict_scores(data))
            for dt, n in jnets.items()}
    net = Net(dev='cpu', cfg=cfg + 'compute_type = bfloat16\n')
    net.init_model()
    net.trainer.params = params_from_jax(params)
    eng = PredictEngine(net.trainer, (1, 4, 8), dtype=serve_dtype)
    got = eng.predict_scores(data)
    assert got.dtype == np.float32 and got.shape == (6, 10)
    d_port = float(np.abs(got - want['float32']).max())
    d_jax = float(np.abs(want['bfloat16'] - want['float32']).max())
    floor = RULE_FLOOR * float(np.abs(want['float32']).max())
    print(f'serve {serve_dtype}: port {d_port}, jax bf16 {d_jax}, floor '
          f'{floor}')
    assert d_port <= RULE_FACTOR * d_jax + floor
    assert eng.compile_count <= 2
