"""cxxnet_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc``; without a card each one
skips (decided inside the fixture, never at import).  The file imports
torch and the port only — no JAX — so it runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Shapes are small and ragged on purpose (odd channel counts, even LRN
windows, asymmetric padding, contraction depths and output edges that
are not a multiple of the 16-deep slice or the tiles), to reach
every masked edge that AlexNet's shapes in ``chip_smoke.py`` do not.
Tolerance: max |kernel - plain| <= 1e-5 * max |plain| + 1e-6 — both sum
in f32, in different orders, over at most a few thousand terms here.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import Net
from cxxnet_tpu_torch.layers import ForwardContext, create_layer, \
    get_layer_type
from cxxnet_tpu_torch.layers.base import NodeSpec
from cxxnet_tpu_torch.ops.cnn import (conv_bias_act, conv_bias_act_backward,
                                      conv_bias_act_plain)
from cxxnet_tpu_torch.ops.kernels import (fullc_gemm, fullc_gemm_nt,
                                          fullc_gemm_nt_plain,
                                          fullc_gemm_plain, fullc_gemm_tn,
                                          fullc_gemm_tn_plain, launch_counts,
                                          lrn_backward, lrn_backward_plain,
                                          lrn_forward, lrn_forward_plain,
                                          reset_launch_counts)

from torch_twins import f16_twin

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the card)')
    return torch.device('cuda', 0)


def _close(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= RTOL * scale + ATOL, (err, scale)


def _rand(shape, dev, seed):
    g = np.random.RandomState(seed)
    return torch.from_numpy(g.randn(*shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize(
    'n,hw,cin,cout,k,stride,pad,groups,act,bias',
    [(2, 9, 4, 8, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True),
     (2, 9, 4, 8, 3, 1, ((1, 1), (1, 1)), 1, 'identity', False),
     (3, 23, 3, 70, 11, 4, ((0, 0), (0, 0)), 1, 'relu', True),
     (2, 10, 6, 10, 5, 2, ((1, 2), (0, 3)), 2, 'relu', True),
     (1, 7, 20, 36, 3, 1, ((1, 1), (1, 1)), 4, 'identity', True),
     (2, 8, 130, 65, 1, 1, ((0, 0), (0, 0)), 1, 'relu', False),
     # the kernel's three patch copies at AlexNet's shapes, batch 2:
     # cin/g % 16 == 0 with padding and groups (conv2; conv4), 16-byte
     # chunks of cin/g % 4 == 0 but not % 16 (conv4's geometry at cin/g
     # 20: no AlexNet layer has one), 4-byte copies of conv1's cin 3 with
     # its 96 channels in one tile
     (2, 27, 96, 256, 5, 1, ((2, 2), (2, 2)), 2, 'relu', True),
     (2, 13, 384, 384, 3, 1, ((1, 1), (1, 1)), 2, 'relu', True),
     (2, 13, 40, 64, 3, 1, ((1, 1), (1, 1)), 2, 'relu', True),
     (2, 227, 3, 96, 11, 4, ((0, 0), (0, 0)), 1, 'relu', True)],
    ids=['base', 'bare', 'conv1like', 'asym_pad_g2', 'group4', 'ragged1x1',
         'conv2_tap16', 'conv4_tap16', 'chunk4_cin_g20', 'conv1_cin3'])
def test_conv_kernel_matches_plain(dev, n, hw, cin, cout, k, stride, pad,
                                   groups, act, bias):
    x = _rand((n, hw, hw, cin), dev, 1)
    w = _rand((k, k, cin // groups, cout), dev, 2)
    b = _rand((cout,), dev, 3) if bias else None
    before = launch_counts()['conv_bias_act']
    y = conv_bias_act(x, w, b, (stride, stride), pad, groups, act)
    torch.cuda.synchronize()
    assert launch_counts()['conv_bias_act'] == before + 1
    ref = conv_bias_act_plain(x, w, b, (stride, stride), pad, groups, act)[0]
    assert y.shape == ref.shape
    _close(y, ref)


def test_conv_kernel_writes_preactivation_only_for_autograd(dev):
    x = _rand((2, 6, 6, 4), dev, 4)
    w = _rand((3, 3, 4, 8), dev, 5).requires_grad_()
    b = _rand((8,), dev, 6)
    y = conv_bias_act(x, w, b, (1, 1), ((1, 1), (1, 1)), 1, 'relu')
    ref_y, ref_z = conv_bias_act_plain(x, w.detach(), b, (1, 1),
                                       ((1, 1), (1, 1)), 1, 'relu')
    _close(y.detach(), ref_y)
    _, _, z = y.grad_fn.saved_tensors
    _close(z, ref_z)
    # the backward computes (the saved z masks, the native transposes)
    gy = _rand(tuple(y.shape), dev, 7)
    y.backward(gy)
    want = conv_bias_act_backward(x.cpu(), w.detach().cpu(), ref_z.cpu(),
                                  gy.cpu(), (1, 1), ((1, 1), (1, 1)), 1,
                                  'relu')[1]
    _close(w.grad, want)


@pytest.mark.parametrize('tf32', [False, True], ids=['f32', 'tf32_flags_on'])
def test_conv_backward_holds_float64_at_conv2(dev, tf32):
    # the fused block's backward at AlexNet's conv2 (grouped 5x5, pad 2,
    # batch 256) against float64, whatever TF32 flags the caller left on:
    # max |err| <= 1e-5 of the largest value, for f32 sums over up to
    # 186624 terms (native transposes measure ~1e-6; cuDNN's f32 weight
    # gradient here measured ~3e-2 on an H100)
    x = torch.relu(_rand((256, 27, 27, 96), dev, 30))
    w = _rand((5, 5, 48, 256), dev, 31) * 0.05
    gy = _rand((256, 27, 27, 256), dev, 32)
    pad = ((2, 2), (2, 2))
    z = conv_bias_act_plain(x, w, None, (1, 1), pad, 2, 'relu')[1]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        got = conv_bias_act_backward(x, w, z, gy, (1, 1), pad, 2, 'relu')
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    want = conv_bias_act_backward(x.double(), w.double(), z.double(),
                                  gy.double(), (1, 1), pad, 2, 'relu')
    for name, g, r in zip(('dx', 'dw', 'db'), got, want):
        err = (g.double() - r).abs().max().item()
        scale = r.abs().max().item()
        assert g.dtype == torch.float32 and err <= 1e-5 * scale, \
            (name, err, scale)


@pytest.mark.parametrize('lowering', ['native', 'split', 'im2col',
                                      'micro_batch'])
def test_unfused_conv_backward_holds_float64_at_conv2(dev, lowering):
    # a conv off the fused kernel at AlexNet's conv2 (grouped 5x5, pad 2,
    # batch 256) in f32 against float64: its backward is the fused
    # block's transposes (cuDNN's f32 weight gradient here measured
    # ~2.7e-2 of its largest value on an H100), im2col's too, and the
    # microbatched conv's dw is the unsplit call, bitwise
    from cxxnet_tpu_torch.layers.conv import (MICRO_BATCHED, conv_im2col,
                                              conv_native, conv_split)
    from cxxnet_tpu_torch.ops.microbatch import microbatched_conv
    from cxxnet_tpu_torch.ops.precision import full_f32
    x = torch.relu(_rand((256, 27, 27, 96), dev, 40))
    w = _rand((5, 5, 48, 256), dev, 41) * 0.05
    gy = _rand((256, 27, 27, 256), dev, 42)
    pad = ((2, 2), (2, 2))
    if lowering == 'im2col':      # ungrouped: one group's channels
        x, w, gy, groups = x[..., :48].contiguous(), w[..., :128], \
            gy[..., :128].contiguous(), 1
    else:
        groups = 2
    fns = {'native': lambda a, b: conv_native(a, b, (1, 1), pad, groups),
           'split': lambda a, b: conv_split(a, b, (1, 1), pad, groups),
           'im2col': lambda a, b: conv_im2col(a, b, (1, 1), pad),
           'micro_batch': lambda a, b: microbatched_conv(
               a, b, (1, 1), pad, groups, 4, *MICRO_BATCHED['native'])}

    def grads(fn, a, b):
        # in full f32, as the trainer runs every step (no TF32)
        a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        with full_f32():
            y = fn(a, b)
            return (y.detach(),) + torch.autograd.grad(y, (a, b),
                                                       gy.to(y.dtype))
    got = grads(fns[lowering], x, w)
    want = grads(fns['native'], x.double(), w.double())
    for name, g, r in zip(('y', 'dx', 'dw'), got, want):
        err = (g.double() - r).abs().max().item()
        scale = r.abs().max().item()
        assert g.dtype == torch.float32 and err <= 1e-5 * scale, \
            (name, err, scale)
    if lowering == 'micro_batch':
        assert torch.equal(got[2], grads(fns['native'], x, w)[2])


@pytest.mark.parametrize('c,nsize', [(96, 5), (256, 5), (13, 4), (130, 3),
                                     (7, 1)])
def test_lrn_kernel_matches_plain(dev, c, nsize):
    x = _rand((3, 5, 7, c), dev, c) * 3.0
    before = launch_counts()['lrn_forward']
    y = lrn_forward(x, nsize, 0.001, 0.75, 1.0)
    torch.cuda.synchronize()
    assert launch_counts()['lrn_forward'] == before + 1
    _close(y, lrn_forward_plain(x, nsize, 0.001, 0.75, 1.0)[0])


@pytest.mark.parametrize('m,k,n', [(256, 4096, 1000), (70, 333, 129),
                                   (1, 17, 5), (256, 9216, 4096),
                                   (256, 4096, 4096)],
                         ids=['fc8', 'ragged', 'tiny', 'fc6', 'fc7'])
def test_gemm_kernel_matches_plain(dev, m, k, n):
    a = _rand((m, k), dev, 7)
    b = _rand((k, n), dev, 8)
    before = launch_counts()['fullc_gemm']
    c = fullc_gemm(a, b)
    torch.cuda.synchronize()
    assert launch_counts()['fullc_gemm'] == before + 1
    _close(c, fullc_gemm_plain(a, b))


def test_gemm_kernel_takes_unaligned_operands(dev):
    # contiguous operands whose rows start 4 bytes past a 16-byte
    # boundary: the kernel's 4-byte copy path, with and without split-K
    for m, k, n in ((64, 64, 68), (256, 4096, 1000)):
        a = _rand((m * k + 1,), dev, 30)[1:].view(m, k)
        b = _rand((k * n + 1,), dev, 31)[1:].view(k, n)
        assert a.data_ptr() % 16 and b.data_ptr() % 16
        _close(fullc_gemm(a, b), fullc_gemm_plain(a, b))


def test_gemm_tn_kernel_takes_unaligned_operands(dev):
    # the weight-gradient kernel's 4-byte copy path: contiguous operands
    # whose rows start 4 bytes past a 16-byte boundary, with row lengths
    # that are multiples of 4 and ones that are not (k = 333, n = 129;
    # k = 130, n = 65), a ragged batch among them
    for m, k, n in ((64, 64, 68), (256, 4096, 1000), (70, 333, 129),
                    (37, 130, 65)):
        a = _rand((m * k + 1,), dev, 32)[1:].view(m, k)
        g = _rand((m * n + 1,), dev, 33)[1:].view(m, n)
        assert a.data_ptr() % 16 and g.data_ptr() % 16
        _close(fullc_gemm_tn(a, g), fullc_gemm_tn_plain(a, g))


@pytest.mark.parametrize('c,nsize', [(96, 5), (256, 5), (13, 4), (130, 3),
                                     (7, 1), (33, 6)])
def test_lrn_backward_kernel_matches_plain(dev, c, nsize):
    x = _rand((3, 5, 7, c), dev, c) * 3.0
    g = _rand((3, 5, 7, c), dev, c + 1)
    _, norm = lrn_forward_plain(x, nsize, 0.001, 0.75, 1.0)
    before = launch_counts()['lrn_backward']
    dx = lrn_backward(x, g, norm, nsize, 0.001, 0.75)
    torch.cuda.synchronize()
    assert launch_counts()['lrn_backward'] == before + 1
    _close(dx, lrn_backward_plain(x, g, norm, nsize, 0.001, 0.75))


def _lrn_all_forms(x, g, nsize, beta, alpha=0.001, knorm=1.0):
    """The forward (inference and training forms, y and norm), and the
    backward from the plain forward's norm, against the plain versions;
    each launched once and counted."""
    from cxxnet_tpu_torch.ops.kernels import _lrn_call
    before = launch_counts()
    y = lrn_forward(x, nsize, alpha, beta, knorm)
    y_t, norm_t = _lrn_call(x, nsize, alpha, beta, knorm, True)
    ref_y, ref_norm = lrn_forward_plain(x, nsize, alpha, beta, knorm)
    dx = lrn_backward(x, g, ref_norm, nsize, alpha, beta)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after['lrn_forward'] == before['lrn_forward'] + 2
    assert after['lrn_backward'] == before['lrn_backward'] + 1
    _close(y, ref_y)
    _close(y_t, ref_y)
    _close(norm_t, ref_norm)
    _close(dx, lrn_backward_plain(x, g, ref_norm, nsize, alpha, beta))


@pytest.mark.parametrize('shape', [(256, 27, 27, 96), (256, 13, 13, 256)],
                         ids=['norm1', 'norm2'])
def test_lrn_kernels_at_alexnet_shapes(dev, shape):
    """AlexNet's norm1 and norm2 at batch 256: both forward forms and the
    backward (the 16-byte path with the unrolled window of 5)."""
    _lrn_all_forms(_rand(shape, dev, 50) * 4.0, _rand(shape, dev, 51), 5,
                   0.75)


@pytest.mark.parametrize('c,nsize,offset', [(13, 5, 0), (130, 5, 0),
                                            (96, 5, 1), (256, 4, 1),
                                            (33, 6, 1)],
                         ids=['c13', 'c130', 'c96_unaligned',
                              'c256_n4_unaligned', 'c33_n6_unaligned'])
def test_lrn_kernels_take_the_4_byte_path(dev, c, nsize, offset):
    """c % 4 != 0, or tensors whose base lies 4 bytes past a 16-byte
    boundary: the kernels' 4-byte path (masked items at a row's end)."""
    shape = (3, 7, 11, c)
    n = 3 * 7 * 11 * c
    x = (_rand((n + offset,), dev, 52) * 3.0)[offset:].view(shape)
    g = _rand((n + offset,), dev, 53)[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    _lrn_all_forms(x, g, nsize, 0.75)


@pytest.mark.parametrize('c,nsize', [(96, 5), (256, 5), (13, 4), (130, 3)])
def test_lrn_kernels_at_another_beta(dev, c, nsize):
    """beta = 0.6: the power by the MUFU log and exponent, not the beta =
    0.75 path."""
    shape = (5, 9, 9, c)
    _lrn_all_forms(_rand(shape, dev, 54) * 4.0, _rand(shape, dev, 55),
                   nsize, 0.6)


@pytest.mark.parametrize('c', [5000, 8192, 5001])
def test_lrn_kernels_take_up_to_8192_channels_both_ways(dev, c):
    """One channel limit for both directions: rows of 5000 (the backward
    used to stop at 4096), 8192 and 5001 channels run forward and
    backward; 8193 raises in both."""
    shape = (2, 3, c)
    _lrn_all_forms(_rand(shape, dev, 56) * 4.0, _rand(shape, dev, 57), 5,
                   0.75)
    x = _rand((2, 8193), dev, 58)
    with pytest.raises(ValueError):
        lrn_forward(x, 5, 0.001, 0.75, 1.0)
    with pytest.raises(ValueError):
        lrn_backward(x, x, x, 5, 0.001, 0.75)


@pytest.mark.parametrize('m,n,k', [(256, 1000, 4096), (70, 333, 129),
                                   (1, 17, 5), (37, 16, 65),
                                   (256, 4096, 4096), (256, 4096, 9216)])
def test_gemm_backward_kernels_match_plain(dev, m, n, k):
    # (256, 4096, 4096), fc7's input gradient, takes the NT kernel's
    # split-K path; (256, 1000, 4096), fc8's, splits its 1000-deep
    # contraction too; (256, 4096, 9216) is fc6, the weight gradient's
    # largest output (72 x 64 tiles)
    g = _rand((m, n), dev, 15)
    b = _rand((k, n), dev, 16)
    a = _rand((m, k), dev, 17)
    before = launch_counts()
    da = fullc_gemm_nt(g, b)
    db = fullc_gemm_tn(a, g)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after['fullc_gemm_nt'], after['fullc_gemm_tn']) == \
        (before['fullc_gemm_nt'] + 1, before['fullc_gemm_tn'] + 1)
    assert da.shape == (m, k) and db.shape == (k, n)
    _close(da, fullc_gemm_nt_plain(g, b))
    _close(db, fullc_gemm_tn_plain(a, g))


def test_gemm_autograd_runs_the_backward_kernels(dev):
    a = _rand((9, 40), dev, 18).requires_grad_()
    b = _rand((40, 7), dev, 19).requires_grad_()
    gc = _rand((9, 7), dev, 20)
    before = launch_counts()
    fullc_gemm(a, b).backward(gc)
    after = launch_counts()
    assert after['fullc_gemm_nt'] == before['fullc_gemm_nt'] + 1
    assert after['fullc_gemm_tn'] == before['fullc_gemm_tn'] + 1
    _close(a.grad, gc.cpu() @ b.detach().cpu().t())
    _close(b.grad, a.detach().cpu().t() @ gc.cpu())


def test_max_pool_gradient_at_all_zero_windows_matches_cpu(dev):
    # all-zero windows tie every element: the gradient goes to one of
    # them, on the card (NHWC, another CUDA kernel) as on the CPU
    x = np.zeros((2, 9, 9, 5), np.float32)
    x[1, 4:, 4:, 2:] = np.random.RandomState(21).randn(5, 5, 3)
    grads = {}
    for d in ('cpu', 'cuda'):
        layer = create_layer(get_layer_type('max_pooling'))
        layer.set_param('kernel_size', '3')
        layer.set_param('stride', '2')
        layer.infer_shapes([NodeSpec(5, 9, 9)])
        xt = torch.from_numpy(x).to(d).requires_grad_()
        out = layer.forward({}, [xt], ForwardContext(is_train=True))[0]
        out.backward(torch.ones_like(out))
        grads[d] = xt.grad.cpu()
    np.testing.assert_array_equal(grads['cuda'].numpy(),
                                  grads['cpu'].numpy())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _rand((2, 6, 6, 4), dev, 9)
    w = _rand((3, 3, 4, 8), dev, 10)
    with pytest.raises(ValueError):
        conv_bias_act(x.double(), w, None, (1, 1), ((0, 0), (0, 0)))
    with pytest.raises(ValueError):
        conv_bias_act(x.transpose(1, 2), w, None, (1, 1), ((0, 0), (0, 0)))
    with pytest.raises(ValueError):
        fullc_gemm(_rand((4, 5), dev, 11), _rand((6, 3), dev, 12))
    with pytest.raises(ValueError):
        lrn_forward(_rand((4, 6), dev, 13).t(), 3, 1e-3, 0.75, 1.0)
    x6 = _rand((4, 6), dev, 22)
    with pytest.raises(ValueError):
        lrn_backward(x6, x6.t().contiguous().t(), x6, 3, 1e-3, 0.75)
    with pytest.raises(ValueError):
        fullc_gemm_nt(_rand((4, 5), dev, 23), _rand((6, 3), dev, 24))
    with pytest.raises(ValueError):
        fullc_gemm_tn(_rand((4, 5), dev, 25), _rand((3, 6), dev, 26))


_NARROW = """
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
layer[3->4] = conv:conv2
  ngroup = 2
  nchannel = 32
  kernel_size = 5
  pad = 2
layer[4->4] = relu
layer[4->5] = max_pooling
  kernel_size = 3
  stride = 2
layer[5->6] = flatten
layer[6->7] = fullc:fc8
  nhidden = 10
layer[7->7] = softmax
netconfig=end
input_shape = 3,67,67
random_type = xavier
use_pallas = 1
seed = 3
"""


def test_net_on_card_matches_cpu_plain_versions(dev):
    x = np.random.RandomState(14).randn(5, 3, 67, 67).astype(np.float32)
    out = {}
    for d in ('cuda', 'cpu'):
        net = Net(dev=d, cfg=_NARROW)
        net.init_model()
        reset_launch_counts()
        out[d] = net.predict_scores(x)
        counts = launch_counts()
        forward = ('conv_bias_act', 'lrn_forward', 'fullc_gemm')
        if d == 'cuda':
            assert all(counts[k] > 0 for k in forward), counts
            assert not any(v for k, v in counts.items()
                           if k not in forward), counts
        else:
            assert not any(counts.values()), counts
    np.testing.assert_allclose(out['cuda'], out['cpu'], rtol=1e-4,
                               atol=1e-6)


def test_train_steps_on_card_match_cpu_plain_versions(dev):
    # three SGD steps (dropout-free net, use_pallas=1): every kernel of
    # the train path launches on the card, and the weights agree with
    # the CPU run of the plain versions to 1e-4 of their largest change
    rng = np.random.RandomState(15)
    x = rng.randn(6, 3, 67, 67).astype(np.float32)
    y = rng.randint(0, 10, 6)
    cfg = _NARROW + 'eta = 0.05\nmomentum = 0.9\nmetric = error\n'
    moved = {}
    for d in ('cuda', 'cpu'):
        net = Net(dev=d, cfg=cfg)
        net.init_model()
        w0 = {(k, f): v.detach().cpu().clone()
              for k, fs in net.trainer.params.items() for f, v in fs.items()}
        reset_launch_counts()
        for _ in range(3):
            net.update(x, y)
        counts = launch_counts()
        if d == 'cuda':
            train = ('conv_bias_act', 'lrn_forward', 'lrn_backward',
                     'fullc_gemm', 'fullc_gemm_nt', 'fullc_gemm_tn')
            assert all(counts[k] > 0 for k in train), counts
            assert not any(v for k, v in counts.items()
                           if k not in train), counts
        moved[d] = {key: net.trainer.params[key[0]][key[1]].detach().cpu()
                    - w for key, w in w0.items()}
    for key, ref in moved['cpu'].items():
        scale = ref.abs().max().item()
        err = (moved['cuda'][key] - ref).abs().max().item()
        assert err <= 1e-4 * scale + 1e-7, (key, err, scale)


# --- the Inception nets' shapes and the sibling conv -------------------------

def _inception_convs():
    """The distinct convs the Inception nets give the conv kernel, read
    off the port's graphs of the example confs: GoogLeNet's 32 conv+relu
    pairs and Inception-BN's 41 solo identity convs under ``fuse=1``, as
    ``(id, hw, cin, cout, k, stride, pad, act)``."""
    from cxxnet_tpu_torch.nnet.net import Net as Graph
    from cxxnet_tpu_torch.nnet.net_config import NetConfig
    from cxxnet_tpu_torch.utils.config import parse_config_string
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for conf, fuse, act in (('GoogLeNet.conf', 'auto', 'relu'),
                            ('Inception-BN.conf', '1', 'identity')):
        with open(os.path.join(root, 'cxxnet_tpu_torch', 'example',
                               conf)) as f:
            cfg = NetConfig()
            cfg.configure(list(parse_config_string(f.read()))
                          + [('fuse', fuse)])
        g = Graph(cfg)
        for i in sorted(g._convact_pairs) + sorted(g._convact_solo):
            p, info = g.layers[i].param, cfg.layers[i]
            spec = g.node_specs[info.nindex_in[0]]
            key = (spec.y, spec.c, p.num_channel, p.kernel_height, p.stride,
                   p.pad_y, act)
            out.setdefault(key, f'{conf.split(".")[0]}-{info.name}')
    return [(name, *key) for key, name in out.items()]


_INCEPTION_CONVS = _inception_convs()


@pytest.mark.parametrize('hw,cin,cout,k,stride,pad,act',
                         [c[1:] for c in _INCEPTION_CONVS],
                         ids=[c[0] for c in _INCEPTION_CONVS])
def test_conv_kernel_at_inception_shapes(dev, hw, cin, cout, k, stride, pad,
                                         act):
    """GoogLeNet's conv+relu pairs (conv1's 3 channels at 7x7 stride 2,
    the 1x1 proj convs, the 3x3 and 5x5 convs at 7-56 pixels, output
    widths off the tile) and Inception-BN's solo identity convs, batch 2,
    against the plain version."""
    x = torch.relu(_rand((2, hw, hw, cin), dev, 60))
    w = _rand((k, k, cin, cout), dev, 61) * (k * k * cin) ** -0.5
    b = _rand((cout,), dev, 62)
    p = ((pad, pad), (pad, pad))
    before = launch_counts()['conv_bias_act']
    y = conv_bias_act(x, w, b, (stride, stride), p, 1, act)
    torch.cuda.synchronize()
    assert launch_counts()['conv_bias_act'] == before + 1
    ref = conv_bias_act_plain(x, w, b, (stride, stride), p, 1, act)[0]
    assert y.shape == ref.shape
    _close(y, ref)


@pytest.mark.parametrize('shape', [(128, 56, 56, 64), (128, 56, 56, 192)],
                         ids=['norm1', 'norm2'])
def test_lrn_kernels_at_googlenet_shapes(dev, shape):
    """GoogLeNet's norm1 (c 64, forced on by use_pallas=1) and norm2 (c
    192, the hybrid's forward under auto) at batch 128: both forward
    forms and the backward."""
    _lrn_all_forms(_rand(shape, dev, 63) * 4.0, _rand(shape, dev, 64), 5,
                   0.75)


@pytest.mark.parametrize('m,k,n', [(128, 1024, 1000), (256, 1024, 1000),
                                   (128, 2048, 1024)],
                         ids=['googlenet_fc', 'inception_bn_fc1',
                              'googlenet_aux_fc1'])
def test_gemm_kernels_at_inception_shapes(dev, m, k, n):
    """The 1000-way fullc layers (GoogLeNet's loss3_fc and aux fc2 at m
    128, Inception-BN's fc1 at m 256) and GoogLeNet's aux fc1: the
    forward GEMM, and the input- and weight-gradient GEMMs."""
    a = _rand((m, k), dev, 65)
    w = _rand((k, n), dev, 66) * k ** -0.5
    g = _rand((m, n), dev, 67)
    before = launch_counts()
    out = fullc_gemm(a, w)
    da = fullc_gemm_nt(g, w)
    dw = fullc_gemm_tn(a, g)
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[x] - before[x] for x in ('fullc_gemm', 'fullc_gemm_nt',
                                           'fullc_gemm_tn')] == [1, 1, 1]
    _close(out, fullc_gemm_plain(a, w))
    _close(da, fullc_gemm_nt_plain(g, w))
    _close(dw, fullc_gemm_tn_plain(a, g))


def _narrow_inception():
    """A stem, one GoogLeNet inception module (a sibling group of three
    1x1 convs) and a fullc, at 32 x 32."""
    from cxxnet_tpu_torch.models import builders as b
    lines = ['netconfig=start']
    top = b._conv_relu(lines, '0', 'conv1', 8, 7, stride=2, pad=3)
    b._pool(lines, top, 'pool1', 'max_pooling', 3, 2)
    top = b._inception_v1(lines, 'pool1', 'in3a', 8, 6, 8, 4, 6, 5)
    b._pool(lines, top, 'gpool', 'avg_pooling', 8, 1)
    return '\n'.join(lines + [
        'layer[gpool->flat] = flatten', 'layer[flat->fc] = fullc:fc',
        '  nhidden = 10', 'layer[fc->fc] = softmax', 'netconfig=end',
        'input_shape = 3,32,32', 'random_type = xavier', 'seed = 4',
        'eta = 0.05', 'momentum = 0.9', 'metric = error']) + '\n'


def test_sibling_conv_on_card_splits_back_per_member(dev):
    """The sibling group's one conv over the concatenated weights gives
    each member its own conv's output on the card; three SGD steps of a
    net with a sibling group agree with the CPU run to 1e-4 of the
    largest change."""
    from cxxnet_tpu_torch.layers.conv import conv_native
    rng = np.random.RandomState(16)
    x = rng.randn(6, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 6)
    moved = {}
    for d in ('cuda', 'cpu'):
        net = Net(dev=d, cfg=_narrow_inception())
        net.init_model()
        graph, params = net.trainer.net, net.trainer.params
        groups = {tuple(g) for g in graph._sibling_groups.values()}
        assert [len(g) for g in groups] == [3]
        if d == 'cuda':
            members = list(next(iter(groups)))
            xin = torch.relu(_rand((6, 8, 8, 8), dev, 68))
            outs = graph._fused_sibling_outputs(params, xin, members)
            for m, out in zip(members, outs):
                lp = params[str(m)]
                want = conv_native(xin, lp['wmat'], (1, 1),
                                   ((0, 0), (0, 0))) + lp['bias']
                assert out.shape == want.shape
                _close(out, want)
        w0 = {(k, f): v.detach().cpu().clone()
              for k, fs in params.items() for f, v in fs.items()}
        for _ in range(3):
            net.update(x, y)
        moved[d] = {key: net.trainer.params[key[0]][key[1]].detach().cpu()
                    - w for key, w in w0.items()}
    for key, ref in moved['cpu'].items():
        scale = ref.abs().max().item()
        err = (moved['cuda'][key] - ref).abs().max().item()
        assert err <= 1e-4 * scale + 1e-7, (key, err, scale)


# --- the paged attention kernels (decode serving) -----------------------------

def _paged_case(dev, S, pp, ps, H, hd, pos, w, seed, K=1, idle=()):
    """A shuffled pool with one stage's pages, its table and per-slot
    positions / pad widths; slots in ``idle`` sit on scratch page 0 with
    pos = w = 0, as the engine's idle slots do."""
    g = np.random.RandomState(seed)
    P = S * pp + 5
    pool = [torch.from_numpy(g.randn(P, ps, H, hd).astype(np.float32))
            .to(dev) for _ in range(2)]
    table = g.permutation(np.arange(1, P))[:S * pp].reshape(S, pp)
    pos, w = np.array(pos, np.int32), np.array(w, np.int32)
    for s in idle:
        table[s], pos[s], w[s] = 0, 0, 0
    q = _rand((S, K, H, hd) if K > 1 else (S, H, hd), dev, seed + 1)
    return (q, pool[0], pool[1],
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(w).to(dev))


@pytest.mark.parametrize(
    'S,pp,ps,H,hd,pos,w,idle',
    [(4, 3, 5, 3, 64, [0, 4, 5, 14], [0, 2, 5, 7], ()),      # ragged T=15
     (3, 4, 16, 16, 64, [15, 16, 63], [3, 0, 7], ()),        # page edges
     (2, 16, 16, 16, 64, [255, 200], [7, 0], ()),            # last position
     (5, 2, 8, 2, 32, [0, 9, 15, 3, 8], [0, 1, 0, 3, 8], (0, 3)),
     (2, 6, 7, 4, 128, [41, 20], [0, 6], ())],
    ids=['ragged', 'page_edges', 'last_pos', 'idle_slots', 'hd128'])
def test_paged_decode_kernel_matches_plain(dev, S, pp, ps, H, hd, pos, w,
                                           idle):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_decode,
                                                paged_flash_decode_plain)
    args = _paged_case(dev, S, pp, ps, H, hd, pos, w, 31, idle=idle)
    before = launch_counts()['paged_flash_decode']
    out = paged_flash_decode(*args, hd ** -0.5)
    torch.cuda.synchronize()
    assert launch_counts()['paged_flash_decode'] == before + 1
    ref = paged_flash_decode_plain(*args, hd ** -0.5)
    assert torch.isfinite(out).all()
    _close(out, ref)


@pytest.mark.parametrize(
    'S,pp,ps,K,pos,w',
    [(3, 4, 8, 4, [6, 13, 28], [0, 3, 2]),      # windows across a page
     (2, 3, 5, 3, [0, 12], [0, 4]),             # ragged T, idle-like start
     (2, 16, 16, 4, [252, 100], [5, 0])],       # up to the last position
    ids=['cross_page', 'ragged', 'last_pos'])
def test_paged_verify_kernel_matches_plain(dev, S, pp, ps, K, pos, w):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_verify,
                                                paged_flash_verify_plain)
    args = _paged_case(dev, S, pp, ps, 4, 64, pos, w, 33, K=K)
    out = paged_flash_verify(*args, 0.125)
    torch.cuda.synchronize()
    _close(out, paged_flash_verify_plain(*args, 0.125))


def test_verify_query_k_is_bitwise_the_decode_step_at_pos_plus_k(dev):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_decode,
                                                paged_flash_verify)
    q, kp, vp, table, pos, w = _paged_case(dev, 3, 4, 8, 4, 64,
                                           [5, 14, 20], [0, 2, 1], 35, K=4)
    win = paged_flash_verify(q, kp, vp, table, pos, w, 0.125)
    for k in range(4):
        step = paged_flash_decode(q[:, k].contiguous(), kp, vp, table,
                                  (pos + k).int(), w, 0.125)
        assert torch.equal(step, win[:, k]), k
    one = paged_flash_verify(q[:, :1].contiguous(), kp, vp, table, pos, w,
                             0.125)
    assert torch.equal(one[:, 0], paged_flash_decode(
        q[:, 0].contiguous(), kp, vp, table, pos, w, 0.125))


def test_paged_kernels_ignore_page_size_and_table(dev):
    # the same live rows under another page size and table give bitwise
    # the same output: what the engine-vs-generate stream twins rest on
    from cxxnet_tpu_torch.ops.attention import paged_flash_decode
    g = np.random.RandomState(37)
    H, hd, T = 4, 64, 48
    k = g.randn(2, T, H, hd).astype(np.float32)
    v = g.randn(2, T, H, hd).astype(np.float32)
    q = _rand((2, H, hd), dev, 38)
    pos = torch.tensor([40, 17], dtype=torch.int32, device=dev)
    w = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    outs = []
    for ps in (16, 48):
        pp = T // ps
        perm = g.permutation(2 * pp)
        kp = np.zeros((2 * pp + 1, ps, H, hd), np.float32)
        vp = np.zeros_like(kp)
        table = (perm.reshape(2, pp) + 1).astype(np.int32)
        for s in range(2):
            for lp in range(pp):
                kp[table[s, lp]] = k[s, lp * ps:(lp + 1) * ps]
                vp[table[s, lp]] = v[s, lp * ps:(lp + 1) * ps]
        outs.append(paged_flash_decode(
            q, torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev),
            torch.from_numpy(table).to(dev), pos, w, 0.125))
    assert torch.equal(outs[0], outs[1])


def test_paged_wrappers_reject_what_the_kernels_do_not_take(dev):
    from cxxnet_tpu_torch.ops.attention import paged_flash_decode
    q, kp, vp, table, pos, w = _paged_case(dev, 2, 2, 4, 2, 64, [3, 5],
                                           [0, 0], 39)
    with pytest.raises(ValueError):
        paged_flash_decode(q.double(), kp, vp, table, pos, w, 0.125)
    with pytest.raises(ValueError):
        paged_flash_decode(q, kp, vp, table.long(), pos, w, 0.125)
    with pytest.raises(ValueError):
        paged_flash_decode(q, kp[:, :, :1], vp, table, pos, w, 0.125)


def test_decode_engine_on_card_streams_equal_generate(dev):
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.attention import paged_flash_decode
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                              d_ff=96, num_stages=2, attn='local')
    params = T.init_params(np.random.RandomState(0), cfg)
    eng = DecodeEngine(params, cfg, slots=4, pages=64, page_size=8,
                       max_prompt=16, max_new_bound=24, device='cuda')
    try:
        assert eng.use_flash
        before = launch_counts()['paged_flash_decode']
        g = np.random.RandomState(1)
        jobs = []
        for i in range(6):
            p = g.randint(0, 64, (1, int(g.randint(1, 14)))).astype(np.int32)
            temp, seed = (0.9, 50 + i) if i % 3 == 2 else (0.0, None)
            jobs.append((p, temp, seed, eng.submit_direct(
                p, max_new=20, temperature=temp, rng=seed)))
        for *_, req in jobs:
            assert req.event.wait(120) and req.error is None, req.error
        steps = int(eng.stats.get('decode_steps'))
        assert launch_counts()['paged_flash_decode'] - before == 2 * steps > 0
        for p, temp, seed, req in jobs:
            want = T.generate(eng.params, p, 20, cfg, temperature=temp,
                              rng=seed)[0]
            np.testing.assert_array_equal(req.result, want)
    finally:
        eng.close(60)


# --- the quantized tiers: the int8 GEMM and the bf16 paged builds -------------

def _int8(shape, dev, seed, offset=0):
    """Random int8 in [-127, 127]; ``offset`` > 0 starts the tensor that
    many bytes into its buffer (an address the word loads cannot take)."""
    g = np.random.RandomState(seed)
    n = int(np.prod(shape))
    buf = torch.from_numpy(g.randint(-127, 128, n + offset).astype(np.int8))
    return buf.to(dev)[offset:].view(*shape)


@pytest.mark.parametrize('m,k,n,offset', [
    (1, 1024, 300, 0),      # the prefill head's one row, ragged n
    (5, 33, 17, 0), (70, 129, 67, 0), (65, 64, 64, 0), (2, 3, 1, 0),
    (3, 4096, 5, 0),        # the FFN's deepest contraction
    (64, 1024, 1024, 0), (8, 4096, 1024, 0),
    (17, 100, 36, 1),       # unaligned operands: the byte loads
    (4, 0, 5, 0)],          # an empty contraction
    ids=['m1_head', 'ragged', 'ragged_big', 'tile_plus_one', 'tiny',
         'deep_k', 'decode', 'prefill8', 'unaligned', 'k0'])
def test_int8_kernel_bitwise_equals_plain(dev, m, k, n, offset):
    from cxxnet_tpu_torch.ops.kernels import int8_matmul, int8_matmul_plain
    a = _int8((m, k), dev, 41, offset)
    b = _int8((k, n), dev, 42, offset)
    before = launch_counts()['int8_matmul']
    out = int8_matmul(a, b)
    torch.cuda.synchronize()
    assert launch_counts()['int8_matmul'] == before + 1
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out, int8_matmul_plain(a, b))


@pytest.mark.parametrize('m,k,n,splits', [
    (64, 40, 64, 1),        # k below one 64-deep tile: no split
    (64, 100, 64, 2),       # k below one split's tiles, not a multiple of 16
    (1, 300, 70, 4),        # 5 tiles over 4 ranges of 2: the last is empty
    (64, 1024, 100, 8),     # n not a multiple of the 64-column tile
    (64, 1000, 1024, 8),    # k % 16 = 8: a's byte path under a full split
    (128, 4096, 48, 8),     # two row tiles, the FFN's depth
    (64, 1024, 4096, 4)],   # the decode step's w1 (256 blocks)
    ids=['k_below_tile', 'k_below_split', 'empty_last_split', 'n_ragged',
         'a_byte_path', 'm128_deep', 'decode_w1'])
def test_int8_kernel_split_k_edges_bitwise_and_repeatable(dev, m, k, n,
                                                          splits):
    """The split-K cluster's edges: the kernel's own split count, the
    result bitwise the plain version's, and a second launch bitwise the
    first (the S partials of a tile are added in rank order)."""
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.kernels import int8_matmul, int8_matmul_plain
    assert build.entry('int8_gemm_splits')(m, n, k) == splits
    a, b = _int8((m, k), dev, 47), _int8((k, n), dev, 48)
    first, second = int8_matmul(a, b), int8_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, int8_matmul_plain(a, b))
    assert torch.equal(first, second)


def test_int8_kernel_holds_the_extremes(dev):
    from cxxnet_tpu_torch.ops.kernels import int8_matmul
    a = torch.full((3, 4096), -127, dtype=torch.int8, device=dev)
    b = torch.full((4096, 70), 127, dtype=torch.int8, device=dev)
    assert (int8_matmul(a, b) == -4096 * 127 * 127).all()


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from cxxnet_tpu_torch.ops.kernels import int8_matmul
    a, b = _int8((4, 8), dev, 43), _int8((8, 6), dev, 44)
    with pytest.raises(ValueError):
        int8_matmul(a.float(), b)
    with pytest.raises(ValueError):
        int8_matmul(a, _int8((6, 8), dev, 45).t())       # not contiguous
    with pytest.raises(ValueError):
        int8_matmul(a, _int8((7, 6), dev, 46))           # k mismatch


BF16_REL = 1e-2   # bf16 rounding of scores, weights and output (chip_smoke)


def _bf16_close(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert (got - ref).abs().max().item() <= BF16_REL * ref.abs().max().item()


@pytest.mark.parametrize(
    'S,pp,ps,H,hd,pos,w,idle',
    [(4, 3, 5, 3, 64, [0, 4, 5, 14], [0, 2, 5, 7], ()),
     (2, 16, 16, 16, 64, [255, 200], [7, 0], ()),
     (5, 2, 8, 2, 32, [0, 9, 15, 3, 8], [0, 1, 0, 3, 8], (0, 3))],
    ids=['ragged', 'last_pos', 'idle_slots'])
def test_paged_decode_bf16_kernel_matches_plain(dev, S, pp, ps, H, hd, pos,
                                                w, idle):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_decode,
                                                paged_flash_decode_plain)
    q, kp, vp, *rest = _paged_case(dev, S, pp, ps, H, hd, pos, w, 51,
                                   idle=idle)
    args = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), *rest)
    before = launch_counts()
    out = paged_flash_decode(*args, hd ** -0.5)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after['paged_flash_decode_bf16'] == \
        before['paged_flash_decode_bf16'] + 1
    assert after['paged_flash_decode'] == before['paged_flash_decode']
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    _bf16_close(out, paged_flash_decode_plain(*args, hd ** -0.5))


def test_paged_verify_bf16_kernel_matches_plain(dev):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_verify,
                                                paged_flash_verify_plain)
    q, kp, vp, *rest = _paged_case(dev, 3, 4, 8, 4, 64, [6, 13, 28],
                                   [0, 3, 2], 53, K=4)
    args = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), *rest)
    out = paged_flash_verify(*args, 0.125)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _bf16_close(out, paged_flash_verify_plain(*args, 0.125))


def test_bf16_verify_query_k_is_bitwise_the_decode_step(dev):
    from cxxnet_tpu_torch.ops.attention import (paged_flash_decode,
                                                paged_flash_verify)
    q, kp, vp, table, pos, w = _paged_case(dev, 3, 4, 8, 4, 64,
                                           [5, 14, 20], [0, 2, 1], 55, K=4)
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    win = paged_flash_verify(q, kp, vp, table, pos, w, 0.125)
    for k in range(4):
        step = paged_flash_decode(q[:, k].contiguous(), kp, vp, table,
                                  (pos + k).int(), w, 0.125)
        assert torch.equal(step, win[:, k]), k


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('hd,pp,ps,pos,w', [
    (64, 128, 16, [2047, 1300, 256], [5, 0, 3]),     # T = 2048
    (32, 20, 16, [319, 257, 40], [0, 7, 2]),         # LPR 4 (f32) / 2
    (128, 24, 12, [287, 270, 11], [2, 0, 11]),       # LPR 16 / 8
    (20, 6, 5, [29, 17, 3], [0, 2, 1])],             # f32 5 chunks over 4
    ids=['T2048', 'hd32', 'hd128', 'hd20'])          # lanes, bf16 1-element
def test_paged_decode_long_rows_and_head_widths(dev, dtype, hd, pp, ps, pos,
                                                w):
    """Live lengths past 256 and head widths 32, 128 and 20 (a ragged
    chunk count in f32, 2-byte loads in bf16) against the plain version,
    f32 within the card rule and bf16 within BF16_REL, and a second
    launch bitwise the first."""
    from cxxnet_tpu_torch.ops.attention import (paged_flash_decode,
                                                paged_flash_decode_plain)
    q, kp, vp, *rest = _paged_case(dev, 3, pp, ps, 2, hd, pos, w, 59)
    if dtype == 'bf16':
        q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    args = (q, kp, vp, *rest, hd ** -0.5)
    first, second = paged_flash_decode(*args), paged_flash_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ref = paged_flash_decode_plain(*args)
    (_bf16_close if dtype == 'bf16' else _close)(first, ref)


def test_paged_wrappers_reject_mixed_dtypes(dev):
    from cxxnet_tpu_torch.ops.attention import paged_flash_decode
    q, kp, vp, table, pos, w = _paged_case(dev, 2, 2, 4, 2, 64, [3, 5],
                                           [0, 0], 57)
    with pytest.raises(ValueError):
        paged_flash_decode(q.bfloat16(), kp, vp, table, pos, w, 0.125)
    with pytest.raises(ValueError):
        paged_flash_decode(q.half(), kp.half(), vp.half(), table, pos, w,
                           0.125)


@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
def test_quantized_decode_engine_on_card_streams_equal_generate(dev, dtype):
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, num_heads=2,
                              d_ff=96, num_stages=2, attn='local')
    params = T.init_params(np.random.RandomState(0), cfg)
    eng = DecodeEngine(params, cfg, slots=4, pages=64, page_size=8,
                       max_prompt=16, max_new_bound=24, device='cuda',
                       dtype=dtype)
    try:
        assert eng.use_flash and eng.cfg.dtype == torch.bfloat16
        reset_launch_counts()
        g = np.random.RandomState(1)
        jobs = []
        for i in range(6):
            p = g.randint(0, 64, (1, int(g.randint(1, 14)))).astype(np.int32)
            temp, seed = (0.9, 50 + i) if i % 3 == 2 else (0.0, None)
            jobs.append((p, temp, seed, eng.submit_direct(
                p, max_new=20, temperature=temp, rng=seed)))
        for *_, req in jobs:
            assert req.event.wait(120) and req.error is None, req.error
        counts = launch_counts()
        steps = int(eng.stats.get('decode_steps'))
        assert counts['paged_flash_decode_bf16'] == 2 * steps > 0
        assert counts['paged_flash_decode'] == 0
        # 2 stages x 6 projections + the head, per step and per prefill
        want_int8 = 13 * (steps + len(jobs)) if dtype == 'int8' else 0
        assert counts['int8_matmul'] == want_int8
        for p, temp, seed, req in jobs:
            want = T.generate(eng.params, p, 20, eng.cfg, temperature=temp,
                              rng=seed)[0]
            np.testing.assert_array_equal(req.result, want)
    finally:
        eng.close(60)


# --- flash attention (ops/flash.py, csrc/flash_*.cu) -------------------------

# (bh, sq, sk, d, causal): ragged lengths on both sides of the 64-row
# tile, one-row slices, d = 64, 32 and a d = 100 that pads to 128, and a
# causal cross shape (top-left mask at the kernel level)
FLASH_CASES = [(3, 1, 1, 64, True), (2, 63, 63, 64, True),
               (2, 65, 65, 64, True), (2, 200, 200, 64, True),
               (2, 200, 200, 32, True), (3, 65, 200, 64, False),
               (2, 200, 63, 32, False), (1, 1, 65, 64, False),
               (2, 130, 130, 100, True), (2, 65, 200, 64, True),
               # the bf16 forward's 16-row fragment edges at the head
               # widths its tiles pad (16 -> 32, 48 -> 64, 80 and 100 ->
               # 128; 100 takes the 4-byte copy path), causal and cross
               (2, 15, 15, 16, True), (2, 17, 17, 48, True),
               (2, 127, 127, 80, True), (2, 129, 129, 128, True),
               (2, 129, 127, 100, True), (2, 15, 129, 100, False),
               (2, 129, 17, 128, False), (2, 127, 15, 48, False),
               (1, 17, 127, 16, False), (2, 129, 15, 80, False),
               # an odd head width: rows of 66 bytes take plain loads
               (2, 65, 130, 33, True),
               # many key and query tiles on both sides: the backward
               # kernels' cp.async rings wrap around several times, also
               # at the widest head (the f32 builds' two-buffer rings)
               (2, 1000, 1000, 64, True), (2, 1000, 1000, 128, True)]
FLASH_IDS = ['s1', 's63', 's65', 's200', 's200_d32', 'cross_65x200',
             'cross_200x63_d32', 'one_query', 'd100', 'causal_65x200',
             's15_d16', 's17_d48', 's127_d80', 's129_d128',
             'causal_129x127_d100', 'cross_15x129_d100',
             'cross_129x17_d128', 'cross_127x15_d48', 'cross_17x127_d16',
             'cross_129x15_d80', 'causal_65x130_d33', 's1000',
             's1000_d128']
# the bf16 builds and the plain versions both sum in f32 from the same
# bf16 inputs and round each output once to bf16, so they agree element by
# element to one bf16 step (at most 2^-7 of the value); 1e-3 of the mean
# magnitude, and FLASH_ATOL, cover elements that cancel to near zero,
# where the two f32 sum orders show
BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3
# the f32 builds: RTOL of the largest value plus an absolute 1e-5 for
# these unit-normal inputs.  With one live key (s1) dq and dk are exactly
# 0 and both sides return the rounding of dp - delta, two 64-term dots of
# magnitude ~8 (~1e-6)
FLASH_ATOL = 1e-5


def _flash_inputs(dev, bh, sq, sk, d, dtype, seed):
    g = np.random.RandomState(seed)

    def mk(s):
        return torch.from_numpy(g.randn(bh, s, d).astype(np.float32)).to(
            dev, dtype)
    return mk(sq), mk(sk), mk(sk), mk(sq)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('bh,sq,sk,d,causal', FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain(dev, dtype, bh, sq, sk, d, causal):
    from cxxnet_tpu_torch.ops.flash import (flash_dkv, flash_dkv_plain,
                                            flash_dq, flash_dq_plain,
                                            flash_fwd, flash_fwd_plain)
    dt, sfx = ((torch.float32, '') if dtype == 'f32'
               else (torch.bfloat16, '_bf16'))
    q, k, v, do = _flash_inputs(dev, bh, sq, sk, d, dt, 71)
    before = launch_counts()
    out, lse = flash_fwd(q, k, v, causal)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = flash_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = flash_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ('flash_fwd', 'flash_dq', 'flash_dkv'):
        assert after[name + sfx] == before[name + sfx] + 1
    refs = ((out, ref_out),
            (dq, flash_dq_plain(q, k, v, do, ref_lse, delta, causal)),
            *zip((dk, dv), flash_dkv_plain(q, k, v, do, ref_lse, delta,
                                           causal)))
    _close(lse, ref_lse)
    for got, ref in refs:
        assert got.dtype == dt and torch.isfinite(got.float()).all()
        if dtype == 'f32':
            err = (got - ref).abs().max().item()
            assert err <= RTOL * ref.abs().max().item() + FLASH_ATOL, err
        else:
            g, r = got.float(), ref.float()
            lim = (BF16_STEP * r.abs() + BF16_FLOOR * r.abs().mean()
                   + FLASH_ATOL)
            excess = ((g - r).abs() / lim).max().item()
            assert excess <= 1.0, excess


@pytest.mark.parametrize('kernel', ['flash_fwd_bf16', 'fullc_gemm',
                                    'flash_dq_bf16', 'flash_dkv_bf16',
                                    'conv_bias_act', 'fullc_gemm_nt',
                                    'flash_dq', 'flash_dkv',
                                    'fullc_gemm_tn', 'flash_fwd',
                                    'lrn_forward', 'lrn_backward'])
def test_redesigned_kernels_are_bitwise_repeatable(dev, kernel):
    """Two launches on the same inputs give bitwise-equal outputs: no
    float atomics, and the GEMMs' split-K ranges are summed in a fixed
    order (fc8's forward and fc7's input gradient split; the weight
    gradient does not split)."""
    from cxxnet_tpu_torch.ops.flash import flash_dkv, flash_dq, flash_fwd
    if kernel == 'fullc_gemm':
        a, b = _rand((256, 4096), dev, 40), _rand((4096, 1000), dev, 41)
        runs = [(fullc_gemm(a, b),) for _ in range(2)]
    elif kernel == 'fullc_gemm_nt':
        g, b = _rand((256, 4096), dev, 43), _rand((4096, 4096), dev, 44)
        runs = [(fullc_gemm_nt(g, b),) for _ in range(2)]
    elif kernel == 'fullc_gemm_tn':
        # fc8's weight gradient
        a, g = _rand((256, 4096), dev, 48), _rand((256, 1000), dev, 49)
        runs = [(fullc_gemm_tn(a, g),) for _ in range(2)]
    elif kernel == 'lrn_forward':
        # norm2 at batch 16, the training form (y and norm)
        from cxxnet_tpu_torch.ops.kernels import _lrn_call
        x = _rand((16, 13, 13, 256), dev, 59) * 4.0
        runs = [_lrn_call(x, 5, 0.001, 0.75, 1.0, True) for _ in range(2)]
    elif kernel == 'lrn_backward':
        # norm1 at batch 16
        x = _rand((16, 27, 27, 96), dev, 60) * 4.0
        g = _rand((16, 27, 27, 96), dev, 61)
        norm = lrn_forward_plain(x, 5, 0.001, 0.75, 1.0)[1]
        runs = [(lrn_backward(x, g, norm, 5, 0.001, 0.75),)
                for _ in range(2)]
    elif kernel == 'conv_bias_act':
        # conv2 at batch 8
        x, w = _rand((8, 27, 27, 96), dev, 45), _rand((5, 5, 48, 256), dev, 46)
        b = _rand((256,), dev, 47)
        runs = [(conv_bias_act(x, w, b, (1, 1), ((2, 2), (2, 2)), 2,
                               'relu'),) for _ in range(2)]
    else:
        dt = torch.bfloat16 if kernel.endswith('_bf16') else torch.float32
        q, k, v, do = _flash_inputs(dev, 8, 1000, 1000, 64, dt, 42)
        if kernel.startswith('flash_fwd'):
            runs = [flash_fwd(q, k, v, True) for _ in range(2)]
        else:
            out, lse = flash_fwd(q, k, v, True)
            delta = (do.float() * out.float()).sum(-1)
            fn = flash_dq if kernel.startswith('flash_dq') else flash_dkv
            runs = [fn(q, k, v, do, lse, delta, True) for _ in range(2)]
            if fn is flash_dq:
                runs = [(r,) for r in runs]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_autograd_on_card_matches_dense(dev, causal):
    """flash_attention's autograd function launches one forward, one dq
    and one dk/dv kernel, and matches the dense reference's autograd to
    1e-4 of the largest value: two algorithms (online against dense
    softmax) whose f32 sums differ in order, and the gradients' ds = p (dp
    - delta) cancels."""
    from cxxnet_tpu_torch.ops.flash import flash_attention
    from cxxnet_tpu_torch.parallel.sequence import attention_reference
    g = np.random.RandomState(72)
    base = [g.randn(2, 150, 3, 64).astype(np.float32) for _ in range(3)]
    w = torch.from_numpy(np.cos(np.arange(2 * 150 * 3 * 64)).reshape(
        2, 150, 3, 64).astype(np.float32)).to(dev)
    grads = []
    for fn in (flash_attention, attention_reference):
        ts = [torch.from_numpy(x).to(dev).requires_grad_() for x in base]
        before = launch_counts()
        out = fn(*ts, causal=causal)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        after = launch_counts()
        launched = {n: after[n] - before[n]
                    for n in ('flash_fwd', 'flash_dq', 'flash_dkv')}
        want = 1 if fn is flash_attention else 0
        assert launched == dict.fromkeys(launched, want)
        grads.append([out.detach()] + [t.grad for t in ts])
    for got, ref in zip(*grads):
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), err


def test_flash_wrappers_reject_what_the_kernels_do_not_take(dev):
    from cxxnet_tpu_torch.ops.flash import flash_dq, flash_fwd
    q, k, v, do = _flash_inputs(dev, 2, 16, 16, 64, torch.float32, 73)
    lse = torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError, match='not contiguous'):
        flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        flash_fwd(q, k.bfloat16(), v)                  # mixed dtypes
    with pytest.raises(ValueError):
        flash_fwd(q.half(), k.half(), v.half())        # no fp16 build
    with pytest.raises(ValueError):
        flash_fwd(*(torch.zeros(1, 4, 160, device=dev),) * 3)   # d > 128
    with pytest.raises(ValueError):
        flash_dq(q, k, v, do, lse.double(), lse, True)  # lse not f32
    with pytest.raises(ValueError):
        flash_dq(q, k, v, do[:, :8], lse, lse, True)    # do's shape
    with pytest.raises(ValueError):
        flash_fwd(q, k.cpu(), v)                        # another device


# --- the TransformerLM training step -------------------------------------------

def test_lm_mesh_step_matches_multi_step_on_the_card(dev, tmp_path):
    """chip_smoke's small mesh-vs-multi case on the card: a 1-rank NCCL
    world and its (1, 1, 1, 1) mesh, one ``make_train_step`` step against
    one ``make_multi_train_step`` step from the same params (loss rtol
    1e-5; params rtol 2e-5 atol 2e-6), ``remat`` against none (rtol
    1e-6), and no kernel of ``ops/`` launched."""
    import dataclasses

    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.parallel import init_distributed
    cfg = T.TransformerConfig(vocab_size=32, d_model=16, num_heads=2,
                              d_ff=32, num_stages=1, seq_len=8,
                              num_microbatches=2)
    rng = np.random.RandomState(7)
    tok = rng.randint(0, 32, (4, 8))
    lab = rng.randint(0, 32, (4, 8))

    def fresh():
        return T.init_params(np.random.RandomState(0), cfg, device=dev)
    init_distributed(f'file://{tmp_path}/rdv', 1, 0)
    try:
        assert torch.distributed.get_backend() == 'nccl'
        mesh = T.build_transformer_mesh(1, 1, 1, 1, 1)
        reset_launch_counts()
        a, loss_a, _ = T.make_train_step(cfg, mesh, lr=0.05)(fresh(), tok,
                                                             lab)
        r, loss_r, _ = T.make_train_step(dataclasses.replace(
            cfg, remat=True), mesh, lr=0.05)(fresh(), tok, lab)
        b, loss_b = T.make_multi_train_step(cfg, 1, lr=0.05)(
            fresh(), tok[None], lab[None])
        assert not any(launch_counts().values())
    finally:
        torch.distributed.destroy_process_group()
    assert loss_a.item() == pytest.approx(loss_b.item(), rel=1e-5)
    assert loss_r.item() == pytest.approx(loss_a.item(), rel=1e-6)
    for x, y, z in zip(T._leaves(a), T._leaves(b), T._leaves(r)):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-6)
        torch.testing.assert_close(z, x, rtol=1e-6, atol=0)


# --- the bf16 and f16 builds of rows 1-7 (compute_type=bfloat16 / float16) ---
#
# Each build and its plain version sum the same 16-bit operands (widened,
# so every product is exact) in f32, in different orders, and round each
# output once to the 16-bit type: they agree element by element to one
# step of it, at most 2^-7 (bf16) or 2^-10 (f16) of the value, with
# BF16_FLOOR of the mean magnitude for elements that cancel to near zero
# (chip_smoke.py's ``step16_excess``).  The f32 outputs (the conv's z, the
# LRN's norm) keep the f32 rule.  Each bf16 test has an f16 twin
# (``tests/torch_twins.py``), the same test at ``dtype=torch.float16``.

BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3
STEP16 = {torch.bfloat16: BF16_STEP, torch.float16: 2.0 ** -10}
SUFFIX16 = {torch.bfloat16: '_bf16', torch.float16: '_f16'}


def _step16_close(got, ref, dtype=torch.bfloat16):
    assert got.dtype == dtype, got.dtype
    got, ref = got.float().cpu(), ref.float().cpu()
    lim = STEP16[dtype] * ref.abs() + BF16_FLOOR * ref.abs().mean()
    excess = ((got - ref).abs() / lim).max().item()
    assert excess <= 1.0, excess


def _rand16(shape, dev, seed, offset=0, scale=1.0, dtype=torch.bfloat16):
    """A 16-bit tensor of ``shape`` (normal, times ``scale``) whose base
    lies ``offset`` elements (2 bytes each) past the allocation's start."""
    n = int(np.prod(shape))
    return (_rand((n + offset,), dev, seed) * scale).to(dtype)[
        offset:].view(shape)


@f16_twin(dtype=torch.float16)
@pytest.mark.parametrize(
    'n,hw,cin,cout,k,stride,pad,groups,act,bias,offset',
    [(2, 9, 4, 8, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 0),
     (2, 9, 16, 8, 3, 1, ((1, 1), (1, 1)), 1, 'identity', False, 0),
     (3, 23, 3, 70, 11, 4, ((0, 0), (0, 0)), 1, 'relu', True, 0),
     (2, 10, 6, 10, 5, 2, ((1, 2), (0, 3)), 2, 'relu', True, 0),
     (1, 7, 32, 36, 3, 1, ((1, 1), (1, 1)), 4, 'identity', True, 0),
     (2, 8, 130, 65, 1, 1, ((0, 0), (0, 0)), 1, 'relu', False, 0),
     (2, 27, 96, 256, 5, 1, ((2, 2), (2, 2)), 2, 'relu', True, 0),
     (2, 13, 384, 384, 3, 1, ((1, 1), (1, 1)), 2, 'relu', True, 0),
     (2, 227, 3, 96, 11, 4, ((0, 0), (0, 0)), 1, 'relu', True, 0),
     (2, 13, 256, 384, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 1),
     (2, 14, 24, 64, 5, 1, ((2, 2), (2, 2)), 1, 'relu', True, 0),
     (2, 9, 8, 16, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 0),
     (2, 11, 32, 48, 3, 2, ((1, 0), (0, 1)), 2, 'identity', True, 0),
     (2, 7, 6, 208, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 0),
     (1, 6, 130, 96, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 0),
     (2, 6, 16, 65, 3, 1, ((1, 1), (1, 1)), 1, 'relu', True, 0),
     (128, 4, 512, 128, 1, 1, ((0, 0), (0, 0)), 1, 'relu', True, 0)],
    ids=['base', 'bare_chunk8', 'conv1like', 'asym_pad_g2', 'group4_chunk8',
         'ragged1x1', 'conv2', 'conv4', 'conv1', 'conv3_unaligned_x',
         'inception_5x5', 'cin_g8_cout_g16', 'cin_g16_cout_g24',
         'cin_g6_cout_g208', 'cin_g130_cout_g96', 'chunk_cout_g65',
         'googlenet_aux_4x4'])
def test_conv_bf16_kernel_matches_plain(dev, n, hw, cin, cout, k, stride,
                                        pad, groups, act, bias, offset,
                                        dtype=torch.bfloat16):
    """The 16-bit build on the tensor cores, every staging path: the patch
    in 8-channel chunks (cin/g 8, 16, 24, 32, ...: x 16-byte aligned) or
    one column a thread (cin/g 3, 4, 6, 130; conv3's x 2 bytes off), K
    tails that are not a multiple of the 32-deep slice (27, 54, 75, 363,
    1170, ...); the weight in 8-column chunks or scalars (cout 70, 65,
    10); tiles 32 to 128 channels wide (cout/g 16, 24, 64, 96, 128, 208),
    ragged channels masked (65, 70, 36 / 4); GoogLeNet's 4 x 4 aux conv
    (M 2048, 16 pixel tiles); y 16-bit within one step, z f32, a repeat
    bitwise, one launch."""
    from cxxnet_tpu_torch.ops.cnn import _conv_call
    x = _rand16((n, hw, hw, cin), dev, 1, offset, dtype=dtype)
    w = (_rand((k, k, cin // groups, cout), dev, 2)
         * (k * k * cin // groups) ** -0.5).to(dtype)
    b = _rand((cout,), dev, 3).to(dtype) if bias else None
    name = 'conv_bias_act' + SUFFIX16[dtype]
    before = launch_counts()
    y, z = _conv_call(x, w, b, (stride, stride), pad, groups, act, True)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after[name] == before[name] + 1
    assert after['conv_bias_act'] == before['conv_bias_act']
    ref_y, ref_z = conv_bias_act_plain(x, w, b, (stride, stride), pad,
                                       groups, act)
    assert y.shape == ref_y.shape and z.dtype == torch.float32
    _step16_close(y, ref_y, dtype)
    _close(z, ref_z)
    y2 = conv_bias_act(x, w, b, (stride, stride), pad, groups, act)
    assert torch.equal(y2, y)


@f16_twin(dtype=torch.float16)
def test_conv_bf16_backward_on_card_matches_cpu(dev, dtype=torch.bfloat16):
    """The block's backward in 16 bits (conv2's 5x5 stride-1 geometry,
    where col2im adds 25 taps into an element): dx and dw on the card
    within one step of the CPU's, both summed in f32 and rounded once."""
    x = _rand16((2, 27, 27, 96), dev, 62, dtype=dtype)
    w = (_rand((5, 5, 48, 64), dev, 63) * 0.03).to(dtype)
    b = _rand((64,), dev, 64).to(dtype)
    pad = ((2, 2), (2, 2))
    z = conv_bias_act_plain(x, w, b, (1, 1), pad, 2, 'relu')[1]
    gy = _rand16(tuple(z.shape), dev, 65, dtype=dtype)
    got = conv_bias_act_backward(x, w, z, gy, (1, 1), pad, 2, 'relu')
    want = conv_bias_act_backward(x.cpu(), w.cpu(), z.cpu(), gy.cpu(),
                                  (1, 1), pad, 2, 'relu')
    for g, r in zip(got, want):
        _step16_close(g, r, dtype)


@f16_twin(dtype=torch.float16)
@pytest.mark.parametrize('c,nsize,offset', [
    (96, 5, 0), (256, 5, 0), (64, 5, 0), (192, 5, 0), (13, 4, 0),
    (130, 3, 0), (7, 1, 0), (33, 6, 0), (96, 5, 1), (256, 4, 4)],
    ids=['c96', 'c256', 'c64', 'c192', 'c13_n4', 'c130_n3', 'c7_n1',
         'c33_n6', 'c96_unaligned', 'c256_n4_unaligned'])
def test_lrn_bf16_kernels_match_plain(dev, c, nsize, offset,
                                     dtype=torch.bfloat16):
    """Both forward forms and the backward of the 16-bit builds: 8-channel
    items with the unrolled window where c % 8 == 0 and the bases are
    16-byte aligned, the masked path otherwise (c 13 / 130 / 7 / 33, and
    tensors 2 or 8 bytes off); y and dx within one step, norm f32."""
    from cxxnet_tpu_torch.ops.kernels import _lrn_call
    shape = (3, 7, 11, c)
    x = _rand16(shape, dev, 66, offset, scale=3.0, dtype=dtype)
    g = _rand16(shape, dev, 67, offset, dtype=dtype)
    sfx = SUFFIX16[dtype]
    before = launch_counts()
    y = lrn_forward(x, nsize, 0.001, 0.75, 1.0)
    y_t, norm_t = _lrn_call(x, nsize, 0.001, 0.75, 1.0, True)
    ref_y, ref_norm = lrn_forward_plain(x, nsize, 0.001, 0.75, 1.0)
    dx = lrn_backward(x, g, ref_norm, nsize, 0.001, 0.75)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after['lrn_forward' + sfx] == before['lrn_forward' + sfx] + 2
    assert after['lrn_backward' + sfx] == before['lrn_backward' + sfx] + 1
    assert after['lrn_forward'] == before['lrn_forward']
    assert norm_t.dtype == torch.float32
    _step16_close(y, ref_y, dtype)
    _step16_close(y_t, ref_y, dtype)
    _close(norm_t, ref_norm)
    _step16_close(dx, lrn_backward_plain(x, g, ref_norm, nsize, 0.001,
                                         0.75), dtype)
    assert torch.equal(lrn_backward(x, g, ref_norm, nsize, 0.001, 0.75), dx)


@f16_twin(dtype=torch.float16)
@pytest.mark.parametrize('shape', [(256, 27, 27, 96), (256, 13, 13, 256),
                                   (128, 56, 56, 192)],
                         ids=['norm1', 'norm2', 'googlenet_norm2'])
def test_lrn_bf16_kernels_at_the_nets_shapes(dev, shape,
                                             dtype=torch.bfloat16):
    from cxxnet_tpu_torch.ops.kernels import _lrn_call
    x = (_rand(shape, dev, 68) * 4.0).to(dtype)
    g = _rand16(shape, dev, 69, dtype=dtype)
    y_t, norm_t = _lrn_call(x, 5, 0.001, 0.75, 1.0, True)
    ref_y, ref_norm = lrn_forward_plain(x, 5, 0.001, 0.75, 1.0)
    _step16_close(y_t, ref_y, dtype)
    _close(norm_t, ref_norm)
    _step16_close(lrn_backward(x, g, norm_t, 5, 0.001, 0.75),
                  lrn_backward_plain(x, g, norm_t, 5, 0.001, 0.75), dtype)


@f16_twin(dtype=torch.float16)
@pytest.mark.parametrize('m,k,n,offset', [
    (256, 4096, 1000, 0), (70, 333, 129, 0), (1, 17, 5, 0),
    (256, 9216, 4096, 0), (128, 1024, 1000, 0), (128, 2048, 1024, 0),
    (256, 1024, 1000, 0), (96, 512, 64, 1), (1, 4096, 1000, 0),
    (1, 333, 129, 0), (64, 8192, 256, 0), (130, 1000, 72, 0)],
    ids=['fc8', 'ragged', 'tiny', 'fc6', 'gn_fc', 'gn_aux_fc',
         'ibn_fc', 'unaligned', 'm1', 'm1_ragged_n', 'split_k',
         'k_tail_two_m_tiles'])
def test_gemm_bf16_kernel_matches_plain(dev, m, k, n, offset,
                                       dtype=torch.bfloat16):
    """The 16-bit forward GEMM on the tensor cores: 16-byte copies where
    k, n % 8 == 0 and the bases are aligned, 2-byte loads and stores
    otherwise (ragged, tiny, m1_ragged_n, a 2-byte offset); K tails that
    are not a multiple of the 32-deep slice (333, 17, 1000); m = 1 and
    ragged n; split-K over f32 partial tiles (fc8, the Inception nets'
    shapes, and split_k's 4 output tiles over a k of 8192, which must
    take more than one range); one step of the plain version, a repeat
    bitwise, one launch."""
    from cxxnet_tpu_torch.ops import build
    name = 'fullc_gemm' + SUFFIX16[dtype]
    a = _rand16((m, k), dev, 70, offset, dtype=dtype)
    b = (_rand((k, n), dev, 71) * k ** -0.5).to(dtype)
    if (m, k, n) == (64, 8192, 256):
        assert build.entry(name + '_splits')(m, n, k) > 1
    before = launch_counts()
    c = fullc_gemm(a, b)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after[name] == before[name] + 1
    assert after['fullc_gemm'] == before['fullc_gemm']
    _step16_close(c, fullc_gemm_plain(a, b), dtype)
    assert torch.equal(fullc_gemm(a, b), c)


def test_backward_gemms_refuse_bf16_on_the_card(dev):
    """Rows 6-7 refuse what their builds do not take, never running a
    plain version on the card: a float64 operand (no build), and a bf16
    operand beside an f32 one; f16 operands (a build since queue A item
    3) launch the f16 builds."""
    g = _rand16((8, 16), dev, 72)
    with pytest.raises(ValueError, match='no kernel build'):
        fullc_gemm_nt(g.double(), _rand16((24, 16), dev, 73).double())
    with pytest.raises(ValueError, match='no kernel build'):
        fullc_gemm_tn(_rand16((8, 24), dev, 74).double(), g.double())
    before = launch_counts()
    fullc_gemm_nt(g.half(), _rand16((24, 16), dev, 73).half())
    fullc_gemm_tn(_rand16((8, 24), dev, 74).half(), g.half())
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[n] - before[n] for n in ('fullc_gemm_nt_f16',
                                           'fullc_gemm_tn_f16')] == [1, 1]
    with pytest.raises(ValueError):
        fullc_gemm_nt(g, _rand((24, 16), dev, 73))
    with pytest.raises(ValueError):
        fullc_gemm_tn(_rand16((8, 24), dev, 74), _rand((8, 16), dev, 72))
    with pytest.raises(ValueError):
        fullc_gemm(_rand16((8, 24), dev, 75), _rand((24, 16), dev, 76))


@f16_twin(dtype=torch.float16)
@pytest.mark.parametrize('m,n,k,offset,nt_splits', [
    (256, 4096, 9216, 0, 1), (256, 4096, 4096, 0, 2),
    (256, 1000, 4096, 0, 2), (128, 1000, 1024, 0, None),
    (128, 1024, 2048, 0, None), (256, 1000, 1024, 0, None),
    (70, 333, 129, 0, None), (1, 17, 5, 0, None), (37, 16, 65, 0, None),
    (96, 64, 512, 1, None), (64, 4096, 1024, 0, 'many'),
    (256, 64, 9216, 0, 1), (40, 2048, 2304, 0, None),
    (100, 512, 768, 0, None)],
    ids=['fc6', 'fc7', 'fc8', 'gn_fc', 'gn_aux_fc', 'ibn_fc', 'ragged',
         'tiny', 'ragged_k', 'unaligned', 'nt_split', 'nt_one_range',
         'tn_walk_tail', 'm100'])
def test_gemm_backward_bf16_kernels_match_plain(dev, m, n, k, offset,
                                                nt_splits,
                                                dtype=torch.bfloat16):
    """Rows 6 and 7's 16-bit builds on wgmma: 16-byte copies where the
    rows are multiples of 8 elements and the bases aligned, 2-byte ones
    otherwise
    (ragged, tiny, an operand 2 bytes off); the input gradient's
    contraction split over a cluster where its tiles do not fill the card
    (the plan an H100 gives AlexNet: fc6 one range, fc7 and fc8 two;
    ``nt_split`` more than one, ``nt_one_range`` one); the
    weight gradient's persistent walk over a tile count that is not a
    multiple of its grid (``tn_walk_tail``: 144 tiles); batches that are
    not multiples of 64; within one step of the plain version, element by
    element, and bitwise on repeat."""
    from cxxnet_tpu_torch.ops import build
    sfx = SUFFIX16[dtype]
    splits = build.entry(f'fullc_gemm_nt{sfx}_splits')(m, n, k)
    if nt_splits == 'many':
        assert splits > 1
    elif nt_splits is not None:
        assert splits == nt_splits
    g = _rand16((m, n), dev, 77, offset, dtype=dtype)
    b = (_rand((k, n), dev, 78) * n ** -0.5).to(dtype)
    a = _rand16((m, k), dev, 79, offset, dtype=dtype)
    before = launch_counts()
    da = fullc_gemm_nt(g, b)
    db = fullc_gemm_tn(a, g)
    torch.cuda.synchronize()
    after = launch_counts()
    names = ('fullc_gemm_nt' + sfx, 'fullc_gemm_tn' + sfx, 'fullc_gemm_nt',
             'fullc_gemm_tn')
    assert [after[n] - before[n] for n in names] == [1, 1, 0, 0]
    assert da.shape == (m, k) and db.shape == (k, n)
    _step16_close(da, fullc_gemm_nt_plain(g, b), dtype)
    _step16_close(db, fullc_gemm_tn_plain(a, g), dtype)
    assert torch.equal(fullc_gemm_nt(g, b), da)
    assert torch.equal(fullc_gemm_tn(a, g), db)


def test_f16_builds_keep_subnormal_outputs(dev):
    """f16 keeps gradual underflow, with no flush to zero anywhere: small
    multiples of 2^-13 multiply and sum exactly in f32, so each GEMM build
    and its plain version round the same sums once into f16's subnormal
    range (below 2^-14) and agree bitwise, zero signs included; a conv of
    the same values does too, and its f32 z is exact."""
    rng = np.random.RandomState(80)

    def small(*shape):
        return torch.from_numpy(rng.randint(-6, 7, shape).astype(
            np.float32) * 2.0 ** -13).to(dev).half()
    a, b, g = small(40, 24), small(24, 72), small(40, 72)
    outs = [(fullc_gemm(a, b), fullc_gemm_plain(a, b)),
            (fullc_gemm_nt(g, b), fullc_gemm_nt_plain(g, b)),
            (fullc_gemm_tn(a, g), fullc_gemm_tn_plain(a, g))]
    x, w = small(2, 6, 6, 8), small(3, 3, 8, 16)
    from cxxnet_tpu_torch.ops.cnn import _conv_call
    y, z = _conv_call(x, w, None, (1, 1), ((1, 1), (1, 1)), 1, 'identity',
                      True)
    ref_y, ref_z = conv_bias_act_plain(x, w, None, (1, 1), ((1, 1), (1, 1)),
                                       1, 'identity')
    outs.append((y, ref_y))
    assert torch.equal(z, ref_z)
    for got, ref in outs:
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
        sub = (got != 0) & (got.float().abs() < 2.0 ** -14)
        assert sub.sum().item() > 10


def test_gemm_nt_bf16_entry_refuses_a_split_count_not_its_plan(dev):
    """The input gradient's bf16 C entry takes the split count its plan
    gives the shape (``fullc_gemm_nt_bf16_splits``) and refuses any
    other, before it launches."""
    from cxxnet_tpu_torch.ops import build
    m, n, k = 256, 1000, 4096
    splits = build.entry('fullc_gemm_nt_bf16_splits')(m, n, k)
    g = _rand16((m, n), dev, 83)
    b = _rand16((k, n), dev, 84, scale=n ** -0.5)
    c = torch.zeros((m, k), device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = build.entry('fullc_gemm_nt_bf16')

    def run(s):
        return entry(g.data_ptr(), b.data_ptr(), c.data_ptr(), 0, m, n, k,
                     s, stream)
    for wrong in {0, splits + 1, 9}:
        assert run(wrong) != 0
    torch.cuda.synchronize()
    assert not c.any()
    assert run(splits) == 0
    torch.cuda.synchronize()
    _step16_close(c, fullc_gemm_nt_plain(g, b))


def test_gemm_bf16_autograd_widens_the_weight_gradient(dev):
    """A bf16 fullc product under autograd: the NT and TN bf16 builds run,
    and the f32 weight's gradient is the bf16 TN output widened."""
    w = _rand((40, 24), dev, 80).requires_grad_()
    x = _rand16((9, 40), dev, 81).requires_grad_()
    gc = _rand16((9, 24), dev, 82)
    fullc_gemm(x, w.to(torch.bfloat16)).backward(gc)
    assert w.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    assert torch.equal(w.grad, fullc_gemm_tn(x.detach(), gc).float())
    assert torch.equal(x.grad, fullc_gemm_nt(gc, w.detach().to(
        torch.bfloat16)))


@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'f16'])
@pytest.mark.parametrize('n,lo,hi,pkeep', [
    (1, 0.0, 1.0, None), (1000003, 0.0, 1.0, None), (4096 * 256, 0.0, 1.0,
                                                    0.5),
    (4099, -0.0123, 0.0123, None), (77, 0.37, 5.1, None),
    (4099, 0.0, 1.0, 0.7), (3000, -1.0 + 2.0 ** -24, 1.0, None)],
    ids=['one', 'odd_1m', 'fc_mask', 'xavier', 'offset', 'mask_0.7',
         'normal_lo'])
def test_threefry_kernel_bitwise_equals_plain(dev, dtype, n, lo, hi, pkeep):
    """The threefry kernel (JAX's uniforms) against its plain version on
    the same card, bitwise: f32, bf16 and f16 draws, affine ranges, the
    compare form; one launch each, none for the plain version."""
    from cxxnet_tpu_torch.ops import threefry
    from cxxnet_tpu_torch.utils import prng
    dt = {'f32': torch.float32, 'bf16': torch.bfloat16,
          'f16': torch.float16}[dtype]
    key = prng.fold_in(prng.prng_key(20261016), n)
    before = launch_counts()['threefry_uniform']
    if pkeep is None:
        got = threefry.uniform(key, (n,), dt, dev, lo, hi)
        ref = prng.uniform_plain(key, n, dt, lo, hi, device=dev)
    else:
        got = threefry.keep_mask(key, (n,), dt, dev, pkeep)
        ref = prng.uniform_plain(key, n, dt, thresh=pkeep, device=dev)
    torch.cuda.synchronize()
    assert launch_counts()['threefry_uniform'] == before + 1
    assert got.dtype == dt and got.device.type == 'cuda'
    assert torch.equal(got.view(-1), ref)
    assert torch.equal(got.cpu().view(-1),
                       prng.uniform_plain(key, n, dt, lo, hi, pkeep))


def test_threefry_on_card_matches_pinned_jax_draws(dev):
    """A handful of uniforms and normals against the jax.random draws
    that tests/test_torch_prng.py holds to JAX and keeps in
    tests/fixtures/torch_jax_draws.json: the card has no JAX.  Uniforms
    bitwise, normals within NORMAL_TOL (XLA's erf_inv against the
    port's)."""
    import json
    from cxxnet_tpu_torch.ops import threefry
    from cxxnet_tpu_torch.utils import prng
    with open(os.path.join(os.path.dirname(__file__), 'fixtures',
                           'torch_jax_draws.json')) as f:
        pinned = json.load(f)
    for d in pinned['draws']:
        dt = getattr(torch, d['dtype'])
        key = prng.fold_in(prng.prng_key(d['seed']), d['fold'])
        fn = threefry.uniform if d['kind'] == 'uniform' else threefry.normal
        got = fn(key, (len(d['values']),), dt, dev).float().cpu()
        want = torch.tensor(d['values'], dtype=torch.float32)
        if d['kind'] == 'uniform':
            assert torch.equal(got, want), d
        else:
            lim = pinned['normal_tol'] * want.abs().clamp_min(1.0)
            assert ((got - want).abs() <= lim).all(), d


def test_threefry_wrapper_raises_rather_than_falls_back(dev):
    """On the card the draw is the kernel or an error, never torch.rand:
    a dtype without a build raises, and nothing launches."""
    from cxxnet_tpu_torch.ops import threefry
    from cxxnet_tpu_torch.utils import prng
    before = launch_counts()['threefry_uniform']
    with pytest.raises(ValueError, match='no kernel build'):
        threefry.uniform(prng.prng_key(1), (64,), torch.float64, dev)
    assert launch_counts()['threefry_uniform'] == before


SNAPSHOT_MLP = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 4096
  init_sigma = 0.01
layer[+1] = relu
layer[+0] = dropout
  threshold = 0.5
layer[+1:fc2] = fullc:fc2
  nhidden = 4096
  init_sigma = 0.01
layer[+1] = relu
layer[+1:fc3] = fullc:fc3
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,2048
batch_size = 512
eta = 0.1
momentum = 0.9
"""


def test_snapshot_host_copy_is_the_snapshots_step(dev):
    """``snapshot_training_state`` clones on the compute stream and the
    writer's host copy waits on the clones' event on a copy stream of its
    own: the host tree is the state at the snapshot's step even when the
    next in-place steps were enqueued before the copy started."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.runtime import async_ckpt
    from cxxnet_tpu_torch.utils.config import parse_config_string
    tr = NetTrainer(parse_config_string(SNAPSHOT_MLP + 'dev = gpu\n'))
    tr.init_model()
    rng = np.random.RandomState(0)
    batches = [DataBatch(rng.randn(512, 1, 1, 2048).astype(np.float32),
                         rng.randint(0, 10, (512, 1)).astype(np.float32))
               for _ in range(4)]
    tr.update(batches[0])
    snap = tr.snapshot_training_state()
    assert snap.ready is not None
    want = {(k, f): v.detach().cpu() for k, d in tr.params.items()
            for f, v in d.items()}
    mom = tr.opt_state['m']['0']['wmat'].cpu()
    for b in batches[1:]:
        tr.update(b)              # in place, enqueued behind the clones
    host = async_ckpt.host_tree(snap)
    for (k, f), w in want.items():
        np.testing.assert_array_equal(host['params'][k][f], w.numpy())
    np.testing.assert_array_equal(host['opt_state']['m']['0']['wmat'],
                                  mom.numpy())
    assert int(host['counters']['sample']) == 1
    torch.cuda.synchronize()
    assert not torch.equal(tr.params['0']['wmat'].cpu(), want[('0', 'wmat')])


REPLICA_NET = """netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 96
layer[1->1] = relu
layer[1->2] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 1000
layer[4->4] = softmax
netconfig=end
input_shape = 3,35,35
batch_size = 32
dev = gpu
"""


def test_pinned_replicas_order_a_placement_from_another_stream(dev):
    """Two pinned engines on the one card (a CUDA stream each) answer
    bitwise the default-stream engine from two threads at once; a tree
    computed on a third stream behind a long kernel and placed there is
    read by a replica only after the event its placement recorded."""
    import threading
    from cxxnet_tpu_torch.serve import PredictEngine, ReplicatedPredictEngine
    net = Net(dev='cuda', cfg=REPLICA_NET)
    net.init_model()
    tr = net.trainer
    base = PredictEngine(tr, (32,))
    rep = ReplicatedPredictEngine(tr, (32,), replicas=2, devices=[dev, dev])
    try:
        x = np.random.RandomState(0).randn(32, 3, 35, 35).astype(np.float32)
        want = base.predict_scores(x)
        outs = [[], []]

        def run(i):
            for _ in range(20):
                outs[i].append(rep.engines[i].predict_scores(x))

        ths = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(120)
        assert all(np.array_equal(o, want) for o in outs[0] + outs[1])
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side), torch.inference_mode():
            torch.cuda._sleep(200_000_000)        # ~0.1 s on the side stream
            p2 = {k: {f: v * 1.5 for f, v in fs.items()}
                  for k, fs in tr.params.items()}
            placed = rep.engines[0].place_params(p2)
        rep.engines[0].swap_params(placed)
        got = rep.engines[0].predict_scores(x)
        torch.cuda.synchronize()
        base.swap_params(p2)
        np.testing.assert_array_equal(got, base.predict_scores(x))
    finally:
        rep.close(30)
