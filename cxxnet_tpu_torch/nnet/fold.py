"""Inference-time conv+BN folding (``serve.fold_bn``).

PyTorch counterpart of ``cxxnet_tpu/nnet/fold.py``.  At serving time a
BatchNorm behind a convolution is an affine map the conv can absorb:
``w' = w * scale`` (output-channel axis) and ``b' = b * scale + shift``
with ``scale = gamma/sqrt(var+eps)``, ``shift = beta - mean*scale``
(``layers/norm.py`` ``fold_scale_shift``).  One conv replaces a conv and
BN's passes.

The reference's BatchNorm keeps no running averages: evaluation
normalizes with the batch's own statistics.  A static fold therefore
freezes the statistics of one calibration batch: the pass runs the
unfolded net once on it, captures each BN's input, folds its batch
statistics into the conv, and proves the rewrite: the folded forward
(the BN run as a pass-through, ``Net.forward(identity_layers=...)``) must
match the unfolded forward on the calibration batch within the pinned
``FOLD_RTOL`` / ``FOLD_ATOL``, or ``FoldError`` is raised.  On any other
batch the folded net is a fixed-statistics approximation that the
serving layer opts into (``serve.fold_bn=1``).

The params tree keeps its structure: the BN's slope and bias stay in
place (unused), so hot-swap checks see the tree they expect.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..layers.conv import ConvolutionLayer
from ..layers.norm import BatchNormLayer, fold_scale_shift
from ..ops.precision import full_f32

#: pinned fold-vs-unfolded tolerances on the calibration batch (f32
#: serving; JAX's): scaling w before the conv against scaling the conv's
#: output reorders one multiply against the reduction.  Pinned here,
#: once, and asserted by the pass itself and the tests
FOLD_RTOL = 1e-4
FOLD_ATOL = 1e-5


class FoldError(RuntimeError):
    """The folded forward failed its pinned equality proof."""


def plan_conv_bn_pairs(net) -> List[Tuple[int, int]]:
    """The foldable ``(conv, batch_norm)`` layer pairs of ``net``: a
    1-in/1-out conv with a bias (the fold needs one to absorb the shift
    without changing the params tree) whose output (node, version) is
    read by exactly one layer, a 1-in/1-out BatchNorm, neither layer's
    params shared."""
    pairs: List[Tuple[int, int]] = []
    reads, writes = net._node_version_maps()
    readers: Dict[tuple, List[int]] = {}
    for i, rs in enumerate(reads):
        for nv in rs:
            readers.setdefault(nv, []).append(i)
    shared = {p for p in net.layer_primary
              if net.layer_primary.count(p) > 1}
    for i, layer in enumerate(net.layers):
        if not isinstance(layer, ConvolutionLayer):
            continue
        info = net.cfg.layers[i]
        if (layer.param.no_bias != 0 or len(info.nindex_in) != 1
                or len(info.nindex_out) != 1 or i in shared
                or net.layer_primary[i] != i):
            continue
        rd = readers.get(next(iter(writes[i])), [])
        if len(rd) != 1:
            continue
        b = rd[0]
        binfo = net.cfg.layers[b]
        if (isinstance(net.layers[b], BatchNormLayer)
                and len(binfo.nindex_in) == 1
                and len(binfo.nindex_out) == 1
                and b not in shared and net.layer_primary[b] == b):
            pairs.append((i, b))
    return pairs


def _top_node(net) -> int:
    return net.cfg.layers[-1].nindex_out[-1]


def fold_params(net, params, calib_batch, ctx, *, extra_data=None,
                verify: bool = True):
    """Fold every plannable conv+BN pair of ``net`` into new params.

    Runs the unfolded forward once on ``calib_batch`` (NCHW, eval mode,
    ``ctx`` an eval ``ForwardContext`` on the params' device) to capture
    each BN's input, freezes its batch statistics into the preceding
    conv's weights and bias (``extra_data`` feeds a net's extra data
    nodes, JAX ``fold.py:98-147``), and, unless ``verify=False``, proves
    the folded forward equal to the unfolded one on the same batch within
    the pinned tolerances.  Returns ``(folded_params, report)``:
    ``report`` holds the folded pairs' names, the retired BN layers (for
    ``Net.forward(identity_layers=...)``) and the proof's error.  A net
    with no foldable pairs gets its params back unchanged."""
    pairs = plan_conv_bn_pairs(net)
    report = {'pairs': [], 'bn_layers': frozenset(),
              'max_abs_err': 0.0, 'rtol': FOLD_RTOL, 'atol': FOLD_ATOL}
    if not pairs:
        return params, report
    capture = {b: None for (_, b) in pairs}
    with torch.no_grad(), full_f32():
        values, _ = net.forward(params, calib_batch, ctx,
                                extra_data=extra_data, capture=capture)
        folded = {k: dict(v) for k, v in params.items()}
        for conv_i, bn_i in pairs:
            xin = capture[bn_i][0].float()
            dims = tuple(range(xin.dim() - 1))
            # BatchNormLayer.forward's statistics, spelled as it spells them
            mean = xin.mean(dims)
            centered = xin - mean
            var = (centered * centered).mean(dims)
            bp = params[str(bn_i)]
            scale, shift = fold_scale_shift(
                bp['wmat'].float(), bp['bias'].float(), mean, var,
                net.layers[bn_i].eps)
            cp = params[str(conv_i)]
            w, b = cp['wmat'], cp['bias']
            folded[str(conv_i)]['wmat'] = (w.float() * scale).to(w.dtype)
            folded[str(conv_i)]['bias'] = (b.float() * scale
                                           + shift).to(b.dtype)
            report['pairs'].append(
                (net.cfg.layers[conv_i].name or str(conv_i),
                 net.cfg.layers[bn_i].name or str(bn_i)))
        bn_layers = frozenset(b for (_, b) in pairs)
        report['bn_layers'] = bn_layers
        if verify:
            fvalues, _ = net.forward(folded, calib_batch, ctx,
                                     extra_data=extra_data,
                                     identity_layers=bn_layers)
            top = _top_node(net)
            ref, got = values[top].float(), fvalues[top].float()
            err = float((got - ref).abs().max())
            bound = FOLD_ATOL + FOLD_RTOL * float(ref.abs().max())
            report['max_abs_err'] = err
            if not err <= bound:
                raise FoldError(
                    f'conv+BN fold failed its equality proof on the '
                    f'calibration batch: max|d|={err:.3e} > {bound:.3e} '
                    f'(pinned rtol={FOLD_RTOL}, atol={FOLD_ATOL}) for '
                    f'pairs {report["pairs"]}')
    return folded, report
