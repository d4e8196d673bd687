"""Neural-net graph executor over a ``NetConfig``.

PyTorch counterpart of ``cxxnet_tpu/nnet/net.py``: builds the layers of a
netconfig, infers every node's shape, and runs the graph in config
order, replaying the reference's in-place node semantics
(``layer[a->a]`` rewrites).  Activations are NHWC; host batches arrive
NCHW and are transposed once on the device.

The fusion passes group layers exactly as the JAX package does, so the
same layers reach the conv kernel in both:

* ``_build_sibling_fusion`` (``fuse_siblings``, on by default) groups the
  ungrouped 1x1 stride-1 unpadded convs that read one node; each group
  runs as one plain conv (``conv_native``, no kernel, as JAX runs it
  through XLA) over the weights concatenated along the output channels,
  split back per member;
* ``_build_blockdiag_fusion`` (``fuse_blockdiag``, off by default) groups
  convs that read different nodes into one wide plain conv over the
  channel-concatenated inputs, each member's weight zero-embedded
  spatially as a diagonal block, split back; the execution order is
  re-scheduled so members run together, and a node-version replay
  proves the new order reads and writes what config order does;
* ``_build_convact_fusion`` pairs each other conv with its exclusive
  in-place relu, and the paired conv runs through the fused kernel of
  ``ops/cnn.py``; sibling and block-diagonal members never pair.

``Net.forward`` also takes ``identity_layers`` (layers run as a
pass-through: the BN layers ``nnet/fold.py`` folded into their convs)
and ``capture`` (layers whose inputs are kept, for the fold).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..layers import ForwardContext, NodeSpec, create_layer
from ..layers.base import Layer, kSharedLayer
from ..layers.common import ReluLayer, SplitLayer
from ..layers.conv import ConvolutionLayer, conv_native
from ..layers.loss import LossLayerBase
from ..layers.pooling import MaxPoolingLayer
from ..ops.cnn import conv_bias_act, conv_use_fused, saved_preactivation
from ..runtime.faults import NotPortedError
from ..utils import prng
from .net_config import NetConfig

Params = Dict[str, Dict[str, torch.Tensor]]


class LabelInfo:
    """Named label-field views over the raw label matrix
    (``layer/layer.h:77-121`` + slicing at ``nnet_impl-inl.hpp:271-285``);
    the matrix is a tensor on the device (losses) or a host array
    (metrics)."""

    def __init__(self, label_mat, name_map: Dict[str, int],
                 ranges: List[tuple]):
        self._mat = label_mat
        self._name_map = name_map
        self._ranges = ranges

    def field(self, name: str):
        if name not in self._name_map:
            raise KeyError(f'unknown label target = {name}')
        a, b = self._ranges[self._name_map[name]]
        return self._mat[:, a:b]

    def slice(self, n: int) -> 'LabelInfo':
        """The first ``n`` instances (pad rows of a tail batch dropped)."""
        return LabelInfo(self._mat[:n], self._name_map, self._ranges)


class Net:
    """A runnable view of a NetConfig."""

    def __init__(self, cfg: NetConfig):
        self.cfg = cfg
        self.layers: List[Layer] = []
        self.layer_primary: List[int] = []   # index of the params owner
        # shared entries alias the primary layer object
        # (neural_net-inl.hpp:216-250)
        for i, info in enumerate(cfg.layers):
            if info.type == kSharedLayer:
                primary = cfg.layers[info.primary_layer_index]
                layer = self.layers[info.primary_layer_index]
                if not layer.allow_sharing():
                    raise ValueError(
                        f'layer {primary.name} does not allow sharing')
                self.layers.append(layer)
                self.layer_primary.append(info.primary_layer_index)
            else:
                self.layers.append(create_layer(info.type, name=info.name))
                self.layer_primary.append(i)
        # global defaults first, then layer-scoped pairs
        # (neural_net-inl.hpp:252-264)
        for i, layer in enumerate(self.layers):
            if self.layer_primary[i] != i:
                continue
            for name, val in cfg.defcfg:
                layer.set_param(name, val)
            for name, val in cfg.layercfg[i]:
                layer.set_param(name, val)
        for name, val in cfg.defcfg:
            if name == 'tensor_parallel' and int(val) > 1:
                raise NotPortedError(f'tensor_parallel={val}',
                                     'queue A item 9')
        # split layers need their fan-out before shape inference
        for i, info in enumerate(cfg.layers):
            if isinstance(self.layers[i], SplitLayer):
                self.layers[i].set_num_outputs(len(info.nindex_out))
        self._infer_shapes()
        self._build_sibling_fusion()
        self._build_blockdiag_fusion()
        self._build_convact_fusion()

    # --- horizontal fusion ------------------------------------------------
    def _build_sibling_fusion(self) -> None:
        """Group sibling 1x1 convs (``cxxnet_tpu/nnet/net.py:92-150``):
        ungrouped 1x1, stride 1, no padding, one input and one output,
        reading the same node with the same bias-ness.  A group whose
        input node some layer rewrites within the group's span is left
        apart, since a later member would read the rewritten value.
        ``fuse_siblings = 0`` disables the pass."""
        enabled = 1
        for name, val in self.cfg.defcfg:
            if name == 'fuse_siblings':
                enabled = int(val)
        self._sibling_groups: Dict[int, List[int]] = {}
        if not enabled:
            return
        groups: Dict[tuple, List[int]] = {}
        for i, info in enumerate(self.cfg.layers):
            layer = self.layers[i]
            if not isinstance(layer, ConvolutionLayer):
                continue
            p = layer.param
            if (p.kernel_height, p.kernel_width, p.stride, p.pad_y,
                    p.pad_x, p.num_group) != (1, 1, 1, 0, 0, 1):
                continue
            if len(info.nindex_in) != 1 or len(info.nindex_out) != 1:
                continue
            groups.setdefault((info.nindex_in[0], p.no_bias), []).append(i)
        for (node, _), members in groups.items():
            if len(members) < 2:
                continue
            if any(node in self.cfg.layers[w].nindex_out
                   for w in range(members[0], members[-1] + 1)):
                continue
            for m in members:
                self._sibling_groups[m] = members

    def _fused_sibling_outputs(self, params, x, members: List[int]):
        """One 1x1 conv over the concatenated weights (cast to the
        activations' dtype), split back into the member layers' outputs
        (same order)."""
        widths = [self.layers[m].param.num_channel for m in members]
        w = torch.cat([self._layer_params(params, m)['wmat']
                       for m in members], dim=3).to(x.dtype)
        out = conv_native(x, w, (1, 1), ((0, 0), (0, 0)))
        if self.layers[members[0]].param.no_bias == 0:
            out = out + torch.cat([self._layer_params(params, m)['bias']
                                   for m in members]).to(x.dtype)
        return torch.split(out, widths, dim=-1)

    # --- cross-input block-diagonal fusion --------------------------------
    def _build_blockdiag_fusion(self) -> None:
        """Fuse convs that read different inputs into one wide conv with a
        block-diagonal weight (``cxxnet_tpu/nnet/net.py:171-506``).

        ``fuse_blockdiag = in3a_3x3+in3a_5x5;in3b_3x3+in3b_5x5`` names the
        groups (layer names, ``+`` within a group, ``;`` between groups);
        ``auto`` (or ``auto:<maxwidth>``, default 96) takes one group per
        concat layer: the convs producing its inputs with at most
        ``maxwidth`` output channels, outside sibling groups.  Members
        are ungrouped 1-in/1-out convs of equal stride and bias-ness,
        equal input spatial size and one ``2*pad - kernel`` extent per
        axis (so the padded output grids coincide), none reading
        another's output.  An explicit group dissolves a sibling group
        its member belongs to; an explicit spec that fails a check
        raises, an ``auto`` candidate that fails is skipped.  The
        execution order is re-scheduled to make members contiguous and
        validated by node-version replay."""
        spec_str = '0'
        for name, val in self.cfg.defcfg:
            if name == 'fuse_blockdiag':
                spec_str = str(val).strip()
        self._blockdiag_groups: Dict[int, List[int]] = {}
        self._exec_order: List[int] = list(range(len(self.cfg.layers)))
        if spec_str in ('', '0'):
            return
        reads, writes = self._node_version_maps()
        if spec_str == 'auto' or spec_str.startswith('auto:'):
            if ':' in spec_str:
                try:
                    maxw = int(spec_str.split(':', 1)[1])
                except ValueError:
                    raise ValueError(
                        f'fuse_blockdiag: bad auto maxwidth in '
                        f'{spec_str!r} — use auto or auto:<int>') from None
            else:
                maxw = 96
            for members in self._auto_blockdiag_candidates(writes, maxw):
                self._register_blockdiag_group(members, reads, writes,
                                               strict=False)
        else:
            byname: Dict[str, int] = {}
            for i, info in enumerate(self.cfg.layers):
                if info.name and info.name not in byname:
                    byname[info.name] = i
            for gspec in spec_str.split(';'):
                names = [t.strip() for t in gspec.split('+') if t.strip()]
                if len(names) < 2:
                    raise ValueError(
                        f'fuse_blockdiag: group {gspec!r} needs >=2 '
                        f'layer names')
                members = []
                for nm in names:
                    if nm not in byname:
                        raise ValueError(
                            f'fuse_blockdiag: no layer named {nm!r}')
                    members.append(byname[nm])
                self._register_blockdiag_group(sorted(members), reads,
                                               writes, strict=True)
        self._verify_blockdiag_final(reads, writes)
        groups = self._blockdiag_group_set()
        print(f'fuse_blockdiag={spec_str}: {len(groups)} group(s) formed'
              + ('' if groups else ' — NO fusion engaged'),
              file=sys.stderr)

    def _blockdiag_group_set(self):
        """The distinct groups (each member maps to its whole group)."""
        return {tuple(g) for g in self._blockdiag_groups.values()}

    def _register_blockdiag_group(self, members, reads, writes,
                                  strict: bool) -> None:
        """Validate and schedule one group; ``strict`` raises on a failed
        check, else the group is skipped."""
        try:
            self._check_blockdiag_group(members, reads, writes)
            new_order = self._reorder_contiguous(
                self._exec_order, members, reads, writes)
            for m in members:
                if m in self._blockdiag_groups:
                    raise ValueError(
                        f'fuse_blockdiag: layer '
                        f'{self.cfg.layers[m].name!r} appears in two '
                        f'groups')
        except ValueError:
            if strict:
                raise
            return
        self._exec_order = new_order
        for m in members:
            self._blockdiag_groups[m] = members

    def _auto_blockdiag_candidates(self, writes, maxw: int):
        """One candidate group per concat layer: the convs producing its
        input nodes (through in-place activations) with output width
        <= ``maxw``, outside sibling and earlier groups."""
        producer: Dict[int, int] = {}     # node -> conv writing version 1
        for i, layer in enumerate(self.layers):
            if isinstance(layer, ConvolutionLayer):
                for (n, v) in writes[i]:
                    if v == 1:
                        producer[n] = i
        for i, info in enumerate(self.cfg.layers):
            if self.layers[i].type_name not in ('concat', 'ch_concat'):
                continue
            members = []
            for n in info.nindex_in:
                m = producer.get(n)
                if (m is None or m in self._sibling_groups
                        or m in self._blockdiag_groups):
                    continue
                if self.layers[m].param.num_channel <= maxw:
                    members.append(m)
            if len(members) >= 2:
                yield sorted(members)

    def _check_blockdiag_group(self, members, reads, writes) -> None:
        layers = [self.layers[m] for m in members]
        infos = [self.cfg.layers[m] for m in members]
        for m, layer, info in zip(members, layers, infos):
            if not isinstance(layer, ConvolutionLayer):
                raise ValueError(
                    f'fuse_blockdiag: layer {info.name!r} is not a conv')
            if (layer.param.num_group != 1 or len(info.nindex_in) != 1
                    or len(info.nindex_out) != 1):
                raise ValueError(
                    f'fuse_blockdiag: {info.name!r} must be an ungrouped '
                    f'1-in/1-out conv')
            if m in self._sibling_groups:
                # an explicit block-diagonal group wins: dissolve the
                # sibling group
                for other in self._sibling_groups.pop(m):
                    self._sibling_groups.pop(other, None)
        p0 = layers[0].param
        for layer, info in zip(layers[1:], infos[1:]):
            p = layer.param
            if p.stride != p0.stride or p.no_bias != p0.no_bias:
                raise ValueError(
                    f'fuse_blockdiag: {info.name!r} stride/bias mismatch')
            if (2 * p.pad_y - p.kernel_height
                    != 2 * p0.pad_y - p0.kernel_height
                    or 2 * p.pad_x - p.kernel_width
                    != 2 * p0.pad_x - p0.kernel_width):
                raise ValueError(
                    f'fuse_blockdiag: {info.name!r} output grid mismatch '
                    f'(2*pad-kernel must match across the group)')
        s0 = self.node_specs[infos[0].nindex_in[0]]
        for info in infos[1:]:
            sp = self.node_specs[info.nindex_in[0]]
            if (sp.y, sp.x) != (s0.y, s0.x):
                raise ValueError(
                    f'fuse_blockdiag: {info.name!r} input spatial mismatch')
        # members run on the group's shared pre-state: no member may read
        # another member's output
        member_writes = frozenset().union(*(writes[m] for m in members))
        for m, info in zip(members, infos):
            if reads[m] & member_writes:
                raise ValueError(
                    f'fuse_blockdiag: {info.name!r} consumes another '
                    f'member\'s output — chain fusion is not supported')

    def _verify_blockdiag_final(self, reads, writes) -> None:
        """Re-verify every group against the final order (a later
        group's reorder could tear an earlier one apart, and the fused
        conv reads every member's input at the first member's place):
        members contiguous, every input version produced before the
        group starts, and no rewriter of an input node before it."""
        pos = {lay: k for k, lay in enumerate(self._exec_order)}
        for members in self._blockdiag_group_set():
            names = [self.cfg.layers[m].name for m in members]
            ps = sorted(pos[m] for m in members)
            if ps != list(range(ps[0], ps[-1] + 1)):
                raise ValueError(
                    f'fuse_blockdiag: groups {names} were torn apart by a '
                    'later group\'s reorder — no safe combined schedule; '
                    'reorder or split the group specs')
            start = ps[0]
            need = set().union(*(reads[m] for m in members))
            for lay in range(len(self.cfg.layers)):
                for (n, v) in writes[lay]:
                    for (n2, v2) in need:
                        if n != n2:
                            continue
                        if v <= v2 and pos[lay] >= start:
                            raise ValueError(
                                f'fuse_blockdiag: group {names} input is '
                                'not produced before the fused execution '
                                'point in the combined schedule')
                        if v > v2 and pos[lay] < start:
                            raise ValueError(
                                f'fuse_blockdiag: group {names} would read '
                                'a stale in-place-rewritten input in the '
                                'combined schedule')

    def _reorder_contiguous(self, order, members, reads, writes):
        """Move the non-members between the group's members out of the way
        (dependents after, independents before), then check that the new
        order replays config order's node-version reads and writes."""
        pos = {lay: k for k, lay in enumerate(order)}
        lo = min(pos[m] for m in members)
        hi = max(pos[m] for m in members)
        seg = [order[k] for k in range(lo, hi + 1) if order[k] not in members]
        # a segment layer follows the members (and whatever was forced
        # after them) iff it reads a version they write, rewrites a node
        # past a version they still read, or writes a later version of a
        # node they write
        after: List[int] = []
        after_reads = set().union(*(reads[m] for m in members))
        after_writes = set().union(*(writes[m] for m in members))
        before: List[int] = []
        for lay in seg:
            true_dep = bool(set(reads[lay]) & after_writes)
            anti_dep = any(n1 == n2 and v2 < v1
                           for (n1, v1) in writes[lay]
                           for (n2, v2) in after_reads)
            ww_dep = any(n1 == n2 and v2 < v1
                         for (n1, v1) in writes[lay]
                         for (n2, v2) in after_writes)
            if true_dep or anti_dep or ww_dep:
                after.append(lay)
                after_reads |= set(reads[lay])
                after_writes |= set(writes[lay])
            else:
                before.append(lay)
        new_order = (order[:lo] + before + sorted(members, key=pos.get)
                     + after + order[hi + 1:])
        ver: Dict[int, int] = {}
        for lay in new_order:
            info = self.cfg.layers[lay]
            got_r = frozenset((n, ver.get(n, 0)) for n in info.nindex_in)
            got_w = set()
            for n in info.nindex_out:
                ver[n] = ver.get(n, 0) + 1
                got_w.add((n, ver[n]))
            if got_r != reads[lay] or frozenset(got_w) != writes[lay]:
                raise ValueError(
                    'fuse_blockdiag: no safe schedule exists for group '
                    f'{[self.cfg.layers[m].name for m in members]} — layer '
                    f'{info.name or lay!r} would observe different node '
                    'versions after the reorder')
        return new_order

    def _fused_blockdiag_outputs(self, params, values, members: List[int]):
        """One plain conv over the channel-concatenated inputs and the
        block-diagonal weight (each member's weight, cast to the
        activations' dtype, zero-padded spatially to the group's largest
        kernel and along the input channels to its block; the input
        padding grown to match), split back into the members' outputs."""
        infos = [self.cfg.layers[m] for m in members]
        layers = [self.layers[m] for m in members]
        xs = [values[info.nindex_in[0]] for info in infos]
        x = torch.cat(xs, dim=-1)
        kh = max(lay.param.kernel_height for lay in layers)
        kw = max(lay.param.kernel_width for lay in layers)
        p0 = layers[0].param
        ph = p0.pad_y + (kh - p0.kernel_height) // 2
        pw = p0.pad_x + (kw - p0.kernel_width) // 2
        cins = [v.shape[-1] for v in xs]
        couts = [lay.param.num_channel for lay in layers]
        blocks, ci = [], 0
        for lay, m, cin in zip(layers, members, cins):
            p = lay.param
            oh = (kh - p.kernel_height) // 2
            ow = (kw - p.kernel_width) // 2
            wm = self._layer_params(params, m)['wmat'].to(x.dtype)
            blocks.append(F.pad(wm, (0, 0, ci, sum(cins) - ci - cin,
                                     ow, kw - ow - p.kernel_width,
                                     oh, kh - oh - p.kernel_height)))
            ci += cin
        out = conv_native(x, torch.cat(blocks, dim=3),
                          (p0.stride, p0.stride), ((ph, ph), (pw, pw)))
        if p0.no_bias == 0:
            out = out + torch.cat([self._layer_params(params, m)['bias']
                                   for m in members]).to(x.dtype)
        return torch.split(out, couts, dim=-1)

    # --- vertical conv+bias+act fusion ------------------------------------
    def _node_version_maps(self):
        """Per-layer (node, version) read/write sets under the sequential
        config-order semantics; versions count in-place rewrites."""
        ver: Dict[int, int] = {}
        reads, writes = [], []
        for info in self.cfg.layers:
            reads.append(frozenset((n, ver.get(n, 0))
                                   for n in info.nindex_in))
            w = set()
            for n in info.nindex_out:
                ver[n] = ver.get(n, 0) + 1
                w.add((n, ver[n]))
            writes.append(frozenset(w))
        return reads, writes

    def _build_convact_fusion(self) -> None:
        """Pair each eligible conv with its exclusive in-place relu reader
        for the fused kernel (``fuse = auto|1|0`` net param; the kernel
        gate ``conv_use_fused`` decides at run time).

        As in ``cxxnet_tpu/nnet/net.py:508-573``: the conv must be a
        1-in/1-out conv outside every sibling group, on the native
        lowering with ``micro_batch = 1`` (JAX ``net.py:555-559``: the
        other lowerings and the microbatched conv never take the kernel),
        whose output (node, version) is read by exactly ONE layer, a
        1-in/1-out relu that rewrites the node **in place**
        (``layer[a->a]``), which keeps every node's value identical to
        the unfused run.  Sibling and block-diagonal members stay out
        (JAX ``net.py:554``).  ``fuse=1``
        also routes unpaired convs through the kernel with an identity
        activation (``_convact_solo``).
        """
        fuse = 'auto'
        for name, val in self.cfg.defcfg:
            if name == 'fuse':
                fuse = str(val).strip()
        self._fuse_knob = fuse
        self._convact_pairs: Dict[int, int] = {}   # conv idx -> relu idx
        self._convact_solo: set = set()
        if fuse == '0':
            return
        reads, writes = self._node_version_maps()
        readers: Dict[tuple, List[int]] = {}
        for i, rs in enumerate(reads):
            for nv in rs:
                readers.setdefault(nv, []).append(i)
        for i, layer in enumerate(self.layers):
            if not isinstance(layer, ConvolutionLayer):
                continue
            info = self.cfg.layers[i]
            if (i in self._sibling_groups or i in self._blockdiag_groups
                    or len(info.nindex_in) != 1
                    or len(info.nindex_out) != 1
                    or layer._lowering() != 'native'
                    or layer.param.micro_batch > 1):
                continue
            out_nv = next(iter(writes[i]))
            rd = readers.get(out_nv, [])
            if len(rd) != 1:
                if fuse == '1':
                    self._convact_solo.add(i)
                continue
            r = rd[0]
            rinfo = self.cfg.layers[r]
            if (isinstance(self.layers[r], ReluLayer)
                    and len(rinfo.nindex_in) == 1
                    and rinfo.nindex_out == rinfo.nindex_in):
                self._convact_pairs[i] = r
            elif fuse == '1':
                self._convact_solo.add(i)

    def _fused_convact_outputs(self, lp, x, i: int, act: str):
        """One fused conv+bias+act kernel call for layer ``i``, its
        weights cast to the activations' dtype (JAX
        ``nnet/net.py:579-584``)."""
        layer = self.layers[i]
        strides, pad = layer.geometry()
        b = lp['bias'].to(x.dtype) if layer.param.no_bias == 0 else None
        return [conv_bias_act(x.contiguous(), lp['wmat'].to(x.dtype), b,
                              strides, pad, layer.param.num_group, act)]

    # --- shape inference --------------------------------------------------
    def _infer_shapes(self) -> None:
        cfg = self.cfg
        specs: List[Optional[NodeSpec]] = [None] * cfg.num_nodes
        c, y, x = cfg.input_shape
        if c * y * x == 0:
            raise ValueError('must set input_shape before building the net')
        specs[0] = NodeSpec(c, y, x)
        # the extra data nodes in_1..in_k (JAX nnet/net.py:594-597)
        for k in range(cfg.extra_data_num):
            ec, ey, ex = cfg.extra_shape[3 * k:3 * k + 3]
            specs[1 + k] = NodeSpec(ec, ey, ex)
        for i, info in enumerate(cfg.layers):
            ins = []
            for j in info.nindex_in:
                if specs[j] is None:
                    raise ValueError(
                        f'layer {i} consumes node {j} before it is produced')
                ins.append(specs[j])
            outs = self.layers[i].infer_shapes(ins)
            if len(outs) != len(info.nindex_out):
                raise ValueError(
                    f'layer {i} ({self.layers[i].type_name}): produced '
                    f'{len(outs)} outputs, expected {len(info.nindex_out)}')
            for j, spec in zip(info.nindex_out, outs):
                if specs[j] is not None and j not in info.nindex_in:
                    if specs[j] != spec:
                        raise ValueError(f'node {j} shape conflict')
                specs[j] = spec
        self.node_specs = specs

    # --- params -----------------------------------------------------------
    def init_params(self, key, device) -> Params:
        """JAX's initial weights (``cxxnet_tpu/nnet/net.py:617-629``):
        primary layer ``i`` draws from ``fold_in(key, i)`` (the trainer
        passes ``fold_in(PRNGKey(seed), 0xC0FFEE)``), directly on
        ``device``."""
        params: Params = {}
        for i, info in enumerate(self.cfg.layers):
            if self.layer_primary[i] != i:
                continue
            ins = [self.node_specs[j] for j in info.nindex_in]
            p = self.layers[i].init_params(prng.fold_in(key, i), ins,
                                           device)
            if p:
                params[str(i)] = p
        return params

    def _layer_params(self, params: Params, i: int):
        return params.get(str(self.layer_primary[i]), {})

    # --- forward ----------------------------------------------------------
    def _input_to_device_layout(self, batch, device, dtype=torch.float32,
                                norm=None) -> torch.Tensor:
        """Host batches arrive NCHW (c, y, x per instance): move them to
        ``device`` and to the on-device layout (NHWC images, flat
        matrices) in ``dtype``.  Float batches are cast before the copy,
        integer (uint8 pixel) batches on the device, so only the raw
        bytes cross the bus.  ``norm`` — a ``(mean, scale)`` pair of f32
        device tensors (``NetTrainer._norm_args``) for a batch of raw
        pixels under a ``NormSpec`` — is applied on the device, in f32,
        before the cast to ``dtype``, as the JAX trainer's
        ``_apply_input_norm`` does: the raw batch crosses the bus as it
        is."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(batch)
        if norm is not None:
            mean, scale = norm
            batch = ((batch.to(device).float() - mean) * scale).to(dtype)
        else:
            if batch.is_floating_point() and batch.dtype != dtype:
                # cast on the host, f64 through f32 and round to nearest
                # even, as the JAX trainer's ml_dtypes cast (bf16) and its
                # on-device astype (f16) round: a 16-bit batch crosses the
                # bus in half the bytes (a batch staged by
                # NetTrainer.stage_batch arrives cast)
                batch = batch.float().to(dtype)
            batch = batch.to(device).to(dtype)
        spec = self.node_specs[0]
        if batch.dim() == 2:
            if not spec.is_mat:
                raise ValueError(
                    f'input batch is flat ({batch.shape[1]}-vectors) but '
                    f'input_shape expects {spec.c}x{spec.y}x{spec.x} '
                    f'images')
            return batch
        if batch.dim() == 4:
            if spec.is_mat:
                return batch.reshape(batch.shape[0], -1)
            if tuple(batch.shape[1:]) != (spec.c, spec.y, spec.x):
                raise ValueError(
                    f'input batch {tuple(batch.shape[1:])} does not match '
                    f'input_shape {spec.c},{spec.y},{spec.x}')
            return batch.permute(0, 2, 3, 1).contiguous()
        raise ValueError(f'bad input batch rank {batch.dim()}')

    def _extras_to_device_layout(self, extra_data, device,
                                 dtype=torch.float32) -> List[torch.Tensor]:
        """The values of the extra data nodes ``in_1..in_k`` (JAX
        ``nnet/net.py:692-704``) from a batch's host (NCHW) or staged
        arrays: cast as JAX's ``_shard_batch`` casts them (f64 to f32, f32
        to a bf16 compute dtype, on the host; an f16 compute dtype leaves
        them f32, as JAX's does; a staged tensor arrives cast), moved to
        ``device``; a 4-d extra feeding an image node
        becomes NHWC, one feeding a matrix node is flattened."""
        num = self.cfg.extra_data_num
        if extra_data is None or len(extra_data) < num:
            raise ValueError(
                f'net requires {num} extra_data inputs (batch.extra_data) '
                f'but got {0 if extra_data is None else len(extra_data)}')
        out = []
        for k in range(num):
            ex = extra_data[k]
            if not isinstance(ex, torch.Tensor):
                ex = torch.from_numpy(np.asarray(ex))
            if ex.dtype == torch.float64:
                ex = ex.float()
            if ex.dtype == torch.float32 and dtype == torch.bfloat16:
                ex = ex.to(dtype)
            ex = ex.to(device)
            spec = self.node_specs[1 + k]
            if ex.dim() == 4 and not spec.is_mat:
                ex = ex.permute(0, 2, 3, 1).contiguous()
            elif ex.dim() > 2 and spec.is_mat:
                ex = ex.reshape(ex.shape[0], -1)
            out.append(ex)
        return out

    def forward(self, params: Params, batch, ctx: ForwardContext,
                labels: Optional[LabelInfo] = None, loss_mask=None,
                norm=None, capture=None, identity_layers=frozenset(),
                extra_data=None):
        """Run the graph.  Returns ``(node_values, total_loss)``, as
        ``cxxnet_tpu/nnet/net.py:670-758`` does: every node's final value
        (post loss-layer transforms, like the reference's in-place nodes)
        and the f32 sum of the loss layers' scalars (0 without labels).
        ``loss_mask`` is the (batch,) 0/1 instance weight of a padded
        tail batch.  ``ctx.decisions`` records or replays the relu and
        max-pooling choices (``layers/base.py`` ``Decisions``).  ``norm``
        is the device-side input normalization of a raw batch (see
        :meth:`_input_to_device_layout`).  ``capture`` (``nnet/fold.py``):
        a dict keyed by layer index; each listed layer's input list is
        stored under its key before it runs.  ``identity_layers`` run as
        a pass-through of their first input (a folded BN), keeping the
        layer indices the params are keyed by.  Layers run in
        ``_exec_order`` (config order unless ``fuse_blockdiag``
        re-scheduled it).  ``extra_data`` feeds the nodes ``in_1..in_k``
        of a net with ``extra_data_num`` (NCHW host layout, like the
        input; :meth:`_extras_to_device_layout`)."""
        cfg = self.cfg
        values: List[Optional[torch.Tensor]] = [None] * cfg.num_nodes
        values[0] = self._input_to_device_layout(batch, ctx.device,
                                                 ctx.dtype, norm)
        if cfg.extra_data_num:
            values[1:1 + cfg.extra_data_num] = self._extras_to_device_layout(
                extra_data, ctx.device, ctx.dtype)
        total_loss = torch.zeros((), dtype=torch.float32, device=ctx.device)
        fused: Dict[int, torch.Tensor] = {}   # sibling outputs by member
        fused_bd: Dict[int, torch.Tensor] = {}   # block-diagonal outputs
        fused_act: set = set()   # relus whose act ran inside their conv
        use_fused = bool(self._convact_pairs or self._convact_solo) and \
            conv_use_fused(self._fuse_knob, ctx.kernel_mode)
        record = ctx.decisions is not None and not ctx.decisions.replay
        for i in self._exec_order:
            info = cfg.layers[i]
            layer = self.layers[i]
            lp = self._layer_params(params, i)
            ins = [values[j] for j in info.nindex_in]
            if capture is not None and i in capture:
                capture[i] = ins
            if record and i not in fused_act and isinstance(
                    layer, (ReluLayer, MaxPoolingLayer)):
                ctx.decisions.inputs[i] = ins[0].detach()
            if isinstance(layer, LossLayerBase) and labels is not None:
                total_loss = total_loss + layer.loss(
                    lp, ins, labels.field(layer.target), ctx, loss_mask)
            if i in identity_layers:
                outs = [ins[0]]
            elif i in fused_act:
                outs = [ins[0]]   # activation already applied in the conv
            elif use_fused and i in self._convact_pairs:
                outs = self._fused_convact_outputs(lp, ins[0], i, 'relu')
                fused_act.add(self._convact_pairs[i])
                if record:   # the fused relu's input: the saved z
                    ctx.decisions.inputs[self._convact_pairs[i]] = \
                        saved_preactivation(outs[0])
            elif use_fused and i in self._convact_solo:
                outs = self._fused_convact_outputs(lp, ins[0], i,
                                                   'identity')
            elif i in self._sibling_groups:
                if i not in fused:   # the first member runs the group
                    members = self._sibling_groups[i]
                    fused.update(zip(members, self._fused_sibling_outputs(
                        params, ins[0], members)))
                outs = [fused.pop(i)]
            elif i in self._blockdiag_groups:
                if i not in fused_bd:   # the first member runs the group
                    members = self._blockdiag_groups[i]
                    fused_bd.update(zip(members, self._fused_blockdiag_outputs(
                        params, values, members)))
                outs = [fused_bd.pop(i)]
            else:
                outs = layer.forward(lp, ins, ctx.for_layer(i))
            for j, v in zip(info.nindex_out, outs):
                values[j] = v
        return values, total_loss

    def node_index(self, name: str) -> int:
        """Resolve a node by name or ``top[-k]`` syntax
        (``nnet_impl-inl.hpp:200-223``)."""
        if name.startswith('top[-') and name.endswith(']'):
            k = int(name[5:-1])
            return self.cfg.layers[-k].nindex_out[-1] if k > 0 else -1
        if name in self.cfg.node_name_map:
            return self.cfg.node_name_map[name]
        raise ValueError(f'unknown node name {name}')

    def make_label_info(self, label_mat) -> LabelInfo:
        return LabelInfo(label_mat, self.cfg.label_name_map,
                         self.cfg.label_range)
