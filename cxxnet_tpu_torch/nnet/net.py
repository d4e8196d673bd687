"""Neural-net graph executor over a ``NetConfig``.

PyTorch counterpart of ``cxxnet_tpu/nnet/net.py``: builds the layers of a
netconfig, infers every node's shape, and runs the graph in config
order, replaying the reference's in-place node semantics
(``layer[a->a]`` rewrites).  Activations are NHWC; host batches arrive
NCHW and are transposed once on the device.

The two fusion passes group layers exactly as the JAX package does, so
the same layers reach the conv kernel in both:

* ``_build_sibling_fusion`` (``fuse_siblings``, on by default) groups the
  ungrouped 1x1 stride-1 unpadded convs that read one node; each group
  runs as one plain conv (``conv_native``, no kernel, as JAX runs it
  through XLA) over the weights concatenated along the output channels,
  split back per member;
* ``_build_convact_fusion`` pairs each other conv with its exclusive
  in-place relu, and the paired conv runs through the fused kernel of
  ``ops/cnn.py``.

``fuse_blockdiag`` (off by default in JAX too) comes with ROADMAP.md
queue A item 4 and is refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..layers import ForwardContext, NodeSpec, create_layer
from ..layers.base import REST_OF_ITEM_2, Layer, kSharedLayer
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
        if cfg.extra_data_num:
            raise NotPortedError('extra_data_num', REST_OF_ITEM_2)
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
            if name == 'fuse_blockdiag' and str(val).strip() not in ('', '0'):
                raise NotPortedError(f'fuse_blockdiag={val}',
                                     'queue A item 4')
            if name == 'tensor_parallel' and int(val) > 1:
                raise NotPortedError(f'tensor_parallel={val}',
                                     'queue A item 9')
        # split layers need their fan-out before shape inference
        for i, info in enumerate(cfg.layers):
            if isinstance(self.layers[i], SplitLayer):
                self.layers[i].set_num_outputs(len(info.nindex_out))
        self._infer_shapes()
        self._build_sibling_fusion()
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
        1-in/1-out conv outside every sibling group whose output (node,
        version) is read by exactly ONE layer, a 1-in/1-out relu that
        rewrites the node **in place** (``layer[a->a]``), which keeps
        every node's value identical to the unfused run.  ``fuse=1`` also routes unpaired convs through the
        kernel with an identity activation (``_convact_solo``).
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
            if (i in self._sibling_groups or len(info.nindex_in) != 1
                    or len(info.nindex_out) != 1):
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
            if batch.is_floating_point():
                # cast on the host, f64 through f32 and round to nearest
                # even, as the JAX trainer's ml_dtypes cast: a bf16 batch
                # crosses the bus in half the bytes
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

    def forward(self, params: Params, batch, ctx: ForwardContext,
                labels: Optional[LabelInfo] = None, loss_mask=None,
                norm=None):
        """Run the graph.  Returns ``(node_values, total_loss)``, as
        ``cxxnet_tpu/nnet/net.py:670-758`` does: every node's final value
        (post loss-layer transforms, like the reference's in-place nodes)
        and the f32 sum of the loss layers' scalars (0 without labels).
        ``loss_mask`` is the (batch,) 0/1 instance weight of a padded
        tail batch.  ``ctx.decisions`` records or replays the relu and
        max-pooling choices (``layers/base.py`` ``Decisions``).  ``norm``
        is the device-side input normalization of a raw batch (see
        :meth:`_input_to_device_layout`)."""
        cfg = self.cfg
        values: List[Optional[torch.Tensor]] = [None] * cfg.num_nodes
        values[0] = self._input_to_device_layout(batch, ctx.device,
                                                 ctx.dtype, norm)
        total_loss = torch.zeros((), dtype=torch.float32, device=ctx.device)
        fused: Dict[int, torch.Tensor] = {}   # sibling outputs by member
        fused_act: set = set()   # relus whose act ran inside their conv
        use_fused = bool(self._convact_pairs or self._convact_solo) and \
            conv_use_fused(self._fuse_knob, ctx.kernel_mode)
        record = ctx.decisions is not None and not ctx.decisions.replay
        for i, info in enumerate(cfg.layers):
            layer = self.layers[i]
            lp = self._layer_params(params, i)
            ins = [values[j] for j in info.nindex_in]
            if record and i not in fused_act and isinstance(
                    layer, (ReluLayer, MaxPoolingLayer)):
                ctx.decisions.inputs[i] = ins[0].detach()
            if isinstance(layer, LossLayerBase) and labels is not None:
                total_loss = total_loss + layer.loss(
                    lp, ins, labels.field(layer.target), ctx, loss_mask)
            if i in fused_act:
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
