"""Layer framework core: hyperparameters, node specs, registry, base class.

PyTorch counterpart of ``cxxnet_tpu/layers/base.py``.  Layers are
parameter descriptions with a pure ``forward(params, inputs, ctx)`` over
tensors, as in the JAX package; parameters are plain ``{field: tensor}``
dictionaries keyed like the JAX trees, so one model file or one
``interop.params_from_jax`` call feeds either package.

* Activations are NHWC ``(batch, y, x, c)`` tensors; matrices are
  ``(batch, len)``.  The reference's NCHW shapes appear only at the
  config / checkpoint boundary.
* The integer layer-type ids are the reference's stable on-disk ids
  (``src/layer/layer.h:284-314``).
* Random draws are JAX's: initial weights and train-time noise come from
  threefry keys (``utils/prng.py``) folded as the JAX package folds them,
  drawn on the target device by ``ops/threefry.py`` (the ``threefry``
  kernel on a card, its plain version on the CPU), so a seed gives JAX's
  numbers on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import threefry
from ..utils import prng

# stable layer-type ids (on-disk format) — src/layer/layer.h:284-314
kSharedLayer = 0
kFullConnect = 1
kSoftmax = 2
kRectifiedLinear = 3
kSigmoid = 4
kTanh = 5
kSoftplus = 6
kFlatten = 7
kDropout = 8
kConv = 10
kMaxPooling = 11
kSumPooling = 12
kAvgPooling = 13
kLRN = 15
kBias = 17
kConcat = 18
kXelu = 19
kCaffe = 20
kReluMaxPooling = 21
kMaxout = 22
kSplit = 23
kInsanity = 24
kInsanityPooling = 25
kL2Loss = 26
kMultiLogistic = 27
kChConcat = 28
kPRelu = 29
kBatchNorm = 30
kFixConnect = 31
kPairTestGap = 1024

_NAME2TYPE = {
    'fullc': kFullConnect, 'fixconn': kFixConnect, 'bias': kBias,
    'softmax': kSoftmax, 'relu': kRectifiedLinear, 'sigmoid': kSigmoid,
    'tanh': kTanh, 'softplus': kSoftplus, 'flatten': kFlatten,
    'dropout': kDropout, 'conv': kConv, 'relu_max_pooling': kReluMaxPooling,
    'max_pooling': kMaxPooling, 'sum_pooling': kSumPooling,
    'avg_pooling': kAvgPooling, 'lrn': kLRN, 'concat': kConcat,
    'xelu': kXelu, 'maxout': kMaxout, 'split': kSplit,
    'insanity': kInsanity, 'insanity_max_pooling': kInsanityPooling,
    'l2_loss': kL2Loss, 'multi_logistic': kMultiLogistic,
    'ch_concat': kChConcat, 'prelu': kPRelu, 'batch_norm': kBatchNorm,
}
_TYPE2NAME = {v: k for k, v in _NAME2TYPE.items()}


def get_layer_type(type_str: str) -> int:
    """String → stable integer type id (``GetLayerType``, layer.h:322-361)."""
    if type_str.startswith('share'):
        return kSharedLayer
    if type_str.startswith('pairtest-'):
        rest = type_str[len('pairtest-'):]
        master, _, slave = rest.partition('-')
        slave = slave.split(':')[0]
        return kPairTestGap * get_layer_type(master) + get_layer_type(slave)
    if type_str in _NAME2TYPE:
        return _NAME2TYPE[type_str]
    if type_str == 'caffe':
        raise ValueError(
            "layer type 'caffe' (reference plugin enum 20) is an "
            'unsupported plugin: it adapts in-process caffe::Layer objects')
    raise ValueError(f'unknown layer type: "{type_str}"')


def layer_type_name(type_id: int) -> str:
    if type_id >= kPairTestGap:
        return (f'pairtest-{layer_type_name(type_id // kPairTestGap)}'
                f'-{layer_type_name(type_id % kPairTestGap)}')
    if type_id == kSharedLayer:
        return 'share'
    return _TYPE2NAME.get(type_id, f'<type{type_id}>')


@dataclasses.dataclass
class LayerParam:
    """Shared layer hyperparameters (``src/layer/param.h:15-110``)."""

    num_hidden: int = 0
    init_sigma: float = 0.01
    init_sparse: int = 10
    init_uniform: float = -1.0
    init_bias: float = 0.0
    num_channel: int = 0
    random_type: int = 0          # 0 gaussian, 1 xavier/uniform, 2 kaiming
    num_group: int = 1
    kernel_height: int = 0
    kernel_width: int = 0
    stride: int = 1
    pad_y: int = 0
    pad_x: int = 0
    no_bias: int = 0
    temp_col_max: int = 64 << 18
    silent: int = 0
    num_input_channel: int = 0
    num_input_node: int = 0
    # the conv's lowering (JAX layers/base.py:132): auto | native (one
    # convolution) | im2col (patches times a GEMM) | split (a convolution
    # a group) | s2d (space-to-depth, strided convs on shallow inputs);
    # layers/conv.py resolves it per shape
    conv_lowering: str = 'auto'
    # μ-cuDNN-style microbatching (JAX layers/base.py:138): the conv's
    # forward and input gradient run over this many batch slices, its
    # weight gradient in one full-batch call, so a split step is a
    # bitwise twin of the unsplit one (ops/microbatch.py)
    micro_batch: int = 1

    def set_param(self, name: str, val: str) -> None:
        if name == 'init_sigma':
            self.init_sigma = float(val)
        if name == 'init_uniform':
            self.init_uniform = float(val)
        if name == 'init_bias':
            self.init_bias = float(val)
        if name == 'init_sparse':
            self.init_sparse = int(val)
        if name == 'random_type':
            table = {'gaussian': 0, 'uniform': 1, 'xavier': 1, 'kaiming': 2}
            if val not in table:
                raise ValueError(f'invalid random_type {val}')
            self.random_type = table[val]
        if name == 'nhidden':
            self.num_hidden = int(val)
        if name == 'nchannel':
            self.num_channel = int(val)
        if name == 'ngroup':
            self.num_group = int(val)
        if name == 'kernel_size':
            self.kernel_height = self.kernel_width = int(val)
        if name == 'kernel_height':
            self.kernel_height = int(val)
        if name == 'kernel_width':
            self.kernel_width = int(val)
        if name == 'stride':
            self.stride = int(val)
        if name == 'pad':
            self.pad_y = self.pad_x = int(val)
        if name == 'pad_y':
            self.pad_y = int(val)
        if name == 'pad_x':
            self.pad_x = int(val)
        if name == 'no_bias':
            self.no_bias = int(val)
        if name == 'silent':
            self.silent = int(val)
        if name == 'temp_col_max':
            self.temp_col_max = int(val) << 18
        if name == 'conv_lowering':
            if val not in ('auto', 'native', 'im2col', 'split', 's2d'):
                raise ValueError(f'conv_lowering: unknown mode {val}')
            self.conv_lowering = val
        if name == 'micro_batch':
            if int(val) < 1:
                raise ValueError(f'micro_batch: must be >= 1, got {val}')
            self.micro_batch = int(val)

    def rand_init_weight(self, key, shape: Tuple[int, ...], in_num: int,
                         out_num: int, device='cpu') -> torch.Tensor:
        """Weight init matching ``RandInitWeight`` (param.h:113-138):
        gaussian(0, init_sigma) / xavier-uniform sqrt(3/(in+out)) /
        kaiming gaussian sqrt(2/fan), float32 on ``device``, drawn from the
        threefry ``key`` as the JAX layer draws it (``jax.random.normal``
        / ``uniform(minval=-a, maxval=a)`` over ``shape``)."""
        if self.random_type == 0:
            return self.init_sigma * threefry.normal(key, shape,
                                                     device=device)
        if self.random_type == 1:
            a = math.sqrt(3.0 / (in_num + out_num))
            if self.init_uniform > 0:
                a = self.init_uniform
            return threefry.uniform(key, shape, device=device, minval=-a,
                                    maxval=a)
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = math.sqrt(2.0 / self.num_hidden)
            else:
                sigma = math.sqrt(2.0 / (self.num_channel * self.kernel_width
                                         * self.kernel_height))
            return sigma * threefry.normal(key, shape, device=device)
        raise ValueError(f'unsupported random_type {self.random_type}')


class NodeSpec:
    """Logical per-instance shape of a node: ``(c, y, x)``.  Matrices are
    ``(1, 1, len)`` and stored 2-D ``(batch, len)``; images are stored
    NHWC ``(batch, y, x, c)``."""

    __slots__ = ('c', 'y', 'x')

    def __init__(self, c: int, y: int, x: int):
        self.c, self.y, self.x = int(c), int(y), int(x)

    @property
    def is_mat(self) -> bool:
        return self.c == 1 and self.y == 1

    @property
    def flat_size(self) -> int:
        return self.c * self.y * self.x

    def batch_shape(self, batch: int) -> Tuple[int, ...]:
        if self.is_mat:
            return (batch, self.x)
        return (batch, self.y, self.x, self.c)

    def __repr__(self):
        return f'NodeSpec(c={self.c}, y={self.y}, x={self.x})'

    def __eq__(self, other):
        return (self.c, self.y, self.x) == (other.c, other.y, other.x)


def as_mat(x: torch.Tensor) -> torch.Tensor:
    """FlatTo2D view: collapse all non-batch dims (``layer.h:63-66``).

    A 4-D NHWC node flattens in the reference's NCHW element order
    (``cxxnet_tpu/layers/base.py:245-256``), so fullc weights keep the
    same column meaning in both packages and in model files.
    """
    if x.dim() == 2:
        return x
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    return x.reshape(x.shape[0], -1)


class Decisions:
    """The relu and max-pooling choices of one forward, replayed in
    another.  Two compositions of one train step (the kernels and the
    stock ops) sum in different orders, so a value within ~1e-6 of 0, or
    of its pooling window's maximum, can fall on the other side in one of
    them; replaying one forward's choices in the other compares the two
    without that noise.

    While ``replay`` is False, ``Net.forward`` records each relu's and
    each max pooling's input by layer index (a relu fused into its conv
    records the pre-activation the kernel saved).  Once it is True, a
    relu layer passes its input where the recorded one was > 0 and half
    its gradient where the recorded one was exactly 0 (the tie's split,
    which an input a rounding away from 0 in this forward would
    otherwise decide), and a max-pooling layer takes, in each window, the
    element that won the recorded window; values and gradients still
    come from the forward's own inputs."""

    def __init__(self):
        self.inputs: Dict[int, torch.Tensor] = {}
        self.replay = False


@dataclasses.dataclass
class ForwardContext:
    """Per-apply context threaded through layer forwards.

    ``rng_key`` is the train step's threefry key ((2,) uint32), which the
    trainer folds from its seed and the step as the JAX trainer does
    (``fold_in(PRNGKey(seed), 1 + sample_counter * 131 + round)``); each
    layer draws from ``fold_in(rng_key, layer_index)``
    (:meth:`layer_key`), JAX's ``layer_rng``, so a net draws JAX's
    dropout, insanity and prelu noise at every step."""

    is_train: bool
    rng_key: Optional[np.ndarray] = None
    layer_index: int = -1
    round: int = 0
    max_round: int = 1
    device: torch.device = torch.device('cpu')
    dtype: torch.dtype = torch.float32
    # tri-state kernel switch ('auto' | 'on' | 'off') read by the gate
    # functions in ops/kernels.py — the net param use_pallas=, carried
    # per trainer instead of through a process-wide environment variable
    kernel_mode: str = 'auto'
    # the relu and max-pooling choices to record or replay (Decisions)
    decisions: Optional[Decisions] = None

    def for_layer(self, index: int) -> 'ForwardContext':
        return dataclasses.replace(self, layer_index=index)

    def layer_key(self) -> np.ndarray:
        """This layer's key at this step: ``fold_in(rng_key,
        layer_index)``."""
        if self.rng_key is None:
            raise ValueError('layer requires rng but none was provided')
        return prng.fold_in(self.rng_key, self.layer_index)

    def replayed(self) -> Optional[torch.Tensor]:
        """The recorded input of this layer when decisions replay, else
        None."""
        d = self.decisions
        if d is None or not d.replay:
            return None
        if self.layer_index not in d.inputs:
            raise ValueError(f'no recorded decisions for layer '
                             f'{self.layer_index}')
        return d.inputs[self.layer_index]


Params = Dict[str, torch.Tensor]


class Layer:
    """Base class for all layers: ``init_params`` produces a dict of
    tensors, ``forward`` is pure.  Field names ('wmat', 'bias', ...)
    match the reference visitor names, so checkpoint blobs line up."""

    type_name: str = ''
    type_id: int = -1
    param_fields: Sequence[str] = ()

    def __init__(self, name: str = ''):
        self.name = name
        self.param = LayerParam()

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)

    def infer_shapes(self, in_specs: List[NodeSpec]) -> List[NodeSpec]:
        raise NotImplementedError

    def init_params(self, key, in_specs: List[NodeSpec],
                    device='cpu') -> Params:
        """Initial f32 parameters on ``device``, drawn from the threefry
        ``key`` (the net's ``fold_in(init_key, layer_index)``)."""
        return {}

    def forward(self, params: Params, inputs: List[torch.Tensor],
                ctx: ForwardContext) -> List[torch.Tensor]:
        raise NotImplementedError

    @property
    def is_loss(self) -> bool:
        return False

    def allow_sharing(self) -> bool:
        """Whether this layer can be referenced by ``share[tag]``."""
        return bool(self.param_fields)

    def __repr__(self):
        return f'{type(self).__name__}(name={self.name!r})'


LAYER_REGISTRY: Dict[int, type] = {}


def register_layer(cls):
    """Class decorator: register under its stable type id."""
    LAYER_REGISTRY[cls.type_id] = cls
    return cls


def create_layer(type_id: int, name: str = '') -> Layer:
    """Factory (``CreateLayer_``, layer_impl-inl.hpp:36-76); a type id of
    ``kPairTestGap * master + slave`` builds a pairtest layer."""
    if type_id >= kPairTestGap:
        from .pairtest import PairTestLayer
        return PairTestLayer(type_id // kPairTestGap, type_id % kPairTestGap,
                             name=name)
    cls = LAYER_REGISTRY.get(type_id)
    if cls is None:
        raise ValueError(
            f'CreateLayer: unknown/unsupported layer type {type_id} '
            f'({layer_type_name(type_id)})')
    return cls(name=name)
