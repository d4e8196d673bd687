"""Data pipeline core: DataBatch, the iterator interface, the chain factory.

The port's own copy of ``cxxnet_tpu/io/data.py`` (numpy only), with the
reference's chained-iterator architecture (``src/io/data.h:19-181``,
factory ``src/io/data.cpp:23-74``): a source wrapped by optional
``threadbuffer`` (prefetch) and ``membuffer`` (cache) stages, assembled
from the ordered config pairs of one ``data = .. iter = .. end``
section.  Batches carry NCHW numpy arrays (the host-side layout
contract); the net moves them to the device and to NHWC.

Sources: ``mnist``, the image sources (``imgbin``, ``imgbinx``, ``img``
and ``imgbin_stream``, the appendable tail of ``io/iter_stream.py``) with
their augmentation stage, and the ``attachtxt`` stage
(``io/iter_attach.py``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.thread_buffer import ThreadBuffer

ConfigEntry = Tuple[str, str]


class NormSpec:
    """Deferred input normalization: what the augment stage would have done
    on host ((x - mean) * scale, ``iter_augment_proc-inl.hpp:199-231``),
    carried alongside a raw uint8 batch so the net applies it on the
    device instead (``device_normalize=1``): the uint8 batch crosses the
    bus in a quarter of the f32 bytes."""

    __slots__ = ('mean_img', 'mean_vals', 'scale')

    def __init__(self, mean_img=None, mean_vals=None, scale=1.0):
        self.mean_img = mean_img            # (c, y, x) float32 or None
        self.mean_vals = mean_vals          # (c,) float32 or None
        self.scale = float(scale)

    def resolved_mean(self) -> np.ndarray:
        """The mean actually subtracted, with the host augment path's
        priority (per-channel ``mean_value`` outranks a mean image),
        broadcastable against (..., c, y, x).  One source of truth for
        host ``apply`` and the trainer's device constants."""
        if self.mean_vals is not None:
            return np.asarray(self.mean_vals, np.float32)[:, None, None]
        if self.mean_img is not None:
            return np.asarray(self.mean_img, np.float32)
        return np.zeros((1, 1, 1), np.float32)

    def apply(self, data: np.ndarray) -> np.ndarray:
        """Host-side application: the same f32 ``(x - mean) * scale`` the
        device runs.  Used where raw batches leave the device path, e.g.
        ``wrapper.DataIter.get_data``, which hands out post-augment float
        data."""
        out = np.asarray(data, np.float32)
        return (out - self.resolved_mean()) * self.scale


class DataBatch:
    """One minibatch (``src/io/data.h:83-181``)."""

    __slots__ = ('data', 'label', 'inst_index', 'num_batch_padd',
                 'pad_synthetic', 'extra_data', 'norm_spec')

    def __init__(self, data: np.ndarray, label: np.ndarray,
                 inst_index: Optional[np.ndarray] = None,
                 num_batch_padd: int = 0,
                 extra_data: Optional[List[np.ndarray]] = None,
                 pad_synthetic: bool = False,
                 norm_spec: Optional[NormSpec] = None):
        self.data = data                    # (b, c, y, x) float32, or uint8
        self.label = label                  # (b, label_width) float32
        self.inst_index = inst_index        # (b,) uint32 or None
        self.num_batch_padd = num_batch_padd
        # True when the padd rows are filler (a short tail batch) and must
        # be masked out of gradients; False when they are real wrapped
        # instances, which the reference trains on
        self.pad_synthetic = pad_synthetic
        self.extra_data = extra_data or []
        # set when data is raw pixels the net must normalize on the
        # device (device_normalize=1)
        self.norm_spec = norm_spec

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class DataInst:
    """One instance (``src/io/data.h:41-57``)."""

    __slots__ = ('index', 'data', 'label', 'extra_data')

    def __init__(self, index: int, data: np.ndarray, label: np.ndarray,
                 extra_data: Optional[List[np.ndarray]] = None):
        self.index = index
        self.data = data                    # (c, y, x)
        self.label = label                  # (label_width,)
        self.extra_data = extra_data or []


class IIterator:
    """Reference iterator protocol: SetParam*, Init, then per-epoch
    BeforeFirst/Next/Value — exposed pythonically as ``__iter__``."""

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def close(self, timeout=None) -> bool:
        """Join any threads the chain started (wrappers delegate)."""
        base = getattr(self, 'base', None)
        return base.close(timeout) if base is not None else True

    def get_norm_spec(self) -> Optional[NormSpec]:
        """The deferred-normalization spec of the augment stage in this
        chain, or None.  Wrappers delegate to their wrapped iterator."""
        base = getattr(self, 'base', None)
        return base.get_norm_spec() if base is not None else None

    def pipeline_stats(self):
        """The chain's ``utils.metric.StatSet`` of per-stage pipeline
        counters (decode/augment/collate ms, pool occupancy, buffer
        stalls), or None when no stage is instrumented (stats turn on
        with ``nworker``).  Wrappers delegate."""
        base = getattr(self, 'base', None)
        return base.pipeline_stats() if base is not None else None

    def iter_thunks(self):
        """One epoch pass as zero-arg callables, each materializing the
        next ``DataInst`` — the submission stream of the parallel
        decode/augment pool (``utils/parallel_pool.py``).  Sources whose
        per-instance work is heavy (``iter_imbin``) override this to
        DEFER that work into the thunk so pool workers carry it; the
        default wraps ``__iter__``.  Thunk order must equal ``__iter__``
        order — the pool's bitwise-identity contract hangs on it."""
        for inst in self:
            yield (lambda inst=inst: inst)

    def is_replay_stable(self) -> bool:
        """True when every ``__iter__`` replays the SAME item sequence.
        Iterators that reshuffle per epoch pass (imgbin/imgbinx with
        ``shuffle=1``) return False.  Wrappers delegate."""
        base = getattr(self, 'base', None)
        return base.is_replay_stable() if base is not None else True

    def __iter__(self) -> Iterator:
        raise NotImplementedError


class ThreadBufferIterator(IIterator):
    """Batch-level prefetch (``iter_batch_proc-inl.hpp:136-224``).
    ``buffer_deadline = <seconds>`` arms a per-batch watchdog that raises
    ``PipelineStallError`` instead of blocking forever (0 disables); the
    first batch of an epoch gets five times the deadline unless
    ``buffer_first_deadline`` pins it.

    ``nworker = N`` is accepted here and cascades down the chain to the
    augment stage, which fans per-instance decode+augment across N pool
    threads (``utils/parallel_pool.py``); output stays bitwise identical
    for any N.  When the chain is instrumented (nworker set), this
    stage's producer/consumer stalls land on the same StatSet, and a
    pooled chain's first batch, which also fills the pool's window, gets
    ten times the deadline unless ``buffer_first_deadline`` pins it."""

    def __init__(self, base: IIterator, buffer_size: int = 2):
        self.base = base
        self._buffer_size = buffer_size
        self._deadline = None
        self._first_deadline = None
        self._buf = self._make_buf()

    def _make_buf(self) -> ThreadBuffer:
        first = self._first_deadline
        if first is None and self._deadline is not None:
            first = self._deadline * 5
        return ThreadBuffer(lambda: iter(self.base), self._buffer_size,
                            deadline=self._deadline, first_deadline=first,
                            fault_scope='batch')

    def set_param(self, name, val):
        if name in ('buffer_deadline', 'buffer_first_deadline'):
            if name == 'buffer_deadline':
                self._deadline = float(val) if float(val) > 0 else None
            else:
                self._first_deadline = \
                    float(val) if float(val) > 0 else None
            # join the old buffer's producers before replacing it
            self._buf.close(timeout=1.0)
            self._buf = self._make_buf()
        self.base.set_param(name, val)

    def init(self):
        self.base.init()

    def close(self, timeout=None):
        """Join any live prefetch producers (see ThreadBuffer.close)."""
        return self._buf.close(timeout)

    def __iter__(self):
        # late-bound: the chain's StatSet exists only after set_param
        # cascaded an ``nworker`` key to the augment stage
        stats = self.base.pipeline_stats()
        self._buf.stats = stats
        if stats is not None and self._deadline is not None \
                and self._first_deadline is None:
            self._buf._first_deadline = self._deadline * 10
        return iter(self._buf)


class DenseBufferIterator(IIterator):
    """Cache the first ``max_nbatch`` batches in RAM and loop over them
    (``iter_mem_buffer-inl.hpp:16-75``)."""

    def __init__(self, base: IIterator):
        self.base = base
        self.max_nbatch = 0
        self._cache: Optional[List[DataBatch]] = None

    def set_param(self, name, val):
        if name == 'max_nbatch':
            self.max_nbatch = int(val)
        self.base.set_param(name, val)

    def init(self):
        self.base.init()

    def __iter__(self):
        if self._cache is None:
            cache = []
            for batch in self.base:
                cache.append(batch)
                if self.max_nbatch and len(cache) >= self.max_nbatch:
                    break
            self._cache = cache
        return iter(self._cache)


def create_iterator(cfg: List[ConfigEntry]) -> IIterator:
    """Assemble an iterator chain from one config section
    (``src/io/data.cpp:23-74``)."""
    from .iter_attach import AttachTxtIterator
    from .iter_augment import AugmentIterator
    from .iter_batch import BatchAdaptIterator
    from .iter_imbin import ImageBinIterator, ImageBinXIterator
    from .iter_img import ImageIterator
    from .iter_mnist import MNISTIterator
    from .iter_stream import ImageBinStreamIterator
    image_sources = {'img': ImageIterator, 'imgbin': ImageBinIterator,
                     'imgbinx': ImageBinXIterator,
                     'imgbin_stream': ImageBinStreamIterator}

    it: Optional[IIterator] = None
    for name, val in cfg:
        if name == 'iter':
            if val == 'mnist':
                if it is not None:
                    raise ValueError('mnist cannot chain over another '
                                     'iterator')
                it = MNISTIterator()
            elif val in image_sources:
                if it is not None:
                    raise ValueError(f'{val} cannot chain over another '
                                     'iterator')
                it = BatchAdaptIterator(AugmentIterator(image_sources[val]()))
            elif val == 'threadbuffer':
                if it is None:
                    raise ValueError('must specify input of threadbuffer')
                it = ThreadBufferIterator(it)
            elif val == 'membuffer':
                if it is None:
                    raise ValueError('must specify input of membuffer')
                it = DenseBufferIterator(it)
            elif val == 'attachtxt':
                if it is None:
                    raise ValueError('must specify input of attachtxt')
                it = AttachTxtIterator(it)
            elif val == 'end':
                break
            else:
                raise ValueError(f'unknown iterator type {val}')
        elif it is not None:
            it.set_param(name, val)
    if it is None:
        raise ValueError('must specify iterator by iter=itername')
    return it
