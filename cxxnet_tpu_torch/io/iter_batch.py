"""Instance→batch adapter (``src/io/iter_batch_proc-inl.hpp:16-133``).

The port's own copy of ``cxxnet_tpu/io/iter_batch.py``.

Collects ``DataInst`` from an instance iterator into fixed-size batches.
``round_batch=1``: when the epoch ends mid-batch, wrap around to the first
instances of the *next* epoch pass and report ``num_batch_padd`` (the count
of wrapped/padding instances) so evaluation can exclude them — same contract
as the reference.  ``test_skipread=1`` re-serves one cached batch to bound
maximum pipeline throughput.  Under ``device_normalize`` the decoded uint8
pixels stay uint8 and every batch carries the chain's ``NormSpec``; the
``collate_ms`` stat lands on the chain's StatSet when ``nworker`` is set.
"""

from __future__ import annotations

import time

import numpy as np

from .data import DataBatch, IIterator


class BatchAdaptIterator(IIterator):
    def __init__(self, base):
        self.base = base               # instance iterator
        self.batch_size = 0
        self.round_batch = 0
        self.test_skipread = 0
        self.label_width = 1
        self._cached: DataBatch | None = None
        self._norm_spec = None
        self._stats = None

    def set_param(self, name, val):
        if name == 'batch_size':
            self.batch_size = int(val)
        if name == 'round_batch':
            self.round_batch = int(val)
        if name == 'test_skipread':
            self.test_skipread = int(val)
        if name == 'label_width':
            self.label_width = int(val)
        self.base.set_param(name, val)

    def init(self):
        self.base.init()
        self._norm_spec = self.base.get_norm_spec()
        self._stats = self.base.pipeline_stats()

    def _make_batch(self, insts):
        if self._stats is not None:
            t0 = time.perf_counter()
            out = self._collate(insts)
            self._stats.observe('collate_ms',
                                (time.perf_counter() - t0) * 1e3)
            return out
        return self._collate(insts)

    def _collate(self, insts):
        data = np.stack([i.data for i in insts])
        if not (data.dtype == np.uint8 and self._norm_spec is not None):
            # reference host contract: float32 batches
            # (device_normalize keeps the decoded uint8 on the wire)
            data = data.astype(np.float32)
        label = np.stack([np.atleast_1d(i.label) for i in insts]).astype(np.float32)
        index = np.asarray([i.index for i in insts], dtype=np.uint32)
        return data, label, index

    def __iter__(self):
        if self.batch_size <= 0:
            raise ValueError('batch: batch_size must be set')
        if self.test_skipread and self._cached is not None:
            while True:   # bounded by the consumer
                yield self._cached
        bs = self.batch_size
        buf = []
        for inst in self.base:
            buf.append(inst)
            if len(buf) == bs:
                data, label, index = self._make_batch(buf)
                batch = DataBatch(data, label, index,
                                  norm_spec=self._norm_spec)
                if self.test_skipread and self._cached is None:
                    self._cached = batch
                yield batch
                buf = []
        if buf and self.round_batch:
            # wrap with the first instances of a fresh epoch pass, like the
            # reference's BeforeFirst-and-continue (iter_batch_proc:84-101)
            npadd = bs - len(buf)
            wrap = []
            while len(wrap) < npadd:
                took = False
                for inst in self.base:
                    wrap.append(inst)
                    took = True
                    if len(wrap) == npadd:
                        break
                if not took:
                    raise RuntimeError('round_batch: source is empty')
            data, label, index = self._make_batch(buf + wrap)
            yield DataBatch(data, label, index, num_batch_padd=npadd,
                            norm_spec=self._norm_spec)
        elif buf:
            # round_batch=0: emit the short final batch padded to full size
            # with num_batch_padd = batch_size - top
            # (iter_batch_proc-inl.hpp:101-103; the reference pads with stale
            # rows of its reused buffer — here the last real instance is
            # repeated, equally ignored downstream).  Consumers mask the pad
            # rows out of grads/metrics/predictions; every batch keeps the
            # full size.
            npadd = bs - len(buf)
            data, label, index = self._make_batch(buf + [buf[-1]] * npadd)
            yield DataBatch(data, label, index, num_batch_padd=npadd,
                            pad_synthetic=True, norm_spec=self._norm_spec)
