"""MNIST idx-format source iterator (``src/io/iter_mnist-inl.hpp:14-156``).

The port's own copy of ``cxxnet_tpu/io/iter_mnist.py``: reads
(optionally gzipped) idx image/label files into memory, scales pixels by
1/256, shuffles **once at init** with ``np.random.RandomState(seed_data)``
(the reference reshuffles only at Init, and both packages then see the
batches in the same order), and yields full batches, dropping the tail
remainder exactly like the reference's ``Next`` (loc + batch_size <= n).
``input_flat=1`` (default) yields ``(b,1,1,784)``; ``0`` yields
``(b,1,28,28)``.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.io_stream import open_maybe_gz
from .data import DataBatch, IIterator


class MNISTIterator(IIterator):
    def __init__(self):
        self.silent = 0
        self.batch_size = 0
        self.input_flat = 1
        self.shuffle = 0
        self.inst_offset = 0
        self.path_img = ''
        self.path_label = ''
        self.seed_data = 0
        self._ready = False

    def set_param(self, name, val):
        if name == 'silent':
            self.silent = int(val)
        if name == 'batch_size':
            self.batch_size = int(val)
        if name == 'input_flat':
            self.input_flat = int(val)
        if name == 'shuffle':
            self.shuffle = int(val)
        if name == 'index_offset':
            self.inst_offset = int(val)
        if name == 'path_img':
            self.path_img = val
        if name == 'path_label':
            self.path_label = val
        if name == 'seed_data':
            self.seed_data = int(val)

    def init(self):
        if self._ready:
            return
        with open_maybe_gz(self.path_img) as f:
            _, n, rows, cols = struct.unpack('>iiii', f.read(16))
            img = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        img = img.reshape(n, rows, cols).astype(np.float32) * (1.0 / 256.0)
        with open_maybe_gz(self.path_label) as f:
            _, nl = struct.unpack('>ii', f.read(8))
            labels = np.frombuffer(f.read(nl), dtype=np.uint8).astype(
                np.float32)
        if n != nl:
            raise ValueError('MNIST: image/label count mismatch')
        inst = np.arange(n, dtype=np.uint32) + self.inst_offset
        if self.shuffle:
            rng = np.random.RandomState(self.seed_data)
            perm = rng.permutation(n)
            img, labels, inst = img[perm], labels[perm], inst[perm]
        self._img, self._labels, self._inst = img, labels, inst
        self._ready = True
        if self.silent == 0:
            shp = ((self.batch_size, 1, 1, rows * cols) if self.input_flat
                   else (self.batch_size, 1, rows, cols))
            print(f'MNISTIterator: load {n} images, shuffle={self.shuffle}, '
                  f'shape={",".join(map(str, shp))}')

    def __iter__(self):
        if self.batch_size <= 0:
            raise ValueError('MNIST: batch_size must be set')
        n = self._img.shape[0]
        bs = self.batch_size
        for loc in range(0, n - bs + 1, bs):
            block = self._img[loc:loc + bs]
            if self.input_flat:
                data = block.reshape(bs, 1, 1, -1)
            else:
                data = block.reshape(bs, 1, block.shape[1], block.shape[2])
            yield DataBatch(data, self._labels[loc:loc + bs, None],
                            self._inst[loc:loc + bs])
