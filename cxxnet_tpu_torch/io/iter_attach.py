"""Attach per-instance side features from a text file.

The port's own copy of ``cxxnet_tpu/io/iter_attach.py`` (reference
``src/io/iter_attach_txt-inl.hpp:15-99``): row ``i`` of ``attach_file``
(one vector per line) is instance ``i``'s side vector, joined to each
batch by its ``inst_index`` as ``extra_data_num`` copies of a
``(batch, 1, 1, len)`` array in ``batch.extra_data``, which feed the
net's ``in_1..in_k`` nodes.
"""

from __future__ import annotations

import numpy as np

from .data import IIterator


class AttachTxtIterator(IIterator):
    def __init__(self, base: IIterator):
        self.base = base
        self.filename = ''
        self.num_extra = 1
        self._table = None

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == 'attach_file':
            self.filename = val
        if name == 'extra_data_num':
            self.num_extra = int(val)

    def init(self):
        self.base.init()
        if not self.filename:
            raise ValueError('attachtxt: must set attach_file')
        self._table = np.loadtxt(self.filename, dtype=np.float32, ndmin=2)

    def __iter__(self):
        for batch in self.base:
            if batch.inst_index is None:
                raise ValueError('attachtxt requires instance indices')
            rows = self._table[batch.inst_index.astype(np.int64)]
            batch.extra_data = [rows.reshape(rows.shape[0], 1, 1, -1)
                                for _ in range(self.num_extra)]
            yield batch
