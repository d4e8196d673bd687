"""Binary stream helpers and the 64MB ``BinaryPage`` container format.

The port's own copy of ``cxxnet_tpu/utils/io_stream.py``, byte-compatible
with the reference's on-disk formats so existing ``.bin`` datasets and
``.model`` files interoperate:

* length-prefixed (uint64 little-endian) strings and POD vectors, matching
  ``IStream::Write``/``Read`` (``src/utils/io.h:43-100``), which
  ``nnet/net_config.py`` reads and writes the model header through;
* ``open_maybe_gz``, which the MNIST iterator reads its idx files through;
* ``BinaryPage``: a fixed 64MB page (``64 << 18`` ints).  ``data[0]`` holds
  the object count, ``data[1+i]`` cumulative byte offsets, and object
  payloads are packed backwards from the end of the page
  (``src/utils/io.h:253-326``).  The page size is read from the class at
  call time, so a caller (or a test) may shrink it.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, List

import numpy as np

_U64 = struct.Struct('<Q')


def write_string(f: BinaryIO, s: bytes | str) -> None:
    if isinstance(s, str):
        s = s.encode('utf-8')
    f.write(_U64.pack(len(s)))
    if s:
        f.write(s)


def read_string(f: BinaryIO) -> bytes:
    raw = f.read(8)
    if len(raw) < 8:
        raise EOFError('read_string: truncated stream')
    (n,) = _U64.unpack(raw)
    data = f.read(n)
    if len(data) < n:
        raise EOFError('read_string: truncated stream')
    return data


def write_vector(f: BinaryIO, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    f.write(_U64.pack(arr.size))
    if arr.size:
        f.write(arr.tobytes())


def read_vector(f: BinaryIO, dtype) -> np.ndarray:
    raw = f.read(8)
    if len(raw) < 8:
        raise EOFError('read_vector: truncated stream')
    (n,) = _U64.unpack(raw)
    dtype = np.dtype(dtype)
    data = f.read(n * dtype.itemsize)
    if len(data) < n * dtype.itemsize:
        raise EOFError('read_vector: truncated stream')
    return np.frombuffer(data, dtype=dtype, count=n).copy()


def open_maybe_gz(path: str, mode: str = 'rb'):
    """Open a file, transparently decompressing ``.gz`` (GzFile
    equivalent)."""
    with open(path, 'rb') as probe:
        magic = probe.read(2)
    if magic == b'\x1f\x8b':
        return gzip.open(path, mode)
    return open(path, mode)


class BinaryPage:
    """One fixed-size page of byte blobs, reference-format-compatible."""

    K_PAGE_SIZE = 64 << 18          # number of int32 slots
    N_BYTES = K_PAGE_SIZE * 4       # 64 MB

    def __init__(self):
        self._head: List[int] = [0, 0]   # head[0]=count, head[1+i]=cum offsets
        self._objs: List[bytes] = []

    def clear(self) -> None:
        self._head = [0, 0]
        self._objs = []

    @property
    def size(self) -> int:
        return self._head[0]

    def _free_bytes(self) -> int:
        return ((self.K_PAGE_SIZE - (self.size + 2)) * 4
                - self._head[self.size + 1])

    def push(self, blob: bytes) -> bool:
        """Append a blob; returns False when the page is full."""
        if self._free_bytes() < len(blob) + 4:
            return False
        self._head.append(self._head[-1] + len(blob))
        self._head[0] += 1
        self._objs.append(bytes(blob))
        return True

    def __getitem__(self, r: int) -> bytes:
        if r >= self.size:
            raise IndexError('BinaryPage: index exceeds bound')
        return self._objs[r]

    def __iter__(self):
        return iter(self._objs)

    def save(self, f: BinaryIO) -> None:
        buf = np.zeros(self.K_PAGE_SIZE, dtype=np.int32)
        buf[:len(self._head)] = self._head
        page = bytearray(buf.tobytes())
        pos = self.N_BYTES
        for blob in self._objs:
            # objects are packed backwards from the end of the page
            page[pos - len(blob):pos] = blob
            pos -= len(blob)
        f.write(bytes(page))

    def load(self, f: BinaryIO) -> bool:
        raw = f.read(self.N_BYTES)
        if len(raw) < self.N_BYTES:
            return False
        head = np.frombuffer(raw, dtype=np.int32, count=self.K_PAGE_SIZE)
        n = int(head[0])
        self._head = [n] + [int(x) for x in head[1:n + 2]]
        self._objs = []
        for r in range(n):
            lo = self.N_BYTES - self._head[2 + r]
            hi = self.N_BYTES - self._head[1 + r]
            self._objs.append(raw[lo:hi])
        return True
