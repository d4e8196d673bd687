"""Binary stream helpers of the model-file header.

The port's own copy of the stream half of ``cxxnet_tpu/utils/io_stream.py``
(``nnet/net_config.py`` reads and writes the header through it):
length-prefixed (uint64 little-endian) strings and POD vectors, matching
``IStream::Write``/``Read`` (``src/utils/io.h:43-100``), byte-compatible
with the reference's ``.model`` files; and ``open_maybe_gz``, which the
MNIST iterator reads its idx files through.  The ``BinaryPage`` dataset
format comes with the image iterators (ROADMAP.md queue A item 12).
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO

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
