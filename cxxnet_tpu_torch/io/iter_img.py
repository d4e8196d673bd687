"""Image-list source iterator (``src/io/iter_img-inl.hpp:16-135``).

The port's own copy of ``cxxnet_tpu/io/iter_img.py``.  Reads a ``.lst``
file (``index \\t label[ \\t label...] \\t filename``) and decodes one image
per instance through PIL (which replaces OpenCV), yielding ``(3, h, w)``
uint8 pixels; the augment stage owns the float32 conversion (host
normalize path) or defers it to the device (``device_normalize=1``).

``decode_image`` is the blob decoder of the binary-page sources, as the
JAX package's ``ImageBinIterator._decode``: the port's native libjpeg
(``runtime/native.py``) when it is built, PIL (``convert('RGB')``) for
non-JPEG blobs or without it, then HWC to CHW.  ``load_image_chw`` (the
``img`` source's files) reads with PIL, as JAX's does.
"""

from __future__ import annotations

import io
import os

import numpy as np

from .data import DataInst, IIterator


def _to_chw(im) -> np.ndarray:
    # uint8 through: the augment stage owns the float32 conversion
    arr = np.asarray(im.convert('RGB'), dtype=np.uint8)
    return np.transpose(arr, (2, 0, 1))          # (3, h, w)


def load_image_chw(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return _to_chw(im)


def decode_image(blob: bytes) -> np.ndarray:
    """An encoded image (JPEG, PNG, ...) to ``(3, h, w)`` uint8: native
    libjpeg first, PIL for what it does not decode."""
    from ..runtime.native import decode_jpeg
    arr = decode_jpeg(blob)
    if arr is not None:
        return np.transpose(arr, (2, 0, 1))
    from PIL import Image
    with Image.open(io.BytesIO(blob)) as im:
        return _to_chw(im)


def parse_lst_line(line: str):
    toks = line.strip().split('\t')
    if len(toks) < 3:
        toks = line.strip().split()
    index = int(float(toks[0]))
    labels = np.asarray([float(t) for t in toks[1:-1]], dtype=np.float32)
    fname = toks[-1]
    return index, labels, fname


class ImageIterator(IIterator):
    def __init__(self):
        self.path_imglist = ''
        self.image_root = ''
        self.label_width = 1
        self.silent = 0
        self._lines = []

    def set_param(self, name, val):
        if name in ('image_list', 'path_imglist'):
            self.path_imglist = val
        if name in ('image_root', 'path_imgdir'):
            self.image_root = val
        if name == 'label_width':
            self.label_width = int(val)
        if name == 'silent':
            self.silent = int(val)

    def init(self):
        if not self.path_imglist:
            raise ValueError('img iterator: must set image_list')
        with open(self.path_imglist) as f:
            self._lines = [parse_lst_line(ln) for ln in f if ln.strip()]
        if self.silent == 0:
            print(f'ImageIterator: {len(self._lines)} images in '
                  f'{self.path_imglist}')

    def __iter__(self):
        for index, labels, fname in self._lines:
            path = os.path.join(self.image_root, fname) \
                if self.image_root else fname
            yield DataInst(index, load_image_chw(path),
                           labels[:self.label_width]
                           if self.label_width else labels)
