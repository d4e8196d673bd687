"""ctypes bindings to the port's native runtime: a background-threaded
``BinaryPage`` reader and libjpeg decoding.

The port's own copy of ``cxxnet_tpu/runtime/native.py`` over its own copy
of the C++ source, ``runtime/cxxnet_runtime.cc`` — the reference's native
IO stack (``iter_thread_imbin`` / ``thread_buffer`` / ``decoder``).  The
library is built at first use with ``g++ -O2 -std=c++17 -fPIC -shared
-pthread ... -ljpeg`` into ``runtime/_build/`` (git-ignored), rebuilt when
the source is newer.  Where ``jpeglib.h`` or ``libjpeg`` is missing the
page reader is built alone (``-DCXR_NO_JPEG``) and JPEG blobs decode with
PIL.  The JAX package's rules hold: the native path when built, PIL for
non-JPEG blobs, ``CXXNET_NO_NATIVE=1`` forces Python.  A failed build is
never silent: :func:`native_status` carries the compiler's message, and
the first failure is printed once on stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Iterator, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'cxxnet_runtime.cc')
LIBRARY = os.path.join(_HERE, '_build', 'libcxxnet_runtime.so')
#: the fixed page the C++ reader reads: 64 << 18 int32 words
PAGE_BYTES = (64 << 18) * 4

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_STATUS = {'built': False, 'jpeg': False, 'disabled': False, 'message': ''}


def _compile(extra) -> Optional[str]:
    """One g++ run into a per-process temp file renamed over the library;
    None on success, else the compiler's message."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f'{LIBRARY}.{os.getpid()}.tmp'
    cmd = ['g++', '-O2', '-std=c++17', '-fPIC', '-shared', '-pthread',
           '-o', tmp, SOURCE, *extra]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        return f'cannot run g++: {e}'
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f'{" ".join(cmd)} failed:\n{r.stderr.strip()}'
    os.replace(tmp, LIBRARY)
    return None


def build_library(force: bool = False) -> str:
    """Compile the library unless it is newer than its source; returns
    its path.  ``-ljpeg`` first; when that fails, the page reader alone
    (``-DCXR_NO_JPEG``), the compiler's message kept beside the library
    (``.log``) and in :func:`native_status`.  Raises ``RuntimeError``
    when neither builds."""
    log = LIBRARY + '.log'
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        if os.path.exists(log):
            with open(log) as f:
                _STATUS['message'] = f.read()
        return LIBRARY
    err = _compile(['-ljpeg'])
    if err is None:
        if os.path.exists(log):
            os.remove(log)
        return LIBRARY
    _STATUS['message'] = err
    err2 = _compile(['-DCXR_NO_JPEG'])
    if err2 is not None:
        raise RuntimeError(f'{err}\n{err2}')
    with open(log, 'w') as f:
        f.write(err)
    return LIBRARY


def _open_library(force: bool = False):
    lib = ctypes.CDLL(build_library(force))
    _bind(lib)
    return lib


def _bind(lib) -> None:
    lib.cxr_open.restype = ctypes.c_void_p
    lib.cxr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.cxr_open_order.restype = ctypes.c_void_p
    lib.cxr_open_order.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int]
    lib.cxr_next_page.restype = ctypes.c_int
    lib.cxr_next_page.argtypes = [ctypes.c_void_p]
    lib.cxr_get_obj.restype = ctypes.c_void_p
    lib.cxr_get_obj.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.cxr_close.argtypes = [ctypes.c_void_p]
    lib.cxr_has_jpeg.restype = ctypes.c_int
    lib.cxr_jpeg_decode.restype = ctypes.c_int
    lib.cxr_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get('CXXNET_NO_NATIVE') == '1':
            _STATUS['disabled'] = True
            _TRIED = True
            return None
        try:
            try:
                lib = _open_library()
            except (OSError, AttributeError):
                # a stale library (another machine's, an older source):
                # rebuilt once from the source here
                lib = _open_library(force=True)
        except (RuntimeError, OSError, AttributeError) as e:
            _STATUS['message'] = str(e)
            lib = None
        if lib is not None:
            _STATUS['built'] = True
            _STATUS['jpeg'] = bool(lib.cxr_has_jpeg())
        if _STATUS['message']:
            what = ('built without libjpeg (JPEG decodes with PIL)'
                    if lib is not None else
                    'not built (pages and JPEG through Python)')
            print(f'cxxnet_tpu_torch native runtime {what}: '
                  f'{_STATUS["message"]}', file=sys.stderr, flush=True)
        _LIB = lib
        _TRIED = True
        return lib


def native_status() -> dict:
    """``{'built', 'jpeg', 'disabled', 'message'}``: whether the library
    loaded, whether its JPEG decoder is compiled in, whether
    ``CXXNET_NO_NATIVE=1`` switched it off, and the compiler's message of
    a failed build (empty when the first build succeeded)."""
    _load()
    return dict(_STATUS)


def native_available() -> bool:
    return _load() is not None


#: JAX's name for the ordered reader's presence; the port's one library
#: always has it
native_order_available = native_available


class NativePageReader:
    """Iterates the blobs of a ``BinaryPage`` stream with C++-side
    prefetch.  ``order`` (a sequence of page indices) switches the reader
    thread to seek-based random access — the shuffled-epoch path — still
    prefetching ``prefetch_pages`` ahead."""

    def __init__(self, path: str, prefetch_pages: int = 2, order=None):
        lib = _load()
        if lib is None:
            raise RuntimeError('native runtime not available: '
                               f'{_STATUS["message"] or "disabled"}')
        self._lib = lib
        if order is not None:
            arr = np.ascontiguousarray(order, dtype=np.int64)
            self._h = lib.cxr_open_order(
                path.encode(),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(arr), prefetch_pages)
        else:
            self._h = lib.cxr_open(path.encode(), prefetch_pages)
        if not self._h:
            raise IOError(f'cannot open {path}')

    def iter_pages(self) -> Iterator[list]:
        """Yield each page's blobs as a list (page granularity is the unit
        of distributed sharding and shuffle)."""
        lib = self._lib
        while True:
            n = lib.cxr_next_page(self._h)
            if n == -2:
                raise RuntimeError('imgbin: truncated page (ordered read '
                                   'past end of .bin)')
            if n < 0:
                return
            page = []
            for r in range(n):
                size = ctypes.c_size_t()
                ptr = lib.cxr_get_obj(self._h, r, ctypes.byref(size))
                page.append(ctypes.string_at(ptr, size.value))
            yield page

    def __iter__(self) -> Iterator[bytes]:
        for page in self.iter_pages():
            yield from page

    def close(self) -> None:
        if self._h:
            self._lib.cxr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def decode_jpeg(blob: bytes) -> Optional[np.ndarray]:
    """Decode a JPEG blob to ``(h, w, 3)`` uint8 RGB via libjpeg; None if
    the native library or its decoder is unavailable, or the blob is not
    a decodable JPEG."""
    lib = _load()
    if lib is None or not _STATUS['jpeg']:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.cxr_jpeg_decode(blob, len(blob), None, 0,
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.cxr_jpeg_decode(blob, len(blob),
                             out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out
