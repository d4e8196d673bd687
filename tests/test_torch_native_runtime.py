"""The native runtime of ``cxxnet_tpu_torch`` (``runtime/native.py`` over
the port's own ``runtime/cxxnet_runtime.cc``) on the CPU, against the JAX
package's native runtime (``runtime/libcxxnet_runtime.so``, built here).

* The page reader and the ordered (seeking) reader give the records of
  JAX's native reader and of the Python ``BinaryPage`` parser; an empty
  order reads nothing, an index past the end raises.
* ``decode_jpeg`` is bitwise JAX's native decode (RGB, grayscale, odd
  sizes, qualities); garbage and PNG give None.
* The imgbin chain takes the native reader and decoder when built and
  the pages are the format's 64 MB (not for the tests' small pages);
  ``CXXNET_NO_NATIVE=1`` forces Python.
* A failed build is said: without ``jpeglib.h`` the page reader builds
  alone and the compiler's message is kept and printed once; a source
  that does not build at all leaves the Python path, message kept.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu.runtime import native as jnative
from cxxnet_tpu_torch.runtime import native
from cxxnet_tpu_torch.utils.io_stream import BinaryPage

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_bin(tmp_path, pages, name='x.bin'):
    path = tmp_path / name
    with open(path, 'wb') as f:
        for blobs in pages:
            page = BinaryPage()
            for b in blobs:
                assert page.push(b)
            page.save(f)
    return str(path)


def _jpeg(arr, quality=95, mode=None):
    from PIL import Image
    buf = io.BytesIO()
    im = Image.fromarray(arr)
    if mode:
        im = im.convert(mode)
    im.save(buf, format='JPEG', quality=quality)
    return buf.getvalue()


def test_native_built_here_with_libjpeg():
    st = native.native_status()
    assert st['built'] and st['jpeg'] and not st['disabled']
    assert st['message'] == ''
    assert native.native_available() and native.native_order_available()
    assert jnative.native_available()


def _read(reader):
    try:
        return list(reader.iter_pages())
    finally:
        reader.close()


def test_page_reader_matches_jax_and_python(tmp_path):
    pages = [[b'a', b'bb' * 100, b''], [os.urandom(5000)],
             [bytes([i]) * (i + 1) for i in range(40)]]
    path = make_bin(tmp_path, pages)
    got = _read(native.NativePageReader(path))
    assert got == _read(jnative.NativePageReader(path)) == pages
    with open(path, 'rb') as f:
        py = []
        while True:
            page = BinaryPage()
            if not page.load(f):
                break
            py.append(list(page))
    assert py == got
    assert list(native.NativePageReader(path)) == \
        [b for page in pages for b in page]


@pytest.mark.parametrize('order', [[2, 0, 1, 0], [1], [0, 1, 2]])
def test_ordered_reader_matches_jax(tmp_path, order):
    pages = [[b'page0-a', b'page0-b'], [b'page1-a'], [b'page2-a', b'x' * 999]]
    path = make_bin(tmp_path, pages)
    got = _read(native.NativePageReader(path, order=order))
    assert got == _read(jnative.NativePageReader(path, order=order))
    assert got == [pages[i] for i in order]


def test_ordered_reader_edge_cases(tmp_path):
    path = make_bin(tmp_path, [[b'p0'], [b'p1']])
    assert _read(native.NativePageReader(path, order=[])) == []
    reader = native.NativePageReader(path, order=[0, 7])
    with pytest.raises(RuntimeError, match='truncated'):
        list(reader.iter_pages())
    reader.close()
    with pytest.raises(IOError):
        native.NativePageReader(str(tmp_path / 'absent.bin'))


@pytest.mark.parametrize('shape,quality,mode', [
    ((32, 48, 3), 95, None), ((17, 23, 3), 75, None),
    ((256, 256, 3), 90, None), ((40, 30, 3), 90, 'L')])
def test_decode_jpeg_bitwise_jax_native(shape, quality, mode):
    arr = np.random.RandomState(sum(shape)).randint(0, 255, shape).astype(
        np.uint8)
    blob = _jpeg(arr, quality, mode)
    got = native.decode_jpeg(blob)
    want = jnative.decode_jpeg(blob)
    assert got is not None and got.dtype == np.uint8
    assert got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)


def test_decode_rejects_garbage_and_png():
    from PIL import Image
    assert native.decode_jpeg(b'not a jpeg at all') is None
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format='PNG')
    assert native.decode_jpeg(buf.getvalue()) is None


def test_decode_image_native_first_pil_for_png():
    """``iter_img.decode_image`` is JAX's ``ImageBinIterator._decode``:
    libjpeg for a JPEG, PIL for a PNG, CHW uint8 either way."""
    from PIL import Image
    from cxxnet_tpu.io.iter_imbin import ImageBinIterator as JBin
    from cxxnet_tpu_torch.io.iter_img import decode_image
    arr = np.random.RandomState(3).randint(0, 255, (21, 19, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    for blob in (_jpeg(arr, 90), buf.getvalue()):
        got = decode_image(blob)
        assert got.shape == (3, 21, 19)
        np.testing.assert_array_equal(got, JBin()._decode(blob))


def _imgbin_pages(tmp_path, n=7):
    lst = tmp_path / 'a.lst'
    page = BinaryPage()
    rng = np.random.RandomState(1)
    with open(lst, 'w') as f:
        for i in range(n):
            arr = rng.randint(0, 255, (20, 20, 3)).astype(np.uint8)
            assert page.push(_jpeg(arr))
            f.write(f'{i}\t{i % 3}\tim{i}.jpg\n')
    with open(tmp_path / 'a.bin', 'wb') as f:
        page.save(f)
    return [('image_list', str(lst)), ('image_bin', str(tmp_path / 'a.bin')),
            ('input_shape', '3,20,20'), ('batch_size', '3'),
            ('silent', '1')]


@pytest.mark.parametrize('kind', ['imgbin', 'imgbinx'])
@pytest.mark.parametrize('shuffle', ['0', '1'])
def test_imgbin_chain_uses_native_and_equals_jax(tmp_path, monkeypatch,
                                                 kind, shuffle):
    from cxxnet_tpu.io.data import create_iterator as jcreate
    from cxxnet_tpu_torch.io.data import create_iterator as tcreate
    opened = []
    real = native.NativePageReader

    def counting(*a, **k):
        opened.append(k.get('order'))
        return real(*a, **k)

    monkeypatch.setattr(native, 'NativePageReader', counting)
    cfg = [('iter', kind)] + _imgbin_pages(tmp_path) + [
        ('shuffle', shuffle), ('iter', 'end')]
    out = []
    for create in (jcreate, tcreate):
        it = create(cfg)
        it.init()
        try:
            out.append([(b.data.copy(), b.label.copy(), b.inst_index.copy())
                        for b in it])
        finally:
            getattr(it, 'close', lambda _t: None)(5.0)
    assert len(opened) == 1
    assert (opened[0] is None) == (shuffle == '0')
    assert len(out[0]) == len(out[1]) == 3
    for j, t in zip(*out):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)


def test_small_pages_take_the_python_reader(tmp_path, monkeypatch):
    from cxxnet_tpu_torch.io.iter_imbin import ImageBinIterator
    monkeypatch.setattr(BinaryPage, 'K_PAGE_SIZE', 512)
    monkeypatch.setattr(BinaryPage, 'N_BYTES', 512 * 4)
    path = make_bin(tmp_path, [[b'a' * 100], [b'b' * 200, b'c']])
    monkeypatch.setattr(native, 'NativePageReader', None)
    it = ImageBinIterator()
    assert it._native() is None
    assert list(it._iter_pages(path)) == [[b'a' * 100], [b'b' * 200, b'c']]


def _python(code, **env):
    return subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT, **env),
                          timeout=300)


def test_no_native_env_forces_python():
    r = _python('from cxxnet_tpu_torch.runtime import native as n\n'
                'print(n.native_status(), n.native_available(), '
                'n.decode_jpeg(b"x"))', CXXNET_NO_NATIVE='1')
    assert r.returncode == 0, r.stderr
    assert "'disabled': True" in r.stdout and 'False None' in r.stdout


SIMULATED = '''
import os, sys
from cxxnet_tpu_torch.runtime import native as n
src = open(n.SOURCE).read()
tmp = sys.argv[1]
n.SOURCE = os.path.join(tmp, 'cxxnet_runtime.cc')
n.LIBRARY = os.path.join(tmp, '_build', 'libcxxnet_runtime.so')
open(n.SOURCE, 'w').write(src.replace(sys.argv[2], sys.argv[3]))
st = n.native_status()
n.native_status()
print(st['built'], st['jpeg'], 'MSG', st['message'].splitlines()[-3:])
'''


def test_build_without_jpeglib_is_said(tmp_path):
    """The card's machine has no ``jpeglib.h``: simulated by a source that
    names a missing header, the page reader builds alone, JPEG decodes
    fall to PIL, and the compiler's message is kept and printed once."""
    r = subprocess.run(
        [sys.executable, '-c', SIMULATED, str(tmp_path), '<jpeglib.h>',
         '<jpeglib_absent.h>'], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith('True False MSG')
    assert 'jpeglib_absent.h' in r.stdout
    assert r.stderr.count('built without libjpeg') == 1
    assert os.path.exists(tmp_path / '_build' / 'libcxxnet_runtime.so.log')


def test_failed_build_is_said_and_python_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, '-c', SIMULATED + (
            'print(n.native_available(), n.decode_jpeg(b"x"))\n'),
         str(tmp_path), '#include <cstdint>',
         '#include <cstdint>\n#error no compiler today'],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith('False False MSG')
    assert 'no compiler today' in r.stdout
    assert 'False None' in r.stdout
    assert r.stderr.count('not built') == 1
