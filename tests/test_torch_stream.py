"""The streaming imgbin source of ``cxxnet_tpu_torch`` (``iter =
imgbin_stream``, ``io/iter_stream.py``) against the JAX package's, on
the CPU.

* Files written by the port's ``append_records`` are byte for byte
  JAX's, page after page.
* While a writer appends to both packages' files, the port's stream
  yields JAX's stream's instances bitwise, and both a static ``imgbin``
  pass over the final bytes; passes fenced by ``stream_fence`` so the
  pass length never rides on the clock.  With 2 KB pages (both native
  readers off) and at the format's 64 MB pages with the port's native
  reader reading the appended pages by index.
* The snapshot pass, its replay and the grown replay; the refusals
  (``shuffle``, multi-part data, ``dist_num_worker > 1``); the
  incremental refresh reading only the appended pages' headers;
  ``scan_page_table(start_page=)``; the wait for late ``.lst`` lines and
  its failure.
* Through the augment + batch chain (``rand_crop``, ``rand_mirror``) at
  ``nworker`` 1 and 4: the port's batches equal JAX's and the static
  ``imgbin`` chain's.
"""

import io as _io
import os
import threading
import time

import numpy as np
import pytest

from cxxnet_tpu.io import iter_imbin as jimbin
from cxxnet_tpu.io import iter_stream as jstream
from cxxnet_tpu.io.data import create_iterator as jcreate
from cxxnet_tpu.utils import io_stream as jio
from cxxnet_tpu_torch.io import iter_imbin, iter_stream
from cxxnet_tpu_torch.io.data import create_iterator
from cxxnet_tpu_torch.utils import io_stream
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

JOIN_S = 60.0          # the bound on every thread a test starts


@pytest.fixture
def jax_python_pages(monkeypatch):
    """The JAX package reads pages through its Python ``BinaryPage`` (its
    native library is another build's)."""
    from cxxnet_tpu.runtime import native as jnative
    monkeypatch.setattr(jnative, 'native_available', lambda: False)
    monkeypatch.setattr(jnative, 'native_order_available', lambda: False)


@pytest.fixture
def small_pages(monkeypatch, jax_python_pages):
    """2 KB pages in both packages, so multi-page streams are test-sized;
    the port's native reader reads only the format's 64 MB pages, so it
    stands aside by itself."""
    for cls in (jio.BinaryPage, io_stream.BinaryPage):
        monkeypatch.setattr(cls, 'K_PAGE_SIZE', 512)
        monkeypatch.setattr(cls, 'N_BYTES', 512 * 4)


def _png(rng, size=6):
    from PIL import Image
    arr = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def _records(n, start=0, seed=0, size=6):
    rng = np.random.RandomState(seed + start)
    return [(i, [i % 4], _png(rng, size)) for i in range(start, start + n)]


def _paths(d):
    return str(d / 's.bin'), str(d / 's.lst')


def _stream(mod, d, **params):
    it = mod.ImageBinStreamIterator()
    binp, lst = _paths(d)
    it.set_param('image_list', lst)
    it.set_param('image_bin', binp)
    it.set_param('silent', '1')
    for k, v in params.items():
        it.set_param(k, str(v))
    it.init()
    return it


def _static(mod, d):
    it = mod.ImageBinIterator()
    binp, lst = _paths(d)
    it.set_param('image_list', lst)
    it.set_param('image_bin', binp)
    it.set_param('silent', '1')
    it.init()
    return it


def _insts(it):
    return [(inst.index, inst.data.tobytes(), inst.label.tobytes())
            for inst in it]


def _same_files(a, b):
    for x, y in zip(_paths(a), _paths(b)):
        with open(x, 'rb') as f, open(y, 'rb') as g:
            assert f.read() == g.read(), (x, y)


def _start(target):
    out = {}

    def run():
        try:
            out['value'] = target()
        except BaseException as e:  # noqa: BLE001 — re-raised in _join
            out['error'] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _join(t, out):
    t.join(JOIN_S)
    assert not t.is_alive(), f'thread still running after {JOIN_S} s'
    if 'error' in out:
        raise out['error']
    return out.get('value')


def _grow_both(tmp_path, recs, cuts, read_kw, gap=0.1):
    """The port's stream over ``tmp_path/t`` and JAX's over
    ``tmp_path/j`` while one writer appends ``recs`` to both in the
    slices ``cuts`` (the first before the readers start), the port's
    ``append_records`` to the port's file and JAX's to JAX's."""
    dt, dj = tmp_path / 't', tmp_path / 'j'
    dt.mkdir()
    dj.mkdir()
    bounds = [0, *cuts, len(recs)]

    def append(a, b):
        iter_stream.append_records(*_paths(dt), recs[a:b])
        jstream.append_records(*_paths(dj), recs[a:b])

    append(bounds[0], bounds[1])
    t_port = _start(lambda: _insts(_stream(iter_stream, dt, **read_kw)))
    t_jax = _start(lambda: _insts(_stream(jstream, dj, **read_kw)))
    for a, b in zip(bounds[1:], bounds[2:]):
        time.sleep(gap)
        append(a, b)
    return dt, dj, _join(*t_port), _join(*t_jax)


def test_append_records_bytes_equal_jax(tmp_path, small_pages):
    """Record after record, page after page (the helper starts a new page
    when one is full, and pads the last): the port's files are JAX's."""
    recs = _records(25, size=10)
    for sub, mod in (('t', iter_stream), ('j', jstream)):
        d = tmp_path / sub
        d.mkdir()
        assert mod.append_records(*_paths(d), recs[:9]) == 9
        assert mod.append_records(*_paths(d), []) == 0
        assert mod.append_records(*_paths(d),
                                  [(i, [i % 4, 0.5], b) for i, _, b
                                   in recs[9:]]) == 16
    _same_files(tmp_path / 't', tmp_path / 'j')
    assert len(iter_imbin.scan_page_table(_paths(tmp_path / 't')[0])) >= 3


def test_stream_bitwise_jax_while_growing(tmp_path, small_pages):
    """The acceptance property: tailing the file WHILE a writer appends,
    the port's stream yields JAX's instances and a static pass's over
    the final bytes."""
    recs = _records(30)
    dt, dj, got, want = _grow_both(
        tmp_path, recs, (10, 22), dict(stream_fence=30, stream_poll=0.02))
    _same_files(dt, dj)
    assert [i for i, _, _ in got] == list(range(30))
    assert got == want
    assert got == _insts(_static(iter_imbin, dt))
    assert want == _insts(_static(jimbin, dj))


def test_stream_native_reader_at_format_pages(tmp_path, monkeypatch,
                                              jax_python_pages):
    """At the format's 64 MB pages the port reads the appended pages with
    its native reader, by page index (``order=``), never re-reading a
    consumed page — and still yields JAX's bytes."""
    from cxxnet_tpu_torch.runtime import native
    if not native.native_available():
        pytest.skip(f'native runtime not built: {native.native_status()}')
    orders = []
    real = native.NativePageReader

    def spy(path, prefetch_pages=2, order=None):
        orders.append(None if order is None else list(order))
        return real(path, prefetch_pages, order=order)

    monkeypatch.setattr(native, 'NativePageReader', spy)
    recs = _records(9, size=8)
    dt, dj, got, want = _grow_both(
        tmp_path, recs, (4, 7), dict(stream_fence=9, stream_poll=0.02))
    assert os.path.getsize(_paths(dt)[0]) == 3 * io_stream.BinaryPage.N_BYTES
    _same_files(dt, dj)
    assert got == want == _insts(_static(jimbin, dj))
    assert [i for i, _, _ in got] == list(range(9))
    # every read went through the native reader by index, each page once
    assert orders and None not in orders
    assert sorted(p for o in orders for p in o) == [0, 1, 2]


def test_stream_fence_cuts_the_last_page(tmp_path, small_pages):
    """``stream_fence`` ends the pass after exactly that many instances,
    in mid-page, in both packages."""
    recs = _records(20, size=10)
    for sub, mod in (('t', iter_stream), ('j', jstream)):
        d = tmp_path / sub
        d.mkdir()
        mod.append_records(*_paths(d), recs)
    got = _insts(_stream(iter_stream, tmp_path / 't', stream_fence=13))
    assert got == _insts(_stream(jstream, tmp_path / 'j', stream_fence=13))
    assert [i for i, _, _ in got] == list(range(13))


def test_stream_snapshot_pass_replay_stable(tmp_path, small_pages):
    """``stream_idle=0``: one pass over the current bytes; a replay yields
    the same prefix, the source says it is replay-stable, and a pass
    after growth sees the tail — as JAX's does."""
    seen = {}
    for sub, mod in (('t', iter_stream), ('j', jstream)):
        d = tmp_path / sub
        d.mkdir()
        mod.append_records(*_paths(d), _records(12))
        it = _stream(mod, d)
        assert it.is_replay_stable()
        first = _insts(it)
        assert [i for i, _, _ in first] == list(range(12))
        assert _insts(it) == first
        mod.append_records(*_paths(d), _records(8, start=12))
        grown = _insts(it)
        assert grown[:12] == first
        assert [i for i, _, _ in grown] == list(range(20))
        seen[sub] = (first, grown)
    assert seen['t'] == seen['j']


@pytest.mark.parametrize('key,val,match', [
    ('shuffle', '1', 'shuffle'),
    ('image_conf_prefix', 'part%d', 'ONE appendable file'),
    ('dist_num_worker', '2', 'single-tail'),
])
def test_stream_refusals(tmp_path, key, val, match):
    for mod in (iter_stream, jstream):
        it = mod.ImageBinStreamIterator()
        it.set_param('image_list', str(tmp_path / 's.lst'))
        it.set_param('image_bin', str(tmp_path / 's.bin'))
        it.set_param(key, val if key != 'image_conf_prefix'
                     else str(tmp_path / val))
        it.set_param('image_conf_ids', '0-1')
        with pytest.raises(ValueError, match=match):
            it.init()


def test_stream_incremental_refresh_reads_only_tail(tmp_path, small_pages,
                                                    monkeypatch):
    """Catching up after growth header-scans ONLY the appended pages
    (``scan_page_table`` from the pages already indexed on) and never
    yields a consumed instance twice; the grown pass equals JAX's."""
    d = tmp_path / 't'
    d.mkdir()
    iter_stream.append_records(*_paths(d), _records(20, size=10))
    calls = []
    real = iter_imbin.scan_page_table

    def spy(path, start_page=0):
        calls.append(start_page)
        return real(path, start_page)

    monkeypatch.setattr(iter_imbin, 'scan_page_table', spy)
    it = _stream(iter_stream, d)
    first = _insts(it)
    pages0 = len(it._tables[0][0])
    assert pages0 >= 2
    assert calls and calls[0] == 0
    iter_stream.append_records(*_paths(d), _records(15, start=20, size=10))
    calls.clear()
    second = _insts(it)
    assert calls and min(calls) >= pages0
    assert [i for i, _, _ in second] == list(range(35))
    assert second == _insts(_static(jimbin, d))
    assert second[:20] == first


def test_scan_page_table_start_page(tmp_path, small_pages):
    """``start_page`` returns the tail of the full scan, as JAX's does."""
    binp, lst = _paths(tmp_path)
    iter_stream.append_records(binp, lst, _records(20, size=10))
    full = iter_imbin.scan_page_table(binp)
    assert full == jimbin.scan_page_table(binp)
    assert len(full) >= 3
    for start in (0, 1, len(full) - 1, len(full), len(full) + 2):
        assert iter_imbin.scan_page_table(binp, start_page=start) == \
            jimbin.scan_page_table(binp, start_page=start) == full[start:]
    # a page the writer has not finished is not reported
    with open(binp, 'ab') as f:
        f.write(b'\0' * 100)
    assert iter_imbin.scan_page_table(binp) == full


def test_stream_waits_for_lst_lines(tmp_path, small_pages):
    """A page seen before its ``.lst`` lines (a writer that broke the
    lines-first order) is held back until the lines land, in both
    packages; past the grace it fails as the static reader does."""
    recs = _records(6)
    for sub in ('t', 'j'):
        d = tmp_path / sub
        d.mkdir()
        iter_stream.append_records(*_paths(d), recs[:3])
        page = io_stream.BinaryPage()
        for _i, _l, blob in recs[3:]:
            assert page.push(blob)
        with open(_paths(d)[0], 'ab') as f:
            page.save(f)
    gate = threading.Event()

    def late_lines():
        gate.wait(JOIN_S)
        time.sleep(0.1)
        for sub in ('t', 'j'):
            with open(_paths(tmp_path / sub)[1], 'a') as f:
                for i, labels, _b in recs[3:]:
                    f.write(f'{i}\t{labels[0]}\tstream\n')

    writer = _start(late_lines)
    kw = dict(stream_poll=0.02, stream_idle=5.0, stream_fence=6)
    t_port = _start(lambda: _insts(_stream(iter_stream, tmp_path / 't',
                                           **kw)))
    t_jax = _start(lambda: _insts(_stream(jstream, tmp_path / 'j', **kw)))
    gate.set()
    _join(*writer)
    got, want = _join(*t_port), _join(*t_jax)
    assert [i for i, _, _ in got] == list(range(6))
    assert got == want
    # no lines ever: the grace ends in the static reader's error
    d = tmp_path / 'n'
    d.mkdir()
    with open(_paths(d)[0], 'wb') as f:
        page.save(f)
    open(_paths(d)[1], 'w').close()
    with pytest.raises(RuntimeError, match='.lst shorter than .bin'):
        _insts(_stream(iter_stream, d, stream_poll=0.01))


def _chain(create, source, binp, lst, nworker):
    cfg = [('iter', source), ('image_list', lst), ('image_bin', binp),
           ('rand_crop', '1'), ('rand_mirror', '1'),
           ('input_shape', '3,8,8'), ('batch_size', '8'),
           ('round_batch', '1'), ('silent', '1'),
           ('iter', 'threadbuffer'), ('nworker', str(nworker))]
    it = create(cfg)
    it.init()
    try:
        return [(b.data.tobytes(), b.label.tobytes(),
                 b.inst_index.tobytes(), b.num_batch_padd) for b in it]
    finally:
        it.close(timeout=5.0)


def test_stream_through_chain_matches_jax_and_static(tmp_path, small_pages):
    """Through the augment + batch chain (the trainer's view) the stream's
    batches are JAX's stream's and static ``imgbin``'s — the per-instance
    augmentation draws (epoch-absolute index) and the ``nworker`` pool
    included."""
    binp, lst = _paths(tmp_path)
    iter_stream.append_records(binp, lst, _records(37, size=12))
    static = _chain(create_iterator, 'imgbin', binp, lst, 1)
    assert len(static) == 5
    assert _chain(jcreate, 'imgbin_stream', binp, lst, 1) == static
    assert _chain(create_iterator, 'imgbin_stream', binp, lst, 1) == static
    assert _chain(create_iterator, 'imgbin_stream', binp, lst, 4) == static
