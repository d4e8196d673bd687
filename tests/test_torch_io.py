"""The port's image data chain against the JAX package's, on the CPU, on
the same files.

Images are made from a seed with numpy (four quadrant classes plus
noise, 20 x 20 and 24 x 24) and written with PIL; ``.bin`` files are
packed by the port's ``im2bin`` over 512-int pages, set on both packages'
``BinaryPage`` classes.  Both packages' native page readers and libjpeg
are switched off (their module attributes are monkeypatched), so both
decode through PIL (the native paths' own case packs 64 MB pages of JPEG
files and holds the port's native chain against JAX's):

* ``BinaryPage`` files written by either package read in the other,
  byte-identical; ``python -m cxxnet_tpu_torch.io.im2bin`` writes
  ``tools/im2bin.py``'s bytes;
* instance streams of ``img``, ``imgbin`` and ``imgbinx`` over two
  epochs — ``index``, pixels and labels bitwise: ``shuffle`` 0 / 1, two
  parts through ``image_conf_prefix``, ``dist_num_worker = 2`` at ranks
  0 and 1 (and ``PS_RANK``), ``decode_threads`` 1 / 4;
* batches bitwise (data and its dtype, labels, ``inst_index``,
  ``num_batch_padd``, ``pad_synthetic``, the ``NormSpec``) for each
  augmentation option, the mean image (its file's bytes too), the
  serial and pooled paths, ``elastic_hosts``, ``round_batch`` and
  ``test_skipread``, ``label_width``, and JPEG files;
* ``OrderedWorkerPool``'s contract;
* ``device_normalize = 1`` through a port ``NetTrainer`` against the
  host-normalized chain and against the JAX trainer;
* the CLI on a tiny imgbin conf against the JAX CLI;
* the fixture digest ``chip_smoke.py`` re-checks on the card's host.
"""

import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.io import iter_imbin as jimbin
from cxxnet_tpu.io import iter_img as jimg
from cxxnet_tpu.utils.io_stream import BinaryPage as JPage
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.io import im2bin as tim2bin
from cxxnet_tpu_torch.io import iter_imbin as timbin
from cxxnet_tpu_torch.io import iter_img as timg
from cxxnet_tpu_torch.utils.io_stream import BinaryPage as TPage
from cxxnet_tpu_torch.utils.parallel_pool import OrderedWorkerPool

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {'jax': (jdata, jimbin, jimg), 'torch': (tdata, timbin, timg)}


@pytest.fixture
def small_pages(monkeypatch):
    """512-int pages on both packages' ``BinaryPage``; both packages'
    native readers and libjpeg off (PIL decodes in both)."""
    for cls in (JPage, TPage):
        monkeypatch.setattr(cls, 'K_PAGE_SIZE', 512)
        monkeypatch.setattr(cls, 'N_BYTES', 512 * 4)
    from cxxnet_tpu.runtime import native
    from cxxnet_tpu_torch.runtime import native as tnative
    for mod in (native, tnative):
        monkeypatch.setattr(mod, 'native_available', lambda: False)
        monkeypatch.setattr(mod, 'native_order_available', lambda: False)
        monkeypatch.setattr(mod, 'decode_jpeg', lambda blob: None)


def _image(rng, label, size):
    arr = rng.randint(0, 48, (size, size, 3)).astype(np.uint8)
    h = size // 2
    y0, x0 = (label // 2) * h, (label % 2) * h
    arr[y0:y0 + h, x0:x0 + h] += np.uint8(60 + 40 * label)
    return arr


def _write_images(d, stem, n, size=20, seed=1, fmt='PNG', labels=1):
    """``n`` images as files under ``d`` and their ``.lst``; returns the
    list's path."""
    rng = np.random.RandomState(seed)
    lst = os.path.join(d, f'{stem}.lst')
    ext = 'png' if fmt == 'PNG' else 'jpg'
    with open(lst, 'w') as f:
        for i in range(n):
            c = int(rng.randint(0, 4))
            name = f'{stem}_{i}.{ext}'
            kw = {'quality': 90} if fmt == 'JPEG' else {}
            Image.fromarray(_image(rng, c, size)).save(
                os.path.join(d, name), format=fmt, **kw)
            extra = ''.join(f'\t{(c + k) % 3}' for k in range(1, labels))
            f.write(f'{i}\t{c}{extra}\t{name}\n')
    return lst


def _pack(d, stem, **kw):
    """Images, their ``.lst`` and the ``.bin`` the port's im2bin packs."""
    lst = _write_images(d, stem, **kw)
    binp = os.path.join(d, f'{stem}.bin')
    assert tim2bin.main([lst, d, binp]) == 0
    return lst, binp


@pytest.fixture
def dataset(tmp_path, small_pages):
    d = str(tmp_path)
    lst, binp = _pack(d, 'train', n=23)
    return {'dir': d, 'lst': lst, 'bin': binp}


def _close(it):
    close = getattr(it, 'close', None)
    if close is not None:
        close(5.0)


def _batches(pkg, cfg, epochs=2, limit=None):
    it = PKGS[pkg][0].create_iterator(cfg)
    it.init()
    try:
        return [list(itertools.islice(it, limit)) for _ in range(epochs)]
    finally:
        _close(it)


def _assert_same_batches(jb, tb):
    assert [len(e) for e in jb] == [len(e) for e in tb]
    for je, te in zip(jb, tb):
        for a, b in zip(je, te):
            assert a.data.dtype == b.data.dtype
            np.testing.assert_array_equal(b.data, a.data)
            np.testing.assert_array_equal(b.label, a.label)
            np.testing.assert_array_equal(b.inst_index, a.inst_index)
            assert (b.num_batch_padd, b.pad_synthetic) == \
                (a.num_batch_padd, a.pad_synthetic)
            assert (a.norm_spec is None) == (b.norm_spec is None)
            if a.norm_spec is not None:
                for f in ('mean_img', 'mean_vals'):
                    x, y = getattr(a.norm_spec, f), getattr(b.norm_spec, f)
                    assert (x is None) == (y is None), f
                    if x is not None:
                        np.testing.assert_array_equal(y, x)
                assert b.norm_spec.scale == a.norm_spec.scale


def _base(ds, source='imgbin', shape='3,16,16', bs=5):
    cfg = [('iter', source), ('image_list', ds['lst'])]
    cfg += [('image_root', ds['dir'])] if source == 'img' \
        else [('image_bin', ds['bin'])]
    return cfg + [('input_shape', shape), ('batch_size', str(bs)),
                  ('silent', '1')]


def _compare(ds, cfg, **kw):
    jb = _batches('jax', cfg, **kw)
    tb = _batches('torch', cfg, **kw)
    _assert_same_batches(jb, tb)
    return tb


# --- BinaryPage and im2bin ----------------------------------------------------

def test_binary_page_files_cross_read(tmp_path, small_pages):
    blobs = [b'hello', b'x' * 700, b'', bytes(range(256)) * 2]
    files = {}
    for tag, cls in (('jax', JPage), ('torch', TPage)):
        page = cls()
        for b in blobs:
            assert page.push(b)
        assert not page.push(b'y' * 2048)
        files[tag] = str(tmp_path / f'{tag}.bin')
        with open(files[tag], 'wb') as f:
            page.save(f)
    raw = [open(p, 'rb').read() for p in files.values()]
    assert raw[0] == raw[1] and len(raw[0]) == 2048
    for reader, path in ((JPage, files['torch']), (TPage, files['jax'])):
        page = reader()
        with open(path, 'rb') as f:
            assert page.load(f)
            assert not reader().load(f)
        assert list(page) == blobs and page.size == len(blobs)


def test_im2bin_twin_writes_the_tools_bytes(tmp_path):
    d = str(tmp_path)
    lst = _write_images(d, 'p', n=5, size=24)
    outs = []
    for cmd in ([sys.executable, os.path.join(ROOT, 'tools', 'im2bin.py')],
                [sys.executable, '-m', 'cxxnet_tpu_torch.io.im2bin']):
        out = os.path.join(d, f'{len(outs)}.bin')
        subprocess.run(cmd + [lst, d, out], cwd=ROOT, check=True,
                       capture_output=True, timeout=120)
        outs.append(open(out, 'rb').read())
    assert outs[0] == outs[1] and len(outs[0]) == TPage.N_BYTES


# --- instance streams ---------------------------------------------------------

def _source(pkg, kind, params):
    _, imbin, img = PKGS[pkg]
    src = {'img': img.ImageIterator, 'imgbin': imbin.ImageBinIterator,
           'imgbinx': imbin.ImageBinXIterator}[kind]()
    for k, v in params:
        src.set_param(k, v)
    src.init()
    return [[(i.index, i.data, i.label) for i in src] for _ in range(2)]


@pytest.fixture
def parts(tmp_path, small_pages):
    d = str(tmp_path)
    for p in range(2):
        _pack(d, f'part{p}', n=9 + 4 * p, seed=10 + p)
    return os.path.join(d, 'part%d')


STREAMS = [
    ('img', ()), ('imgbin', ()), ('imgbin', (('shuffle', '1'),)),
    ('imgbinx', (('decode_threads', '1'),)),
    ('imgbinx', (('shuffle', '1'), ('decode_threads', '4'))),
    ('imgbin', (('dist_num_worker', '2'), ('dist_worker_rank', '0'))),
    ('imgbin', (('dist_num_worker', '2'), ('dist_worker_rank', '1'),
                ('shuffle', '1'))),
    ('imgbinx', (('dist_num_worker', '2'), ('dist_worker_rank', '1'))),
    ('imgbin', (('dist_num_worker', '2'), ('PS_RANK', '1'))),
]


@pytest.mark.parametrize('kind,params', STREAMS)
def test_instance_streams_match_jax(dataset, monkeypatch, kind, params):
    params = list(params)
    for k, v in params:
        if k == 'PS_RANK':
            monkeypatch.setenv('PS_RANK', v)
    params = [p for p in params if p[0] != 'PS_RANK']
    params += [('image_list', dataset['lst']), ('silent', '1'),
               ('seed_data', '3')]
    params += [('image_root', dataset['dir'])] if kind == 'img' \
        else [('image_bin', dataset['bin'])]
    want = _source('jax', kind, params)
    got = _source('torch', kind, params)
    assert [len(e) for e in got] == [len(e) for e in want]
    for we, ge in zip(want, got):
        for (wi, wd, wl), (gi, gd, gl) in zip(we, ge):
            assert gi == wi and gd.dtype == wd.dtype == np.uint8
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
    if ('shuffle', '1') in params:
        assert [i for i, _, _ in got[0]] != [i for i, _, _ in got[1]]


@pytest.mark.parametrize('kind', ['imgbin', 'imgbinx'])
@pytest.mark.parametrize('extra', [(), (('shuffle', '1'),),
                                   (('dist_num_worker', '2'),
                                    ('dist_worker_rank', '1'))])
def test_multi_part_streams_match_jax(parts, kind, extra):
    params = [('image_conf_prefix', parts), ('image_conf_ids', '0-1'),
              ('silent', '1')] + list(extra)
    want = _source('jax', kind, params)
    got = _source('torch', kind, params)
    assert [[i for i, _, _ in e] for e in got] == \
        [[i for i, _, _ in e] for e in want]
    for we, ge in zip(want, got):
        for (_, wd, wl), (_, gd, gl) in zip(we, ge):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)


def test_lst_shorter_than_bin_raises(dataset):
    with open(dataset['lst']) as f:
        lines = f.readlines()
    with open(dataset['lst'], 'w') as f:
        f.writelines(lines[:10])
    for shuffle in ('0', '1'):
        with pytest.raises(RuntimeError, match='.lst shorter than .bin'):
            _source('torch', 'imgbin', [
                ('image_list', dataset['lst']),
                ('image_bin', dataset['bin']), ('shuffle', shuffle),
                ('silent', '1')])


# --- batches ------------------------------------------------------------------

BATCHES = {
    'crop_mirror_shuffle': ('imgbin', [('rand_crop', '1'),
                                       ('rand_mirror', '1'),
                                       ('shuffle', '1')]),
    'mirror_crop_start': ('img', [('mirror', '1'), ('crop_y_start', '1'),
                                  ('crop_x_start', '3')]),
    'mean_value_divideby': ('imgbinx', [('mean_value', '120,110,100'),
                                        ('divideby', '256')]),
    'contrast_illumination': ('imgbin', [('max_random_contrast', '0.3'),
                                         ('max_random_illumination', '10'),
                                         ('rand_crop', '1')]),
    'affine': ('imgbin', [('max_rotate_angle', '15'),
                          ('max_shear_ratio', '0.1'),
                          ('min_random_scale', '0.9'),
                          ('max_random_scale', '1.2'),
                          ('max_aspect_ratio', '0.1'), ('rand_crop', '1')]),
    'rotate_list': ('imgbin', [('rotate_list', '0,90,180'),
                               ('fill_value', '128')]),
    'flat_scale': ('imgbin', [('scale', '0.5')]),
    'round_batch_1': ('imgbin', [('round_batch', '1'), ('shuffle', '1')]),
    'round_batch_0_threadbuffer': ('imgbinx', [('round_batch', '0'),
                                               ('iter', 'threadbuffer')]),
    'pooled_1': ('imgbin', [('nworker', '1'), ('rand_crop', '1'),
                            ('rand_mirror', '1'),
                            ('max_random_contrast', '0.2')]),
    'pooled_3_affine': ('imgbinx', [('nworker', '3'),
                                    ('max_rotate_angle', '10'),
                                    ('rand_crop', '1'), ('shuffle', '1'),
                                    ('iter', 'threadbuffer')]),
    'device_normalize_mean_value': ('imgbin', [('device_normalize', '1'),
                                               ('mean_value', '100,90,80'),
                                               ('divideby', '64'),
                                               ('rand_crop', '1')]),
    'device_normalize_pooled': ('imgbin', [('device_normalize', '1'),
                                           ('nworker', '2'),
                                           ('scale', '0.25')]),
    'device_normalize_with_contrast': ('imgbin', [
        ('device_normalize', '1'), ('max_random_contrast', '0.2')]),
    'device_normalize_affine': ('imgbin', [('device_normalize', '1'),
                                           ('max_rotate_angle', '20')]),
}


@pytest.mark.parametrize('name', sorted(BATCHES))
def test_batches_match_jax(dataset, name):
    source, extra = BATCHES[name]
    shape = '1,1,1200' if name == 'flat_scale' else '3,16,16'
    cfg = _base(dataset, source, shape) + [('seed_data', '5')] + extra
    got = _compare(dataset, cfg)
    pads = [b.num_batch_padd for b in got[0]]
    assert pads == [0, 0, 0, 0, 2]
    assert got[0][-1].pad_synthetic == ('round_batch_1' != name)
    dev_norm = name.startswith('device_normalize') and 'contrast' not in name
    assert (got[0][0].norm_spec is not None) == dev_norm
    if dev_norm:
        assert got[0][0].data.dtype == (np.float32 if 'affine' in name
                                         else np.uint8)


def test_test_skipread_matches_jax(dataset):
    cfg = _base(dataset) + [('test_skipread', '1'), ('rand_crop', '1')]
    got = _compare(dataset, cfg, limit=6)
    # the second pass re-serves the first batch
    assert all(b is got[1][0] for b in got[1])


def test_label_width_matches_jax(tmp_path, small_pages):
    d = str(tmp_path)
    lst, binp = _pack(d, 'lw', n=11, labels=3)
    ds = {'dir': d, 'lst': lst, 'bin': binp}
    got = _compare(ds, _base(ds, bs=4) + [('label_width', '3')])
    assert got[0][0].label.shape == (4, 3)


def test_pooled_paths_equal_for_any_worker_count(dataset):
    cfg = _base(dataset) + [('rand_crop', '1'), ('rand_mirror', '1'),
                            ('max_random_illumination', '5')]
    runs = [_batches('torch', cfg + [('nworker', n)]) for n in ('1', '3')]
    _assert_same_batches(*runs)
    _assert_same_batches(_batches('jax', cfg + [('nworker', '2')]), runs[0])


def test_elastic_hosts_match_jax_and_interleave(dataset):
    cfg = _base(dataset, bs=1) + [('rand_crop', '1'), ('nworker', '2')]
    whole = _batches('torch', cfg, epochs=1)[0]
    shards = [_compare(dataset, cfg + [('elastic_hosts', '2'),
                                       ('elastic_rank', str(r))])[0]
              for r in (0, 1)]
    joined = [b for pair in itertools.zip_longest(*shards) for b in pair
              if b is not None]
    assert [int(b.inst_index[0]) for b in joined] == \
        [int(b.inst_index[0]) for b in whole]
    for a, b in zip(joined, whole):
        np.testing.assert_array_equal(a.data, b.data)


def test_serial_path_refuses_elastic_hosts(dataset):
    it = tdata.create_iterator(_base(dataset) + [('elastic_hosts', '2')])
    it.init()
    with pytest.raises(ValueError, match='pooled path'):
        list(it)


def test_mean_image_created_then_loaded_matches_jax(dataset):
    files = {}
    for pkg in ('jax', 'torch'):
        files[pkg] = os.path.join(dataset['dir'], f'mean_{pkg}.bin')
    runs = {}
    for rep in ('create', 'load'):
        for pkg in ('jax', 'torch'):
            cfg = _base(dataset) + [('rand_crop', '1'), ('rand_mirror', '1'),
                                    ('image_mean', files[pkg])]
            runs[pkg, rep] = _batches(pkg, cfg)
        assert open(files['torch'], 'rb').read() == \
            open(files['jax'], 'rb').read()
        _assert_same_batches(runs['jax', rep], runs['torch', rep])
    _assert_same_batches(runs['torch', 'create'], runs['torch', 'load'])
    with open(files['torch'], 'rb') as f:
        head = np.frombuffer(f.read(16), '<u4')
    assert list(head) == [3, 3, 16, 16]
    # the same mean deferred to the device: the spec carries it
    cfg = _base(dataset) + [('image_mean', files['torch']),
                            ('device_normalize', '1')]
    b = _compare(dataset, cfg)[0][0]
    host = _batches('torch', _base(dataset) + [
        ('image_mean', files['torch'])], epochs=1)[0][0]
    np.testing.assert_array_equal(b.norm_spec.apply(b.data), host.data)


def test_jpeg_matches_jax_pil_path(tmp_path, small_pages):
    d = str(tmp_path)
    lst, binp = _pack(d, 'jpg', n=9, size=24, fmt='JPEG')
    ds = {'dir': d, 'lst': lst, 'bin': binp}
    for source in ('img', 'imgbin'):
        _compare(ds, _base(ds, source, '3,20,20', bs=4)
                 + [('rand_crop', '1')])


@pytest.mark.parametrize('source,extra', [
    ('imgbin', [('rand_crop', '1'), ('rand_mirror', '1')]),
    ('imgbinx', [('shuffle', '1'), ('nworker', '2'),
                 ('max_random_contrast', '0.2')])], ids=['imgbin', 'imgbinx'])
def test_jpeg_matches_jax_native_path(tmp_path, source, extra):
    """Both packages' native paths built (the format's 64 MB pages, the
    C++ reader, libjpeg): the port's imgbin chain gives JAX's batches
    bitwise."""
    from cxxnet_tpu.runtime import native
    from cxxnet_tpu_torch.runtime import native as tnative
    assert native.native_available() and tnative.native_status()['jpeg']
    d = str(tmp_path)
    lst, binp = _pack(d, 'jpg', n=11, size=24, fmt='JPEG')
    ds = {'dir': d, 'lst': lst, 'bin': binp}
    _compare(ds, _base(ds, source, '3,20,20', bs=4) + extra)


def test_pooled_chain_reports_its_pipeline_stats(dataset):
    it = tdata.create_iterator(_base(dataset) + [
        ('nworker', '2'), ('iter', 'threadbuffer'), ('iter', 'end')])
    it.init()
    try:
        assert len(list(it)) == 5
        counters, samples = it.pipeline_stats().snapshot()
    finally:
        _close(it)
    assert {'decode_ms', 'augment_ms', 'collate_ms'} <= set(samples)
    assert counters['pool.workers'] == 2
    assert 0 < counters['pool.occupancy'] <= 1
    # a pooled chain's first batch gets ten deadlines, as in JAX
    it.set_param('buffer_deadline', '2')
    iter(it).close()
    assert it._buf._first_deadline == 20.0
    line = it.pipeline_stats().print_and_clear('io')
    assert '\tio-collate_ms.p50:' in line
    assert it.pipeline_stats().snapshot() == ({}, {})


@pytest.mark.parametrize('kind,shuffle', [('imgbin', '0'), ('imgbin', '1'),
                                           ('imgbinx', '1'), ('img', '0')])
def test_replay_stability_matches_jax(dataset, kind, shuffle):
    cfg = _base(dataset, kind) + [('shuffle', shuffle), ('nworker', '1'),
                                  ('iter', 'threadbuffer'), ('iter', 'end')]
    got = []
    for pkg in ('jax', 'torch'):
        it = PKGS[pkg][0].create_iterator(cfg)
        it.init()
        got.append(it.is_replay_stable())
        _close(it)
    assert got[0] == got[1] == (shuffle == '0')


def test_data_iter_get_data_applies_the_spec(dataset):
    from cxxnet_tpu_torch.wrapper import DataIter
    text = (f'iter = imgbin\nimage_list = "{dataset["lst"]}"\n'
            f'image_bin = "{dataset["bin"]}"\nmean_value = 90,80,70\n'
            'divideby = 32\n{extra}iter = end\ninput_shape = 3,16,16\n'
            'batch_size = 5\nsilent = 1\n')
    host, dev = (DataIter(text.replace('{extra}', e))
                 for e in ('', 'device_normalize = 1\n'))
    for it in (host, dev):
        assert it.next()
    assert dev.value.data.dtype == np.uint8
    np.testing.assert_array_equal(dev.get_data(), host.get_data())
    # the wrapper's net takes the spec from a DataIter, to predict and to
    # train, as the host-normalized array gives
    from cxxnet_tpu_torch import Net
    nets = []
    for _ in range(2):
        net = Net(dev='cpu', cfg=SMALL_NET)
        net.init_model()
        nets.append(net)
    np.testing.assert_array_equal(nets[0].predict_scores(dev),
                                  nets[1].predict_scores(host.get_data()))
    nets[0].update(dev)
    nets[1].update(host.get_data(), host.get_label())
    for k, d in nets[1].trainer.params.items():
        for f, v in d.items():
            assert torch.equal(nets[0].trainer.params[k][f], v), (k, f)


# --- OrderedWorkerPool --------------------------------------------------------

def _pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith('cxxnet-pool-test')]


def test_pool_keeps_order_under_racing_durations():
    rng = np.random.RandomState(0)
    delays = rng.uniform(0, 0.004, 60)

    def fn(i):
        time.sleep(delays[i])
        return i * i
    pool = OrderedWorkerPool(4, name='test')
    assert list(pool.imap(fn, range(60))) == [i * i for i in range(60)]
    assert not _pool_threads()


def test_pool_raises_at_the_error_position():
    def fn(i):
        if i == 5:
            raise KeyError('five')
        time.sleep(0.001 * (9 - i % 10))
        return i
    got = []
    with pytest.raises(KeyError, match='five'):
        for v in OrderedWorkerPool(3, name='test').imap(fn, range(20)):
            got.append(v)
    assert got == [0, 1, 2, 3, 4]
    assert not _pool_threads()


def test_pool_bounds_its_window():
    pulled, done = [0], [0]

    def source():
        for i in range(40):
            pulled[0] += 1
            yield i
    peak = 0
    pool = OrderedWorkerPool(2, window=5, name='test')
    for _ in pool.imap(lambda i: i, source()):
        done[0] += 1
        peak = max(peak, pulled[0] - done[0])
    assert done[0] == 40 and peak <= 5


def test_pool_order_under_stress_with_more_workers_than_cores():
    # 3x the cores, a 1 us switch interval: a lost or misordered result
    # breaks the sequence; the consumer runs in a thread joined with a
    # timeout
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = OrderedWorkerPool(3 * (os.cpu_count() or 1), window=64,
                                 name='test')
        th = threading.Thread(target=lambda: got.extend(
            pool.imap(lambda i: (i, sum(range(i % 97))), range(3000))))
        th.start()
        th.join(60)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert got == [(i, sum(range(i % 97))) for i in range(3000)]
    assert not _pool_threads()


def test_pool_joins_its_workers_on_generator_exit():
    gen = OrderedWorkerPool(3, name='test').imap(lambda i: i, range(100))
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    assert len(_pool_threads()) == 3
    gen.close()
    assert not _pool_threads()


# --- device_normalize through the trainer -------------------------------------

SMALL_NET = """netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  stride = 2
  nchannel = 8
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 3,16,16
batch_size = 5
eta = 0.05
momentum = 0.9
wd = 0.0001
metric = error
metric = logloss
"""


def test_device_normalize_trains_as_the_host_chain_and_jax(dataset):
    from cxxnet_tpu.wrapper import Net as JNet
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.interop import params_from_jax
    chain = _base(dataset) + [('mean_value', '110,100,90'),
                              ('divideby', '64'), ('rand_crop', '1')]
    dev_chain = chain + [('device_normalize', '1')]
    jnet = JNet(dev='cpu', cfg=SMALL_NET)
    jnet.init_model()
    import jax
    params0 = jax.tree.map(np.asarray, jnet._trainer.params)
    runs = {}
    for tag, cfg in (('host', chain), ('device', dev_chain)):
        net = Net(dev='cpu', cfg=SMALL_NET)
        net.init_model()
        net.trainer.params = params_from_jax(params0)
        runs[tag] = net
    it_dev = _batches('torch', dev_chain, epochs=1)[0]
    it_host = _batches('torch', chain, epochs=1)[0]
    j_dev = _batches('jax', dev_chain, epochs=1)[0]
    assert it_dev[0].norm_spec is not None and it_host[0].norm_spec is None
    for bd, bh, bj in zip(it_dev[:3], it_host[:3], j_dev[:3]):
        runs['device'].trainer.update(bd)
        runs['host'].trainer.update(bh)
        jnet._trainer.update(bj)
    jtr = jnet._trainer
    for k, d in jtr.params.items():
        for f, v in d.items():
            dev = runs['device'].trainer.params[k][f].detach().numpy()
            host = runs['host'].trainer.params[k][f].detach().numpy()
            np.testing.assert_array_equal(dev, host)
            np.testing.assert_allclose(dev, np.asarray(v), rtol=1e-4,
                                       atol=1e-6, err_msg=f'{k}/{f}')
    evals = {tag: runs[tag].trainer.evaluate(iter(b), 'test')
             for tag, b in (('device', it_dev), ('host', it_host))}
    preds = {tag: np.concatenate(list(runs[tag].trainer.predict_stream(
        iter(b)))) for tag, b in (('device', it_dev), ('host', it_host))}
    np.testing.assert_array_equal(preds['device'], preds['host'])
    assert evals['device'] == evals['host']
    jline = jtr.evaluate(iter(j_dev), 'test')
    nums = [[float(t.split(':')[1]) for t in line.split('\t') if t]
            for line in (jline, evals['device'])]
    np.testing.assert_allclose(nums[1], nums[0], rtol=1e-4)
    jpred = np.concatenate([jtr.predict(b) for b in j_dev])
    tpred = np.concatenate(list(runs['device'].trainer.predict_stream(
        iter(it_dev))))
    assert len(tpred) == 23
    np.testing.assert_array_equal(tpred, jpred)


# --- the CLI ------------------------------------------------------------------

def _cli_conf(d, train, test):
    return f"""data = train
iter = imgbin
  image_list = "{train[0]}"
  image_bin = "{train[1]}"
  rand_crop = 1
  rand_mirror = 1
iter = threadbuffer
iter = end

eval = test
iter = imgbin
  image_list = "{test[0]}"
  image_bin = "{test[1]}"
iter = end

{SMALL_NET.replace('batch_size = 5', 'batch_size = 100')}
divideby = 64
save_model = 1
silent = 1
dev = cpu
"""


def _eval_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith('[')]


def test_cli_trains_and_predicts_imgbin_as_jax(tmp_path, capsys,
                                               monkeypatch):
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu.runtime import native
    from cxxnet_tpu_torch.main import main as tmain
    monkeypatch.setattr(native, 'decode_jpeg', lambda blob: None)
    d = str(tmp_path)
    train = _pack(d, 'tr', n=230, seed=4)
    test = _pack(d, 'te', n=60, seed=5)
    with open(os.path.join(d, 'net.conf'), 'w') as f:
        f.write(_cli_conf(d, train, test))
    monkeypatch.chdir(d)
    common = ['net.conf', 'num_round=2', 'max_round=2']
    capsys.readouterr()
    assert jmain(common + ['model_dir=mj', 'image_mean=mean_j.bin']) == 0
    jlines = _eval_lines(capsys.readouterr().err)
    assert tmain(common + ['model_dir=mt', 'image_mean=mean_t.bin',
                           'model_in=mj/0000.model']) == 0
    tlines = _eval_lines(capsys.readouterr().err)
    assert open('mean_t.bin', 'rb').read() == open('mean_j.bin', 'rb').read()
    assert len(jlines) == len(tlines) == 2
    for jl, tl in zip(jlines, tlines):
        jt, tt = jl.split('\t'), tl.split('\t')
        assert [t.split(':')[0] for t in tt] == [t.split(':')[0] for t in jt]
        for a, b in zip(jt[1:], tt[1:]):
            key, ja, tb = a.split(':')[0], float(a.split(':')[1]), \
                float(b.split(':')[1])
            if key.endswith('error'):
                n = 230 if key.startswith('train') else 60
                assert abs(ja - tb) * n <= 1.0 + 1e-9, (key, ja, tb)
            else:
                assert tb == pytest.approx(ja, rel=1e-4), (key, ja, tb)
    assert os.path.exists(os.path.join('mt', '0002.model'))
    pred_net = SMALL_NET.replace('batch_size = 5', 'batch_size = 100')
    for tag, fn in (('j', jmain), ('t', tmain)):
        with open(f'pred_{tag}.conf', 'w') as f:
            f.write(f'pred = {tag}.txt\niter = imgbin\n'
                    f'  image_list = "{test[0]}"\n'
                    f'  image_bin = "{test[1]}"\niter = end\n'
                    f'{pred_net}divideby = 64\nsilent = 1\ndev = cpu\n')
        assert fn([f'pred_{tag}.conf', 'task=pred', 'image_mean=mean_j.bin',
                   'model_in=mt/0002.model']) == 0
    capsys.readouterr()
    tp, jp = np.loadtxt('t.txt'), np.loadtxt('j.txt')
    assert len(tp) == 60
    np.testing.assert_array_equal(tp, jp)


def test_cli_still_refuses_dist_num_worker(tmp_path, monkeypatch):
    from cxxnet_tpu_torch.main import main as tmain
    from cxxnet_tpu_torch.runtime.faults import NotPortedError
    with open(tmp_path / 'x.conf', 'w') as f:
        f.write('iter = imgbin\niter = end\n')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotPortedError, match='queue A item 9'):
        tmain(['x.conf', 'dev=cpu', 'dist_num_worker=2'])


# --- the fixture digest -------------------------------------------------------

def test_fixture_digest_is_jaxs_and_pinned(tmp_path, small_pages):
    sys.path.insert(0, ROOT)
    import chip_smoke
    with open(os.path.join(ROOT, 'tests', 'fixtures',
                           'torch_imgbin_digest.json')) as f:
        pinned = json.load(f)['sha256']
    got = {}
    for pkg, page_cls in (('jax', JPage), ('torch', TPage)):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = chip_smoke.imgbin_fixture_digest(
            PKGS[pkg][0].create_iterator, page_cls, str(d))
    assert got['jax'] == got['torch'] == pinned
    # the page size the fixture set is restored
    assert TPage.N_BYTES == JPage.N_BYTES == 2048
