"""The port's C ABI (``cxxnet_tpu_torch/runtime/cxxnet_wrapper.cc`` over
``cxxnet_tpu_torch/capi.py``), as ``tests/test_c_abi.py`` holds the JAX
package's library.

Two ways in, both exercised: ctypes from this running interpreter (the
library attaches through the GIL) and a standalone C program that links
the library, which starts CPython itself.  The library is built with
``capi.build_library`` (``g++``, ``python3-config``) into a git-ignored
directory; the module skips only where that toolchain is absent.  Beside
the cases of ``tests/test_c_abi.py``: a model file the JAX package wrote,
read through the C ABI, gives JAX's weights bitwise and its predictions;
the iterator calls stream a whole dataset; the functions of subsystems
not ported yet raise ``NotPortedError`` naming their ROADMAP.md item.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from cxxnet_tpu import wrapper as jw
from cxxnet_tpu_torch import capi
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from tests.test_io import write_mnist

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent


def _toolchain() -> bool:
    """``g++`` and the Python headers, which the library's build needs."""
    if shutil.which('g++') is None:
        return False
    r = subprocess.run(['python3-config', '--includes'], capture_output=True,
                       text=True)
    return r.returncode == 0 and bool(r.stdout.strip())


needs_lib = pytest.mark.skipif(
    not _toolchain(), reason='g++ or the Python headers are missing: '
                             'cannot build libcxxnetwrapper.so')


@pytest.fixture(scope='module')
def lib_path():
    return pathlib.Path(capi.build_library())


TINY_CONF = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = sigmoid
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
eta = 0.3
momentum = 0.9
metric = error
"""

F = ctypes.POINTER(ctypes.c_float)
U = ctypes.c_uint


@pytest.fixture(scope='module')
def lib(lib_path):
    L = ctypes.CDLL(str(lib_path))
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    sig = {
        'CXNNetCreate': (vp, [cp, cp]), 'CXNNetFree': (None, [vp]),
        'CXNNetSetParam': (None, [vp, cp, cp]),
        'CXNNetInitModel': (None, [vp]),
        'CXNNetSaveModel': (None, [vp, cp]),
        'CXNNetLoadModel': (None, [vp, cp]),
        'CXNNetStartRound': (None, [vp, ctypes.c_int]),
        'CXNNetUpdateBatch': (None, [vp, F, U * 4, F, U * 2]),
        'CXNNetUpdateIter': (None, [vp, vp]),
        'CXNNetPredictBatch': (F, [vp, F, U * 4, ctypes.POINTER(U)]),
        'CXNNetPredictIter': (F, [vp, vp, ctypes.POINTER(U)]),
        'CXNNetExtractBatch': (F, [vp, F, U * 4, cp, U * 4]),
        'CXNNetExtractIter': (F, [vp, vp, cp, U * 4]),
        'CXNNetEvaluate': (cp, [vp, vp, cp]),
        'CXNNetGetWeight': (F, [vp, cp, cp, U * 4, ctypes.POINTER(U)]),
        'CXNNetSetWeight': (None, [vp, F, U, cp, cp]),
        'CXNIOCreateFromConfig': (vp, [cp]), 'CXNIONext': (ctypes.c_int, [vp]),
        'CXNIOBeforeFirst': (None, [vp]), 'CXNIOFree': (None, [vp]),
        'CXNIOGetData': (F, [vp, U * 4, ctypes.POINTER(U)]),
        'CXNIOGetLabel': (F, [vp, U * 2, ctypes.POINTER(U)]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(L, name)
        fn.restype, fn.argtypes = res, args
    return L


def _fptr(arr):
    return arr.ctypes.data_as(F)


def _weight(lib, net, layer, tag):
    wshape, wdim = (U * 4)(0, 0, 0, 0), U(0)
    p = lib.CXNNetGetWeight(net, layer, tag, wshape, ctypes.byref(wdim))
    shape = tuple(wshape)[:wdim.value]
    return np.ctypeslib.as_array(p, shape).copy()


@needs_lib
def test_library_lands_in_an_ignored_directory(lib_path):
    assert lib_path.parent == REPO / 'cxxnet_tpu_torch' / 'runtime' / '_build'
    r = subprocess.run(['git', 'check-ignore', '-q', str(lib_path)],
                       cwd=REPO)
    assert r.returncode == 0
    mtime = lib_path.stat().st_mtime
    assert capi.build_library() == str(lib_path)   # built once, then reused
    assert lib_path.stat().st_mtime == mtime


@needs_lib
def test_ctypes_train_predict_weights(lib, tmp_path):
    u4 = U * 4
    net = lib.CXNNetCreate(b'cpu', TINY_CONF.encode())
    assert net
    lib.CXNNetInitModel(net)
    lib.CXNNetStartRound(net, 0)

    rng = np.random.RandomState(0)
    data = rng.randn(16, 1, 1, 8).astype(np.float32)
    label = (rng.randint(0, 4, (16, 1))).astype(np.float32)
    for _ in range(3):
        lib.CXNNetUpdateBatch(net, _fptr(data), u4(16, 1, 1, 8),
                              _fptr(label), (U * 2)(16, 1))

    out_size = U(0)
    p = lib.CXNNetPredictBatch(net, _fptr(data), u4(16, 1, 1, 8),
                               ctypes.byref(out_size))
    assert out_size.value == 16
    preds = np.ctypeslib.as_array(p, (16,))
    assert set(np.unique(preds)).issubset({0., 1., 2., 3.})

    # extract a hidden node by name
    oshape = u4(0, 0, 0, 0)
    lib.CXNNetExtractBatch(net, _fptr(data), u4(16, 1, 1, 8), b'2', oshape)
    assert list(oshape) == [16, 1, 1, 16]

    # weight get/set roundtrip in disk layout (nhidden, nin)
    w = _weight(lib, net, b'fc1', b'wmat')
    assert w.shape == (16, 8)
    w2 = w * 2.0
    lib.CXNNetSetWeight(net, _fptr(w2), U(w2.size), b'fc1', b'wmat')
    np.testing.assert_allclose(_weight(lib, net, b'fc1', b'wmat'), w2,
                               rtol=1e-6)

    # save / load through a second handle
    fname = str(tmp_path / 'm.model').encode()
    lib.CXNNetSaveModel(net, fname)
    net2 = lib.CXNNetCreate(b'cpu', TINY_CONF.encode())
    lib.CXNNetLoadModel(net2, fname)
    np.testing.assert_allclose(_weight(lib, net2, b'fc1', b'wmat'), w2,
                               rtol=1e-6)
    lib.CXNNetFree(net2)
    lib.CXNNetFree(net)


@needs_lib
def test_a_jax_model_file_through_the_c_abi(lib, tmp_path):
    """A model file the JAX package wrote, loaded by the port's library:
    JAX's weights bitwise, its predictions and its hidden node (f32
    forwards in another sum order: rtol 1e-5, atol 1e-6)."""
    jnet = jw.Net(dev='cpu', cfg=TINY_CONF)
    jnet.init_model()
    path = tmp_path / 'j.model'
    jnet.save_model(str(path))
    net = lib.CXNNetCreate(b'cpu', TINY_CONF.encode())
    lib.CXNNetLoadModel(net, str(path).encode())
    for layer in ('fc1', 'fc2'):
        for tag in ('wmat', 'bias'):
            np.testing.assert_array_equal(
                _weight(lib, net, layer.encode(), tag.encode()),
                jnet.get_weight(layer, tag))
    x = np.random.RandomState(1).randn(16, 1, 1, 8).astype(np.float32)
    out_size = U(0)
    p = lib.CXNNetPredictBatch(net, _fptr(x), (U * 4)(16, 1, 1, 8),
                               ctypes.byref(out_size))
    np.testing.assert_array_equal(np.ctypeslib.as_array(p, (16,)),
                                  jnet.predict(x))
    oshape = (U * 4)(0, 0, 0, 0)
    p = lib.CXNNetExtractBatch(net, _fptr(x), (U * 4)(16, 1, 1, 8), b'2',
                               oshape)
    got = np.ctypeslib.as_array(p, tuple(oshape)).reshape(16, 16)
    np.testing.assert_allclose(got, np.asarray(jnet.extract(x, '2')).reshape(
        16, 16), rtol=1e-5, atol=1e-6)
    lib.CXNNetFree(net)


@needs_lib
def test_iterator_calls_stream_a_dataset(lib, tmp_path):
    pi, pl, _, y = write_mnist(str(tmp_path))
    it = lib.CXNIOCreateFromConfig(f"""
iter = mnist
  path_img = "{pi}"
  path_label = "{pl}"
  batch_size = 10
  silent = 1
iter = end
""".encode())
    conf = TINY_CONF.replace('input_shape = 1,1,8', 'input_shape = 1,1,64') \
        .replace('batch_size = 16', 'batch_size = 10')
    net = lib.CXNNetCreate(b'cpu', conf.encode())
    lib.CXNNetInitModel(net)
    lib.CXNIOBeforeFirst(it)
    n = 0
    while lib.CXNIONext(it):
        dshape, stride = (U * 4)(0, 0, 0, 0), U(0)
        lib.CXNIOGetData(it, dshape, ctypes.byref(stride))
        assert list(dshape) == [10, 1, 1, 64] and stride.value == 64
        lshape = (U * 2)(0, 0)
        p = lib.CXNIOGetLabel(it, lshape, ctypes.byref(stride))
        np.testing.assert_array_equal(
            np.ctypeslib.as_array(p, (10,)), y[n * 10:(n + 1) * 10])
        lib.CXNNetUpdateIter(net, it)
        n += 1
    assert n == 5
    out_size = U(0)
    lib.CXNNetPredictIter(net, it, ctypes.byref(out_size))
    assert out_size.value == 50
    oshape = (U * 4)(0, 0, 0, 0)
    lib.CXNNetExtractIter(net, it, b'top[-3]', oshape)
    assert list(oshape) == [50, 1, 1, 16]
    line = lib.CXNNetEvaluate(net, it, b'test').decode()
    assert line.startswith('\ttrain-error:') and '\ttest-error:' in line
    lib.CXNNetFree(net)
    lib.CXNIOFree(it)


C_PROGRAM = r'''
#include <stdio.h>
#include <stdlib.h>

typedef unsigned int cxx_uint;
typedef float cxx_real_t;

void *CXNNetCreate(const char *device, const char *cfg);
void CXNNetFree(void *handle);
void CXNNetInitModel(void *handle);
void CXNNetStartRound(void *handle, int round);
void CXNNetUpdateBatch(void *handle, cxx_real_t *p_data,
                       const cxx_uint dshape[4], cxx_real_t *p_label,
                       const cxx_uint lshape[2]);
const cxx_real_t *CXNNetPredictBatch(void *handle, cxx_real_t *p_data,
                                     const cxx_uint dshape[4],
                                     cxx_uint *out_size);
const cxx_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *wtag, cxx_uint wshape[4],
                                  cxx_uint *out_dim);

static const char *kConf = "%CONF%";

int main(void) {
  void *net = CXNNetCreate("cpu", kConf);
  if (!net) return 1;
  CXNNetInitModel(net);
  CXNNetStartRound(net, 0);
  float data[16 * 8];
  float label[16];
  unsigned seed = 7;
  for (int i = 0; i < 16 * 8; ++i) {
    seed = seed * 1103515245u + 12345u;
    data[i] = (float)(seed % 1000) / 500.0f - 1.0f;
  }
  for (int i = 0; i < 16; ++i) label[i] = (float)(i % 4);
  cxx_uint dshape[4] = {16, 1, 1, 8};
  cxx_uint lshape[2] = {16, 1};
  for (int step = 0; step < 3; ++step)
    CXNNetUpdateBatch(net, data, dshape, label, lshape);
  cxx_uint out_size = 0;
  const float *pred = CXNNetPredictBatch(net, data, dshape, &out_size);
  if (out_size != 16 || pred == NULL) return 2;
  cxx_uint wshape[4];
  cxx_uint wdim = 0;
  const float *w = CXNNetGetWeight(net, "fc1", "wmat", wshape, &wdim);
  if (wdim != 2 || wshape[0] != 16 || wshape[1] != 8 || w == NULL) return 3;
  CXNNetFree(net);
  printf("C_ABI_OK\n");
  return 0;
}
'''


@needs_lib
def test_standalone_c_program(lib_path, tmp_path):
    src = tmp_path / 'program.c'
    conf = TINY_CONF.replace('\n', '\\n')
    src.write_text(C_PROGRAM.replace('%CONF%', conf))
    exe = tmp_path / 'program'
    r = subprocess.run(
        ['gcc', '-O1', str(src), '-o', str(exe), f'-L{lib_path.parent}',
         '-lcxxnetwrapper', f'-Wl,-rpath,{lib_path.parent}'],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert 'C_ABI_OK' in r.stdout


_ONLINE = {}
#: stats keys the clock decides (a swap's age, the freshness quantiles)
_CLOCK = ('last_swap_age_s', 'freshness_s.', 'swap_lag_s.')


def _online_sessions(root):
    """One ``net_online_*`` session in each package on TINY_CONF from the
    same batches (cached: each parametrized case reads its function's
    part)."""
    if _ONLINE:
        return _ONLINE
    import json

    from cxxnet_tpu import capi as jcapi
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu.io.data import IIterator as JIter
    from cxxnet_tpu_torch.io.data import DataBatch, IIterator
    rng = np.random.RandomState(5)
    arrays = [(rng.randn(16, 1, 1, 8).astype(np.float32),
               rng.randint(0, 4, (16, 1)).astype(np.float32))
              for _ in range(6)]
    rows = np.ascontiguousarray(rng.randn(3, 1, 1, 8).astype(np.float32))
    for pkg, mod, batch, base in (('t', capi, DataBatch, IIterator),
                                  ('j', jcapi, JBatch, JIter)):
        class Batches(base):
            def __iter__(self, batch=batch):
                return iter([batch(x, y) for x, y in arrays])

        net = mod.net_create('cpu', TINY_CONF)
        net.set_param('seed', 3)
        net.init_model()
        d = os.path.join(root, pkg)
        mod.net_online_start(
            net, Batches(), f'model_dir={d};rounds=1;save_every=2;'
            'reload=0.02;buckets=4;deadline=60;watchdog_deadline=60')
        pred = mod.net_online_predict(net, memoryview(rows.tobytes()),
                                      rows.shape)
        wait = json.loads(mod.net_online_wait(net))
        stats = mod.net_online_stats(net)
        mod.net_online_stop(net)
        mod.net_online_stop(net)              # idempotent
        with pytest.raises(RuntimeError) as guard:
            mod.net_online_stats(net)
        _ONLINE[pkg] = {
            'net_online_start': sorted(os.listdir(d)),
            'net_online_predict': (pred.shape, pred.dtype,
                                   bool(((pred >= 0) & (pred < 4)).all())),
            'net_online_stats': [
                t.split(':')[0] for t in stats.split('\t')
                if t.startswith(('online-', 'registry-'))
                and not any(c in t for c in _CLOCK)],
            'net_online_wait': (sorted(wait), wait['steps'],
                                wait['dropped']),
            'net_online_stop': 'online_start' in str(guard.value)}
    return _ONLINE


@pytest.mark.parametrize('fn,args,item', [
    ('net_obs_stats', (None,), 'queue A item 10'),
    ('net_obs_slos', (None,), 'queue A item 10'),
    ('net_obs_programs', (None,), 'queue A item 10'),
    ('net_autotune', (None, 'nworker=1,2', None), 'queue A item 10'),
    ('net_online_start', (None, None, 'model_dir=m'), 'queue A item 10'),
    ('net_online_predict', (None, b'', (1,)), 'queue A item 10'),
    ('net_online_stats', (None,), 'queue A item 10'),
    ('net_online_wait', (None,), 'queue A item 10'),
    ('net_online_stop', (None,), 'queue A item 10'),
    ('lm_serve_scenario', (None, 'shape=burst'), 'queue A item 10'),
    ('lm_serve_autoscale', (None, 'min_slots=1'), 'queue A item 10'),
])
def test_unported_functions_refuse(fn, args, item, tmp_path_factory):
    if fn.startswith('net_obs_'):
        # ported (queue A item 10.1): the hub's /statusz, /slos and
        # /programs bodies, keyed as JAX's functions key them
        import json

        from cxxnet_tpu import capi as jcapi
        from cxxnet_tpu_torch import wrapper as tw
        net = tw.Net(dev='cpu', cfg=TINY_CONF)
        got = json.loads(getattr(capi, fn)(net))
        want = json.loads(getattr(jcapi, fn)(
            jw.Net(dev='cpu', cfg=TINY_CONF)))
        if fn == 'net_obs_slos':
            assert got == want == {}
        else:
            assert sorted(got) == sorted(want)
        return
    if fn.startswith('net_online_'):
        # ported (queue A item 10.3): one train-while-serve session a
        # package over the same batches; each function's result held
        # against JAX's
        got = _online_sessions(str(tmp_path_factory.mktemp('online')))
        assert got['t'][fn] == got['j'][fn]
        if fn == 'net_online_start':
            assert [n for n in got['t'][fn] if n.endswith('.model')] == [
                '0000.model', '0002.model', '0004.model', '0006.model']
        return
    with pytest.raises(NotPortedError, match=item):
        getattr(capi, fn)(*args)



@pytest.mark.parametrize('cfg,item', [('models=a:m1|b:m2', 'queue A item 8'),
                                      ('mem_budget=1000', 'queue A item 8'),
                                      ('replicas=2', 'queue A item 8')])
def test_serve_start_refuses_the_fleet(cfg, item, tmp_path, monkeypatch):
    # ported (queue A item 8): models= stands the fleet up (ids routed
    # to their dirs' newest checkpoint), mem_budget= sets its budget, and
    # replicas=2 asks for two CUDA devices, JAX's error where there are
    # fewer
    import torch
    from cxxnet_tpu_torch import wrapper as tw
    net = tw.Net(dev='cpu', cfg=TINY_CONF)
    net.init_model()
    monkeypatch.chdir(tmp_path)
    x = np.random.RandomState(2).randn(3, 1, 1, 8).astype(np.float32)
    if cfg.startswith('replicas'):
        if torch.cuda.device_count() < 2:
            with pytest.raises(ValueError, match='exceeds the '
                               f'{torch.cuda.device_count()} available'):
                capi.net_serve_start(net, cfg)
    else:
        for i, d in enumerate(('m1', 'm2')):
            other = tw.Net(dev='cpu', cfg=TINY_CONF)
            other.set_param('seed', str(10 + i))
            other.init_model()
            os.makedirs(d)
            other.save_model(os.path.join(d, '0001.model'))
        capi.net_serve_start(net, cfg + ';buckets=4')
        try:
            if cfg.startswith('models'):
                assert net.fleet.models() == ['a', 'b']
                np.testing.assert_array_equal(
                    net.serve_scores(x, model='b'),
                    net.fleet.get('b').predict_scores(x))
                assert 'fleet-models_loaded:1' in capi.net_serve_stats(net)
            else:
                assert net.fleet is None     # a budget without models
        finally:
            capi.net_serve_stop(net)
    capi.net_serve_start(net, 'buckets=4:16;max_wait=0.001;mem_budget=0')
    x = np.random.RandomState(2).randn(3, 1, 1, 8).astype(np.float32)
    got = capi.net_serve_predict(net, memoryview(x.tobytes()), (3, 1, 1, 8))
    np.testing.assert_array_equal(got, net.predict(x))
    assert 'serve-requests:1' in capi.net_serve_stats(net)
    capi.net_serve_stop(net)


def test_lm_serve_calls():
    from cxxnet_tpu_torch.models import transformer as T
    svc = capi.lm_serve_start('vocab=32;d_model=16;heads=2;d_ff=24;stages=1;'
                              'seq=32;slots=2;pages=16;page_size=4;'
                              'max_prompt=8;max_new=4;seed=5;dev=cpu')
    try:
        prompt = np.array([3, 1, 4, 1, 5], np.int32)
        toks = capi.lm_serve_generate(svc, memoryview(prompt.tobytes()), 5,
                                      4)
        assert toks.dtype == np.int32 and len(toks) == 4
        off = T.generate(svc.engine.params, prompt[None], 4, svc.engine.cfg,
                         flash=svc.engine.use_flash)[0]
        np.testing.assert_array_equal(toks, off[:4])
        assert 'decode-' in capi.lm_serve_stats(svc)
    finally:
        capi.lm_serve_stop(svc)
