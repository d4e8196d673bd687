"""The port's serving extensions against the JAX package's, on the CPU:
checkpoint hot reload (``serve/registry.ModelRegistry``), the multi-model
fleet under a ``MemoryBudgeter`` (``MultiModelRegistry``), the replicated
engine (``ReplicatedPredictEngine``), decode models under the registry,
and their wrapper, C-ABI and CLI surfaces.

* The registry's state machine: the same directory of model files, some
  written by the JAX package and some by the port (the format is
  shared), gives the same ``transitions`` states, adopted counters and
  blacklist from both packages' registries.
* The fleet: the same ``get`` / ``lease`` / ``evict`` sequence under the
  same budget gives the same eviction order, the same
  ``MemoryBudgetExceededError`` and the same ``report()`` keys (JAX's
  ``budget_drift`` is queue A item 10's); ``resident_bytes`` equal JAX's
  at f32, bf16 and int8.
* Scores of the port's replicated and reloaded engines within ``RTOL`` /
  ``ATOL`` of JAX's ``PredictEngine`` on the same weights (f32, sums in
  another order: ``tests/test_torch_slice.py``'s tolerance).
* Within the port, replicas are bitwise their base engine; CPU replicas
  take explicit ``devices`` (``devices=None`` is every CUDA device), as
  JAX's take its 8 forced host devices.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from cxxnet_tpu import wrapper as jw
from cxxnet_tpu.models import transformer as JT
from cxxnet_tpu.nnet import checkpoint as jckpt
from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu.serve import (MemoryBudgeter as JBudgeter,
                              ModelRegistry as JRegistry,
                              MultiModelRegistry as JFleet,
                              PredictEngine as JEngine)
from cxxnet_tpu.serve.decode import DecodeEngine as JDecodeEngine
from cxxnet_tpu_torch import capi as tcapi
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch import wrapper as tw
from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.nnet import checkpoint as tckpt
from cxxnet_tpu_torch.runtime import faults as tfaults
from cxxnet_tpu_torch.serve import (LM_PATTERN, DecodeEngine, DynamicBatcher,
                                    MemoryBudgeter, ModelRegistry,
                                    MultiModelRegistry, PredictEngine,
                                    ReplicatedPredictEngine, lm_loader,
                                    load_model_params, save_lm_params)
from cxxnet_tpu_torch.utils.metric import StatSet
from tests.test_io import write_mnist

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-4, 1e-5

NET_CFG = """
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 16
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 4
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
dev = cpu
eta = 0.1
momentum = 0.9
"""


def tnet(seed=0, cfg=NET_CFG):
    net = tw.Net(dev='cpu', cfg=cfg)
    net.set_param('seed', str(seed))
    net.init_model()
    return net


def jnet(seed=0, cfg=NET_CFG):
    net = jw.Net(dev='cpu', cfg=cfg)
    net.set_param('seed', str(seed))
    net.init_model()
    return net


def rig_constant_class(net, cls=2):
    """Zero fc2 and bias one logit: every input argmaxes to ``cls``, a
    recognizable new checkpoint (either package's ``Net``)."""
    w = net.get_weight('fc2', 'wmat')
    net.set_weight(np.zeros_like(w), 'fc2', 'wmat')
    b = np.zeros(4, np.float32)
    b[cls] = 5.0
    net.set_weight(b, 'fc2', 'bias')
    return net


def save_with_digest(net, path, pkg):
    """``net.save_model`` + the digest sidecar of package ``pkg``."""
    net.save_model(str(path))
    (jckpt if pkg == 'jax' else tckpt).write_model_digest(str(path))


def corrupt(path, at=150, data=b'\xba\xad\xbe\xef'):
    with open(path, 'r+b') as f:
        f.seek(at)
        f.write(data)


def _x(seed=0, n=4):
    return np.random.RandomState(seed).randn(n, 1, 1, 8).astype(np.float32)


def _engines(tmp_path, buckets=(1, 8)):
    """Both packages' engines serving ``0000.model`` of ``tmp_path``."""
    j = jw.Net(dev='cpu', cfg=NET_CFG)
    j.load_model(str(tmp_path / '0000.model'))
    t = tw.Net(dev='cpu', cfg=NET_CFG)
    t.load_model(str(tmp_path / '0000.model'))
    return JEngine(j._trainer, buckets), PredictEngine(t.trainer, buckets)


# --- checkpoint digests and the corrupt_model event -----------------------

def test_digest_helpers_match_jax(tmp_path):
    net = tnet()
    path = str(tmp_path / '0000.model')
    net.save_model(path)
    assert tckpt.model_digest_path(path) == jckpt.model_digest_path(path)
    assert tckpt.file_crc32(path) == jckpt.file_crc32(path)
    side = tckpt.write_model_digest(path)
    tbytes = open(side, 'rb').read()
    jckpt.write_model_digest(path)
    assert open(side, 'rb').read() == tbytes
    assert tckpt.verify_model_digest(path) is None
    assert jckpt.verify_model_digest(path) is None
    corrupt(path)
    assert tckpt.verify_model_digest(path) == jckpt.verify_model_digest(path)
    assert 'crc32' in tckpt.verify_model_digest(path)


@pytest.mark.parametrize('payload', ['{"size": 12}', '[1, 2, 3]', '"nope"',
                                     'not json at all'])
def test_verify_model_digest_malformed_sidecar_is_reason(tmp_path, payload):
    """A malformed sidecar is a reason, never an exception (JAX
    ``tests/test_serve.py:480``), and the reason is JAX's."""
    path = str(tmp_path / '0000.model')
    tnet().save_model(path)
    assert tckpt.verify_model_digest(path) is None   # no sidecar: plausible
    with open(tckpt.model_digest_path(path), 'w') as f:
        f.write(payload)
    reason = tckpt.verify_model_digest(path)
    assert isinstance(reason, str) and reason
    assert reason == jckpt.verify_model_digest(path)


def test_publish_model_file_commits_digest_first(tmp_path):
    """The digest is on disk before the model file is: a watcher never
    sees a model without it; the bytes are JAX's publish's."""
    net = tnet(3)
    seen = []

    def write(f):
        seen.append(os.path.exists(tckpt.model_digest_path(path)))
        _save_into(net, f)

    path = str(tmp_path / 't' / '0001.model')
    tckpt.publish_model_file(path, write)
    jpath = str(tmp_path / 'j' / '0001.model')
    jckpt.publish_model_file(jpath, lambda f: f.write(open(path, 'rb')
                                                      .read()))
    assert seen == [False]
    assert open(path, 'rb').read() == open(jpath, 'rb').read()
    assert open(path + '.crc32').read() == open(jpath + '.crc32').read()
    assert tckpt.verify_model_digest(path) is None
    assert not [n for n in os.listdir(tmp_path / 't') if n.startswith('.')]


@pytest.mark.parametrize('publish', [True, False])
def test_corrupt_model_plan_is_rejected_by_both_registries(tmp_path,
                                                           publish):
    """``FaultPlan(corrupt_model=2)``: the second committed model file is
    truncated (on the staged file when published, on the live file after
    the save-then-digest path), and both packages' registries reject it,
    keep serving the first, then adopt the third."""
    d = tmp_path / 'm'
    d.mkdir()
    save_with_digest(jnet(), d / '0000.model', 'jax')
    jeng, teng = _engines(d)
    regs = {'jax': JRegistry(jeng, str(d), current=0),
            'port': ModelRegistry(teng, str(d), current=0)}
    prev = tfaults.install_plan(tfaults.FaultPlan.parse('corrupt_model=2'))
    try:
        for counter, seed in ((1, 4), (2, 5)):
            path = str(d / f'{counter:04d}.model')
            net = tnet(seed)
            if publish:
                tckpt.publish_model_file(path,
                                         lambda f, n=net: _save_into(n, f))
            else:
                save_with_digest(net, path, 'port')
            for reg in regs.values():
                reg.poll_once()
        fired = tfaults.active_plan().fired()
    finally:
        tfaults.install_plan(prev)
    assert fired == ['corrupt_model=2']
    for reg in regs.values():
        assert reg.current == 1
        assert reg.states()[-1] == 'REJECTED'
    assert regs['jax'].states() == regs['port'].states()
    save_with_digest(tnet(6), d / '0003.model', 'port')
    for reg in regs.values():
        assert reg.poll_once() and reg.current == 3
    np.testing.assert_allclose(teng.predict_scores(_x()),
                               jeng.predict_scores(_x()), rtol=RTOL,
                               atol=ATOL)


def _save_into(net, f):
    f.write(int(0).to_bytes(4, 'little', signed=True))
    net._require().save_model(f)


# --- the engine's registry protocol ----------------------------------------

def test_engine_swap_validates_structure():
    for eng in (PredictEngine(tnet().trainer, (8,)),
                JEngine(jnet()._trainer, (8,))):
        tree = eng.trainer.params
        bad = {k: dict(v) for k, v in tree.items()}
        key = next(iter(bad))
        field = next(iter(bad[key]))
        bad[key][field] = np.zeros((3, 3), np.float32)   # wrong shape
        with pytest.raises(ValueError, match='swap_params'):
            eng.swap_params(bad)
        with pytest.raises(ValueError, match='structure'):
            eng.swap_params({'nope': {}})


@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_engine_protocol_and_resident_bytes_match_jax(dtype):
    """``resident_bytes`` equals JAX's at every tier; ``place_params``
    passes the engine's own placement through (a quantized tree is not
    quantized twice); ``warm_params`` and ``swap_params`` take it, and
    the swapped engine scores as JAX's on the same host tree."""
    t, j = tnet(), jnet()
    teng = PredictEngine(t.trainer, (1, 8), dtype=dtype)
    jeng = JEngine(j._trainer, (1, 8), dtype=dtype)
    assert teng.resident_bytes() == jeng.resident_bytes()
    new = jnet(9)
    host = {k: {f: np.asarray(v) for f, v in fs.items()}
            for k, fs in new._trainer.params.items()}
    placed = teng.place_params(host)
    assert teng.place_params(placed) is placed
    teng.warm_params(placed)
    assert not teng.busy()
    teng.swap_params(placed, version=7)
    jeng.swap_params(jeng.place_params(host), version=7)
    assert teng.version == jeng.version == 7
    np.testing.assert_allclose(teng.predict_scores(_x()),
                               jeng.predict_scores(_x()), rtol=RTOL,
                               atol=ATOL)
    view = teng.capacity_view()
    assert set(view) == set(jeng.capacity_view())
    assert view['resident_bytes'] == jeng.resident_bytes()
    assert view['compile_count'] == 2      # the warm's bucket and the 8


def test_engine_inflight_count_behind_busy():
    eng = PredictEngine(tnet().trainer, (8,))
    entered, release = threading.Event(), threading.Event()
    orig = eng._fwd

    def gated(params, data):
        entered.set()
        release.wait(10)
        return orig(params, data)

    eng._fwd = gated
    th = threading.Thread(target=eng.predict_scores, args=(_x(),))
    th.start()
    assert entered.wait(10)
    assert eng.busy() and eng.capacity_view()['busy']
    release.set()
    th.join(10)
    assert not eng.busy()


def test_pinned_engine_leaves_the_trainer_alone():
    """A pinned engine runs on its own device and writes nothing of the
    shared trainer; two pinned engines forward concurrently from two
    threads, bitwise the unpinned engine."""
    net = tnet()
    tr = net.trainer
    base = PredictEngine(tr, (8,))
    a = PredictEngine(tr, (8,), device='cpu')
    b = PredictEngine(tr, (8,), device='cpu')
    want = base.predict_scores(_x(1, 7))
    snap = (tr.device, tr.round, id(tr.params))
    outs = {}

    def run(name, eng):
        outs[name] = [eng.predict_scores(_x(1, 7)) for _ in range(20)]

    ths = [threading.Thread(target=run, args=(n, e))
           for n, e in (('a', a), ('b', b))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    assert (tr.device, tr.round, id(tr.params)) == snap
    for got in outs['a'] + outs['b']:
        np.testing.assert_array_equal(got, want)


# --- ModelRegistry ----------------------------------------------------------

def test_registry_state_machine_same_dir_as_jax(tmp_path):
    """One directory, model files from both packages: the same
    transitions, adopted counters and blacklist from both registries,
    and the reloaded engines score alike."""
    save_with_digest(jnet(), tmp_path / '0000.model', 'jax')
    jeng, teng = _engines(tmp_path)
    jreg = JRegistry(jeng, str(tmp_path), current=0)
    treg = ModelRegistry(teng, str(tmp_path), current=0)
    regs = (jreg, treg)
    log = []

    def poll():
        out = [r.poll_once() for r in regs]
        log.append(out)
        assert out[0] == out[1]
        assert jreg.states() == treg.states()
        assert jreg.current == treg.current
        assert jeng.version == teng.version
        np.testing.assert_allclose(teng.predict_scores(_x(2)),
                                   jeng.predict_scores(_x(2)), rtol=RTOL,
                                   atol=ATOL)

    poll()                                            # nothing newer
    save_with_digest(rig_constant_class(tnet(7)), tmp_path / '0001.model',
                     'port')
    poll()                                            # port-written: adopt
    assert treg.states() == ['DETECTED', 'VERIFYING', 'LOADING', 'WARMING',
                             'SWAPPED']
    assert np.all(teng.predict(_x(3)) == 2.0)
    save_with_digest(jnet(8), tmp_path / '0002.model', 'jax')
    corrupt(str(tmp_path / '0002.model'))             # JAX-written, bad
    for _ in range(treg.retry.max_attempts + 2):
        poll()                                        # counted, blacklisted
    save_with_digest(tnet(9), tmp_path / '0003.model', 'port')
    corrupt(str(tmp_path / '0003.model'), at=200)     # port-written, bad
    save_with_digest(jnet(10), tmp_path / '0004.model', 'jax')
    poll()                                            # the newest is good
    assert treg.current == 4
    assert treg._attempts == jreg._attempts == {
        2: treg.retry.max_attempts}
    assert treg.swaps == jreg.swaps == 2
    trep, jrep = treg.report(), jreg.report()
    assert _keys(trep) == _keys(jrep)
    assert [t for t in trep.split('\t') if 'age' not in t] \
        == [t for t in jrep.split('\t') if 'age' not in t]
    assert treg.status_view() == jreg.status_view()


def _keys(line):
    return [tok.split(':')[0] for tok in line.split('\t') if ':' in tok]


def test_registry_rejects_corrupt_checkpoint_and_keeps_serving(tmp_path):
    save_with_digest(tnet(), tmp_path / '0000.model', 'port')
    _, eng = _engines(tmp_path)
    log = tfaults.FailureLog()
    before = eng.predict_scores(_x(1))
    reg = ModelRegistry(eng, str(tmp_path), current=0, log=log)
    save_with_digest(tnet(3), tmp_path / '0001.model', 'port')
    corrupt(str(tmp_path / '0001.model'), at=200)
    assert not reg.poll_once()
    assert reg.states()[-1] == 'REJECTED'
    assert reg.current == 0 and eng.swap_count == 0
    np.testing.assert_array_equal(eng.predict_scores(_x(1)), before)
    for _ in range(10):
        reg.poll_once()
    assert sum(s == 'REJECTED' for s in reg.states()) \
        == reg.retry.max_attempts
    assert [r.kind for r in log.records()] \
        == ['serve_reload_reject'] * reg.retry.max_attempts


def test_registry_falls_back_past_corrupt_newest(tmp_path):
    for pkg in ('port', 'jax'):
        d = tmp_path / pkg
        d.mkdir()
        save_with_digest(tnet(), d / '0000.model', 'port')
        eng = (_engines(d)[1] if pkg == 'port' else _engines(d)[0])
        reg = (ModelRegistry if pkg == 'port' else JRegistry)(
            eng, str(d), current=0)
        save_with_digest(rig_constant_class(jnet(13)), d / '0001.model',
                         'jax')
        save_with_digest(tnet(14), d / '0002.model', 'port')
        corrupt(str(d / '0002.model'))
        assert reg.poll_once()           # 0002 rejected, 0001 adopted
        assert reg.current == 1 and eng.version == 1
        assert reg.states() == ['DETECTED', 'VERIFYING', 'REJECTED',
                                'DETECTED', 'VERIFYING', 'LOADING',
                                'WARMING', 'SWAPPED']
        assert np.all(eng.predict(np.zeros((3, 1, 1, 8), np.float32)) == 2.0)


def test_registry_rejects_structural_mismatch(tmp_path):
    other_cfg = NET_CFG.replace('layer[+1] = relu', 'layer[+1] = sigmoid')
    path = str(tmp_path / 'other.model')
    jnet(cfg=other_cfg).save_model(path)
    eng = PredictEngine(tnet().trainer, (8,))
    with pytest.raises(ValueError, match='architecture'):
        load_model_params(eng, path)
    # and the registry turns it into a REJECTED cycle
    os.rename(path, str(tmp_path / '0001.model'))
    reg = ModelRegistry(eng, str(tmp_path), current=0)
    assert not reg.poll_once()
    assert reg.states()[-1] == 'REJECTED' and 'architecture' in \
        reg.transitions[-1][1]


def test_registry_watcher_thread_lifecycle(tmp_path):
    save_with_digest(tnet(), tmp_path / '0000.model', 'port')
    _, eng = _engines(tmp_path)
    reg = ModelRegistry(eng, str(tmp_path), poll_interval=0.02, current=0)
    reg.start()
    reg.start()                          # idempotent
    assert sum(t.name == 'serve-registry'
               for t in threading.enumerate()) >= 1
    save_with_digest(rig_constant_class(jnet(11)), tmp_path / '0001.model',
                     'jax')
    deadline = time.monotonic() + 10
    while reg.current != 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert reg.current == 1
    assert reg.last_swap_age_s() >= 0.0
    assert set(reg.last_timings) == {'verify_s', 'load_s', 'warm_s',
                                     'swap_s'}
    assert reg.close(timeout=5)
    assert reg.close(timeout=5)          # idempotent


def test_e2e_concurrent_serve_hot_reload_zero_drops(tmp_path):
    """Six clients with mixed request sizes; mid-traffic the registry
    swaps in a new checkpoint.  Every request completes, the engine ran
    exactly ``len(buckets)`` shapes, and after the swap the scores are a
    fresh engine's on the new weights (and JAX's)."""
    buckets = (1, 8, 32)
    save_with_digest(tnet(), tmp_path / '0000.model', 'port')
    jeng, eng = _engines(tmp_path, buckets)
    eng.warm()
    bat = DynamicBatcher(eng, max_queue=256, max_wait=0.002, deadline=30.0)
    reg = ModelRegistry(eng, str(tmp_path), current=0)
    jreg = JRegistry(jeng, str(tmp_path), current=0)
    done, errors = [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(cid):
        rng = np.random.RandomState(cid)
        while not stop.is_set():
            n = int(rng.randint(1, 13))
            try:
                s = bat.submit(rng.randn(n, 1, 1, 8).astype(np.float32))
                with lock:
                    done.append((eng.version, s.shape))
            except Exception as e:  # noqa: BLE001 — fails the test below
                with lock:
                    errors.append(e)

    def count(version):
        with lock:
            return sum(1 for v, _ in done if v == version)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 60
        while count(0) < 30 and time.monotonic() < deadline:
            time.sleep(0.005)
        new = rig_constant_class(jnet(21))
        save_with_digest(new, tmp_path / '0001.model', 'jax')
        assert reg.poll_once() and jreg.poll_once()
        while count(1) < 30 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        bat.close(30)
    assert not errors, errors[:3]
    assert count(0) >= 30 and count(1) >= 30
    assert all(len(shape) == 2 and shape[1] == 4 for _, shape in done)
    assert eng.compile_count == len(buckets)
    fresh = tw.Net(dev='cpu', cfg=NET_CFG)
    fresh.load_model(str(tmp_path / '0001.model'))
    x = _x(5, 9)
    np.testing.assert_array_equal(
        eng.predict_scores(x), PredictEngine(fresh.trainer,
                                             buckets).predict_scores(x))
    np.testing.assert_allclose(eng.predict_scores(x),
                               jeng.predict_scores(x), rtol=RTOL, atol=ATOL)
    assert bat.stats.get('requests') == len(done)


# --- ReplicatedPredictEngine -------------------------------------------------

@pytest.fixture(scope='module')
def predict_pair():
    return tnet(), jnet()


def test_replicas_score_bitwise_like_base(predict_pair):
    net, j = predict_pair
    base = PredictEngine(net.trainer, (8,))
    rep = ReplicatedPredictEngine(net.trainer, (8,), replicas=3,
                                  devices=['cpu'] * 3)
    jrep_scores = JEngine(j._trainer, (8,)).predict_scores(_x(0, 5))
    try:
        s0 = base.predict_scores(_x(0, 5))
        for _ in range(3):          # every replica takes a turn
            np.testing.assert_array_equal(rep.predict_scores(_x(0, 5)), s0)
        np.testing.assert_allclose(s0, jrep_scores, rtol=RTOL, atol=ATOL)
        # three replicas on one device: one entry, three full copies
        per = rep.resident_bytes_per_device()
        assert per == [rep.resident_bytes()]
        assert per[0] == 3 * base.resident_bytes()
        assert rep.compile_count == 3   # one bucket x 3 replicas
        view = rep.capacity_view()
        assert (view['replicas'], view['queued_windows']) == (3, 0)
    finally:
        rep.close(10)


def test_replicas_batcher_round_robin_is_bitwise(predict_pair):
    net, _ = predict_pair
    rep = ReplicatedPredictEngine(net.trainer, (8,), replicas=2,
                                  devices=['cpu', 'cpu'], stats=StatSet())
    bat = DynamicBatcher(rep, max_queue=64, max_wait=0.001, deadline=30.0,
                         stats=rep.stats)
    try:
        data = _x(1, 6)
        base = rep.engines[0].predict_scores(data)
        for i in range(6):          # one window a request: strict rotation
            r = bat.submit_async(data[i:i + 1])
            np.testing.assert_array_equal(bat.wait(r), base[i:i + 1])
        assert [rep.stats.get(f'replica_rows[r{i}]') for i in range(2)] \
            == [3, 3]
        assert rep.stats.get('requests') == 6
    finally:
        bat.close()
        rep.close(10)


def test_replicas_fleet_swap_is_atomic_under_traffic(predict_pair):
    """The swap drains every replica and flips them together: no request
    fails, no window runs while the replicas' versions differ, and every
    replica serves the last swap's tree."""
    net, _ = predict_pair
    tr = net.trainer
    rep = ReplicatedPredictEngine(tr, (8,), replicas=2,
                                  devices=['cpu', 'cpu'], stats=StatSet())
    bat = DynamicBatcher(rep, max_queue=256, max_wait=0.001, deadline=30.0,
                         stats=rep.stats)
    seen = []
    for e in rep.engines:
        orig = e.predict_scores

        def wrapped(data, orig=orig):
            seen.append(tuple(x.version for x in rep.engines))
            return orig(data)
        e.predict_scores = wrapped
    data = _x(2)
    p2 = {k: {f: v * 1.5 for f, v in fs.items()}
          for k, fs in tr.params.items()}
    stop = threading.Event()
    errs = []

    def pound():
        while not stop.is_set():
            try:
                bat.submit(data)
            except Exception as e:  # noqa: BLE001 — recorded
                errs.append(e)
                return

    thr = [threading.Thread(target=pound) for _ in range(3)]
    try:
        for t in thr:
            t.start()
        time.sleep(0.05)
        for v in range(1, 4):
            rep.swap_params(p2 if v % 2 else tr.params, version=v)
            time.sleep(0.02)
        stop.set()
        for t in thr:
            t.join(30)
        assert not errs, errs[:2]
        assert rep.swap_count == 3 and rep.version == 3
        assert seen and all(len(set(vs)) == 1 for vs in seen)
        assert len({vs[0] for vs in seen}) >= 2
        s_each = [e.predict_scores(data) for e in rep.engines]
        np.testing.assert_array_equal(s_each[0], s_each[1])
        last = PredictEngine(tr, (8,))
        last.swap_params(p2)                      # version 3 is p2's
        np.testing.assert_array_equal(s_each[0], last.predict_scores(data))
    finally:
        stop.set()
        bat.close()
        rep.close(10)
    time.sleep(0.2)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith('cxxnet-replica-')]


def test_replicas_close_fails_queued_windows(predict_pair):
    net, _ = predict_pair
    rep = ReplicatedPredictEngine(net.trainer, (8,), replicas=1,
                                  devices=['cpu'], stats=StatSet())
    gate = threading.Event()
    orig = rep.engines[0].predict_scores

    def gated(data):
        gate.wait(10)
        return orig(data)

    rep.engines[0].predict_scores = gated
    from cxxnet_tpu_torch.serve.batcher import ServeRequest
    reqs = [ServeRequest(_x(i, 1), 30.0) for i in range(3)]
    for r in reqs:
        rep.execute_requests([r])
    time.sleep(0.05)                    # the worker holds the first window
    closer = threading.Thread(target=rep.close, args=(10,))
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(10)
    assert reqs[0].event.is_set() and reqs[0].error is None
    for r in reqs[1:]:
        assert r.event.is_set() and isinstance(r.error, tfaults.ServeError)
    with pytest.raises(tfaults.ServeError, match='closed'):
        rep.execute_requests([ServeRequest(_x(), 30.0)])


def test_replicas_shed_expired_and_abandoned(predict_pair):
    net, _ = predict_pair
    stats = StatSet()
    rep = ReplicatedPredictEngine(net.trainer, (8,), replicas=1,
                                  devices=['cpu'], stats=stats)
    from cxxnet_tpu_torch.serve.batcher import ServeRequest
    try:
        dead = ServeRequest(_x(0, 2), 0.0)
        gone = ServeRequest(_x(1, 1), 30.0)
        gone.abandoned = True
        live = ServeRequest(_x(2, 3), 30.0)
        rep.execute_requests([dead, gone, live])
        for r in (dead, gone, live):
            assert r.event.wait(10)
        assert isinstance(dead.error, tfaults.DeadlineExceededError)
        assert isinstance(gone.error, tfaults.RequestAbandonedError)
        assert live.error is None and live.result.shape == (3, 4)
        assert (stats.get('expired'), stats.get('abandoned'),
                stats.get('requests'), stats.get('replica_rows[r0]')) \
            == (1, 1, 1, 3)
    finally:
        rep.close(10)


def test_replicas_validate_like_jax(predict_pair):
    import torch
    net, j = predict_pair
    msgs = []
    for cls, tr in ((ReplicatedPredictEngine, net.trainer),
                    (jfaults and __import__('cxxnet_tpu.serve', fromlist=[
                        'ReplicatedPredictEngine']).ReplicatedPredictEngine,
                     j._trainer)):
        with pytest.raises(ValueError) as e:
            cls(tr, (8,), replicas=0)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match='devices') as e:
            cls(tr, (8,), replicas=999, devices=['cpu'] * 3
                if cls is ReplicatedPredictEngine else None)
        msgs.append(str(e.value).split(' exceeds')[0])
    assert msgs[0] == msgs[2] == 'serve.replicas must be >= 1'
    assert msgs[1] == msgs[3] == 'serve.replicas=999'
    # devices=None is every CUDA device: JAX's words for the count here
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f'serve.replicas={n + 1} exceeds '
                       f'the {n} available devices'):
        ReplicatedPredictEngine(net.trainer, (8,), replicas=n + 1)


def test_replicas_reload_through_the_registry(tmp_path):
    """The registry's place / warm / swap on a replicated engine: one
    placement a replica, every replica on the new checkpoint, scores
    JAX's."""
    save_with_digest(tnet(), tmp_path / '0000.model', 'port')
    jeng, teng = _engines(tmp_path)
    rep = ReplicatedPredictEngine(teng.trainer, (1, 8), replicas=2,
                                  devices=['cpu', 'cpu'])
    try:
        reg = ModelRegistry(rep, str(tmp_path), current=0)
        save_with_digest(rig_constant_class(jnet(4), 3),
                         tmp_path / '0001.model', 'jax')
        assert reg.poll_once() and rep.version == 1
        assert [e.swap_count for e in rep.engines] == [1, 1]
        assert JRegistry(jeng, str(tmp_path), current=0).poll_once()
        # JAX's replicated engine has no trainer for the loader's
        # structural check, so its registry rejects the same checkpoint
        # there (ROADMAP queue C: repaired in the port)
        from cxxnet_tpu.serve import ReplicatedPredictEngine as JRep
        jrep = JRep(jeng.trainer, (1, 8), replicas=2)
        try:
            jr = JRegistry(jrep, str(tmp_path), current=0)
            assert not jr.poll_once()
            assert 'trainer' in jr.transitions[-1][1]
        finally:
            jrep.close(10)
        for e in rep.engines:
            np.testing.assert_allclose(e.predict_scores(_x()),
                                       jeng.predict_scores(_x()),
                                       rtol=RTOL, atol=ATOL)
            assert np.all(e.predict(_x()) == 3.0)
    finally:
        rep.close(10)


# --- MemoryBudgeter / MultiModelRegistry --------------------------------------

class _Stub:
    def __init__(self, nbytes, busy=False):
        self.nbytes = nbytes
        self._busy = busy
        self.closed = False
        self.version = 0

    def resident_bytes(self):
        return self.nbytes

    def busy(self):
        return self._busy

    def close(self, timeout=None):
        self.closed = True


def test_budgeter_ledger_matches_jax():
    out = []
    for cls in (MemoryBudgeter, JBudgeter):
        b = cls(100)
        b.account('a', 60)
        b.account('b', 30)
        r = [b.usage(), b.over_budget()]
        b.account('c', 30)
        r += [b.over_budget(), b.release('a'), b.usage()]
        b.account('rep', [20, 50])       # a replicated engine's vector
        r += [b.usage(), b.usage_per_device(), b.over_budget(),
              b.resident(), b.set_budget(40), b.over_budget(),
              cls(0).over_budget()]
        out.append(r)
    assert out[0] == out[1]
    assert out[0][:5] == [90, 0, 20, 60, 60]


def _fleet_script(fleet_cls, err_cls, engines):
    """One sequence of loads, touches, leases and evictions; returns what
    each step left loaded and the errors' fields."""
    trail = []

    def mk(mid, nbytes, busy=False):
        def factory():
            engines[mid] = _Stub(nbytes, busy)
            return engines[mid]
        return factory

    fleet = fleet_cls(mem_budget=130)
    fleet.add_model('a', mk('a', 60), load=True)
    time.sleep(0.002)
    fleet.add_model('b', mk('b', 60), load=True)
    trail.append(fleet.loaded())
    fleet.add_model('c', mk('c', 60), load=True)    # a is coldest
    trail.append(fleet.loaded())
    fleet.get('b')
    fleet.get('a')                                  # c is coldest now
    trail.append(fleet.loaded())
    with fleet.lease('a'):
        with fleet.lease('b'):
            with pytest.raises(err_cls) as e:
                fleet.get('c')                      # both leased
            trail.append((e.value.model_id, e.value.needed, e.value.budget,
                          e.value.resident, fleet.loaded()))
    fleet.add_model('busy', mk('busy', 100, busy=True))
    fleet.evict('a')
    fleet.evict('b')
    fleet.get('busy')
    with pytest.raises(err_cls) as e:
        fleet.get('a')                              # busy is serving
    trail.append((str(e.value), fleet.loaded()))
    trail.append((fleet.evict_coldest(), fleet.evictions,
                   sorted(_keys(fleet.report()))))
    fleet.add_model('pinned', mk('pinned', 10), pinned=True, load=True)
    trail.append(fleet.loaded())
    fleet.close(5)
    return trail


def test_fleet_eviction_order_matches_jax():
    te, je = {}, {}
    got = _fleet_script(MultiModelRegistry,
                        tfaults.MemoryBudgetExceededError, te)
    want = _fleet_script(JFleet, jfaults.MemoryBudgetExceededError, je)
    assert got[:-2] == want[:-2]
    assert got[-1] == want[-1]
    evicted, n, keys = got[-2]
    jevicted, jn, jkeys = want[-2]
    assert (evicted, n) == (jevicted, jn)
    assert keys == sorted(k for k in jkeys if k != 'fleet-budget_drift')
    assert te['a'].closed and je['a'].closed
    assert got[1] == ['b', 'c'] and got[2] == ['a', 'b']


@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_fleet_of_real_engines_matches_jax(tmp_path, dtype):
    """Three models of one architecture under a budget that fits two (at
    the tier's own bytes): loading the third evicts the coldest, a
    leased one never goes, the rollback raises the same error, and the
    resident bytes and the report are JAX's."""
    dirs = {}
    for i, mid in enumerate('xyz'):
        d = tmp_path / mid
        d.mkdir()
        save_with_digest(jnet(30 + i), d / '0001.model', 'jax')
        dirs[mid] = str(d)
    one = PredictEngine(tnet().trainer, (4,), dtype=dtype).resident_bytes()
    budget = int(one * 2.5)

    def run(fleet_cls, net_cls, engine_cls, err_cls):
        trail = []

        def factory(mdir):
            def make():
                n = net_cls(dev='cpu', cfg=NET_CFG)
                n.load_model(os.path.join(mdir, '0001.model'))
                return engine_cls(getattr(n, '_trainer'), (4,), dtype=dtype)
            return make

        fleet = fleet_cls(mem_budget=budget)
        for mid, mdir in dirs.items():
            fleet.add_model(mid, factory(mdir), model_dir=mdir)
        fleet.get('x')
        time.sleep(0.002)
        fleet.get('y')
        trail.append(fleet.loaded())
        fleet.get('z')
        trail.append(fleet.loaded())
        with fleet.lease('y') as eng:
            scores = eng.predict_scores(_x(6))
            fleet.get('x')                        # z is cold: it goes
            trail.append(fleet.loaded())
            with fleet.lease('x'):
                with pytest.raises(err_cls) as e:
                    fleet.get('z')
                trail.append((e.value.needed, e.value.budget,
                              e.value.resident, fleet.loaded()))
        trail.append(fleet.budgeter.resident())
        trail.append(sorted(k for k in _keys(fleet.report())
                            if k != 'fleet-budget_drift'))
        fleet.close(5)
        return trail, scores

    got, ts = run(MultiModelRegistry, tw.Net, PredictEngine,
                  tfaults.MemoryBudgetExceededError)
    want, js = run(JFleet, jw.Net, JEngine,
                   jfaults.MemoryBudgetExceededError)
    assert got == want
    assert got[1] == ['y', 'z'] and got[2] == ['x', 'y']
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == 'f32' else \
        dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(ts, js, **tol)


def test_fleet_reloads_each_model_from_its_dir(tmp_path):
    """A fleet model hot-reloads through its own registry; the blacklist
    outlives an eviction (it is the entry's, not the engine's)."""
    d = tmp_path / 'a'
    d.mkdir()
    save_with_digest(tnet(1), d / '0001.model', 'port')
    log = tfaults.FailureLog()
    fleet = MultiModelRegistry(log=log)

    def factory():
        n = tw.Net(dev='cpu', cfg=NET_CFG)
        n.load_model(str(d / '0001.model'))
        return PredictEngine(n.trainer, (4,))

    fleet.add_model('a', factory, model_dir=str(d), current=1, load=True)
    save_with_digest(tnet(2), d / '0002.model', 'port')
    corrupt(str(d / '0002.model'))
    attempts = tfaults.DEFAULT_IO_RETRY.max_attempts
    for _ in range(attempts + 1):
        assert fleet.poll_once() == 0
    fleet.evict('a')
    fleet.get('a')
    assert fleet.poll_once() == 0         # 0002 stays blacklisted
    save_with_digest(rig_constant_class(tnet(3)), d / '0003.model', 'port')
    assert fleet.poll_once() == 1
    assert np.all(fleet.get('a').predict(_x()) == 2.0)
    kinds = [r.kind for r in log.records()]
    assert kinds.count('serve_reload_reject') == attempts
    assert kinds.count('serve_evicted') == 1
    fleet.swap_model('a', tnet(4).trainer.params, version='manual')
    assert fleet.get('a').version == 'manual'
    fleet.close(5)


def test_fleet_watcher_and_refused_kv_wiring(tmp_path):
    fleet = MultiModelRegistry(poll_interval=0.02)
    fleet.start()
    fleet.start()
    assert any(t.name == 'serve-fleet' for t in threading.enumerate())
    fleet.close(5)
    # the tiered-KV wiring is ported (queue A item 7): no root, no kwargs;
    # with a root, the same per-model dirs as JAX's registry
    assert fleet.kv_engine_kwargs('a', kv_host_mb=4) == {}
    root = str(tmp_path)
    kv_fleet = MultiModelRegistry(kv_share_dir=root)
    jfleet = JFleet(kv_share_dir=root)
    assert kv_fleet.kv_share_dir == jfleet.kv_share_dir == root
    for host, disk in ((4, 0), (0, 64), (4, 64), (0, 0)):
        got = kv_fleet.kv_engine_kwargs('a', kv_host_mb=host,
                                        kv_disk_mb=disk)
        assert got == jfleet.kv_engine_kwargs('a', kv_host_mb=host,
                                              kv_disk_mb=disk)
    assert got == {} and kv_fleet.kv_engine_kwargs(
        'b', 0, 64)['kv_share_dir'] == os.path.join(root, 'shared', 'b')


# --- decode models under the registry ------------------------------------

LM_KW = dict(vocab_size=64, d_model=32, num_heads=4, d_ff=48, num_stages=2,
             seq_len=32, attn='local')
CFG, JCFG = T.TransformerConfig(**LM_KW), JT.TransformerConfig(**LM_KW)
DCFG = T.TransformerConfig(vocab_size=64, d_model=16, num_heads=2, d_ff=24,
                           num_stages=1, attn='local')


def _lm(seed=0, cfg=CFG):
    return T.init_params(np.random.RandomState(seed), cfg)


def _prompt(rng):
    return rng.randint(0, 64, (1, int(rng.randint(1, 12)))).astype(np.int32)


def _wait_ok(req, timeout=60):
    assert req.event.wait(timeout), 'request never completed'
    if req.error is not None:
        raise req.error
    return req.result


def _assert_twin(got, off):
    got = np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(off)[:len(got)])


def _offline(params, cfg, prompt, max_new):
    return T.generate(params, prompt, max_new, cfg)[0]


def test_lm_registry_drains_then_swaps(tmp_path):
    """A new ``%04d.lm`` swaps in while a stream is mid-decode: the
    stream finishes on the old tree, nothing drops, the next request
    serves the new one (JAX ``tests/test_serve_decode.py:514``)."""
    pa, pb = _lm(0), _lm(21)
    save_lm_params(str(tmp_path / '0001.lm'), pa)
    eng = DecodeEngine(pa, CFG, slots=2, pages=64, page_size=8,
                       max_prompt=16, max_new_bound=64, device='cpu')
    reg = ModelRegistry(eng, str(tmp_path), current=1, pattern=LM_PATTERN,
                        loader=lm_loader)
    try:
        assert not reg.poll_once()
        rng = np.random.RandomState(12)
        p1, p2 = _prompt(rng), _prompt(rng)
        r1 = eng.submit_direct(p1, max_new=48)
        save_lm_params(str(tmp_path / '0002.lm'), pb)
        assert reg.poll_once() and reg.current == 2
        assert reg.states()[-1] == 'SWAPPED'
        assert r1.event.is_set() and r1.error is None
        _assert_twin(r1.result, _offline(pa, CFG, p1, 48))
        _assert_twin(_wait_ok(eng.submit_direct(p2, max_new=6)),
                     _offline(pb, CFG, p2, 6))
        assert eng.version == 2
    finally:
        eng.close(30)


def test_lm_registry_rejects_corrupt_and_keeps_serving(tmp_path):
    pa, pb = _lm(0), _lm(22)
    save_lm_params(str(tmp_path / '0001.lm'), pa)
    eng = DecodeEngine(pa, CFG, slots=2, pages=32, page_size=8,
                       max_prompt=16, max_new_bound=16, device='cpu')
    jeng = JDecodeEngine(JT.init_params(np.random.RandomState(0), JCFG),
                         JCFG, slots=2, pages=32, page_size=8,
                         max_prompt=16, max_new_bound=16)
    from cxxnet_tpu.serve.decode import (LM_PATTERN as JPATTERN,
                                         lm_loader as jloader)
    regs = (ModelRegistry(eng, str(tmp_path), current=1, pattern=LM_PATTERN,
                          loader=lm_loader),
            JRegistry(jeng, str(tmp_path), current=1, pattern=JPATTERN,
                      loader=jloader))
    try:
        assert LM_PATTERN == JPATTERN
        path = str(tmp_path / '0002.lm')
        save_lm_params(path, pb)
        corrupt(path, at=100, data=b'\xff\xff\xff\xff')
        for reg in regs:
            assert not reg.poll_once()
            assert reg.current == 1
        assert regs[0].states() == regs[1].states()
        assert regs[0].states()[-1] == 'REJECTED'
        p = _prompt(np.random.RandomState(13))
        _assert_twin(_wait_ok(eng.submit_direct(p, max_new=4)),
                     _offline(pa, CFG, p, 4))
    finally:
        eng.close(30)
        jeng.close(30)


@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
def test_lm_quantized_tier_reloads_once_quantized(tmp_path, dtype):
    """At a quantized tier the registry's placement is quantized once:
    ``warm_params`` and ``swap_params`` take it as it is."""
    pa, pb = _lm(0), _lm(5)
    save_lm_params(str(tmp_path / '0001.lm'), pa)
    eng = DecodeEngine(pa, CFG, slots=2, pages=32, page_size=8,
                       max_prompt=16, max_new_bound=16, dtype=dtype,
                       device='cpu')
    try:
        reg = ModelRegistry(eng, str(tmp_path), current=1,
                            pattern=LM_PATTERN, loader=lm_loader)
        save_lm_params(str(tmp_path / '0002.lm'), pb)
        placed = eng.place_params(pb)
        assert eng.place_params(placed) is placed
        assert reg.poll_once() and eng.version == 2
        p = _prompt(np.random.RandomState(8))
        got = _wait_ok(eng.submit_direct(p, max_new=6))
        _assert_twin(got, T.generate(eng.params, p, 6, eng.cfg)[0])
    finally:
        eng.close(30)


def test_budgeter_fits_more_int8_models():
    """Under a budget sized for one f32 decode engine, two int8 engines
    fit where two f32 ones cannot (JAX ``tests/test_quantize.py:255``),
    and each tier's ``resident_bytes`` is JAX's."""
    def factory(dtype, pkg='port'):
        if pkg == 'jax':
            return lambda: JDecodeEngine(
                JT.init_params(np.random.RandomState(0), JCFG), JCFG,
                slots=2, pages=32, page_size=8, max_prompt=16,
                max_new_bound=16, dtype=dtype)
        return lambda: DecodeEngine(_lm(), CFG, slots=2, pages=32,
                                    page_size=8, max_prompt=16,
                                    max_new_bound=16, dtype=dtype,
                                    device='cpu')

    for dtype in ('f32', 'int8'):
        t, j = factory(dtype)(), factory(dtype, 'jax')()
        assert t.resident_bytes() == j.resident_bytes()
        t.close(30)
        j.close(30)
    probe = factory('f32')()
    budget = int(probe.resident_bytes() * 1.2)
    probe.close(30)
    fleet = MultiModelRegistry(mem_budget=budget)
    fleet.add_model('a8', factory('int8'))
    fleet.add_model('b8', factory('int8'))
    try:
        fleet.get('a8')
        fleet.get('b8')
        assert fleet.loaded() == ['a8', 'b8']
    finally:
        fleet.close(10)
    fleet32 = MultiModelRegistry(mem_budget=budget)
    fleet32.add_model('a32', factory('f32'), pinned=True)
    fleet32.add_model('b32', factory('f32'))
    try:
        fleet32.get('a32')
        with pytest.raises(tfaults.MemoryBudgetExceededError):
            fleet32.get('b32')
    finally:
        fleet32.close(10)


def test_real_decode_engines_under_budget():
    """A second model loading under pressure evicts the cold model, never
    the one with streams in flight."""
    pa, pb = _lm(0), _lm(31)
    probe = DecodeEngine(pa, CFG, slots=2, pages=16, page_size=8,
                         max_prompt=16, max_new_bound=32, device='cpu')
    fleet = MultiModelRegistry(mem_budget=int(probe.resident_bytes() * 1.4))
    probe.close(30)

    def mk(params):
        return lambda: DecodeEngine(params, CFG, slots=2, pages=16,
                                    page_size=8, max_prompt=16,
                                    max_new_bound=32, device='cpu')

    try:
        fleet.add_model('a', mk(pa), load=True)
        eng_a = fleet.get('a')
        p = _prompt(np.random.RandomState(14))
        req = eng_a.submit_direct(p, max_new=32)
        with pytest.raises(tfaults.MemoryBudgetExceededError):
            fleet.add_model('b', mk(pb), load=True)
        assert fleet.loaded() == ['a']
        _assert_twin(_wait_ok(req), _offline(pa, CFG, p, 32))
        deadline = time.time() + 5
        while eng_a.busy() and time.time() < deadline:
            time.sleep(0.01)
        fleet.get('b')
        assert fleet.loaded() == ['b']
    finally:
        fleet.close(30)


def test_attach_draft_hot_swaps_and_streams_unchanged(tmp_path):
    """A new draft checkpoint swaps into the decode engine's draft slot
    through the verify / blacklist machinery and never changes a stream
    (JAX ``tests/test_serve_spec.py:554``)."""
    target, draft = _lm(0), _lm(1, DCFG)
    fleet = MultiModelRegistry()
    holder = {}

    def factory():
        holder['eng'] = DecodeEngine(target, CFG, slots=2, pages=32,
                                     page_size=8, max_prompt=16,
                                     max_new_bound=16, spec_k=3,
                                     draft=(draft, DCFG), device='cpu')
        return holder['eng']

    fleet.add_model('lm', factory, load=True)
    reg = fleet.attach_draft('lm', str(tmp_path), pattern=LM_PATTERN,
                             loader=lm_loader)
    try:
        eng = holder['eng']
        p = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
        off = _offline(target, CFG, p, 8)
        _assert_twin(_wait_ok(eng.submit_direct(p, max_new=8)), off)
        assert fleet.poll_once() == 0
        save_lm_params(str(tmp_path / '0001.lm'), target)   # wrong shape
        assert fleet.poll_once() == 0
        assert 'REJECTED' in reg.states()
        save_lm_params(str(tmp_path / '0002.lm'), _lm(8, DCFG))
        assert fleet.poll_once() == 1
        assert eng.draft_version == 2
        _assert_twin(_wait_ok(eng.submit_direct(p.copy(), max_new=8)), off)
        with pytest.raises(ValueError, match='no draft slot'):
            fleet.add_model('plain', lambda: DecodeEngine(
                target, CFG, slots=1, pages=8, page_size=8, max_prompt=8,
                max_new_bound=8, device='cpu'), load=True)
            fleet.attach_draft('plain', str(tmp_path))
    finally:
        fleet.close(30)


# --- the surfaces: wrapper, C ABI, CLI --------------------------------------

def test_wrapper_fleet_routes_models_and_reports_budget(tmp_path):
    """``serve_start(models=...)``: requests route per model id (JAX's
    scores on the same JAX-written files), the ledger prints with the
    stats, an evicted model reloads on its next request, and a deadline
    is refused on the fleet path."""
    a_dir, b_dir = tmp_path / 'a', tmp_path / 'b'
    a_dir.mkdir()
    b_dir.mkdir()
    rig_constant_class(jnet(1), cls=1).save_model(str(a_dir / '0001.model'))
    jb = jnet(2)
    jb.save_model(str(b_dir / '0001.model'))
    models = {'a': str(a_dir), 'b': str(b_dir)}
    net = tnet()
    jserve = jnet()
    net.serve_start(buckets='1,4', models=models)
    jserve.serve_start(buckets='1,4', models=models)
    try:
        x = _x(4, 2)
        assert (net.serve_predict(x, model='a') == 1).all()
        assert (jserve.serve_predict(x, model='a') == 1).all()
        np.testing.assert_allclose(net.serve_scores(x, model='b'),
                                   jserve.serve_scores(x, model='b'),
                                   rtol=RTOL, atol=ATOL)
        stats = net.serve_stats()
        assert 'fleet-models_loaded:2' in stats and 'fleet-bytes[a]' in stats
        jstats = jserve.serve_stats()
        # budget_drift too: both packages hold the budgeter against the
        # forwards' ledger rows
        assert [k for k in _keys(stats) if k.startswith('fleet-')] == [
            k for k in _keys(jstats) if k.startswith('fleet-')]
        assert 'fleet-budget_drift:0' in stats
        net.fleet.evict('a')
        assert net.fleet.loaded() == ['b']
        assert (net.serve_predict(x, model='a') == 1).all()
        with pytest.raises(ValueError, match='deadline'):
            net.serve_scores(x, deadline=1.0, model='a')
        with pytest.raises(KeyError):
            net.serve_scores(x, model='nope')
    finally:
        net.serve_stop()
        jserve.serve_stop()
    assert net.fleet is None
    with pytest.raises(RuntimeError, match='models'):
        tnet().serve_scores(_x(), model='a')


def test_wrapper_fleet_factory_owns_every_reference(tmp_path):
    """The factory keeps no trainer: once the fleet evicts a model and
    the caller drops the engine, nothing of it stays reachable."""
    import gc
    import weakref
    d = tmp_path / 'a'
    d.mkdir()
    tnet(3).save_model(str(d / '0001.model'))
    net = tnet()
    net.serve_start(buckets='4', models={'a': str(d)})
    try:
        eng = net.fleet.get('a')
        assert eng.trainer.params is None     # the engine's tree alone
        refs = [weakref.ref(eng), weakref.ref(eng.trainer)]
        del eng
        net.fleet.evict('a')
        gc.collect()
        assert [r() for r in refs] == [None, None]
    finally:
        net.serve_stop()


def test_wrapper_replicas_on_cpu_need_devices():
    import torch
    net = tnet()
    n = torch.cuda.device_count()
    if n >= 2:
        pytest.skip('two cards present: serve_start(replicas=2) runs')
    with pytest.raises(ValueError, match=f'exceeds the {n} available'):
        net.serve_start(buckets='4', replicas=2)
    assert net._batcher is None


def test_capi_fleet_options_and_reload(tmp_path):
    net = tnet()
    m1 = tmp_path / 'm1'
    m1.mkdir()
    save_with_digest(tnet(5), m1 / '0001.model', 'port')
    tcapi.net_serve_start(net, f'buckets=1:4;models=a:{m1};mem_budget=4096')
    try:
        x = _x(7, 3)
        np.testing.assert_array_equal(net.serve_scores(x, model='a'),
                                      net.fleet.get('a').predict_scores(x))
        assert net.fleet.budgeter.budget == 4096
        tcapi.net_serve_reload(net, str(m1 / '0001.model'))
        np.testing.assert_array_equal(
            tcapi.net_serve_predict(net, memoryview(x.tobytes()), x.shape),
            net.fleet.get('a').predict(x))
        assert 'fleet-budget_bytes:4096' in tcapi.net_serve_stats(net)
    finally:
        tcapi.net_serve_stop(net)


MLP_CONF = """data = train
iter = mnist
  path_img = "{img}"
  path_label = "{lbl}"
  input_flat = 1
iter = end
pred = pred.txt
iter = mnist
  path_img = "{img}"
  path_label = "{lbl}"
  input_flat = 1
iter = end
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 12
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 3
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 10
eta = 0.1
momentum = 0.9
dev = cpu
"""


@pytest.fixture()
def cli_dir(tmp_path, monkeypatch):
    img, lbl, _, _ = write_mnist(str(tmp_path), n=50)
    (tmp_path / 'mlp.conf').write_text(MLP_CONF.format(img=img, lbl=lbl))
    monkeypatch.chdir(tmp_path)
    assert port_main.main(['mlp.conf', 'num_round=2', 'max_round=2',
                           'silent=1']) == 0
    return tmp_path


def test_cli_serve_reload_models_and_budget(cli_dir, capsys):
    """``task=serve`` with ``serve.reload``, ``serve.models`` and
    ``serve.mem_budget``: the pred file is ``task=pred``'s and the fleet
    and reload lines print, as the JAX CLI prints them."""
    assert port_main.main(['mlp.conf', 'task=pred',
                           'model_in=models/0001.model',
                           'pred=want.txt']) == 0
    capsys.readouterr()
    os.makedirs('b')
    shutil.copy('models/0002.model', 'b/0002.model')
    assert port_main.main(['mlp.conf', 'task=serve',
                           'model_in=models/0001.model',
                           'serve.reload=0.05', 'serve.models=b=b',
                           'serve.mem_budget=100000',
                           'serve.buckets=1,10', 'pred=got.txt']) == 0
    out = capsys.readouterr()
    assert open('got.txt').read() == open('want.txt').read()
    assert 'serve: fleet of 1 models, 1 resident under 100000 bytes' \
        in out.out
    assert '[serve]\tregistry-' in out.err and '[serve]\tfleet-' in out.err
    assert 'compiled 2 programs for 2 buckets' in out.out


def test_cli_serve_hot_reloads_a_newer_checkpoint(cli_dir, capsys):
    """The watcher adopts the newer ``models/0002.model`` while the CLI
    serves from 0001 (the pred file then mixes versions by design)."""
    import cxxnet_tpu_torch.serve.registry as treg
    orig = treg.ModelRegistry.start
    adopted = threading.Event()

    def start(self):
        on_swap = self.on_swap

        def noted(c, p):
            on_swap(c, p)
            adopted.set()
        self.on_swap = noted
        assert self.poll_once()            # adopt before the drive
        orig(self)

    treg.ModelRegistry.start = start
    try:
        assert port_main.main(['mlp.conf', 'task=serve',
                               'model_in=models/0001.model',
                               'serve.reload=0.05', 'pred=p.txt']) == 0
    finally:
        treg.ModelRegistry.start = orig
    out = capsys.readouterr()
    assert adopted.is_set()
    assert 'serve: hot-reloaded checkpoint 2 from models' in out.out
    assert 'registry-last_swap_step:2' in out.err
    assert port_main.main(['mlp.conf', 'task=pred',
                           'model_in=models/0002.model',
                           'pred=want2.txt']) == 0
    assert open('p.txt').read() == open('want2.txt').read()


def test_cli_replicas_take_every_card(cli_dir):
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        pytest.skip('two cards present: serve.replicas=2 runs')
    with pytest.raises(ValueError, match=f'serve.replicas=2 exceeds the '
                       f'{n} available devices'):
        port_main.main(['mlp.conf', 'task=serve',
                        'model_in=models/0001.model', 'serve.replicas=2'])
