"""The train-while-serve loop of ``cxxnet_tpu_torch`` (``online/``, the
CLI's ``task=online``, ``Net.online_*``, ``capi.net_online_*``) against
the JAX package's, on the CPU.

* ``FreshnessTracker`` fed the same stamps on an injected clock gives
  JAX's samples, report line, breach count and failure records.
* ``OnlinePipeline`` on JAX's tiny MLP from the same weights and batches
  publishes the same step-named files at the same cadence as JAX's
  pipeline, each file's params within the trainers' tolerance (rtol 1e-4,
  atol 1e-6), with the same summary and eval-line keys.  The tests drive
  the registry in lock step with the trainer (``_Lockstep``: the writer
  drained, one registry poll and one request before each step, the
  watcher thread parked), so swap and freshness counts are the cadence's
  and never the clock's.
* The port's own bitwise contracts: the chaos drill (a retried write, a
  corrupted serving checkpoint, a NaN streak in one run) never serves the
  poisoned step and ends bitwise equal to a fault-free twin; a save that
  fails past its retries costs freshness, not training.
* The CLI's ``task=online`` against JAX's CLI on one conf (eval-line
  keys, model-file names, the summary's keys), ``continue=1``, the
  ``serve.autoscale`` refusal; the wrapper and the C ABI's functions.
"""

import io as _io
import json
import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.io.data import IIterator as JIter
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.online import FreshnessTracker as JTracker
from cxxnet_tpu.online import OnlineConfig as JConfig
from cxxnet_tpu.online import OnlinePipeline as JPipeline
from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.io.data import DataBatch, IIterator
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.online import (FreshnessTracker, OnlineConfig,
                                     OnlinePipeline)
from cxxnet_tpu_torch.online import freshness as tfresh
from cxxnet_tpu_torch.runtime import faults
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from cxxnet_tpu_torch.serve.registry import load_into_trainer
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

#: JAX's ``tests/test_online.py`` MLP
MLP_CONF = """
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.05
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 4
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 8
dev = cpu
eta = 0.05
momentum = 0.9
metric[label] = error
"""

#: the trainers' tolerance (tests/test_torch_train.py's contract)
RTOL, ATOL = 1e-4, 1e-6
JOIN_S = 120.0


class ListIter(IIterator):
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


class JListIter(JIter):
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _arrays(n, seed=0, bs=8):
    rng = np.random.RandomState(seed)
    centers = np.random.RandomState(99).randn(4, 16).astype(np.float32) * 2
    out = []
    for _ in range(n):
        y = rng.randint(0, 4, bs)
        x = centers[y] + 0.2 * rng.randn(bs, 16).astype(np.float32)
        out.append((x.reshape(bs, 1, 1, 16), y[:, None].astype(np.float32)))
    return out


def _batches(n, seed=0):
    return [DataBatch(x, y) for x, y in _arrays(n, seed)]


def _jbatches(n, seed=0):
    return [JBatch(x, y) for x, y in _arrays(n, seed)]


def _rows(seed=7):
    """A seeded request source: 4 rows a request."""
    rng = np.random.RandomState(seed)
    centers = np.random.RandomState(99).randn(4, 16).astype(np.float32) * 2

    def req():
        y = rng.randint(0, 4, 4)
        return (centers[y] + 0.2 * rng.randn(4, 16).astype(np.float32)
                ).reshape(4, 1, 1, 16)
    return req


def _serve_factory():
    return NetTrainer(parse_config_string(MLP_CONF + 'inference_only = 1\n'))


def _jserve_factory():
    return JTrainer(jparse(MLP_CONF + 'inference_only = 1\n'))


class _Lockstep:
    """``before_step`` of a pipeline run that makes the serving side move
    with the trainer: the writer drained (the last publish committed),
    one registry poll (the watcher itself is parked by a 1 h poll
    period) and one request through the batcher (the first request on a
    swapped version closes its freshness sample)."""

    def __init__(self, rows):
        self.pipe = None
        self.rows = rows
        self.versions = []

    def __call__(self, _i):
        pipe = self.pipe
        pipe._ckpt.drain()
        pipe.registry.poll_once()
        pipe.submit(self.rows())
        self.versions.append(int(pipe.engine.version))


PARKED = 3600.0


def _cfg(cls, tmp, **kw):
    base = dict(model_dir=os.path.join(tmp, 'm'), save_every=10,
                reload_poll=PARKED, buckets=(4, 8), qps=50.0,
                deadline=60.0, watchdog_deadline=60.0, freshness_slo=30.0,
                silent=True)
    base.update(kw)
    return cls(**base)


def _run(tmp, batches, rounds=1, plan=None, log=None, tr=None, jax=False,
         **kw):
    """One lock-stepped pipeline run (the port's, or JAX's with
    ``jax=True``); ``(pipe, summary, trainer, eval lines, lockstep)``."""
    if jax:
        if tr is None:
            tr = JTrainer(jparse(MLP_CONF))
            tr.init_model()
        pipe_cls, cfg_cls, fac, fmod = (JPipeline, JConfig, _jserve_factory,
                                        jfaults)
        it = JListIter(batches)
    else:
        if tr is None:
            tr = NetTrainer(parse_config_string(MLP_CONF))
            tr.init_model()
        pipe_cls, cfg_cls, fac, fmod = (OnlinePipeline, OnlineConfig,
                                        _serve_factory, faults)
        it = ListIter(batches)
    step = _Lockstep(_rows())
    prev = fmod.install_plan(plan)
    pipe = pipe_cls(tr, it, fac, _cfg(cfg_cls, tmp, **kw),
                    failure_log=log)
    step.pipe = pipe
    out = _io.StringIO()
    try:
        summary = pipe.run(num_rounds=rounds, out=out, before_step=step)
    finally:
        pipe.close(timeout=JOIN_S)
        fmod.install_plan(prev)
    return pipe, summary, tr, out.getvalue().strip().splitlines(), step


def _jax_twin():
    """A JAX trainer from the conf's seed and the port's from its
    weights."""
    jtr = JTrainer(jparse(MLP_CONF))
    jtr.init_model()
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    tr.params = params_from_jax(jtr.params)
    return jtr, tr


def _models(d):
    return sorted(f for f in os.listdir(d) if f.endswith('.model'))


def _keys(line):
    return [t.split(':')[0] for t in line.split('\t')[1:]]


def _file_params(path):
    return load_into_trainer(_serve_factory(), path).params


# --- the freshness tracker --------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_freshness_tracker_matches_jax(monkeypatch):
    """Both trackers fed the same stamps on one injected clock: the same
    samples (only the first request a swapped version closes one, the
    bootstrap version and non-integer versions none), report line,
    breaches and failure records; strict mode raises the typed error."""
    from cxxnet_tpu.online import freshness as jfresh
    clock = _Clock()
    monkeypatch.setattr(tfresh, 'time', clock)
    monkeypatch.setattr(jfresh, 'time', clock)
    logs = (faults.FailureLog(), jfaults.FailureLog())
    trs = (FreshnessTracker(slo_s=0.5, log=logs[0]),
           JTracker(slo_s=0.5, log=logs[1]))
    script = [('step', 0, 0.0), ('served', 0, 0.1),       # bootstrap
              ('step', 10, 1.0), ('swap', 10, 1.2), ('served', 10, 1.25),
              ('served', 10, 1.3), ('served', 'v1.model', 1.3),
              ('step', 20, 2.0), ('swap', 20, 2.9), ('served', 20, 3.0),
              ('step', 30, 3.1), ('swap', 30, 3.2),        # never served
              ('served', 99, 3.3)]                          # never swapped
    got = ([], [])
    for kind, step, t in script:
        clock.now = 1000.0 + t
        for k, tr in enumerate(trs):
            if kind == 'step':
                tr.record_step(step, t=clock.now)
            elif kind == 'swap':
                tr.record_swap(step, t=clock.now)
            else:
                got[k].append(tr.note_served(step))
    assert got[0] == got[1]
    assert [g is not None for g in got[0]] == [
        False, True, False, False, True, False]
    assert trs[0].report() == trs[1].report()
    for key in ('freshness_s', 'swap_lag_s'):
        for q in (0.5, 0.99):
            assert trs[0].stats.quantile(key, q) == \
                trs[1].stats.quantile(key, q)
    assert trs[0].swaps == trs[1].swaps == 3
    assert trs[0].breaches == trs[1].breaches == 1          # step 20: 1.0 s
    assert trs[0].unserved_swaps() == trs[1].unserved_swaps() == 1
    assert [(r.kind, r.step) for r in logs[0].records()] == \
        [(r.kind, r.step) for r in logs[1].records()]
    assert logs[0].records('freshness_slo_breach')
    assert isinstance(trs[0].last_breach, faults.FreshnessSLOError)
    assert isinstance(trs[0].last_breach, faults.ServeError)
    with pytest.raises(faults.FreshnessSLOError, match='step 20'):
        trs[0].check_strict()
    assert 'FreshnessSLOError' in faults.slo_breach_kinds()
    assert faults.slo_breach_kinds() == jfaults.slo_breach_kinds()


def test_freshness_tracker_bounds_versions_as_jax():
    """A 24/7 run publishes forever: both trackers keep only the newest
    ``MAX_VERSIONS`` stamps, and a pruned version closes no sample."""
    trs = (FreshnessTracker(), JTracker())
    for tr in trs:
        tr.MAX_VERSIONS = 4
        for s in range(10):
            tr.record_step(s, t=float(s))
            tr.record_swap(s, t=float(s) + 0.5)
        assert tr.note_served(2) is None
        assert tr.note_served(9) is not None
    assert sorted(trs[0]._step_t) == sorted(trs[1]._step_t) == [6, 7, 8, 9]
    assert trs[0].unserved_swaps() == trs[1].unserved_swaps() == 3


# --- the pipeline against JAX's ----------------------------------------------

def test_online_pipeline_matches_jax(tmp_path):
    """The same weights, batches and cadence through both pipelines: the
    same step-named files, each within the trainers' tolerance of JAX's,
    every publish swapped and served (lock step), no drop, the same
    summary and eval-line keys."""
    jtr, tr = _jax_twin()
    kw = dict(rounds=2, save_every=10)
    pipe, summary, tr, lines, step = _run(str(tmp_path / 't'),
                                          _batches(20), tr=tr, **kw)
    jpipe, jsummary, jtr, jlines, _ = _run(str(tmp_path / 'j'),
                                           _jbatches(20), tr=jtr, jax=True,
                                           **kw)
    names = _models(tmp_path / 't' / 'm')
    assert names == _models(tmp_path / 'j' / 'm') == [
        f'{s:04d}.model' for s in (0, 10, 20, 30, 40)]
    for name in names:
        got = _file_params(str(tmp_path / 't' / 'm' / name))
        want = _file_params(str(tmp_path / 'j' / 'm' / name))
        for k, fields in want.items():
            for f, v in fields.items():
                np.testing.assert_allclose(
                    got[k][f].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f'{name} layer {k} {f}')
        assert os.path.exists(str(tmp_path / 't' / 'm' / name) + '.crc32')
    assert sorted(summary) == sorted(jsummary)
    for key in ('steps', 'swaps', 'served', 'dropped', 'last_swap_step',
                'save_failures', 'restarts', 'slo_breaches'):
        assert summary[key] == jsummary[key], key
    # the step-40 publish lands after the last step: no poll swaps it
    assert summary['steps'] == 40 and summary['swaps'] == 3
    assert summary['dropped'] == 0
    assert summary['freshness_p50_s'] > 0
    assert summary['freshness_p99_s'] >= summary['freshness_p50_s']
    # the served versions only move forward, one swap a publish
    assert step.versions == sorted(step.versions)
    assert sorted(set(step.versions)) == [0, 10, 20, 30]
    assert len(lines) == len(jlines) == 2
    for a, b in zip(lines, jlines):
        assert _keys(a) == _keys(b)
        assert 'online-freshness_s.p50:' in a and 'online-dropped:0' in a
    assert 'registry-last_swap_step:30' in pipe.serve_report()
    assert pipe.tracker.unserved_swaps() == 0


def test_online_freshness_strict_raises_after_run(tmp_path):
    """``freshness_strict``: an impossible SLO raises the typed error at
    the END of the run (training and serving finish first), in both
    packages."""
    for jax in (False, True):
        err = jfaults.FreshnessSLOError if jax else faults.FreshnessSLOError
        with pytest.raises(err):
            _run(str(tmp_path / str(jax)),
                 _jbatches(12) if jax else _batches(12), jax=jax,
                 save_every=5, freshness_slo=1e-9, freshness_strict=True)


def test_online_chaos_drill_bitwise(tmp_path):
    """The chaos drill: a retried write, a corrupted serving checkpoint
    (the step-10 publish, the second model commit) and a NaN streak in
    ONE run.  The served versions only move forward and never include
    step 10 (the registry REJECTED it), nothing is dropped, and the
    trainer ends bitwise equal to a fault-free twin."""
    plan = faults.FaultPlan(seed=11, raise_on_write=(2,), corrupt_model=(2,),
                            nan_at_step=(13, 14, 15))
    log = faults.FailureLog()
    pipe, summary, chaos, _, step = _run(str(tmp_path / 'chaos'),
                                         _batches(20, seed=3), rounds=2,
                                         plan=plan, log=log)
    fired = plan.fired()
    assert 'raise_on_write=2' in fired and 'corrupt_model=2' in fired
    assert any(f.startswith('nan_at_step=') for f in fired)
    assert log.records('DivergenceError') and log.records('restored')
    assert summary['restarts'] >= 1
    swaps = [s for s, _ in sorted(pipe.tracker._swap_t.items(),
                                  key=lambda kv: kv[1])]
    assert swaps == sorted(swaps) and 10 not in swaps
    assert step.versions == sorted(step.versions) and 10 not in step.versions
    assert pipe.registry.last_swap_step == 30
    assert 'REJECTED' in pipe.registry.states()
    assert summary['dropped'] == 0
    _, clean_summary, clean, _, _ = _run(str(tmp_path / 'clean'),
                                         _batches(20, seed=3), rounds=2)
    assert clean_summary['steps'] == summary['steps'] == 40
    for k, fields in clean.params.items():
        for f, v in fields.items():
            assert torch.equal(chaos.params[k][f], v), (k, f)


def test_online_save_failure_degrades_freshness_not_training(tmp_path,
                                                             monkeypatch):
    """A serving checkpoint whose write fails past its retries is logged
    (``async_save_failed``) and skipped: training goes on bitwise, later
    checkpoints publish and swap, the server never sees the lost step."""
    from cxxnet_tpu_torch.nnet import checkpoint
    real = checkpoint.publish_model_file

    def flaky(path, write_fn, retry=None):
        if path.endswith('0008.model'):
            raise faults.RetryError('publish_model', 4,
                                    OSError('disk gone'))
        return real(path, write_fn, retry=retry)

    _, _, clean, _, _ = _run(str(tmp_path / 'clean'), _batches(24, seed=5),
                             save_every=8)
    monkeypatch.setattr(checkpoint, 'publish_model_file', flaky)
    log = faults.FailureLog()
    pipe, summary, tr, _, _ = _run(str(tmp_path / 'lost'),
                                   _batches(24, seed=5), log=log,
                                   save_every=8)
    assert summary['steps'] == 24 and summary['dropped'] == 0
    assert summary['save_failures'] >= 1 and log.records('async_save_failed')
    swapped = sorted(pipe.tracker._swap_t)
    assert 8 not in swapped and swapped == [16]     # 24: after the last step
    assert _models(tmp_path / 'lost' / 'm') == ['0000.model', '0016.model',
                                                '0024.model']
    for k, fields in clean.params.items():
        for f, v in fields.items():
            assert torch.equal(tr.params[k][f], v), (k, f)


def test_online_traffic_thread_and_knobs(tmp_path):
    """The built-in traffic driver at ``qps`` with the registry's own
    watcher: the run ends, nothing is dropped, ``set_qps`` and
    ``set_train_throttle`` return the previous values and bound theirs
    as JAX's do."""
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    pipe = OnlinePipeline(tr, ListIter(_batches(16)), _serve_factory,
                          _cfg(OnlineConfig, str(tmp_path), save_every=4,
                               reload_poll=0.01, qps=200.0),
                          request_source=_rows())
    jpipe = JPipeline(None, None, _jserve_factory,
                      _cfg(JConfig, str(tmp_path / 'j')))
    try:
        for p in (pipe, jpipe):
            assert p.set_qps(100.0) in (200.0, 50.0)
            with pytest.raises(ValueError):
                p.set_qps(0)
            assert p.set_train_throttle(5.0) == 0.0
            assert p.train_throttle() == 1.0
            assert p.set_train_throttle(0.0) == 1.0
        summary = pipe.run(num_rounds=1, out=_io.StringIO())
    finally:
        pipe.close(timeout=JOIN_S)
        jpipe.close(timeout=JOIN_S)
    assert summary['steps'] == 16 and summary['dropped'] == 0
    assert summary['served'] > 0
    assert _models(tmp_path / 'm') == [
        f'{s:04d}.model' for s in (0, 4, 8, 12, 16)]


# --- the CLI -----------------------------------------------------------------

def _write_mnist(d, n, seed):
    """Seeded idx files (JAX ``tests/test_io.write_mnist``'s format)."""
    import gzip
    import struct
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (n, 8, 8)).astype(np.uint8)
    y = rng.randint(0, 3, n).astype(np.uint8)
    with gzip.open(d / 'img.gz', 'wb') as f:
        f.write(struct.pack('>iiii', 2051, n, 8, 8) + img.tobytes())
    with gzip.open(d / 'lbl.gz', 'wb') as f:
        f.write(struct.pack('>ii', 2049, n) + y.tobytes())


def _online_conf(d, extra=''):
    _write_mnist(d, 128, 4)
    (d / 'online.conf').write_text(f"""
data = train
iter = mnist
  path_img = {d}/img.gz
  path_label = {d}/lbl.gz
  shuffle = 0
iter = end
pred = pred.txt
iter = mnist
  path_img = {d}/img.gz
  path_label = {d}/lbl.gz
iter = end
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.05
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 3
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 16
dev = cpu
eta = 0.05
momentum = 0.9
metric[label] = error
task = online
num_round = 2
online.save_every = 5
online.freshness_slo = 60
online.reload = 0.02
online.qps = 100
serve.buckets = 8,16
serve.deadline = 60
{extra}""")
    return 'online.conf'


#: eval-line keys the clock decides: a swap's age and the freshness
#: quantiles appear once the watcher has swapped and a request landed
CLOCK_KEYS = {'online-last_swap_age_s', 'online-freshness_s.p50',
              'online-freshness_s.p99', 'online-swap_lag_s.p50',
              'online-swap_lag_s.p99'}


def test_cli_task_online_matches_jax(tmp_path, monkeypatch, capsys):
    """``task=online`` through both CLIs on one conf: the same step-named
    model files (with sidecars), the same eval-line keys (but the
    clock's), the same summary keys, no drop, the ``[online]`` serving
    line."""
    from cxxnet_tpu.main import main as jmain
    from cxxnet_tpu_torch.main import main as tmain
    conf = _online_conf(tmp_path)
    monkeypatch.chdir(tmp_path)
    out = {}
    for pkg, fn in (('t', tmain), ('j', jmain)):
        assert fn([conf, f'model_dir=models_{pkg}']) == 0
        so, se = capsys.readouterr()
        summary = [ln for ln in so.splitlines()
                   if ln.startswith('online summary: ')]
        assert len(summary) == 1, so
        evals = [ln for ln in se.splitlines()
                 if ln.startswith('[') and 'online-served:' in ln]
        out[pkg] = (json.loads(summary[0][len('online summary: '):]),
                    evals, se, so, _models(tmp_path / f'models_{pkg}'))
    (ts, tev, tse, tso, tnames), (js, jev, _, _, jnames) = out['t'], out['j']
    assert tnames == jnames == [f'{s:04d}.model' for s in (0, 5, 8, 13, 16)]
    assert all(os.path.exists(tmp_path / 'models_t' / (n + '.crc32'))
               for n in tnames)
    assert sorted(ts) == sorted(js)
    assert ts['steps'] == js['steps'] == 16
    assert ts['dropped'] == 0 and ts['slo_breaches'] == 0
    assert len(tev) == len(jev) == 2
    for a, b in zip(tev, jev):
        ka, kb = _keys(a), _keys(b)
        assert [k for k in ka if k not in CLOCK_KEYS] == \
            [k for k in kb if k not in CLOCK_KEYS]
        assert 'online-dropped:0' in a
    assert '[online]' in tse and 'registry-swaps:' in tse
    assert 'start online training-while-serving...' in tso
    assert 'online: serving from step 0' in tso


def test_cli_task_online_continue_resumes_from_newest_step(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``continue=1``: the newest step-named file (the names have gaps)
    is adopted and the publish counter re-armed, so the resumed run
    publishes strictly past it and overwrites nothing."""
    from cxxnet_tpu_torch.main import main as tmain
    conf = _online_conf(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert tmain([conf, 'num_round=1', 'silent=1']) == 0
    first = [int(n.split('.')[0]) for n in _models(tmp_path / 'models')]
    assert first == [0, 5, 8]
    capsys.readouterr()
    assert tmain([conf, 'num_round=1', 'continue=1']) == 0
    so, _ = capsys.readouterr()
    assert 'Init: continue online run from step 8' in so
    after = [int(n.split('.')[0]) for n in _models(tmp_path / 'models')]
    assert after[:len(first)] == first
    assert after[len(first):] == [13, 16]


def test_cli_online_autoscale_refused(tmp_path, monkeypatch):
    """The autoscaler over the online stack is queue A item 10.4 (its
    ``serve/autoscale.py``): ``serve.autoscale`` with ``task=online``
    raises ``NotPortedError`` naming queue A item 10, before any work."""
    from cxxnet_tpu_torch.main import main as tmain
    conf = _online_conf(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotPortedError, match='queue A item 10'):
        tmain([conf, 'serve.autoscale=min_qps=1'])
    assert not os.path.exists(tmp_path / 'models')


# --- the wrapper and the C ABI -----------------------------------------------

def test_wrapper_online_surface_matches_jax(tmp_path):
    """``Net.online_*`` in both packages over the same batches: replies
    while training runs, the same summary keys and steps, the stats
    line's keys, idempotent stop and the guard after it; the training
    thread is ``online-train``."""
    import threading

    from cxxnet_tpu import wrapper as jw
    from cxxnet_tpu_torch import capi, wrapper
    got = {}
    for pkg, mod, batches in (('t', wrapper, _batches(20, seed=9)),
                              ('j', jw, _jbatches(20, seed=9))):
        net = mod.Net(dev='cpu', cfg=MLP_CONF)
        net.set_param('seed', 1)
        net.init_model()
        it = ListIter(batches) if pkg == 't' else JListIter(batches)
        net.online_start(it, str(tmp_path / pkg), rounds=2, save_every=8,
                         reload=0.02, buckets='4,8', deadline=60.0,
                         watchdog_deadline=60.0)
        if pkg == 't':
            assert any(t.name == 'online-train'
                       for t in threading.enumerate())
        rows = _rows()()
        scores = net.online_scores(rows)
        pred = net.online_predict(rows)
        summary = net.online_wait(timeout=JOIN_S)
        stats = net.online_stats()
        if pkg == 't':
            assert 'online-swaps:' in capi.net_online_stats(net)
            assert json.loads(capi.net_online_wait(net))['steps'] == 40
        net.online_stop(timeout=JOIN_S)
        net.online_stop()
        with pytest.raises(RuntimeError, match='online_start'):
            net.online_stats()
        got[pkg] = (scores.shape, pred.shape, summary, stats,
                    _models(tmp_path / pkg))
    (ts, tp, tsum, tstats, tn), (js, jp, jsum, jstats, jn) = \
        got['t'], got['j']
    assert ts == js == (4, 4) and tp == jp == (4,)
    assert sorted(tsum) == sorted(jsum) and tsum['steps'] == 40
    assert tsum['dropped'] == 0
    assert tn == jn
    for key in ('online-swaps', 'online-served', 'online-dropped',
                'registry-last_swap_step', 'serve-'):
        assert key in tstats and key in jstats


def test_capi_online_start_parses_cfg_as_jax(tmp_path):
    """``net_online_start``'s ``k=v;...`` cfg: the run JAX's gives, and
    the same refusals."""
    from cxxnet_tpu import capi as jcapi
    from cxxnet_tpu_torch import capi
    names = {}
    for pkg, mod, batches in (('t', capi, _batches(10, seed=2)),
                              ('j', jcapi, _jbatches(10, seed=2))):
        net = mod.net_create('cpu', MLP_CONF)
        net.set_param('seed', 2)
        net.init_model()
        it = ListIter(batches) if pkg == 't' else JListIter(batches)
        mod.net_online_start(
            net, it, f'model_dir={tmp_path}/{pkg};rounds=1;save_every=5;'
            'reload=0.02;buckets=4:8;freshness_slo=30;deadline=60;'
            'watchdog_deadline=30')
        rows = np.ascontiguousarray(_rows()())
        out = mod.net_online_predict(net, memoryview(rows.tobytes()),
                                     rows.shape)
        assert out.shape == (4,) and out.dtype == np.float32
        assert json.loads(mod.net_online_wait(net))['steps'] == 10
        mod.net_online_stop(net)
        names[pkg] = _models(tmp_path / pkg)
        for cfg, match in (('rounds=1', 'model_dir'),
                           ('model_dir=m;colour=red', 'unknown online')):
            with pytest.raises(ValueError, match=match):
                mod.net_online_start(net, it, cfg)
    assert names['t'] == names['j'] == ['0000.model', '0005.model',
                                        '0010.model']
