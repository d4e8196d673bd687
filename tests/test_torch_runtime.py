"""The training runtime of ``cxxnet_tpu_torch`` (``runtime/faults.py``,
``runtime/supervisor.py``, ``nnet/sharded_ckpt.py``, the fault hooks of
``utils/thread_buffer.py`` and ``nnet/checkpoint.py``) on the CPU, against
the JAX package's.

* Parity: ``RetryPolicy.delays`` equals JAX's float for float for the same
  ``(seed, op_name)``; ``FaultPlan.parse(...).describe()`` and the
  ``fired()`` lists of the training grammar (``@every`` included) equal
  JAX's; the serving and elastic kinds raise ``NotPortedError`` naming
  their items.
* The retry policy, the failure log, atomic model-file I/O with its
  retry, the batch-scoped stall hook, the divergence gate with injected
  NaNs, the step checkpoints' digest, quarantine and fallback, and the
  orbax refusal.
* Recovery inside the port: a supervised run with injected faults (a
  failed write, a stalled batch, a corrupt step and a NaN loss) ends
  **bitwise** equal to an uninterrupted port run — per step and under a
  K=2 window, sync and async saves; the supervisor's give-up, pruning and
  NaN-streak rules; the CLI's ``train.supervise=1`` round bitwise its
  plain round.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import checkpoint, sharded_ckpt
from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.runtime import faults
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from cxxnet_tpu_torch.runtime.supervisor import (SupervisorConfig,
                                                 TrainSupervisor)
from cxxnet_tpu_torch.utils.config import parse_config_string
from cxxnet_tpu_torch.utils.thread_buffer import ThreadBuffer

pytestmark = pytest.mark.torch_port

NO_WAIT = faults.NO_WAIT_RETRY

# the JAX fault suite's MLP (tests/test_net_mnist.py) with a dropout layer,
# so a replayed step must also replay its random draws
MLP_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.1
layer[+1:sg1] = sigmoid:se1
layer[+0] = dropout
  threshold = 0.5
layer[sg1->fc2] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 32
dev = cpu
eta = 0.5
momentum = 0.9
wd  = 0.0
metric[label] = error
"""


@pytest.fixture(autouse=True)
def _clean_plans():
    prev, jprev = faults.install_plan(None), jfaults.install_plan(None)
    yield
    faults.install_plan(prev)
    jfaults.install_plan(jprev)


def synth_batches(n_batches=8, bs=32, dim=16, k=4, seed=0):
    """The JAX fault suite's batches (``test_net_mnist.synth_batches``) as
    the port's ``DataBatch``es."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim).astype(np.float32) * 2
    out = []
    for _ in range(n_batches):
        y = rng.randint(0, k, size=bs)
        x = centers[y] + 0.3 * rng.randn(bs, dim).astype(np.float32)
        out.append(DataBatch(x.reshape(bs, 1, 1, dim).astype(np.float32),
                             y[:, None].astype(np.float32)))
    return out


def fresh(extra='', conf=MLP_CONF):
    tr = NetTrainer(parse_config_string(conf + extra))
    tr.init_model()
    return tr


def state(tr):
    """Params, optimizer slots, accumulator and counters, cloned."""
    out = {}
    for part in ('params', 'opt_state', 'grad_acc'):
        for key, t in sharded_ckpt.flatten_with_keys(getattr(tr, part),
                                                     f'[{part!r}]'):
            out[key] = t.detach().clone()
    out['counters'] = (tr.epoch_counter, tr.sample_counter, tr.round)
    return out


def assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == 'counters':
            assert a[k] == b[k]
        else:
            assert torch.equal(a[k], b[k]), k


# --- parity with the JAX package ------------------------------------------------

@pytest.mark.parametrize('seed,op', [(0, ''), (0, 'save_native:step_4'),
                                     (7, 'save_model:0001.model'),
                                     (123, 'restore_sharded:step_8')])
def test_retry_delays_equal_jax(seed, op):
    kw = dict(max_attempts=6, base_delay=0.05, multiplier=2.0,
              max_delay=0.3, jitter=0.1, seed=seed)
    assert faults.RetryPolicy(**kw).delays(op) == \
        jfaults.RetryPolicy(**kw).delays(op)
    assert faults.DEFAULT_IO_RETRY.delays(op) == \
        jfaults.DEFAULT_IO_RETRY.delays(op)


PLAN_TEXTS = [
    'seed=3; raise_on_write=2; stall_batch=5:0.75; corrupt_shard=1; '
    'nan_at_step=7',
    'seed=2; raise_on_write=3; raise_on_write@every=5; '
    'stall_batch@every=50:0.2; nan_at_step@every=7',
    'nan_at_step=6;stall_batch=9:3.0;raise_on_write=2;corrupt_shard=8',
    'stall_write=2; stall_write@every=3:0.1; corrupt_shard@every=4; '
    'stall_batch=1',
]


@pytest.mark.parametrize('text', PLAN_TEXTS)
def test_fault_plan_describe_equals_jax(text):
    assert faults.FaultPlan.parse(text).describe() == \
        jfaults.FaultPlan.parse(text).describe()


def _drive_plan(mod, plan, monkeypatch):
    """The same hook sequence through either package's plan; returns
    what fired and what each hook did."""
    monkeypatch.setattr(mod.time, 'sleep', lambda _s: None)
    seen = []
    for n in range(1, 13):
        try:
            plan.on_checkpoint_write('p')
            seen.append(('write', n, 'ok'))
        except mod.FaultInjected:
            seen.append(('write', n, 'raised'))
    for idx in range(12):
        plan.on_pipeline_item('batch', idx)
        plan.on_pipeline_item('page', idx)
    for step in list(range(12)) + [4, 8, 7]:
        seen.append(('loss', step, bool(np.isnan(plan.on_loss(step, 1.0)))))
    return plan.fired(), seen


@pytest.mark.parametrize('text', PLAN_TEXTS)
def test_fault_plan_fired_equals_jax(text, monkeypatch):
    got = _drive_plan(faults, faults.FaultPlan.parse(text), monkeypatch)
    want = _drive_plan(jfaults, jfaults.FaultPlan.parse(text), monkeypatch)
    assert got == want


@pytest.mark.parametrize('kind,item', [
    ('corrupt_model', 'items 8 and 10'), ('host_loss', 'item 9'),
    ('partition', 'item 9'), ('corrupt_kv', 'item 7'),
    ('slow_step', 'item 10')])
@pytest.mark.parametrize('every', [False, True])
def test_fault_plan_refuses_serve_kinds(kind, item, every, tmp_path):
    key = f'{kind}@every' if every else kind
    jfaults.FaultPlan.parse(f'{key}=2')          # JAX runs it
    if kind == 'slow_step':
        # ported (queue A item 10.1): the N-th decode loop iteration (and
        # every K-th) fires in both packages alike, and the plans say so
        fired = {}
        for mod, tag in ((faults, 't'), (jfaults, 'j')):
            plan = mod.FaultPlan.parse(f'nan_at_step=1;{key}=2:0')
            for _ in range(6):
                plan.on_decode_step()
            fired[tag] = (plan.fired(), plan.describe())
        assert fired['t'] == fired['j']
        assert fired['t'][0]
        return
    if kind in ('corrupt_model', 'corrupt_kv'):
        # ported (queue A items 8 and 7): the same commits truncate the
        # same files in both packages, and the plans say so alike
        sizes, fired = {}, {}
        for mod, tag in ((faults, 't'), (jfaults, 'j')):
            plan = mod.FaultPlan.parse(f'nan_at_step=1;{key}=2')
            hook = (plan.on_model_committed if kind == 'corrupt_model'
                    else plan.on_kv_record_committed)
            for n in range(1, 7):
                p = tmp_path / f'{tag}{n}.model'
                p.write_bytes(b'x' * 64)
                hook(str(p))
            sizes[tag] = [(tmp_path / f'{tag}{n}.model').stat().st_size
                          for n in range(1, 7)]
            fired[tag] = (plan.fired(), plan.describe())
        assert sizes['t'] == sizes['j']
        assert sizes['t'][1] == 32
        assert fired['t'] == fired['j']
        return
    with pytest.raises(NotPortedError, match=f'queue A {item}'):
        faults.FaultPlan.parse(f'nan_at_step=1;{key}=2')


def test_fault_plan_rejects_unknown_event():
    for text in ('explode_at=3', 'raise_on_write@often=3', 'explode@every=3',
                 'raise_on_write@every=0'):
        with pytest.raises(ValueError):
            faults.FaultPlan.parse(text)
        with pytest.raises(ValueError):
            jfaults.FaultPlan.parse(text)


def test_fault_plan_corrupt_shard_picks_jax_victim(tmp_path):
    """The seeded truncation picks the same payload file in both."""
    for mod, tag in ((faults, 't'), (jfaults, 'j')):
        d = tmp_path / tag
        d.mkdir()
        for name in ('a.bin', 'b.bin', 'c.bin', 'ckpt_digest.json'):
            (d / name).write_bytes(b'x' * 64)
        mod.FaultPlan(seed=11, corrupt_shard=(6,)).on_shard_committed(
            6, str(d))
    sizes = {tag: sorted((f.name, f.stat().st_size)
                         for f in (tmp_path / tag).iterdir())
             for tag in 'tj'}
    assert sizes['t'] == sizes['j']
    assert sum(s == 32 for _, s in sizes['t']) == 1


def test_training_fault_classes():
    for cls in (faults.DivergenceError, faults.PipelineStallError,
                faults.CheckpointCorruptError):
        assert issubclass(cls, faults.TrainingFault)
    assert issubclass(faults.FaultInjected, OSError)


# --- retry policy and failure log ------------------------------------------------

def test_retry_recovers_from_transient_and_logs():
    sleeps = []
    pol = faults.RetryPolicy(max_attempts=3, base_delay=0.05, jitter=0.0,
                             sleep=sleeps.append)
    log = faults.FailureLog()
    calls = {'n': 0}

    def flaky():
        calls['n'] += 1
        if calls['n'] < 3:
            raise OSError('transient')
        return 42

    assert pol.call(flaky, op_name='op', log=log) == 42
    assert sleeps == [0.05, 0.10]
    assert [r.kind for r in log.records()] == ['io_retry', 'io_retry']
    assert 'op attempt 1/3 failed' in log.records()[0].detail


def test_retry_exhausts_then_raises_with_cause():
    def broken():
        raise OSError('still down')

    log = faults.FailureLog()
    with pytest.raises(faults.RetryError) as ei:
        NO_WAIT.call(broken, op_name='op', log=log)
    assert isinstance(ei.value.__cause__, OSError)
    assert ei.value.attempts == NO_WAIT.max_attempts
    assert len(log.records('io_retry')) == NO_WAIT.max_attempts
    with pytest.raises(ValueError):       # a bug is not retried
        NO_WAIT.call(lambda: (_ for _ in ()).throw(ValueError('bug')),
                     op_name='op', log=log)


def test_failure_log_listeners_and_summary():
    log = faults.FailureLog()
    assert not log and log.summary() == 'no failures'
    seen = []

    def listener(rec, lg):
        seen.append((rec.kind, lg is log))
        raise RuntimeError('a broken listener adds no fault')

    faults.add_failure_listener(listener)
    try:
        log.record('restored', 'x', step=3)
        log.record('io_retry', 'y')
        log.record('restored', 'z')
    finally:
        faults.remove_failure_listener(listener)
    log.record('restored', 'after')
    assert seen == [('restored', True), ('io_retry', True),
                    ('restored', True)]
    assert log.summary() == 'io_retry=1, restored=3'
    assert log.records('restored')[0].step == 3
    assert faults.global_failure_log() is faults.global_failure_log()


# --- model files: atomic, retried, hooked ------------------------------------------

def test_save_model_file_injected_fault_rides_retry(tmp_path):
    plan = faults.FaultPlan(raise_on_write=(1,))
    faults.install_plan(plan)
    path = str(tmp_path / '0002.model')
    checkpoint.save_model_file(path, lambda f: f.write(b'v2'),
                               retry=NO_WAIT)
    assert plan.fired() == ['raise_on_write=1']
    assert open(path, 'rb').read() == b'v2'


def test_save_model_file_failure_keeps_previous(tmp_path):
    path = str(tmp_path / '0001.model')
    checkpoint.save_model_file(path, lambda f: f.write(b'good-v1'),
                               retry=NO_WAIT)
    with pytest.raises(RuntimeError):
        checkpoint.save_model_file(
            path, lambda f: (_ for _ in ()).throw(RuntimeError('kill')),
            retry=NO_WAIT)
    faults.install_plan(faults.FaultPlan(raise_on_write_every=(1,)))
    with pytest.raises(faults.RetryError):
        checkpoint.save_model_file(path, lambda f: f.write(b'bad'),
                                   retry=NO_WAIT)
    assert open(path, 'rb').read() == b'good-v1'
    assert os.listdir(tmp_path) == ['0001.model']


def test_read_model_file_retries_and_fails_fast_on_absence(tmp_path):
    path = str(tmp_path / '0003.model')
    checkpoint.save_model_file(path, lambda f: f.write(b'v3'),
                               retry=NO_WAIT)
    (tmp_path / '.0003.model.tmp.999').write_bytes(b'par')
    calls = []

    def read(f):
        calls.append(1)
        if len(calls) < 2:
            raise OSError('flaky disk')
        return f.read()

    assert checkpoint.read_model_file(path, read, retry=NO_WAIT) == b'v3'
    assert len(calls) == 2
    log_before = len(faults.global_failure_log())
    with pytest.raises(FileNotFoundError):
        checkpoint.read_model_file(str(tmp_path / 'absent.model'),
                                   lambda f: f.read(), retry=NO_WAIT)
    assert len(faults.global_failure_log()) == log_before


# --- the batch buffer's fault hook ------------------------------------------------

def test_thread_buffer_injected_stall_is_batch_scoped():
    plan = faults.FaultPlan(stall_batch=((1, 0.6),))
    faults.install_plan(plan)
    inner = ThreadBuffer(lambda: iter(range(3)), fault_scope='page')
    assert list(inner) == [0, 1, 2]
    assert list(ThreadBuffer(lambda: iter(range(3)))) == [0, 1, 2]
    assert plan.fired() == []
    outer = ThreadBuffer(lambda: iter(range(3)), deadline=0.15,
                         fault_scope='batch')
    with pytest.raises(faults.PipelineStallError):
        list(outer)
    assert plan.fired() == ['stall_batch=1:0.6']
    outer.close(timeout=5.0)


def test_thread_buffer_fault_base_keeps_indices_epoch_absolute(
        monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, 'sleep', slept.append)
    plan = faults.FaultPlan(stall_batch=((5, 0.5), (1, 0.25)))
    faults.install_plan(plan)
    # a consumer re-wound to batch 4: the producer's item 1 is batch 5
    assert list(ThreadBuffer(lambda: iter('abc'), fault_scope='batch',
                             fault_base=4)) == list('abc')
    assert plan.fired() == ['stall_batch=5:0.5'] and slept == [0.5]


def test_data_thread_buffer_stage_is_batch_scoped():
    from cxxnet_tpu_torch.io.data import ThreadBufferIterator
    it = ThreadBufferIterator(None)
    assert it._buf._fault_scope == 'batch'


# --- the divergence gate with injected NaNs -----------------------------------------

def test_nan_action_halt_raises_divergence_with_context():
    tr = fresh('nan_action = halt\n')
    faults.install_plan(faults.FaultPlan(nan_at_step=(2,)))
    batches = synth_batches(n_batches=4)
    for b in batches[:3]:
        tr.update(b)                # step 2's NaN pending (checked late)
    with pytest.raises(faults.DivergenceError) as ei:
        tr.update(batches[3])
    assert ei.value.step == 2 and not np.isfinite(ei.value.loss)


def test_injected_nan_arms_gate_and_flush_settles_last_step():
    """A plan with NaN events arms the gate by itself (no halt, no
    breaker: the streak counts); ``flush_divergence_check`` settles the
    last step, and ``reset_transient_state`` clears the streak."""
    tr = fresh()
    faults.install_plan(faults.FaultPlan(nan_at_step=(1,)))
    batches = synth_batches(n_batches=2)
    tr.update(batches[0])
    tr.update(batches[1])
    assert tr.nan_streak == 0
    tr.flush_divergence_check()
    assert tr.nan_streak == 1
    tr.reset_transient_state()
    assert tr.nan_streak == 0 and tr._pending_loss is None


def test_nan_breaker_trips_on_consecutive_not_isolated():
    tr = fresh('nan_action = skip\nnan_breaker = 2\n')
    faults.install_plan(faults.FaultPlan(nan_at_step=(1, 3, 4)))
    batches = synth_batches(n_batches=6)
    for b in batches[:3]:
        tr.update(b)
    assert tr.nan_streak == 1
    tr.update(batches[3])
    assert tr.nan_streak == 0
    tr.update(batches[4])
    with pytest.raises(faults.DivergenceError) as ei:
        tr.update(batches[5])
    assert ei.value.streak == 2


def test_window_gate_sees_injected_nan_at_its_step():
    tr = fresh('nan_breaker = 1\n')
    faults.install_plan(faults.FaultPlan(nan_at_step=(5,)))
    stepper = ExecutionPlan.resolve(2, strict=True,
                                    silent=True).round_stepper(tr)
    batches = synth_batches(n_batches=8)
    with pytest.raises(faults.DivergenceError) as ei:
        for b in batches:
            stepper.feed(b)
    assert ei.value.step == 5 and tr.sample_counter == 6


# --- step checkpoints: digest, quarantine, fallback ---------------------------------

def _tiny_tree():
    return {'w': torch.arange(8, dtype=torch.float32),
            'c': {'step': np.asarray(3, np.int64)}}


def test_digest_written_and_detects_truncation(tmp_path):
    d = str(tmp_path / 'ck')
    path = sharded_ckpt.save_tree_native(d, 1, _tiny_tree(), retry=NO_WAIT)
    assert os.path.exists(os.path.join(path, 'ckpt_digest.json'))
    assert sharded_ckpt.verify_step_dir(path) is None
    victim = os.path.join(path, 'packed_leaves.bin')
    with open(victim, 'r+b') as f:
        f.truncate(os.path.getsize(victim) // 2)
    assert 'truncated' in sharded_ckpt.verify_step_dir(path)
    sharded_ckpt.write_digest(path)            # re-digest what is there
    assert sharded_ckpt.verify_step_dir(path) is None


def test_restore_resilient_falls_back_past_corrupt_step(tmp_path):
    d = str(tmp_path / 'ck')
    tree = _tiny_tree()
    sharded_ckpt.save_tree_native(d, 1, tree, retry=NO_WAIT)
    plan = faults.FaultPlan(seed=5, corrupt_shard=(2,))
    faults.install_plan(plan)
    sharded_ckpt.save_tree_native(d, 2, tree, retry=NO_WAIT)
    assert plan.fired() == ['corrupt_shard=2']
    got, step = sharded_ckpt.restore_resilient(d, tree, retry=NO_WAIT)
    assert step == 1
    assert torch.equal(got['w'], torch.arange(8, dtype=torch.float32))
    assert got['c']['step'].shape == () and int(got['c']['step']) == 3
    assert sharded_ckpt.all_steps(d) == [1]
    assert sharded_ckpt.quarantined_steps(d) == [2]
    rec = faults.global_failure_log().records('ckpt_quarantined')[-1]
    assert rec.step == 2


def test_restore_resilient_no_quarantine_when_digest_verifies(
        tmp_path, monkeypatch):
    d = str(tmp_path / 'ck')
    sharded_ckpt.save_tree_native(d, 1, _tiny_tree(), retry=NO_WAIT)

    def outage(*_a):
        raise OSError('synthetic storage outage')

    monkeypatch.setattr(sharded_ckpt, '_restore_native', outage)
    with pytest.raises(faults.RetryError):
        sharded_ckpt.restore_resilient(d, _tiny_tree(), retry=NO_WAIT)
    assert sharded_ckpt.all_steps(d) == [1]
    monkeypatch.undo()
    _, step = sharded_ckpt.restore_resilient(d, _tiny_tree(), retry=NO_WAIT)
    assert step == 1


def test_restore_missing_step_fails_fast_and_nothing_intact(tmp_path):
    d = str(tmp_path / 'ck')
    tree = _tiny_tree()
    faults.install_plan(faults.FaultPlan(seed=5, corrupt_shard=(1,)))
    sharded_ckpt.save_tree_native(d, 1, tree, retry=NO_WAIT)
    log_before = len(faults.global_failure_log())
    with pytest.raises(FileNotFoundError):
        sharded_ckpt.restore_sharded(d, tree, step=99)
    assert len(faults.global_failure_log()) == log_before
    with pytest.raises(faults.CheckpointCorruptError):
        sharded_ckpt.restore_resilient(d, tree, retry=NO_WAIT)
    with pytest.raises(FileNotFoundError):
        sharded_ckpt.restore_resilient(str(tmp_path / 'empty'), tree)


def test_step_scan_skips_temp_and_quarantined_dirs(tmp_path):
    d = tmp_path / 'ck'
    for name in ('step_3', 'step_7.corrupt', 'step_9.tmp.123',
                 'tmp_step_11', 'step_12.corrupt'):
        (d / name).mkdir(parents=True)
    (d / 'step_20').write_text('a file, not a step')
    assert sharded_ckpt.latest_step(str(d)) == 3
    assert sharded_ckpt.all_steps(str(d)) == [3]
    assert sharded_ckpt.quarantined_steps(str(d)) == [12, 7]
    assert sharded_ckpt.latest_step(str(tmp_path / 'none')) is None


def test_orbax_dir_raises_named_divergence_and_is_not_quarantined(tmp_path):
    """A step dir without a manifest (JAX's orbax format) is refused with
    the divergence named, and never quarantined: its bytes are intact."""
    d = tmp_path / 'ck'
    (d / 'step_4').mkdir(parents=True)
    (d / 'step_4' / '_METADATA').write_text('{}')
    sharded_ckpt.write_digest(str(d / 'step_4'))
    with pytest.raises(sharded_ckpt.OrbaxCheckpointError,
                       match='orbax.*queue C'):
        sharded_ckpt.restore_sharded(str(d), _tiny_tree())
    with pytest.raises(sharded_ckpt.OrbaxCheckpointError):
        sharded_ckpt.restore_resilient(str(d), _tiny_tree(), retry=NO_WAIT)
    assert sharded_ckpt.all_steps(str(d)) == [4]
    assert sharded_ckpt.quarantined_steps(str(d)) == []


def test_restore_under_changed_structure_is_a_value_error(tmp_path):
    d = str(tmp_path / 'ck')
    sharded_ckpt.save_tree_native(d, 1, _tiny_tree(), retry=NO_WAIT)
    with pytest.raises(ValueError, match="no leaf"):
        sharded_ckpt.restore_sharded(d, {'other': torch.zeros(2)})


# --- supervised recovery, bitwise -------------------------------------------------

def _sup_config(**kw):
    base = dict(batch_deadline=0.3, max_restarts=4, nan_breaker=0,
                save_every=2, buffer_size=2, retry=NO_WAIT)
    base.update(kw)
    return SupervisorConfig(**base)


@pytest.fixture(scope='module')
def reference_run():
    """Eight uninterrupted per-step updates: the state every recovered
    run must end at, bit for bit."""
    tr = fresh()
    for b in synth_batches():
        tr.update(b)
    return state(tr)


@pytest.mark.parametrize('k', [1, 2], ids=['per_step', 'window2'])
@pytest.mark.parametrize('save_async', [0, 1], ids=['sync', 'async'])
def test_supervised_faults_recover_bitwise(tmp_path, reference_run, k,
                                           save_async):
    """A failed checkpoint write, a batch stalled past the watchdog, the
    newest step corrupted and a NaN loss at that step: the run completes
    its 8 updates, every event fired, one stall and one divergence were
    restored from (the second past the quarantined step 6 to step 4),
    and params, momentum, accumulator and counters are bitwise the
    uninterrupted run's.  The stall outlasts the deadline by seconds, so
    a loaded machine cannot absorb it."""
    batches = synth_batches()
    plan = faults.FaultPlan(seed=2, raise_on_write=(2,),
                            stall_batch=((5, 4.0),), corrupt_shard=(6,),
                            nan_at_step=(6,))
    faults.install_plan(plan)
    tr = fresh()
    log = faults.FailureLog()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(nan_breaker=1, save_async=save_async),
                          failure_log=log)
    ep = ExecutionPlan.resolve(k, strict=True, silent=True)
    try:
        n = sup.run(lambda s: iter(batches[s:]),
                    make_stepper=lambda: ep.round_stepper(tr, lookahead=0))
    finally:
        sup.close()
    assert n == 8 and sup.state == 'IDLE'
    assert sorted(plan.fired()) == sorted([
        'raise_on_write=2', 'stall_batch=5:4', 'corrupt_shard=6',
        'nan_at_step=6'])
    assert len(log.records('PipelineStallError')) == 1
    assert len(log.records('DivergenceError')) == 1
    assert [r.step for r in log.records('restored')] == [4, 4]
    assert os.path.isdir(str(tmp_path / 'sup' / 'step_6.corrupt'))
    assert_bitwise(state(tr), reference_run)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    batches = synth_batches(n_batches=6)
    plan = faults.FaultPlan(stall_batch=((0, 4.0), (1, 4.0), (2, 4.0)))
    faults.install_plan(plan)
    tr = fresh()
    log = faults.FailureLog()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(max_restarts=2), failure_log=log)
    with pytest.raises(faults.PipelineStallError):
        sup.run(lambda k: iter(batches[k:]))
    assert len(log.records('giving_up')) == 1
    assert sup.restarts_total == 3


def test_supervisor_prunes_checkpoints_to_keep_last(tmp_path):
    tr = fresh()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(save_every=1, keep_last=2))
    assert sup.run(lambda k: iter(synth_batches()[k:])) == 8
    assert sharded_ckpt.all_steps(str(tmp_path / 'sup')) == [8, 7]


def test_supervisor_n_steps_budget_discards_staged(tmp_path):
    """``n_steps`` stops the loop at the budget; under a K=2 window the
    overshoot stays inside the crossing dispatch."""
    batches = synth_batches()
    tr = fresh()
    ep = ExecutionPlan.resolve(2, strict=True, silent=True)
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'), _sup_config())
    assert sup.run(lambda k: iter(batches[k:]), n_steps=3,
                   make_stepper=lambda: ep.round_stepper(
                       tr, lookahead=0)) == 4
    assert sharded_ckpt.latest_step(str(tmp_path / 'sup')) == 4


def test_periodic_save_skipped_mid_nan_streak(tmp_path):
    faults.install_plan(faults.FaultPlan(nan_at_step=(2, 3)))
    tr = fresh('nan_breaker = 3\n')
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(save_every=1, nan_breaker=0,
                                      keep_last=0))
    assert sup.run(lambda k: iter(synth_batches(n_batches=6)[k:])) == 6
    steps = set(sharded_ckpt.all_steps(str(tmp_path / 'sup')))
    assert not {3, 4} & steps
    assert {0, 1, 2, 5, 6} <= steps


def test_anchor_skipped_with_open_nan_streak(tmp_path):
    tr = fresh()
    tr.nan_streak = 1
    log = faults.FailureLog()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(nan_breaker=3), failure_log=log)
    sup.run(lambda k: iter(synth_batches(n_batches=2)[k:]))
    assert 'anchor skipped' in log.records('save_skipped')[0].detail
    assert sharded_ckpt.all_steps(str(tmp_path / 'sup')) == [2]


def test_supervisor_prunes_quarantined_dirs_too(tmp_path):
    d = str(tmp_path / 'sup')
    for step in range(1, 5):
        sharded_ckpt.save_tree_native(d, step, _tiny_tree(), retry=NO_WAIT)
        sharded_ckpt.quarantine_step(d, step, 'synthetic bit rot')
    tr = fresh()
    TrainSupervisor(tr, d, _sup_config(keep_last=2)).save()
    assert sharded_ckpt.quarantined_steps(d) == [4, 3]


def test_supervisor_save_replaces_an_existing_step(tmp_path):
    d = tmp_path / 'sup'
    (d / 'step_0').mkdir(parents=True)
    (d / 'step_0' / 'stale.bin').write_bytes(b'old')
    tr = fresh()
    TrainSupervisor(tr, str(d), _sup_config()).save()
    assert not (d / 'step_0' / 'stale.bin').exists()
    assert sharded_ckpt.verify_step_dir(str(d / 'step_0')) is None


def test_replay_stability_contract():
    from cxxnet_tpu_torch.io.data import ThreadBufferIterator
    from cxxnet_tpu_torch.io.iter_imbin import ImageBinIterator
    from cxxnet_tpu_torch.io.iter_mnist import MNISTIterator
    imbin = ImageBinIterator()
    assert imbin.is_replay_stable()
    imbin.set_param('shuffle', '1')
    assert not imbin.is_replay_stable()
    mnist = MNISTIterator()
    mnist.set_param('shuffle', '1')
    assert mnist.is_replay_stable()
    assert not ThreadBufferIterator(imbin).is_replay_stable()


# --- the CLI ------------------------------------------------------------------------

def test_cli_knobs_parse_into_learn_task():
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu.main import LearnTask as JTask
    pairs = [('train.fault_plan', 'nan_at_step=3;stall_batch=2:0.5'),
             ('train.supervise', '1'), ('train.watchdog_deadline', '7.5'),
             ('train.max_restarts', '5'), ('train.nan_breaker', '4'),
             ('train.save_every', '10'), ('train.keep_last', '3'),
             ('save_async', '1'), ('save_workers', '3'),
             ('exact_ckpt', '1')]
    got, want = LearnTask(), JTask()
    for name, val in pairs:
        got.set_param(name, val)
        want.set_param(name, val)
    attrs = ('fault_plan', 'supervise', 'watchdog_deadline', 'max_restarts',
             'nan_breaker', 'save_every', 'keep_last', 'save_async',
             'save_workers', 'exact_ckpt')
    assert [getattr(got, a) for a in attrs] == \
        [getattr(want, a) for a in attrs]


@pytest.mark.parametrize('name,val,match', [
    ('train.micro_batch', '2', 'queue A item 2'),
    ('train.fault_plan', 'host_loss=3', 'queue A item 9'),
    ('train.fault_plan', 'slow_step=3', 'queue A item 10')])
def test_cli_refuses_the_rest(tmp_path, monkeypatch, name, val, match):
    """The fault events of later items refuse; ``train.micro_batch``
    (queue A item 2, done) is held as the JAX CLI holds it, the split its
    autotuner starts from, and reaches no layer there either."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask, main as tmain
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'x.conf').write_text('dev = cpu\n')
    if val.startswith('slow_step'):
        # ported (queue A item 10.1): the CLI takes the event and the
        # plan reads as JAX's
        got, want = LearnTask(), JTask()
        for task in (got, want):
            task.set_param(name, val)
        assert got.fault_plan == want.fault_plan == val
        assert faults.FaultPlan.parse(val).describe() == \
            jfaults.FaultPlan.parse(val).describe()
        return
    if name == 'train.micro_batch':
        got, want = LearnTask(), JTask()
        for task in (got, want):
            task.set_param(name, val)
        assert got.micro_batch == want.micro_batch == int(val)
        assert got.cfg[-1] == want.cfg[-1] == (name, val)
    else:
        with pytest.raises(NotPortedError, match=match):
            tmain(['x.conf', f'{name}={val}'])
    with pytest.raises(ValueError, match='unknown training key'):
        LearnTask().set_param('train.no_such_key', '1')


CLI_CONF = """
data = train
iter = mnist
  path_img = train-img.gz
  path_label = train-lab.gz
  shuffle = 1
  input_flat = 0
iter = threadbuffer
iter = end
netconfig = start
layer[0->1] = flatten
layer[1->2] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[2->3] = sigmoid
layer[3->3] = dropout
  threshold = 0.5
layer[3->4] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[4->4] = softmax
netconfig = end
input_shape = 1,28,28
batch_size = 50
dev = cpu
eta = 0.1
momentum = 0.9
num_round = 2
silent = 1
metric = error
"""


def write_mnist(d, n=300, seed=0):
    import gzip
    import struct
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, n).astype(np.uint8)
    x = np.zeros((n, 28, 28), np.uint8)
    for i, c in enumerate(y):
        r0, c0 = (c // 2) * 14, (c % 2) * 14
        x[i, r0:r0 + 14, c0:c0 + 14] = rng.randint(100, 255, (14, 14))
    with gzip.open(os.path.join(d, 'train-img.gz'), 'wb') as f:
        f.write(struct.pack('>iiii', 2051, n, 28, 28))
        f.write(x.tobytes())
    with gzip.open(os.path.join(d, 'train-lab.gz'), 'wb') as f:
        f.write(struct.pack('>ii', 2049, n))
        f.write(y.tobytes())


@pytest.mark.parametrize('extra', [(), ('save_async=1', 'steps_per_dispatch=2')],
                         ids=['sync', 'async_window2'])
def test_cli_supervised_round_bitwise_plain(tmp_path, capsys, monkeypatch,
                                            extra):
    """``train.supervise=1`` with a fault plan (a failed write, a NaN, a
    corrupt step) writes model files byte-equal to the plain run's; the
    fault-free round's eval line is equal too (a recovered round reports
    its train metrics over the pass after the restore, as in JAX); the
    checkpoints live in ``model_dir/supervised_state``."""
    from cxxnet_tpu_torch.main import main as tmain
    write_mnist(str(tmp_path))
    (tmp_path / 'mlp.conf').write_text(CLI_CONF)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert tmain(['mlp.conf', 'model_dir=plain']) == 0
    plain = capsys.readouterr().err
    assert tmain(['mlp.conf', 'model_dir=sup', 'train.supervise=1',
                  'train.save_every=2', 'train.nan_breaker=1',
                  'train.keep_last=3', 'train.watchdog_deadline=30',
                  'train.fault_plan=seed=1;raise_on_write=3;'
                  'nan_at_step=4;corrupt_shard=4', *extra]) == 0
    sup = capsys.readouterr().err
    assert faults.active_plan() is None        # the CLI's plan uninstalled
    lines = [[ln for ln in e.splitlines() if ln.startswith('[')]
             for e in (plain, sup)]
    assert len(lines[0]) == len(lines[1]) == 2
    assert lines[0][1] == lines[1][1]
    for rd in (0, 1, 2):
        assert (tmp_path / 'plain' / f'{rd:04d}.model').read_bytes() == \
            (tmp_path / 'sup' / f'{rd:04d}.model').read_bytes()
    state_dir = str(tmp_path / 'sup' / 'supervised_state')
    assert sharded_ckpt.quarantined_steps(state_dir) == [4]
    assert len(sharded_ckpt.all_steps(state_dir)) <= 3
