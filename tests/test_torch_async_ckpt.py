"""The asynchronous checkpoint writer of ``cxxnet_tpu_torch``
(``runtime/async_ckpt.py``) on the CPU: the contracts of the JAX
package's ``tests/test_async_ckpt.py``, held by the port.

* A snapshot keeps its values through later in-place steps (the port
  updates parameters in place where JAX donates buffers).
* The native format's typed round trip: small leaves packed, f32 / int64
  / bfloat16, 0-d counters staying 0-d, the digest.
* An async-written checkpoint restores bitwise equal to its sync twin,
  and training on from either stays bitwise equal.
* A writer fault never removes the previous checkpoint, lands in the
  failure log and re-raises at the next barrier; a one-shot fault rides
  the retry; ``corrupt_shard`` fires after the background commit.
* Double buffering, the deferred failure, ``stall_write``.
* The supervisor: a restore barriers on a pending save (it restores that
  step), the NaN gate is settled at snapshot time, pruning keeps
  ``keep_last``; the CLI's ``save_async=1`` writes the sync run's bytes.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.nnet import sharded_ckpt
from cxxnet_tpu_torch.runtime import async_ckpt, faults
from cxxnet_tpu_torch.runtime.async_ckpt import AsyncCheckpointer
from cxxnet_tpu_torch.runtime.supervisor import (SupervisorConfig,
                                                 TrainSupervisor)

from test_torch_runtime import (CLI_CONF, assert_bitwise, fresh, state,
                                synth_batches, write_mnist)

pytestmark = pytest.mark.torch_port

NO_WAIT = faults.NO_WAIT_RETRY
ONE_SHOT = faults.RetryPolicy(max_attempts=1, base_delay=0.0, jitter=0.0,
                              sleep=lambda _t: None)


@pytest.fixture(autouse=True)
def _clean_plan():
    prev = faults.install_plan(None)
    yield
    faults.install_plan(prev)


def _sup_config(**kw):
    base = dict(batch_deadline=0.3, max_restarts=3, nan_breaker=0,
                save_every=2, buffer_size=2, retry=NO_WAIT,
                save_async=1, save_workers=3)
    base.update(kw)
    return SupervisorConfig(**base)


def _params(tr):
    return {(k, f): v.detach().clone() for k, d in tr.params.items()
            for f, v in d.items()}


# --- snapshot semantics ---------------------------------------------------

def test_snapshot_survives_in_place_steps():
    tr = fresh()
    batches = synth_batches(n_batches=4)
    tr.update(batches[0])
    snap = tr.snapshot_training_state()
    want = _params(tr)
    for b in batches[1:]:
        tr.update(b)                      # updates the live tensors
    assert not torch.equal(tr.params['0']['wmat'], want[('0', 'wmat')])
    host = async_ckpt.host_tree(snap)
    for (k, f), w in want.items():
        np.testing.assert_array_equal(host['params'][k][f], w.numpy())
    assert host['counters']['sample'].shape == ()
    assert int(host['counters']['sample']) == 1
    assert snap.ready is None             # no card: nothing to wait on


def test_snapshot_tree_copies_host_leaves_and_keeps_structure():
    counter = np.asarray(5, np.int64)
    tree = {'a': [torch.ones(3), (np.arange(2), None)], 'c': counter}
    snap = async_ckpt.snapshot_tree(tree)
    counter[...] = 9
    tree['a'][0].add_(1)
    host = async_ckpt.host_tree(snap)
    assert int(host['c']) == 5
    np.testing.assert_array_equal(host['a'][0], np.ones(3, np.float32))
    assert isinstance(host['a'][1], tuple) and host['a'][1][1] is None


# --- native format --------------------------------------------------------

def test_native_roundtrip_packed_and_typed(tmp_path):
    rng = np.random.RandomState(0)
    tree = {'w': torch.arange(8, dtype=torch.float32),
            'big': torch.from_numpy(rng.randn(512, 200).astype(np.float32)),
            'half': torch.from_numpy(rng.randn(600, 300).astype(
                np.float32)).to(torch.bfloat16),
            'c': {'step': np.asarray(3, np.int64),
                  'vec': np.arange(5, dtype=np.int64)}}
    path = sharded_ckpt.save_tree_native(str(tmp_path / 'ck'), 1, tree,
                                         retry=NO_WAIT)
    assert sharded_ckpt.verify_step_dir(path) is None
    names = set(os.listdir(path))
    assert {'tree_manifest.json', 'ckpt_digest.json',
            'packed_leaves.bin'} <= names
    got, step = sharded_ckpt.restore_sharded(str(tmp_path / 'ck'), tree,
                                             retry=NO_WAIT)
    assert step == 1
    for key in ('w', 'big', 'half'):
        assert got[key].dtype == tree[key].dtype
        assert torch.equal(got[key], tree[key])
    for key in ('step', 'vec'):
        assert got['c'][key].dtype == np.int64
        assert got['c'][key].shape == tree['c'][key].shape
        np.testing.assert_array_equal(got['c'][key], tree['c'][key])


def test_native_digest_detects_truncation(tmp_path):
    tree = {'big': torch.from_numpy(
        np.random.RandomState(0).randn(512, 600).astype(np.float32))}
    path = sharded_ckpt.save_tree_native(str(tmp_path / 'ck'), 1, tree,
                                         retry=NO_WAIT)
    victim = max((os.path.join(path, f) for f in os.listdir(path)
                  if f != 'ckpt_digest.json'), key=os.path.getsize)
    with open(victim, 'r+b') as f:
        f.truncate(os.path.getsize(victim) // 2)
    assert sharded_ckpt.verify_step_dir(path) is not None


# --- the bitwise twin and writer-fault isolation ---------------------------

def test_async_restore_bitwise_identical_to_sync_twin(tmp_path):
    batches = synth_batches(n_batches=6)
    tr = fresh()
    for b in batches[:3]:
        tr.update(b)
    tr.save_training_state(str(tmp_path / 'sync'), 3)
    ck = AsyncCheckpointer(workers=3)
    ck.save_sharded_async(str(tmp_path / 'async'), 3,
                          tr.snapshot_training_state(), retry=NO_WAIT)
    for b in batches[3:]:
        tr.update(b)          # the write overlaps in-place training
    ck.wait()
    ck.close()
    for name in os.listdir(tmp_path / 'sync' / 'step_3'):
        assert (tmp_path / 'sync' / 'step_3' / name).read_bytes() == \
            (tmp_path / 'async' / 'step_3' / name).read_bytes(), name
    t_sync, t_async = fresh(), fresh()
    assert t_sync.load_training_state(str(tmp_path / 'sync'),
                                      restore_params=True) == 3
    assert t_async.load_training_state(str(tmp_path / 'async'),
                                       restore_params=True) == 3
    assert_bitwise(state(t_async), state(t_sync))
    for b in batches[3:]:
        t_sync.update(b)
        t_async.update(b)
    assert_bitwise(state(t_async), state(t_sync))
    assert_bitwise(state(t_async), state(tr))


def test_writer_fault_preserves_previous_checkpoint(tmp_path):
    d = str(tmp_path / 'ck')
    batches = synth_batches(n_batches=4)
    tr = fresh()
    tr.update(batches[0])
    good = state(tr)
    log = faults.FailureLog()
    ck = AsyncCheckpointer(workers=2, failure_log=log)
    ck.save_sharded_async(d, 1, tr.snapshot_training_state(),
                          retry=ONE_SHOT)
    ck.wait()
    faults.install_plan(faults.FaultPlan(raise_on_write=(1,)))
    tr.update(batches[1])
    ck.save_sharded_async(d, 2, tr.snapshot_training_state(),
                          retry=ONE_SHOT)
    with pytest.raises(faults.RetryError):
        ck.wait()
    assert len(log.records('async_save_failed')) == 1
    assert sharded_ckpt.all_steps(d) == [1]
    assert [n for n in os.listdir(d) if '.tmp.' in n] == []
    assert sharded_ckpt.verify_step_dir(sharded_ckpt.step_dir(d, 1)) is None
    t2 = fresh()
    assert t2.load_training_state(d, restore_params=True,
                                  fallback=True) == 1
    assert_bitwise(state(t2), good)
    ck.close()


def test_injected_writer_fault_rides_retry_and_recovers(tmp_path):
    d = str(tmp_path / 'ck')
    tr = fresh()
    tr.update(synth_batches(n_batches=1)[0])
    plan = faults.FaultPlan(raise_on_write=(1,))
    faults.install_plan(plan)
    ck = AsyncCheckpointer(workers=2)
    ck.save_sharded_async(d, 1, tr.snapshot_training_state(),
                          retry=NO_WAIT)
    ck.wait()
    assert plan.fired() == ['raise_on_write=1']
    assert sharded_ckpt.all_steps(d) == [1]
    assert sharded_ckpt.verify_step_dir(sharded_ckpt.step_dir(d, 1)) is None
    assert ck.commits == 1 and ck.submits == 1
    ck.close()


def test_corrupt_shard_fires_in_writer_and_falls_back(tmp_path):
    d = str(tmp_path / 'ck')
    tr = fresh()
    batches = synth_batches(n_batches=2)
    tr.update(batches[0])
    ck = AsyncCheckpointer(workers=2)
    ck.save_sharded_async(d, 1, tr.snapshot_training_state(),
                          retry=NO_WAIT)
    ck.wait()
    good = state(tr)
    plan = faults.FaultPlan(seed=5, corrupt_shard=(2,))
    faults.install_plan(plan)
    tr.update(batches[1])
    ck.save_sharded_async(d, 2, tr.snapshot_training_state(),
                          retry=NO_WAIT)
    ck.wait()
    ck.close()
    assert plan.fired() == ['corrupt_shard=2']
    t2 = fresh()
    assert t2.load_training_state(d, restore_params=True,
                                  fallback=True) == 1
    assert_bitwise(state(t2), good)
    assert os.path.isdir(os.path.join(d, 'step_2.corrupt'))


# --- double buffering ---------------------------------------------------------

def test_double_buffer_blocks_second_submit_until_commit():
    ck = AsyncCheckpointer(workers=2)
    gate = threading.Event()
    done = []

    def slow():
        gate.wait(5.0)
        done.append('first')

    ck.submit(slow, label='first')
    assert ck.pending()
    releaser = threading.Timer(0.2, gate.set)
    releaser.start()
    ck.submit(lambda: done.append('second'), label='second')
    assert done[0] == 'first'
    assert ck.in_flight() <= 1
    ck.wait()
    assert done == ['first', 'second'] and not ck.pending()
    releaser.cancel()
    ck.close()
    ck.close()                            # idempotent
    with pytest.raises(RuntimeError, match='closed'):
        ck.submit(lambda: None)


def test_submit_resurfaces_previous_failure_then_recovers():
    log = faults.FailureLog()
    ck = AsyncCheckpointer(workers=1, failure_log=log)
    ck.submit(lambda: (_ for _ in ()).throw(OSError('disk gone')),
              label='bad')
    with pytest.raises(OSError):
        ck.submit(lambda: 'fine', label='next')
    f = ck.submit(lambda: 'fine', label='next')
    ck.wait()
    assert f.result() == 'fine'
    assert len(log.records('async_save_failed')) == 1
    ck.submit(lambda: (_ for _ in ()).throw(OSError('again')), label='bad')
    ck.drain()                            # the restore barrier swallows it
    assert len(log.records('async_save_failed')) == 2
    ck.close()


def test_stall_write_event_parse_and_fire():
    plan = faults.FaultPlan.parse('stall_write=1:0.05;stall_write=3')
    assert 'stall_write=1:0.05' in plan.describe()
    t0 = time.monotonic()
    plan.on_checkpoint_write('p')
    assert time.monotonic() - t0 >= 0.05
    plan.on_checkpoint_write('p')
    assert plan.fired() == ['stall_write=1:0.05']


# --- the supervisor ---------------------------------------------------------------

def test_supervisor_restore_barriers_on_pending_save(tmp_path):
    """A fault while a save is mid-commit (``stall_write`` slows write #2,
    the step-2 save; the NaN at step 2 trips the breaker meanwhile): the
    restore drains the writer and restores that step, then the run ends
    bitwise the uninterrupted one, its last step committed."""
    batches = synth_batches(n_batches=8)
    ref = fresh()
    for b in batches:
        ref.update(b)
    plan = faults.FaultPlan(stall_write=((2, 1.5),), nan_at_step=(2,))
    faults.install_plan(plan)
    tr = fresh()
    log = faults.FailureLog()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(nan_breaker=1, batch_deadline=30.0),
                          failure_log=log)
    try:
        assert sup.run(lambda k: iter(batches[k:])) == 8
    finally:
        sup.close()
    assert 'stall_write=2:1.5' in plan.fired()
    restored = log.records('restored')
    assert len(restored) == 1 and restored[0].step == 2
    assert_bitwise(state(tr), state(ref))
    assert sharded_ckpt.all_steps(str(tmp_path / 'sup'))[0] == 8
    assert sharded_ckpt.verify_step_dir(
        sharded_ckpt.step_dir(str(tmp_path / 'sup'), 8)) is None


def test_nan_streak_gate_resolved_at_snapshot_time(tmp_path):
    faults.install_plan(faults.FaultPlan(nan_at_step=(2, 3)))
    tr = fresh('nan_breaker = 3\n')
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(save_every=1, nan_breaker=0,
                                      keep_last=0))
    try:
        assert sup.run(lambda k: iter(synth_batches(n_batches=6)[k:])) == 6
        sup.wait_for_saves()
    finally:
        sup.close()
    steps = set(sharded_ckpt.all_steps(str(tmp_path / 'sup')))
    assert not {3, 4} & steps
    assert {1, 2, 5, 6} <= steps


def test_supervisor_async_prunes_to_keep_last(tmp_path):
    tr = fresh()
    sup = TrainSupervisor(tr, str(tmp_path / 'sup'),
                          _sup_config(save_every=1, keep_last=2))
    try:
        assert sup.run(lambda k: iter(synth_batches()[k:])) == 8
        sup.wait_for_saves()
    finally:
        sup.close()
    assert sharded_ckpt.all_steps(str(tmp_path / 'sup')) == [8, 7]


# --- the CLI ------------------------------------------------------------------------

def test_cli_save_async_writes_the_sync_bytes(tmp_path, capsys, monkeypatch):
    """``save_async=1 exact_ckpt=1``: the model files, their digests and
    the newest exact sidecar are byte-equal to the synchronous run's, and
    only the newest sidecar is kept."""
    from cxxnet_tpu_torch.main import main as tmain
    write_mnist(str(tmp_path))
    (tmp_path / 'mlp.conf').write_text(CLI_CONF)
    monkeypatch.chdir(tmp_path)
    assert tmain(['mlp.conf', 'model_dir=s', 'exact_ckpt=1']) == 0
    assert tmain(['mlp.conf', 'model_dir=a', 'exact_ckpt=1', 'save_async=1',
                  'save_workers=3']) == 0
    capsys.readouterr()
    for name in ('0000.model', '0001.model', '0002.model',
                 '0002.model.crc32'):
        assert (tmp_path / 's' / name).read_bytes() == \
            (tmp_path / 'a' / name).read_bytes(), name
    for tag in 'sa':
        assert sharded_ckpt.all_steps(str(tmp_path / tag / 'exact_state')) \
            == [2]
    step = tmp_path / 's' / 'exact_state' / 'step_2'
    for name in os.listdir(step):
        assert (step / name).read_bytes() == (
            tmp_path / 'a' / 'exact_state' / 'step_2' / name).read_bytes()
