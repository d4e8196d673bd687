"""The K-step window of ``cxxnet_tpu_torch`` (``steps_per_dispatch``,
``nnet/execution.py``) on the CPU, against its own per-step path and
against the JAX package's ``compile_multi_step``.

* A window of the port is **bitwise** K single steps of the port: with a
  dropout layer (each step's key ``fold_in(key, 1 + (sc0 + t) * 131 +
  round)``), ``update_period`` 2 and 3 straddling windows (the open
  accumulation carried across), a synthetic-pad tail whose mask rides
  with its batch, and ``eval_train`` metrics read one window late — the
  same eager step code runs either way.
* Against JAX's scanned window, from the same weights (carried across
  with ``params_from_jax``), the same dropout keys and batches: the
  parameters within ``tests/test_torch_train.py``'s train tolerance,
  rtol 1e-4 / atol 1e-6 (f32 sums in another order), the counters equal.
* The plan: the registry's keys are JAX's ``DEMOTION_REASONS``,
  ``scan_strict`` raises the port's ``ScanStrictError``, one note per
  reason, the K=1 lookahead, the round-only ``extra_data`` demotion.
* The CLI: an MNIST run at ``steps_per_dispatch=4 scan_strict=1`` writes
  model files byte-equal to the K=1 run's, eval lines equal.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.nnet.execution import (DEMOTION_REASONS as JAX_REASONS,
                                       ExecutionPlan as JPlan)
from cxxnet_tpu.nnet.execution import RUNTIME_REASONS as JAX_RUNTIME
from cxxnet_tpu.nnet.execution import STATIC_REASONS as JAX_STATIC
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import execution
from cxxnet_tpu_torch.nnet.execution import (DEMOTION_REASONS,
                                             ExecutionPlan, WindowedStepper)
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.runtime.faults import DivergenceError, ScanStrictError
from cxxnet_tpu_torch.utils.config import parse_config_string

from test_io_perf import DROPOUT_MLP, MNIST_CONF, _write_mnist
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


# the train tolerance of tests/test_torch_train.py: parameters after a
# few updates, f32 through the same layers with sums in another order
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6


def _batches(n=8, bs=32, pad_last=False, seed=0):
    """Seeded blobs of 4 classes for ``DROPOUT_MLP`` (JAX
    ``test_io_perf._mlp_batches``); a pad tail's last 5 rows are filler."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 16).astype(np.float32) * 2
    out = []
    for j in range(n):
        y = rng.randint(0, 4, bs)
        x = centers[y] + 0.3 * rng.randn(bs, 16).astype(np.float32)
        npadd = 5 if (pad_last and j == n - 1) else 0
        out.append(DataBatch(x.reshape(bs, 1, 1, 16),
                             y[:, None].astype(np.float32),
                             num_batch_padd=npadd, pad_synthetic=npadd > 0))
    return out


def _trainer(extra=''):
    tr = NetTrainer(parse_config_string(DROPOUT_MLP + extra))
    tr.init_model()
    return tr


def _run_per_step(tr, batches):
    for b in batches:
        tr.update_staged(tr.stage_batch(b))


def _run_windowed(tr, batches, k):
    plan = ExecutionPlan.resolve(requested_k=k, silent=True)
    stepper = plan.round_stepper(tr)
    for b in batches:
        stepper.feed(b)
    stepper.finish()
    return stepper


def _snap(tr):
    return {k: {f: v.detach().clone() for f, v in d.items()}
            for k, d in tr.params.items()}


def _assert_bitwise(a, b):
    for k, d in b.items():
        for f, v in d.items():
            assert torch.equal(a[k][f], v), (k, f)


# --- the window is bitwise K single steps -----------------------------------

@pytest.mark.parametrize('pad_last', [False, True])
def test_update_period_window_bitwise_matches_per_step(pad_last):
    batches = _batches(pad_last=pad_last)
    per = _trainer('update_period = 2\n')
    _run_per_step(per, batches)
    win = _trainer('update_period = 2\n')
    stepper = _run_windowed(win, batches, 4)
    assert stepper.updates == len(batches) and not stepper.window
    assert win.epoch_counter == per.epoch_counter == len(batches) // 2
    assert win.sample_counter == per.sample_counter == len(batches)
    _assert_bitwise(_snap(win), _snap(per))
    _assert_bitwise(win.opt_state['m'], per.opt_state['m'])
    assert torch.equal(win.last_loss, per.last_loss)


def test_update_period_straddles_window_boundaries():
    """P=3 with K=2: no window aligns with an accumulation boundary, so
    the partial sum carries across windows and into the per-step tail."""
    batches = _batches(n=7)
    per = _trainer('update_period = 3\n')
    _run_per_step(per, batches)
    win = _trainer('update_period = 3\n')
    stepper = _run_windowed(win, batches, 2)
    assert stepper.updates == 7
    assert win.epoch_counter == per.epoch_counter == 7 // 3
    _assert_bitwise(_snap(win), _snap(per))
    # the open accumulation (7 % 3 = 1 step) matches too
    _assert_bitwise(win.grad_acc, per.grad_acc)


@pytest.mark.parametrize('pad_last', [False, True])
def test_train_metrics_window_bitwise_matches_per_step(pad_last):
    """eval_train=1: the window's stacked outputs feed the same host-side
    metric math in step order, so the train line is byte-equal (pad rows
    left out on both paths)."""
    batches = _batches(pad_last=pad_last)
    per = _trainer('eval_train = 1\n')
    _run_per_step(per, batches)
    win = _trainer('eval_train = 1\n')
    _run_windowed(win, batches, 4)
    assert isinstance(win._pending_train_eval, dict)   # one window late
    lines = [t.evaluate(None, 'train') for t in (per, win)]
    assert lines[0] == lines[1] and 'train-error' in lines[1]
    _assert_bitwise(_snap(win), _snap(per))


def test_window_requires_train_eval_compiled_fn():
    tr = _trainer('eval_train = 1\n')
    fn = tr.compile_multi_step(2, train_eval=False)
    staged = [tr.stage_batch(b) for b in _batches(n=2)]
    with pytest.raises(ValueError, match='train_eval=True'):
        tr.update_staged_window(fn, staged)


def test_window_rejects_wrong_arity_and_extra_data():
    tr = _trainer()
    fn = tr.compile_multi_step(2)
    assert (fn.n_steps, fn.train_eval, fn.update_period) == (2, False, 1)
    staged = [tr.stage_batch(b) for b in _batches(n=3)]
    with pytest.raises(ValueError, match='does not match the step count'):
        tr.update_staged_window(fn, staged)
    b = _batches(n=1)[0]
    b.extra_data = [np.zeros((32, 2), np.float32)]
    with pytest.raises(ValueError, match='extra_data'):
        tr.update_staged_window(fn, [tr.stage_batch(b)] * 2)
    with pytest.raises(ValueError, match='n_steps'):
        tr.compile_multi_step(0)


def test_window_losses_feed_the_divergence_gate():
    """The window returns every step's loss and the armed gate reads them
    back once: a NaN batch in the middle of a window raises at its own
    step index, though the gate of the per-step path would wait a step."""
    tr = _trainer('nan_action = halt\n')
    fn = tr.compile_multi_step(4)
    batches = _batches(n=4)
    batches[1].data = batches[1].data.copy()
    batches[1].data[0, 0, 0, 0] = np.nan
    with pytest.raises(DivergenceError) as ei:
        tr.update_staged_window(fn, [tr.stage_batch(b) for b in batches])
    assert ei.value.step == 1
    assert tr.sample_counter == 4


def test_update_n_on_device_stacks_and_ones_mask():
    """A window over stacked tensors (round-robin over the stack, the
    cached all-ones mask) equals per-step runs of the same batches."""
    batches = _batches(n=2)
    per = _trainer()
    _run_per_step(per, batches + batches)
    win = _trainer()
    fn = win.compile_multi_step(4)
    data = torch.stack([torch.from_numpy(b.data) for b in batches])
    label = torch.stack([torch.from_numpy(b.label) for b in batches])
    loss = win.update_n_on_device(fn, data, label)
    assert win._ones_mask_stack((2, 32)) is win._ones_mask_stack((2, 32))
    with pytest.raises(ValueError, match='does not match'):
        win.update_n_on_device(fn, data, label, n_steps=3)
    assert (win.sample_counter, win.epoch_counter) == (4, 4)
    assert torch.equal(loss, per.last_loss)
    _assert_bitwise(_snap(win), _snap(per))


def test_stage_batch_casts_as_the_forward_does():
    tr = _trainer('compute_type = bfloat16\n')
    b = _batches(n=1)[0]
    staged = tr.stage_batch(b)
    assert staged[0].dtype == torch.bfloat16 and staged.ready is None
    assert torch.equal(staged[0], torch.from_numpy(b.data).to(torch.bfloat16))
    assert staged[1].dtype == torch.float32 and staged[3] is None
    u8 = DataBatch(np.arange(32 * 16, dtype=np.uint8).reshape(32, 1, 1, 16),
                   b.label, num_batch_padd=3, pad_synthetic=True)
    staged = tr.stage_batch(u8)
    assert staged[0].dtype == torch.uint8
    assert staged[3].tolist() == [1.0] * 29 + [0.0] * 3
    assert staged[5:7] == (32, 3)


# --- against the JAX package's scanned window --------------------------------

@pytest.mark.parametrize('period', [1, 2])
def test_window_matches_jax_compile_multi_step(period):
    """K=4 windows with a dropout layer and eval_train metrics, from the
    same weights and keys as JAX's scanned window."""
    conf = DROPOUT_MLP + f'update_period = {period}\neval_train = 1\n'
    batches = _batches(n=10, pad_last=True)
    jt = JTrainer(jparse(conf))
    jt.init_model()
    params0 = {k: {f: np.asarray(v) for f, v in d.items()}
               for k, d in jt.params.items()}
    plan = JPlan.resolve(requested_k=4, silent=True)
    stepper = plan.round_stepper(jt)
    for b in batches:
        stepper.feed(b)
    stepper.finish()
    tt = _trainer(f'update_period = {period}\neval_train = 1\n')
    tt.params = params_from_jax(params0)
    tt._post_params_init()
    _run_windowed(tt, batches, 4)
    assert (tt.sample_counter, tt.epoch_counter) == \
        (jt.sample_counter, jt.epoch_counter)
    for k, d in jt.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(tt.params[k][f].detach().numpy(),
                                       np.asarray(v), rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL, err_msg=f'{k}/{f}')
    jline, tline = jt.evaluate(None, 'train'), tt.evaluate(None, 'train')
    assert [t.split(':')[0] for t in tline.split('\t')] == \
        [t.split(':')[0] for t in jline.split('\t')]
    np.testing.assert_allclose(
        [float(t.split(':')[1]) for t in tline.split('\t') if t],
        [float(t.split(':')[1]) for t in jline.split('\t') if t],
        rtol=TRAIN_RTOL)


# --- the plan ---------------------------------------------------------------

def test_demotion_registry_matches_jax():
    assert set(DEMOTION_REASONS) == set(JAX_REASONS)
    assert execution.STATIC_REASONS == JAX_STATIC
    assert execution.RUNTIME_REASONS == JAX_RUNTIME


def test_static_demotions_and_strict():
    plan = ExecutionPlan.resolve(requested_k=4, profiling=True, silent=True)
    assert (plan.k, plan.requested_k, plan.scanned) == (1, 4, False)
    plan = ExecutionPlan.resolve(requested_k=4, test_io=True, silent=True)
    assert plan.k == 1
    for kw, reason in (({'profiling': True}, 'profile_dir'),
                       ({'test_io': True}, 'test_io')):
        with pytest.raises(ScanStrictError) as ei:
            ExecutionPlan.resolve(requested_k=4, strict=True, silent=True,
                                  **kw)
        assert ei.value.reason == reason
    plan = ExecutionPlan.resolve(requested_k=4, strict=True, silent=True)
    assert plan.k == 4 and plan.scanned
    assert ExecutionPlan.resolve(requested_k=0, test_io=True).k == 1


def test_fallback_note_printed_once_per_reason(capsys):
    plan = ExecutionPlan.resolve(requested_k=4, profiling=True)
    assert plan.note('profile_dir') is None          # already noted
    msg = plan.note('extra_data')
    assert msg and 'falls back to per-step' in msg
    assert plan.note('extra_data') is None
    assert capsys.readouterr().out.count('falls back to per-step') == 2


class _StubTrainer:
    """Just enough of a trainer for the stepper: records which path each
    staged batch took."""

    def __init__(self, extra=False):
        self.eval_train = 0
        self.train_metric = ()
        self.extra = extra
        self.calls = []

    def compile_multi_step(self, k, train_eval=False):
        def fn(*_a, **_kw):
            raise AssertionError('the stub window is never run raw')
        fn.n_steps = k
        fn.train_eval = train_eval
        return fn

    def stage_batch(self, batch):
        return (batch, None, (1,) if self.extra else (), None, None,
                0, 0, None)

    def update_staged(self, staged):
        self.calls.append(('step', staged[0]))

    def update_staged_window(self, fn, window):
        self.calls.append(('window', [s[0] for s in window]))


def test_extra_data_demotes_current_round_only():
    plan = ExecutionPlan.resolve(requested_k=2, silent=True)
    tr = _StubTrainer(extra=True)
    s1 = plan.round_stepper(tr)
    for i in range(3):
        s1.feed(i)
    s1.finish()
    assert s1.demoted
    assert [c[0] for c in tr.calls] == ['step'] * 3
    assert plan.k == 2                         # no permanent mutation
    tr2 = _StubTrainer(extra=False)
    s2 = plan.round_stepper(tr2)
    for i in range(4):
        s2.feed(i)
    s2.finish()
    assert not s2.demoted
    assert tr2.calls == [('window', [0, 1]), ('window', [2, 3])]
    assert s2.updates == 4


def test_extra_data_strict_raises_mid_round():
    plan = ExecutionPlan.resolve(requested_k=2, strict=True, silent=True)
    stepper = plan.round_stepper(_StubTrainer(extra=True))
    with pytest.raises(ScanStrictError) as ei:
        stepper.feed(0)
    assert ei.value.reason == 'extra_data'


def test_stepper_k1_keeps_one_batch_lookahead():
    tr = _StubTrainer()
    s = WindowedStepper(tr, k=1, lookahead=1)
    assert s.feed('a') == 0                    # staged, not run
    assert s.feed('b') == 1                    # runs 'a'
    assert tr.calls == [('step', 'a')]
    assert s.finish() == 1                     # drains 'b'
    assert tr.calls == [('step', 'a'), ('step', 'b')]


def test_stepper_lookahead_0_and_hooks():
    """lookahead=0 (a supervised loop) steps at once; before_dispatch sees
    each per-step update's index; discard drops a filling window."""
    seen = []
    plan = ExecutionPlan.resolve(requested_k=1, silent=True)
    tr = _StubTrainer()
    s = plan.round_stepper(tr, before_dispatch=seen.append, lookahead=0)
    assert s.feed('a') == 1 and s.feed('b') == 1
    assert seen == [0, 1] and tr.calls == [('step', 'a'), ('step', 'b')]
    with pytest.raises(ValueError, match='scan_fn'):
        WindowedStepper(tr, k=2)
    s4 = ExecutionPlan.resolve(requested_k=4, silent=True).round_stepper(tr)
    s4.feed('c')
    s4.discard()
    assert s4.finish() == 0


# --- the CLI ---------------------------------------------------------------

def _eval_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith('[')]


@pytest.mark.parametrize('extra', [(), ('update_period=2', 'eval_train=1')],
                         ids=['plain', 'period2_metrics'])
def test_cli_window_model_files_equal_k1(tmp_path, capsys, monkeypatch,
                                          extra):
    from cxxnet_tpu_torch.main import main as tmain
    _write_mnist(tmp_path)
    (tmp_path / 'mlp.conf').write_text(MNIST_CONF)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert tmain(['mlp.conf', 'model_dir=m1', *extra]) == 0
    r1 = capsys.readouterr()
    assert tmain(['mlp.conf', 'model_dir=m4', 'steps_per_dispatch=4',
                  'train.scan_strict=1', *extra]) == 0
    r4 = capsys.readouterr()
    assert 'falls back' not in r4.out
    e1, e4 = _eval_lines(r1.err), _eval_lines(r4.err)
    assert e1 == e4 and len(e1) == 2
    if extra:
        assert all('train-error' in ln for ln in e4)
    for rd in (1, 2):
        a = (tmp_path / 'm1' / f'{rd:04d}.model').read_bytes()
        b = (tmp_path / 'm4' / f'{rd:04d}.model').read_bytes()
        assert a == b, f'round {rd} diverged under the window'


def test_cli_scan_strict_raises_and_test_io_notes(tmp_path, capsys,
                                                  monkeypatch):
    from cxxnet_tpu_torch.main import main as tmain
    _write_mnist(tmp_path, n_train=200)
    (tmp_path / 'mlp.conf').write_text(
        MNIST_CONF.replace('num_round = 2', 'num_round = 1'))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ScanStrictError, match='test_io'):
        tmain(['mlp.conf', 'steps_per_dispatch=4', 'scan_strict=1',
               'test_io=1'])
    capsys.readouterr()
    assert tmain(['mlp.conf', 'train.steps_per_dispatch=4',
                  'test_io=1']) == 0
    out = capsys.readouterr().out
    assert out.count('steps_per_dispatch=4 falls back to per-step') == 1
    assert 'start I/O test' in out
