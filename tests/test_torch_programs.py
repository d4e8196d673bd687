"""The program ledger, device memory, MFU and the profiler of
``cxxnet_tpu_torch`` (``obs/programs.py``, ``utils/profiler.py``) against
the JAX package's, on the CPU.

* ``peak_flops`` / ``mfu`` under ``CXXNET_PEAK_TFLOPS`` equal to JAX's,
  and 0.0 / None on the CPU without it (MFU unreported, never 0).
* The ledger's ``flops`` of ``tests/test_net_mnist.py``'s ``MLP_CONF``
  step at ``synth_batches(1, 16)``: **exactly** the closed form 45056 =
  2·16·(16·32 + 32·4) forward + 2·16·32·4 (fc2's input gradient) +
  2·16·(16·32 + 32·4) (weight gradients); at most JAX's
  ``train_step_flops()`` (XLA also counts elementwise work) and at least
  0.75 of it.  A K-step window's row normalizes to the same per-step
  figure; ``/programs`` has JAX's top-level keys.
* The recompile sentinel under ``warn`` (one typed record, one stderr
  note, the call runs) and ``raise`` (the call never runs, every call at
  the new key raises again), JAX's bound semantics.
* The ``hbm`` gauges' CPU fallback: ``supported`` 0, the live tensors'
  bytes one count a storage (views do not double), the peak monotone.
* ``TraceWindow`` on the CPU: a trace file and a launch-count file for
  the window; ``/profile`` answers busy while it runs and traces once it
  stopped; the CLI's ``profile_dir`` demotes a K-step window.
* The serving programs: ``PredictEngine``'s bucket rows within its bound
  (no sentinel fire), ``ledger_bytes`` = ``resident_bytes`` on every
  tier, and above it by the whole buffer of a leaf that is a view
  (``held_bytes``: each storage once, an int8 leaf's payload and
  scales); the decode engine's one-key ``decode.step`` and its prefill
  rows.
* The execution plan's ``/statusz`` provider and one ``train.dispatch``
  span a step and a window.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.obs import programs as jprograms
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.obs import TelemetryHub, install_hub
from cxxnet_tpu_torch.obs import programs
from cxxnet_tpu_torch.runtime import faults
from cxxnet_tpu_torch.utils import profiler
from cxxnet_tpu_torch.utils.config import parse_config_string
from tests.test_net_mnist import MLP_CONF, synth_batches
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

MLP_STEP_FLOPS = (2 * 16 * (16 * 32 + 32 * 4) + 2 * 16 * 32 * 4
                  + 2 * 16 * (16 * 32 + 32 * 4))


@pytest.fixture
def ledger():
    led = programs.ProgramLedger()
    prev = programs.install_ledger(led)
    yield led
    programs.install_ledger(prev)


@pytest.fixture
def hub():
    h = TelemetryHub(ring_events=512)
    prev = install_hub(h)
    yield h
    h.disarm()
    install_hub(prev)


def _batch(b):
    return DataBatch(np.asarray(b.data), np.asarray(b.label))


# --- peaks and MFU -----------------------------------------------------------------

@pytest.mark.parametrize('env', ['0.001', '989', None])
def test_peak_flops_and_mfu_match_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv('CXXNET_PEAK_TFLOPS', raising=False)
    else:
        monkeypatch.setenv('CXXNET_PEAK_TFLOPS', env)
    got = programs.peak_flops('cpu' if env is None else None)
    assert got == jprograms.peak_flops()
    for flops, sps in ((MLP_STEP_FLOPS, 12.5), (0.0, 3.0), (1e9, 0.0)):
        assert programs.mfu(flops, sps, 'cpu') == jprograms.mfu(flops, sps)
    if env is None:
        assert got == 0.0 and programs.mfu(1e9, 1.0, 'cpu') is None


def test_peak_table_names_nvidia_parts(monkeypatch):
    monkeypatch.delenv('CXXNET_PEAK_TFLOPS', raising=False)
    names = {'NVIDIA H100 80GB HBM3': 989e12, 'NVIDIA H100 PCIe': 756e12,
             'NVIDIA A100-SXM4-80GB': 312e12, 'Tesla T4': 0.0}
    for name, want in names.items():
        monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i, n=name: n)
        assert programs.peak_flops(0) == want, name


# --- the ledger's flops ------------------------------------------------------------

def test_mlp_step_flops_closed_form_and_jax(ledger):
    batch = synth_batches(1, 16)[0]
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    assert tr.train_step_flops() == 0.0          # nothing ran yet
    tr.update(_batch(batch))
    got = tr.train_step_flops()
    assert got == MLP_STEP_FLOPS == 45056
    jt = JTrainer(jparse(MLP_CONF))
    jt.init_model()
    jt.update(batch)
    want = jt.train_step_flops()
    assert 0.75 * want <= got <= want, (got, want)
    row = ledger.view()['programs'][0]
    assert (row['name'], row['shape_key'], row['flops']) == \
        ('train.step', 'b16', 45056.0)
    nbytes = 3 * 4 * (16 * 32 + 32 + 32 * 4 + 4)  # params, momentum, acc
    assert row['argument_bytes'] == nbytes
    assert sorted(ledger.view()) == sorted(jprograms.ProgramLedger().view())
    assert sorted(ledger.summary()) == sorted(
        jprograms.ProgramLedger().summary())


def test_window_row_is_per_step_and_forward_rows(ledger):
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    staged = [tr.stage_batch(_batch(b)) for b in synth_batches(4, 16)]
    fn = tr.compile_multi_step(4, train_eval=True)
    tr.update_staged_window(fn, staged)
    rows = {r['name']: r for r in ledger.view()['programs']}
    assert rows['train.multi_step']['shape_key'] == 'k4eb16'
    assert rows['train.multi_step']['steps'] == 4
    assert rows['train.multi_step']['flops'] == 4 * MLP_STEP_FLOPS
    assert tr.train_step_flops() == MLP_STEP_FLOPS
    tr.predict_scores(np.zeros((5, 1, 1, 16), np.float32))
    fwd = [r for r in ledger.view()['programs']
           if r['name'] == 'train.forward']
    assert fwd[0]['shape_key'] == 'b5'
    assert fwd[0]['flops'] == 2 * 5 * (16 * 32 + 32 * 4)


def test_cnn_flops_count_conv_products():
    """A conv net: the data-reading conv has no input gradient, grouped
    convs count their groups' products."""
    conf = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
  pad = 1
layer[1->2] = relu
layer[2->3] = conv:c2
  kernel_size = 3
  nchannel = 6
  ngroup = 2
  stride = 2
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 3
layer[5->5] = softmax
netconfig=end
input_shape = 2,8,8
batch_size = 5
dev = cpu
"""
    tr = NetTrainer(parse_config_string(conf))
    tr.init_net()
    c1 = 8 * 8 * 4 * 2 * 9           # pad 1: 8 x 8 out
    c2 = 3 * 3 * 6 * 2 * 9           # stride 2, no pad: 3 x 3 out
    fc = 6 * 3 * 3 * 3
    fwd = 2 * 5 * (c1 + c2 + fc)
    assert programs.cnn_step_flops(tr.net, 5, train=False) == fwd
    assert programs.cnn_step_flops(tr.net, 5) == \
        3 * fwd - 2 * 5 * c1


# --- the recompile sentinel ---------------------------------------------------------

def test_recompile_sentinel_warn_and_raise(ledger, capsys):
    log = faults.global_failure_log()
    n0 = len(log.records('RecompileStormError'))
    prog = ledger.program('probe.fn', bound=2)
    calls = []
    for key in ('a', 'b', 'a', 'c', 'd'):
        prog.run(key, calls.append, key)
    assert calls == ['a', 'b', 'a', 'c', 'd']     # warn: the calls run
    assert prog.compiles == 4 and ledger.recompiles_total == 2
    assert len(log.records('RecompileStormError')) == n0 + 2
    assert capsys.readouterr().err.count('recompile storm') == 1
    ledger.set_recompile('raise')
    prog2 = ledger.program('probe.fn', bound=1)
    assert prog2.name == 'probe.fn#2'
    prog2.run('x', calls.append, 'x')
    for _ in range(2):
        with pytest.raises(faults.RecompileStormError, match='bound of 1'):
            prog2.run('y', calls.append, 'y')
    assert calls[-1] == 'x'                       # never ran at 'y'
    prog2.run('x', calls.append, 'x2')
    ledger.set_recompile('off')
    prog2.run('z', calls.append, 'z')
    assert calls[-2:] == ['x2', 'z']
    with pytest.raises(ValueError, match='warn\\|raise\\|off'):
        ledger.set_recompile('loud')


# --- device memory --------------------------------------------------------------------

def test_hbm_cpu_fallback_counts_storages_once(hub):
    stats = programs.register_hbm(hub)
    hub.metrics_text()
    base = stats.get('bytes_in_use[d0]')
    assert stats.get('supported') == 0.0 and base >= 0
    big = torch.zeros(1 << 21)                    # 8 MiB
    views = [big[1:], big.view(2, -1), big.reshape(-1)]
    snap = hub.gauge_snapshot()
    grown = snap['hbm.bytes_in_use[d0]'] - base
    assert (8 << 20) <= grown < (8 << 20) + (1 << 20), grown
    assert snap['hbm.peak_bytes[d0]'] >= snap['hbm.bytes_in_use[d0]']
    del big, views
    snap2 = hub.gauge_snapshot()
    assert snap2['hbm.bytes_in_use[d0]'] < snap['hbm.bytes_in_use[d0]']
    assert snap2['hbm.peak_bytes[d0]'] == snap['hbm.peak_bytes[d0]']
    assert 'headroom_frac[d0]' not in stats.snapshot()[0]


# --- the profiler ------------------------------------------------------------------------

def test_trace_window_and_profile_session_exclude_each_other(tmp_path,
                                                             ledger):
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    win = profiler.TraceWindow()
    win.configure([('profile_dir', str(tmp_path / 'prof')),
                   ('profile_start_batch', '1'),
                   ('profile_stop_batch', '3')])
    sess = programs.ProfilerSession()
    assert win.enabled and not win.active
    for i, b in enumerate(synth_batches(5, 16)):
        win.before_update(i)
        if i == 1:
            assert win.active and profiler.trace_owner() == 'profile_dir'
            busy = sess.start(str(tmp_path / 'obs'), ms=100)
            assert busy == {'started': False, 'busy': 'profile_dir'}
        tr.update(_batch(b))
    win.stop()
    assert not win.active and profiler.trace_owner() is None
    pid = os.getpid()
    with open(win.path) as f:
        trace = json.load(f)
    assert win.path == str(tmp_path / 'prof' / f'trace_{pid}.json')
    assert trace['traceEvents']
    with open(tmp_path / 'prof' / f'launches_{pid}.json') as f:
        window = json.load(f)
    assert window.pop('stop_ms') > 0
    assert window == {'start_batch': 1, 'stop_batch': 3,
                      'launches': {}}             # plain versions: none
    res = sess.start(str(tmp_path / 'obs'), ms=50)
    assert res['started'] is True
    assert sess.start(str(tmp_path / 'obs'))['busy'] == res['path']
    assert not profiler.acquire_trace('profile_dir')
    deadline = time.monotonic() + 30
    while sess.status()['active'] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sess.status() == {'active': None, 'sessions': 1,
                             'last_error': None}
    assert os.path.exists(os.path.join(res['path'], 'trace.json'))
    assert profiler.trace_owner() is None


def test_profile_endpoint_answers_busy_then_traces(hub, tmp_path):
    from cxxnet_tpu_torch.obs.endpoints import ObsServer
    prev = programs._PROFILE
    programs._PROFILE = programs.ProfilerSession()
    srv = ObsServer(hub, port=0, profile_dir=str(tmp_path / 'p'))
    try:
        def get(path):
            with urllib.request.urlopen(srv.url + path, timeout=10) as r:
                return json.loads(r.read())
        first = get('/profile?ms=200')
        assert first['started'] is True and first['ms'] == 200.0
        assert get('/profile?ms=200')['busy'] == first['path']
        deadline = time.monotonic() + 30
        while programs._PROFILE.status()['active'] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert os.path.exists(os.path.join(first['path'], 'trace.json'))
    finally:
        assert srv.close(timeout=10.0)
        programs._PROFILE = prev
    assert not [t for t in threading.enumerate()
                if t.name.startswith('cxxnet-obs-')]


def test_cli_profile_dir_demotes_the_window(tmp_path, monkeypatch, capsys):
    from tests.test_io import write_mnist
    from tests.test_torch_obs import CLI_CONF
    from cxxnet_tpu_torch.main import main as tmain
    write_mnist(str(tmp_path), n=96, rows=8, cols=8, seed=4)
    (tmp_path / 'train.conf').write_text(CLI_CONF.format(root=tmp_path))
    monkeypatch.chdir(tmp_path)
    assert tmain(['train.conf', 'num_round=1', 'steps_per_dispatch=2',
                  'profile_dir=prof', 'profile_start_batch=1',
                  'profile_stop_batch=3']) == 0
    out, _ = capsys.readouterr()
    assert 'falls back to per-step' in out and 'trace window' in out
    assert sorted(os.listdir(tmp_path / 'prof')) == sorted(
        [f'launches_{os.getpid()}.json', f'trace_{os.getpid()}.json'])


# --- the serving programs ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_predict_engine_bucket_rows(ledger, dtype):
    from cxxnet_tpu_torch.serve import PredictEngine
    tr = NetTrainer(parse_config_string(MLP_CONF + 'inference_only = 1\n'))
    tr.init_model()
    eng = PredictEngine(tr, (1, 4, 8), dtype=dtype)
    assert eng.ledger_bytes() is None
    eng.warm()
    for n in (3, 8, 11, 1):
        eng.predict_scores(np.zeros((n, 1, 1, 16), np.float32))
    rows = [r for r in ledger.view()['programs']
            if r['name'] == 'serve.predict']
    assert [r['shape_key'] for r in rows] == ['b1', 'b4', 'b8']
    assert [r['flops'] for r in rows] == [
        2.0 * b * (16 * 32 + 32 * 4) for b in (1, 4, 8)]
    assert eng.compile_count == 3 and ledger.recompiles_total == 0
    assert eng.ledger_bytes() == eng.resident_bytes()
    assert rows[1]['calls'] >= 2


def test_ledger_bytes_hold_a_views_buffer(ledger):
    from cxxnet_tpu_torch.nnet.quantize import QuantLeaf
    from cxxnet_tpu_torch.serve import PredictEngine
    x = torch.zeros(6, 4)
    assert programs.held_bytes({'a': x, 'b': x.view(-1)}, [x[:2]]) == 96
    q, sc = torch.zeros(4, 8, dtype=torch.int8), torch.ones(1, 8)
    assert programs.held_bytes(QuantLeaf(q, sc)) == 32 + 32
    tr = NetTrainer(parse_config_string(MLP_CONF + 'inference_only = 1\n'))
    tr.init_model()
    layer = sorted(tr.params)[0]
    field = sorted(tr.params[layer])[0]
    leaf = tr.params[layer][field]
    buf = torch.zeros(3 * leaf.numel(), dtype=leaf.dtype)
    buf[:leaf.numel()] = leaf.reshape(-1)
    tr.params[layer][field] = buf[:leaf.numel()].view(leaf.shape)
    eng = PredictEngine(tr, (1, 4))
    eng.warm()
    assert eng.ledger_bytes() == (eng.resident_bytes()
                                  + 2 * leaf.numel() * leaf.element_size())


def test_decode_programs_one_step_key(ledger):
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.serve.decode import DecodeService
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, num_heads=4,
                              d_ff=48, num_stages=2, seq_len=32,
                              attn='local')
    params = T.init_params(np.random.RandomState(0), cfg)
    svc = DecodeService(params, cfg, slots=2, pages=32, page_size=8,
                        max_prompt=16, max_new_bound=6, deadline=60.0,
                        device='cpu')
    try:
        for s0 in (3, 5, 11):
            svc.generate(np.arange(s0, dtype=np.int32), 6)
    finally:
        svc.close(30.0)
    rows = ledger.view()['programs']
    steps = [r for r in rows if r['name'] == 'decode.step']
    assert len(steps) == 1 and steps[0]['shape_key'] == 'step'
    eng = svc.engine
    r = T.step_rows(2)
    assert steps[0]['flops'] == programs.lm_flops(cfg, r, 2 * eng.cache_len,
                                                  r)
    from cxxnet_tpu_torch.serve.decode import _prompt_bucket
    pre = {r['shape_key']: r['flops'] for r in rows
           if r['name'] == 'decode.prefill'}
    buckets = sorted({_prompt_bucket(s) for s in (3, 5, 11)})
    assert sorted(pre) == sorted(f's{b}' for b in buckets)
    for b in buckets:
        assert pre[f's{b}'] == programs.lm_flops(cfg, b, b * b, 1)
    assert ledger.recompiles_total == 0


# --- the execution plan ----------------------------------------------------------------

@pytest.mark.parametrize('k', [1, 4])
def test_plan_status_and_dispatch_spans(hub, ledger, k):
    from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
    tr = NetTrainer(parse_config_string(MLP_CONF))
    tr.init_model()
    plan = ExecutionPlan.resolve(requested_k=k, silent=True)
    assert hub.status()['status']['execution_plan']['flops_per_step'] == 0
    stepper = plan.round_stepper(tr)
    for b in synth_batches(8, 16):
        stepper.feed(_batch(b))
    stepper.finish()
    st = hub.status()['status']['execution_plan']
    assert st == {'requested_k': k, 'k': k, 'scanned': k > 1,
                  'demotions': [], 'flops_per_step': float(MLP_STEP_FLOPS)}
    spans = [e for e in hub.events() if e['name'] == 'train.dispatch']
    assert [e['attrs']['k'] for e in spans] == [k] * (8 // k)
    assert [e['attrs']['update'] for e in spans] == list(range(0, 8, k))
