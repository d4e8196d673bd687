"""The telemetry hub of ``cxxnet_tpu_torch`` (``obs/hub.py``,
``obs/endpoints.py``) against the JAX package's, on the CPU.

* The one eval-line formatter: ``format_report`` / ``StatSet.print`` /
  ``print_and_clear`` strings over the same seeded samples **byte-equal**
  to JAX's, and ``tail_view`` / ``quantile`` / ``clear`` alike.
* ``metrics_text`` byte-equal to JAX's golden (``tests/test_obs.py``) and
  to JAX's hub fed the same StatSets; ``gauge_snapshot`` with JAX's keys
  and values (the uptime aside).
* Spans: nesting, trace-id inheritance, errors, the bounded ring, the
  enabled switch, the decorator form; the Chrome trace export and the
  flight dump of the same span sequence with JAX's names, nesting, trace
  ids and keys once times, pids and thread ids are stripped.
* The dump triggers (a training fault, an SLO breach, SIGUSR1; not an
  ``io_retry``), per-thread rings from two threads, a serve request's
  trace id across the batcher's threads, a decode request's lifecycle
  in the exported trace with JAX's event names.
* The endpoints on ephemeral ports (``/healthz`` ``/metrics``
  ``/statusz`` ``/slos`` ``/programs``, 404, a render error answering
  500), each closed at teardown, the port announced into a port file.
* The CLI: a small MNIST conf with ``obs.port=0``, a ``slo.`` spec and
  ``obs.trace_export``: ``/metrics`` answers mid-run (scraped from inside
  the second step), the SLO's exit line, the Chrome trace with one
  ``train.dispatch`` span a step, and the ``[N]`` eval lines byte-equal to
  the same run without telemetry.
* ``Net.obs_stats`` / ``capi.net_obs_*``: JSON with JAX's key set.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu import obs as jobs
from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu.utils.metric import StatSet as JStatSet
from cxxnet_tpu_torch import obs as tobs
from cxxnet_tpu_torch.obs.endpoints import ObsServer
from cxxnet_tpu_torch.runtime import faults
from cxxnet_tpu_torch.utils.metric import StatSet
from tests.test_obs import GOLDEN_METRICS
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture
def hubs():
    """Fresh hubs installed process-wide in both packages (the production
    code records through the module-level ``span()`` / ``record_event``)."""
    t, j = tobs.TelemetryHub(ring_events=256), jobs.TelemetryHub(
        ring_events=256)
    prev = (tobs.install_hub(t), jobs.install_hub(j))
    # and a fresh program ledger: program names are claimed once a
    # process, so a trainer of an earlier test file in this worker would
    # otherwise hold the bare names these tests read
    prev_ledger = tobs.install_ledger(tobs.ProgramLedger())
    yield t, j
    t.disarm()
    j.disarm()
    tobs.install_hub(prev[0])
    jobs.install_hub(prev[1])
    tobs.install_ledger(prev_ledger)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _fill(stats, seed=0):
    """The same counters, gauges, peaks and seeded samples into a
    StatSet of either package."""
    rng = np.random.RandomState(seed)
    stats.inc('requests', 3)
    stats.inc('rows[b8]', 16)
    stats.gauge('queue_peak', 2)
    stats.peak('depth', 5)
    stats.peak('depth', 4)
    for v in rng.lognormal(1.0, 0.7, 257):
        stats.observe('latency_ms', float(v))
    for v in rng.rand(33):
        stats.observe('occupancy[b32]', float(v))
    return stats


# --- the one formatter ------------------------------------------------------

def test_format_report_and_statset_strings_match_jax():
    t, j = _fill(StatSet()), _fill(JStatSet())
    assert tobs.format_report('serve', t) == jobs.format_report('serve', j)
    assert t.print('serve') == j.print('serve')
    assert '\tserve-requests:3' in t.print('serve')
    for name in ('latency_ms', 'occupancy[b32]', 'missing'):
        for q in (0.5, 0.99):
            a, b = t.quantile(name, q), j.quantile(name, q)
            assert a == b or (np.isnan(a) and np.isnan(b))
    assert t.tail_view(7) == j.tail_view(7)
    assert t.print_and_clear('io') == j.print_and_clear('io')
    assert t.snapshot() == j.snapshot() == ({}, {})
    _fill(t, 1)
    _fill(j, 1)
    t.clear()
    j.clear()
    assert t.print('x') == j.print('x') == ''


# --- renderers ----------------------------------------------------------------

def test_metrics_text_golden_and_equal_to_jax(hubs):
    """The exposition format is an advertised machine surface: byte for
    byte JAX's golden, and JAX's hub fed the same StatSets."""
    thub, jhub = hubs
    for hub, cls in ((thub, StatSet), (jhub, JStatSet)):
        s = cls()
        s.inc('requests', 3)
        s.gauge('queue_peak', 2)
        s.inc('rows[b8]', 16)
        for v in (1.0, 2.0, 3.0, 4.0):
            s.observe('latency_ms', v)
        hub.register_stats('serve', s)
        d = _fill(cls(), 3)
        hub.register_stats('decode', d,
                           refresh=lambda d=d: d.gauge('free_pages', 31))
    texts = [h.metrics_text() for h in (thub, jhub)]
    strip = [[ln for ln in t.splitlines() if 'cxxnet_obs_uptime' not in ln]
             for t in texts]
    assert strip[0] == strip[1]
    golden = [ln for ln in texts[0].splitlines()
              if ln.startswith(('cxxnet_serve', '# TYPE cxxnet_serve'))]
    assert '\n'.join(golden) + '\n' == GOLDEN_METRICS
    assert 'cxxnet_decode_free_pages 31' in texts[0]    # the refresh ran


def test_gauge_snapshot_keys_and_values_match_jax(hubs):
    thub, jhub = hubs
    for hub, cls in ((thub, StatSet), (jhub, JStatSet)):
        hub.register_stats('serve', _fill(cls(), 5))
        big = cls()
        for v in range(3000):
            big.observe('lat', float(v))
        hub.register_stats('kv', big, refresh=lambda b=big: b.gauge(
            'hit_rate', 0.25))
    a, b = thub.gauge_snapshot(), jhub.gauge_snapshot()
    assert sorted(a) == sorted(b)
    for k in a:
        if k != 'obs.uptime_s':
            assert a[k] == b[k], k
    assert a['kv.lat.n'] == 3000 and a['kv.lat.p50'] == b['kv.lat.p50']


def test_status_providers_degrade_not_kill(hubs):
    thub, _ = hubs
    thub.register_status('ok', lambda: {'x': 1})
    thub.register_status('broken', lambda: 1 / 0)
    st = thub.status()
    assert st['status']['ok'] == {'x': 1}
    assert 'error' in st['status']['broken']
    assert sorted(st) == sorted(jobs.TelemetryHub().status())


# --- spans --------------------------------------------------------------------

def _span_program(pkg):
    """One span sequence: nesting, an explicit and an inherited trace id,
    an error, events with explicit times, a decorated function."""
    with pkg.span('outer', 'test', trace_id='t-req', k=1):
        with pkg.span('inner', 'test'):
            pkg.record_event('leaf', 'test', n=3)
    with pkg.span('sibling', 'test'):
        pass
    with pytest.raises(ValueError):
        with pkg.span('boom', 'test'):
            raise ValueError('x')
    pkg.record_event('timed', 'io', t_start_ns=1000, dur_ns=5000, index=7)

    @pkg.span('decorated', 'test', k=2)
    def work():
        return 42

    assert work() == 42
    tid = pkg.next_trace_id()
    with pkg.span('with.id', 'serve', trace_id=tid):
        pass
    return tid


def _strip(events):
    """Chrome-trace events without their times, pids and thread ids."""
    out = []
    for e in events:
        e = dict(e)
        for key in ('ts', 'dur', 'pid', 'tid'):
            e.pop(key, None)
        if e.get('ph') == 'M':
            e['args'] = {}
        out.append(e)
    return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))


def test_spans_and_chrome_trace_match_jax(hubs, tmp_path):
    thub, jhub = hubs
    tids = (_span_program(tobs), _span_program(jobs))
    assert tids[0] == tids[1] == 't000001'
    evs = {e['name']: e for e in thub.events()}
    assert evs['inner']['trace_id'] == 't-req'
    assert evs['inner']['attrs']['parent'] == 'outer'
    assert evs['leaf']['trace_id'] is None     # events inherit nothing
    assert evs['sibling']['trace_id'] is None
    assert evs['boom']['attrs']['error'] == 'ValueError'
    traces = []
    for hub, name in ((thub, 't.json'), (jhub, 'j.json')):
        path = hub.export_chrome_trace(str(tmp_path / name))
        with open(path) as f:
            traces.append(json.load(f))
    assert traces[0]['displayTimeUnit'] == traces[1]['displayTimeUnit']
    assert _strip(traces[0]['traceEvents']) == \
        _strip(traces[1]['traceEvents'])
    timed = [e for e in traces[0]['traceEvents'] if e['name'] == 'timed']
    assert timed[0]['ts'] == 1.0 and timed[0]['dur'] == 5.0


def test_ring_bounded_disabled_and_decorator_flips(hubs):
    thub, _ = hubs
    thub.set_ring(64)
    for i in range(500):
        tobs.record_event('e', 'test', n=i)
    evs = thub.events()
    assert len(evs) <= 64 and evs[-1]['attrs']['n'] == 499
    thub.enabled = False

    @tobs.span('decorated', 'test')
    def work():
        return 1

    with tobs.span('off', 'test'):
        tobs.record_event('off2', 'test')
    work()
    thub.enabled = True
    work()
    names = [e['name'] for e in thub.events()]
    assert 'off' not in names and 'off2' not in names
    assert names.count('decorated') == 1


def test_per_thread_rings_merge(hubs):
    """Two threads record into rings of their own; the merged view holds
    both, oldest first."""
    thub, _ = hubs
    tid = thub.next_trace_id()
    go = threading.Barrier(2)

    def worker(tag):
        go.wait()
        for i in range(20):
            with tobs.span(f'{tag}.step', 'test', trace_id=tid, i=i):
                pass

    ts = [threading.Thread(target=worker, args=(t,)) for t in 'ab']
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    evs = [e for e in thub.events() if e['trace_id'] == tid]
    assert len(evs) == 40 and len({e['thread'] for e in evs}) == 2
    assert [e['t_start_ns'] for e in evs] == sorted(
        e['t_start_ns'] for e in evs)


# --- flight dumps ---------------------------------------------------------------

def _dump(hub, pkg_faults, root, kind):
    hub.arm_flight_recorder(str(root))
    with hub.span('train.dispatch', 'train', k=1, update=3):
        pass
    log = pkg_faults.FailureLog()
    log.record('io_retry', 'transient: no dump')
    assert not os.path.exists(root)
    log.record(kind, 'stalled', step=3)
    files = sorted(os.listdir(root))
    assert len(files) == 1 and kind in files[0]
    with open(os.path.join(root, files[0])) as f:
        return json.load(f)


@pytest.mark.parametrize('kind', ['PipelineStallError', 'SLOBreachError'])
def test_flight_dump_matches_jax(hubs, tmp_path, kind):
    """A training fault or an SLO breach reaching a failure log dumps the
    flight record: JAX's keys, the same events (times stripped), the
    failure log's records, the stat snapshots."""
    thub, jhub = hubs
    for hub, cls in ((thub, StatSet), (jhub, JStatSet)):
        hub.register_stats('probe', _fill(cls()))
    got = _dump(thub, faults, tmp_path / 't', kind)
    want = _dump(jhub, jfaults, tmp_path / 'j', kind)
    assert sorted(got) == sorted(want)
    assert got['reason'] == want['reason'] == kind
    assert [(e['name'], e['trace_id'], e['attrs']) for e in got['events']] \
        == [(e['name'], e['trace_id'], e['attrs']) for e in want['events']]
    assert [(r['kind'], r['detail'], r['step'])
            for r in got['failure_log']] == \
        [(r['kind'], r['detail'], r['step']) for r in want['failure_log']]
    assert got['stats'] == want['stats']
    assert kind in faults.training_fault_kinds() | faults.slo_breach_kinds()


def test_sigusr1_dumps_flight_record(hubs, tmp_path):
    thub, _ = hubs
    thub.configure_dump(str(tmp_path / 'flight'))
    if not thub.arm_signal_dump():
        pytest.skip('SIGUSR1 unavailable on this platform')
    tobs.record_event('before.signal', 'test')
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5
        while not os.path.exists(tmp_path / 'flight') \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        dumps = os.listdir(tmp_path / 'flight')
        assert len(dumps) == 1 and 'SIGUSR1' in dumps[0]
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)


# --- serve trace ids ------------------------------------------------------------

class _StubEngine:
    buckets = (4,)

    def predict_scores(self, data):
        return np.zeros((data.shape[0], 2), np.float32)


def test_request_trace_id_spans_batcher_threads(hubs):
    from cxxnet_tpu_torch.serve.batcher import DynamicBatcher
    thub, _ = hubs
    b = DynamicBatcher(_StubEngine(), max_queue=8, max_wait=0.001,
                       deadline=5.0)
    try:
        req = b.submit_async(np.zeros((1, 3), np.float32))
        b.wait(req)
    finally:
        b.close(timeout=5.0)
    mine = [e for e in thub.events() if e['trace_id'] == req.trace_id]
    assert {'serve.admit', 'serve.queue', 'serve.finish'} <= \
        {e['name'] for e in mine}
    assert len({e['thread'] for e in mine}) >= 2
    assert any(e['name'] == 'serve.forward' for e in thub.events())


def test_decode_request_lifecycle_matches_jax(hubs, tmp_path):
    """A decode request's trace id rides every event of its lifecycle in
    the exported trace, under JAX's names; the shared steps carry none."""
    from cxxnet_tpu.models import transformer as JT
    from cxxnet_tpu.serve.decode import DecodeService as JService
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.serve.decode import DecodeService
    names = []
    for hub, mod, svc_cls, extra in (
            (hubs[0], T, DecodeService, {'device': 'cpu'}),
            (hubs[1], JT, JService, {})):
        cfg = mod.TransformerConfig(vocab_size=64, d_model=32, num_heads=4,
                                    d_ff=48, num_stages=2, seq_len=32,
                                    attn='local')
        params = mod.init_params(np.random.RandomState(0), cfg)
        svc = svc_cls(params, cfg, slots=2, pages=32, page_size=8,
                      max_prompt=16, max_new_bound=8, deadline=60.0, **extra)
        try:
            req = svc.submit_async(np.arange(5, dtype=np.int32), max_new=4)
            svc.batcher.wait(req)
        finally:
            svc.close(30.0)
        path = hub.export_chrome_trace(str(tmp_path / f'{len(names)}.json'))
        with open(path) as f:
            trace = json.load(f)['traceEvents']
        mine = {e['name'] for e in trace if e.get('ph') == 'X'
                and e['args'].get('trace_id') == req.trace_id}
        steps = [e for e in trace if e['name'] == 'decode.step']
        assert steps and all('trace_id' not in e['args'] for e in steps)
        names.append(mine)
    assert {'serve.admit', 'serve.queue', 'decode.prefill', 'decode.emit',
            'decode.finish'} <= names[0]
    assert names[0] == names[1]


# --- endpoints ------------------------------------------------------------------

def test_endpoints_on_ephemeral_ports(hubs, tmp_path):
    from cxxnet_tpu_torch.obs.programs import get_ledger
    thub, _ = hubs
    s = StatSet()
    s.inc('tokens', 7)
    thub.register_stats('decode', s, refresh=lambda: s.gauge('free_pages',
                                                             31))
    thub.register_stats('bad', StatSet(), refresh=lambda: 1 / 0)
    thub.register_status('registry', lambda: {'current': 5})
    port_file = tmp_path / 'port'
    servers = [ObsServer(thub, port=0, port_file=str(port_file)),
               ObsServer(thub, port=0)]
    try:
        srv = servers[0]
        assert port_file.read_text().strip() == str(srv.port)
        assert servers[1].port != srv.port
        assert _get(f'{srv.url}/healthz') == b'ok\n'
        text = _get(f'{srv.url}/metrics').decode()
        assert 'cxxnet_decode_tokens 7' in text
        assert 'cxxnet_decode_free_pages 31' in text
        st = json.loads(_get(f'{srv.url}/statusz'))
        assert st['stats']['decode']['tokens'] == 7
        assert st['status']['registry']['current'] == 5
        assert json.loads(_get(f'{srv.url}/slos')) == {}
        progs = json.loads(_get(f'{srv.url}/programs'))
        assert sorted(progs) == sorted(get_ledger().view())
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f'{srv.url}/nope')
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f'{srv.url}/profile')          # no profile dir: no route
        assert e.value.code == 404
        thub.register_status('raises', lambda: 1 / 0)
        assert 'error' in json.loads(
            _get(f'{srv.url}/statusz'))['status']['raises']
    finally:
        for srv in servers:
            assert srv.close(timeout=10.0)
    assert not [t for t in threading.enumerate()
                if t.name.startswith('cxxnet-obs-')]


# --- the CLI --------------------------------------------------------------------

CLI_CONF = """
data = train
iter = mnist
  path_img = {root}/img.gz
  path_label = {root}/lbl.gz
  shuffle = 0
iter = end
eval = test
iter = mnist
  path_img = {root}/img.gz
  path_label = {root}/lbl.gz
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
metric[label] = error
num_round = 3
save_model = 0
"""


def _cli(tmp_path, monkeypatch, capsys, extra, scrape=None):
    """One in-process CLI run; ``scrape(port)`` runs inside the second
    train step, while the run is live.  Returns (stdout, stderr)."""
    from cxxnet_tpu_torch.main import main as tmain
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    if scrape is not None:
        port_file = tmp_path / 'obs.port'
        monkeypatch.setenv('CXXNET_OBS_PORT_FILE', str(port_file))
        orig = NetTrainer.update_staged
        seen = []

        def update_staged(self, staged):
            if self.sample_counter == 1:
                seen.append(scrape(int(port_file.read_text())))
            return orig(self, staged)

        monkeypatch.setattr(NetTrainer, 'update_staged', update_staged)
    capsys.readouterr()
    assert tmain([str(tmp_path / 'train.conf'), *extra]) == 0
    out, err = capsys.readouterr()
    if scrape is not None:
        monkeypatch.setattr(NetTrainer, 'update_staged', orig)
        monkeypatch.delenv('CXXNET_OBS_PORT_FILE')
        assert seen
        return out, err, seen[0]
    return out, err, None


def test_cli_obs_run_scrapes_live_and_keeps_eval_lines(hubs, tmp_path,
                                                        monkeypatch, capsys):
    from tests.test_io import write_mnist
    write_mnist(str(tmp_path), n=96, rows=8, cols=8, seed=4)
    (tmp_path / 'train.conf').write_text(CLI_CONF.format(root=tmp_path))
    monkeypatch.chdir(tmp_path)

    def scrape(port):
        base = f'http://127.0.0.1:{port}'
        return {'metrics': _get(f'{base}/metrics').decode(),
                'statusz': json.loads(_get(f'{base}/statusz')),
                'healthz': _get(f'{base}/healthz').decode(),
                'programs': json.loads(_get(f'{base}/programs'))}

    trace = tmp_path / 'trace.json'
    out, err, live = _cli(
        tmp_path, monkeypatch, capsys,
        ['obs.port=0', 'obs.sample_every=0.05',
         'slo.rate=train.steps_per_sec>0.001@30', f'obs.trace_export={trace}'],
        scrape=scrape)
    _, err_plain, _ = _cli(tmp_path, monkeypatch, capsys, [])
    evals = [ln for ln in err.splitlines() if ln.startswith('[')]
    assert len(evals) == 3
    assert evals == [ln for ln in err_plain.splitlines()
                     if ln.startswith('[')]
    # the train line rides its own stderr line, never the eval line
    speed = [ln for ln in err.splitlines() if ln.startswith('train-')]
    assert len(speed) == 3 and 'train-flops_per_step:' in speed[0]
    assert 'train-mfu' not in speed[0]          # no peak on the CPU
    assert 'obs: telemetry on http://127.0.0.1:' in out
    assert 'obs: slo rate:' in out
    assert 'cxxnet_programs_compiles_total' in live['metrics']
    assert 'cxxnet_hbm_supported 0' in live['metrics']
    assert live['healthz'] == 'ok\n'
    assert live['statusz']['status']['execution_plan']['k'] == 1
    assert [p['name'] for p in live['programs']['programs']
            ].count('train.step') == 1
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    steps = 96 // 16 * 3
    assert sum(e['name'] == 'train.dispatch' for e in events) == steps
    assert not [t for t in threading.enumerate()
                if t.name.startswith('cxxnet-obs-')]


# --- the JSON surface -------------------------------------------------------------

def test_wrapper_and_capi_obs_json_keys_match_jax(hubs):
    from cxxnet_tpu import capi as jcapi
    from cxxnet_tpu.wrapper import Net as JNet
    from cxxnet_tpu_torch import capi
    from cxxnet_tpu_torch.wrapper import Net
    from tests.test_torch_c_abi import TINY_CONF
    thub, jhub = hubs
    for hub, cls in ((thub, StatSet), (jhub, JStatSet)):
        hub.register_stats('serve', _fill(cls()))
    net, jnet = Net(dev='cpu', cfg=TINY_CONF), JNet(dev='cpu', cfg=TINY_CONF)
    for fn in ('net_obs_stats', 'net_obs_slos', 'net_obs_programs'):
        got = json.loads(getattr(capi, fn)(net))
        want = json.loads(getattr(jcapi, fn)(jnet))
        assert sorted(got) == sorted(want), fn
    stats = json.loads(net.obs_stats())
    assert stats['stats']['serve'] == json.loads(
        jnet.obs_stats())['stats']['serve']
