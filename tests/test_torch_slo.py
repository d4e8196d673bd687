"""The gauge history and the SLO engine of ``cxxnet_tpu_torch``
(``obs/history.py``, ``obs/slo.py``) against the JAX package's, on the
CPU.

* ``SLOSpec.parse`` over JAX's grammar cases gives the same fields, the
  same ``describe()`` and the same violations; the malformed cases of
  ``tests/test_slo.py`` raise in both, and the CLI's ``slo.`` keys (``@0``
  refused) and ``obs.recompile`` values are validated at parse in both.
* ``GaugeHistory`` windows and the ``rate`` / ``mean`` / ``min`` /
  ``max`` / ``p50`` / ``p99`` reductions over the same seeded timed
  samples within 1e-12 (they are the same float64 arithmetic).
* One ``SLOEngine`` per package fed the same timed samples: the verdict
  of every spec at **every tick** equal, ``status_view`` equal, the
  breach records alike; the per-sample ``observe`` path alike.
* The hub wiring: the verdict rows on ``/metrics``, ``/slos``,
  ``/healthz`` flipping to ``degraded`` while a spec is BREACHED, a
  sampler driven through a real ``slow_step`` drill breaching an SLO
  with exactly one flight dump carrying the window and the verdicts.
"""

import json
import os
import time

import numpy as np
import pytest

from cxxnet_tpu.obs import history as jhistory
from cxxnet_tpu.obs import slo as jslo
from cxxnet_tpu.runtime import faults as jfaults
from cxxnet_tpu_torch.obs import TelemetryHub, install_hub
from cxxnet_tpu_torch.obs import history, slo
from cxxnet_tpu_torch.obs.endpoints import ObsServer
from cxxnet_tpu_torch.runtime import faults
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

GRAMMAR = [
    ('fresh', 'online.freshness_s.p99<=0.25@60'),
    ('floor', 'fleet.elastic_steps.max.rate>=2@30:2.5'),
    ('d', 'serve.queue_depth<32@5'),
    ('t', 'a.b>1e-3@0.5'),
    ('k', 'a.b<=5@1'),
    ('tag', 'serve.latency_ms[b8].p50 <= 12.5@2:4'),
    ('neg', 'x.y>=-3.5E+2@10'),
    ('kv_hit', 'kv.hit_rate>=0.5@60'),
    ('per', 'probe.v<=1@0'),
]

MALFORMED = ['nodots<=1@5', 'a.b!=1@5', 'a.b<=1', 'a.b<=@5', 'a.b<=1@5:']


@pytest.fixture
def hub():
    h = TelemetryHub(ring_events=256)
    prev = install_hub(h)
    yield h
    h.disarm()
    install_hub(prev)


def _get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


# --- the grammar ---------------------------------------------------------------

@pytest.mark.parametrize('name,text', GRAMMAR)
def test_spec_grammar_matches_jax(name, text):
    got, want = slo.SLOSpec.parse(name, text), jslo.SLOSpec.parse(name, text)
    fields = ('name', 'key', 'op', 'threshold', 'window', 'burn', 'budget',
              'kind')
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert got.describe() == want.describe()
    assert got.alarm_fraction == want.alarm_fraction
    for v in (-400.0, 0.0, 1e-3, 0.25, 1.0, 5.0, 12.5, 32.0, 1e9):
        assert got.violates(v) == want.violates(v)


@pytest.mark.parametrize('bad', MALFORMED)
def test_spec_grammar_rejects_malformed_in_both(bad):
    for mod in (slo, jslo):
        with pytest.raises(ValueError, match='slo.x'):
            mod.SLOSpec.parse('x', bad)


@pytest.mark.parametrize('name,val,match', [
    ('slo.dead', 'online.freshness_s<=0.5@0', 'window > 0'),
    ('slo.bad', 'not-a-spec', 'cannot parse'),
    ('obs.recompile', 'loud', 'warn|raise|off'),
    ('obs.no_such_key', '1', 'unknown telemetry key')])
def test_cli_validates_at_parse_as_jax(name, val, match):
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask
    # JAX passes an unknown obs. key on unread; the port refuses it
    for cls in ((LearnTask,) if name == 'obs.no_such_key'
                else (LearnTask, JTask)):
        task = cls()
        task.set_param('slo.ok_spec', 'serve.queue_depth<=32@5')
        assert task.slo_specs == [('ok_spec', 'serve.queue_depth<=32@5')]
        with pytest.raises(ValueError, match=match):
            task.set_param(name, val)


# --- the history ---------------------------------------------------------------

def _timed_samples(seed, n=400):
    rng = np.random.RandomState(seed)
    t = 1000.0 + np.cumsum(rng.uniform(0.01, 0.2, n))
    return [(float(ti), {'a.v': float(rng.lognormal(0, 1)),
                         'a.c': float(i * 3 + rng.randint(0, 3)),
                         'b.x[t1]': float(rng.randn())})
            for i, ti in enumerate(t)]


def test_history_reductions_match_jax():
    got, want = history.GaugeHistory(128), jhistory.GaugeHistory(128)
    samples = _timed_samples(3)
    for t, vals in samples:
        got.record(t, vals)
        want.record(t, vals)
    assert got.keys() == want.keys()
    t_end = samples[-1][0]
    for key in ('a.v', 'a.c', 'b.x[t1]', 'nope'):
        for seconds in (0.0, 0.3, 2.0, 7.5, 1e4):
            for now in (None, t_end, t_end - 3.0):
                assert got.window(key, seconds, now) == \
                    want.window(key, seconds, now)
                for red in history.REDUCERS:
                    a = got.reduce(key, red, seconds, now)
                    b = want.reduce(key, red, seconds, now)
                    assert (a is None) == (b is None), (key, red)
                    if a is not None:
                        assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
    assert history.REDUCERS == jhistory.REDUCERS
    with pytest.raises(ValueError):
        got.reduce('a.v', 'p42', 1.0)


def test_sampler_ticks_listeners_and_broken_source():
    calls = []
    vals = iter(range(100))
    s = history.GaugeSampler(lambda: {'x.n': float(next(vals))},
                             period=0.05)
    s.add_listener(lambda now, h: calls.append(now))
    s.tick(10.0)
    s.tick(10.5)
    assert s.maybe_tick(11.0) and not s.maybe_tick(11.01)
    assert calls == [10.0, 10.5, 11.0]
    assert s.history.reduce('x.n', 'rate', 5.0) == 2.0 / 1.0
    s.add_listener(lambda now, h: 1 / 0)
    s.tick(12.0)
    assert s.stats() == (4, 1)
    s.start()
    time.sleep(0.2)
    assert s.close(timeout=5.0)
    bad = history.GaugeSampler(lambda: 1 / 0, period=0.05)
    bad.tick(1.0)
    assert bad.stats() == (0, 1)


# --- the engine ----------------------------------------------------------------

SPECS = [('obj', 'probe.err<=5@12:10'), ('spike', 'probe.err<=5@60'),
         ('rate', 'train.steps.rate>=5@6'), ('p99', 'probe.lat.p99<=40@3'),
         ('ghost', 'ghost.gauge<=1@5')]


def _drive(mod, fmod):
    """One engine over a deterministic timed sample stream: a quiet
    stretch, a blip, a sustained violation, a recovery, a counter that
    ramps then stalls.  Returns the verdicts of every tick, the final
    status view and the breach records."""
    hist = mod.history.GaugeHistory()
    log = fmod.FailureLog()
    eng = mod.slo.SLOEngine(hist, log=log)
    for name, text in SPECS:
        eng.add(mod.slo.SLOSpec.parse(name, text))
    rng = np.random.RandomState(11)
    ticks = []
    t = 1000.0
    for i in range(260):
        t += 0.25
        err = 1.0
        if i in (40, 41) or 120 <= i < 190:
            err = 9.0
        steps = float(min(i, 150)) * 2.0
        vals = {'probe.err': err, 'train.steps': steps}
        hist.record(t, vals)
        hist.record(t, {'probe.lat': float(rng.lognormal(3.0, 0.6))})
        ticks.append(eng.evaluate(t))
    return (ticks, eng.status_view(),
            [(r.kind, r.detail, r.step) for r in log.records()],
            {n: eng.breaches(n) for n, _ in SPECS})


class _Pkg:
    def __init__(self, history_mod, slo_mod):
        self.history, self.slo = history_mod, slo_mod


def test_verdict_sequences_match_jax_at_every_tick():
    got = _drive(_Pkg(history, slo), faults)
    want = _drive(_Pkg(jhistory, jslo), jfaults)
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert a == b, i
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    states = {n: {tick[n]['state'] for tick in got[0]} for n, _ in SPECS}
    assert states['obj'] >= {slo.OK, slo.AT_RISK, slo.BREACHED}
    assert slo.BREACHED in states['rate']
    assert got[1]['ghost']['no_data'] is True
    assert got[3]['obj'] == 1                  # an ongoing breach counts once


def test_per_sample_observe_matches_jax():
    out = []
    for mod, fmod in ((slo, faults), (jslo, jfaults)):
        log = fmod.FailureLog()
        eng = mod.SLOEngine(log=log)
        eng.add(mod.SLOSpec.parse('cap', 'probe.v<=1@0'))
        states = [eng.observe('cap', v, step=i)
                  for i, v in enumerate((0.5, 2.0, 3.0, 0.1))]
        view = eng.status_view()['cap']
        for h in view['history']:
            h.pop('t')
        view['window_samples'] = [v for _t, v in view['window_samples']]
        out.append((states, eng.breaches('cap'), view,
                    [(r.kind, r.step) for r in log.records()]))
    assert out[0] == out[1]
    assert out[0][0] == [slo.OK, slo.BREACHED, slo.BREACHED, slo.OK]


def test_summary_lines_match_jax():
    views = []
    for mod in (_Pkg(history, slo), _Pkg(jhistory, jslo)):
        views.append(_drive(mod, faults if mod.slo is slo else jfaults)[1])
    assert slo.summary_lines(views[0]) == jslo.summary_lines(views[1])
    assert any('NO DATA' in ln for ln in slo.summary_lines(views[0]))


# --- the hub wiring --------------------------------------------------------------

def test_register_into_hub_verdict_rows_slos_and_healthz(hub):
    eng = slo.SLOEngine(log=faults.FailureLog())
    eng.add(slo.SLOSpec.parse('cap', 'probe.v<=1@0'))
    eng.register_into(hub)
    srv = ObsServer(hub, port=0)
    try:
        assert _get(f'{srv.url}/healthz') == b'ok\n'
        eng.observe('cap', 5.0)
        text = hub.metrics_text()
        assert 'cxxnet_slo_verdict{tag="cap"} 2' in text
        assert 'cxxnet_slo_breaches{tag="cap"} 1' in text
        assert _get(f'{srv.url}/healthz') == b'degraded\n'   # still 200
        slos = json.loads(_get(f'{srv.url}/slos'))
        assert slos['cap']['state'] == slo.BREACHED
        assert hub.status()['status']['slo']['cap']['breaches'] == 1
        eng.observe('cap', 0.5)
        assert _get(f'{srv.url}/healthz') == b'ok\n'
    finally:
        eng.close()
        assert srv.close(timeout=10.0)
    assert hub.slos_view() == {} and hub.slo_engines() == []


def test_slow_step_drill_breaches_with_one_postmortem(hub, tmp_path):
    """A FaultPlan ``slow_step`` on the decode loop stretches the token
    gaps; the sampled SLO over ``decode.token_ms.p99`` goes BREACHED and
    the armed flight recorder writes exactly one dump holding the
    breaching window and the verdicts.  The streams stay their offline
    ``generate`` twins, and the ``kv`` StatSet's hit-rate spec
    evaluates (not NO DATA)."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.serve.decode import DecodeService
    hub.arm_flight_recorder(str(tmp_path / 'flight'))
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, num_heads=4,
                              d_ff=48, num_stages=2, seq_len=32,
                              attn='local')
    params = T.init_params(np.random.RandomState(0), cfg)
    svc = DecodeService(params, cfg, slots=2, pages=64, page_size=4,
                        max_prompt=16, max_new_bound=8, deadline=60.0,
                        prefix_share=8, kv_host_mb=1, device='cpu')
    svc.register_into(hub)
    sampler = history.GaugeSampler(hub.gauge_snapshot, period=0.05)
    eng = slo.SLOEngine(sampler.history)
    eng.add(slo.SLOSpec.parse('tok', 'decode.token_ms.p99<=150@1'))
    eng.add(slo.SLOSpec.parse('kv_hit', 'kv.hit_rate>=0@1'))
    eng.register_into(hub)
    sampler.add_listener(eng.on_tick)
    plan = faults.FaultPlan(slow_step=((3, 0.6),))
    prev = faults.install_plan(plan)
    prompt = np.arange(1, 10, dtype=np.int32)
    try:
        reqs = [svc.submit_async(prompt, max_new=8) for _ in range(2)]
        for r in reqs:
            svc.batcher.wait(r)
        t0 = time.monotonic()
        for i in range(16):
            sampler.tick(t0 + 0.1 * i)
    finally:
        faults.install_plan(prev)
        svc.close(30.0)
        eng.close()
    assert plan.fired() == ['slow_step=3:0.6']
    want = T.generate(svc.engine.params, prompt[None], 8, svc.engine.cfg)[0]
    for r in reqs:
        np.testing.assert_array_equal(r.result, want[:len(r.result)])
    assert eng.state('tok') == slo.BREACHED
    assert eng.state('kv_hit') == slo.OK
    assert eng.status_view()['kv_hit']['no_data'] is False
    dumps = sorted(os.listdir(tmp_path / 'flight'))
    assert len(dumps) == 1 and 'SLOBreachError' in dumps[0], dumps
    with open(tmp_path / 'flight' / dumps[0]) as f:
        d = json.load(f)
    view = d['slos']['tok']
    assert view['state'] == slo.BREACHED
    assert max(v for _t, v in view['window_samples']) > 150
    assert any(e['name'] == 'decode.step' for e in d['events'])
