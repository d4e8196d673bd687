"""Declarative SLOs with multi-window burn-rate verdicts.

The port's own copy of ``cxxnet_tpu/obs/slo.py``.  The config grammar::

    slo.<name> = <set>.<key><op><threshold>@<window>[:burn]

    slo.step   = train.steps_per_sec>0.5@30
    slo.kv_hit = kv.hit_rate>=0.5@60:2

``<set>.<key>`` names a gauge exactly as sampled into the
:class:`~cxxnet_tpu.obs.history.GaugeHistory` (the ``/metrics``
spelling minus ``cxxnet_``); a trailing ``.rate``/``.mean``/``.min``/
``.max``/``.p50``/``.p99`` that does not name a sampled key itself is a
*window reduction* over the base gauge.  ``@<window>`` is the long
evaluation window in seconds; ``@0`` declares a *per-sample* spec fed
directly through :meth:`SLOEngine.observe` (every violating sample is
its own breach).

**Verdicts.**  Evaluation is the SRE multi-window burn-rate shape, the
standard fix for turning raw gauges into actionable alarms without
flapping: over the long window W and a short window W/12 compute the
*violating fraction* of samples (for reduced specs the reduction either
violates or not — fraction 1 or 0), and compare both against the alarm
fraction ``f = min(1, burn * budget)`` (budget defaults to 10% of the
window).  Typed verdict:

* ``BREACHED`` — both windows at or past ``f``: the violation is
  sustained *and* still happening,
* ``AT_RISK``  — exactly one window past ``f``: either a fresh spike
  the long window has not absorbed yet, or a recovering breach whose
  budget is still spent,
* ``OK``       — neither (including "no samples yet").

A transition *into* BREACHED records the typed
:class:`~cxxnet_tpu_torch.runtime.faults.SLOBreachError` kind into the
failure log — which arms the flight-recorder postmortem, so every
breach ships the window samples and verdict history that explain it —
and counts one breach; re-evaluating an ongoing breach does not flood
the log.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..runtime import faults
from ..utils.metric import StatSet
from .history import REDUCERS, GaugeHistory

__all__ = ['SLOSpec', 'SLOEngine', 'OK', 'AT_RISK', 'BREACHED',
           'summary_lines']

OK = 'OK'
AT_RISK = 'AT_RISK'
BREACHED = 'BREACHED'

_STATE_CODE = {OK: 0, AT_RISK: 1, BREACHED: 2}

_SPEC_RE = re.compile(
    r'^(?P<key>[A-Za-z_][\w.\[\]]*\.[\w.\[\]]+)\s*'
    r'(?P<op><=|>=|<|>)\s*'
    r'(?P<thr>[-+]?[0-9.]+(?:[eE][-+]?[0-9]+)?)'
    r'@(?P<win>[0-9.]+)'
    r'(?::(?P<burn>[0-9.]+))?$')

_OPS: Dict[str, Callable[[float, float], bool]] = {
    '<=': lambda v, t: v <= t,
    '>=': lambda v, t: v >= t,
    '<': lambda v, t: v < t,
    '>': lambda v, t: v > t,
}


@dataclass(frozen=True)
class SLOSpec:
    """One parsed objective (module docstring grammar)."""

    name: str
    key: str                 # '<set>.<gauge>' history spelling
    op: str                  # <=, >=, <, >
    threshold: float
    window: float            # long window seconds; 0 = per-sample
    burn: float = 1.0
    budget: float = 0.1      # violating fraction of a window = 1 burn
    kind: str = 'SLOBreachError'   # failure-log kind on breach

    @classmethod
    def parse(cls, name: str, text: str, **overrides) -> 'SLOSpec':
        m = _SPEC_RE.match(text.strip())
        if m is None:
            raise ValueError(
                f'slo.{name}: cannot parse {text!r} — expected '
                f'<set>.<key><op><threshold>@<window>[:burn]')
        burn = m.group('burn')
        return cls(name=name, key=m.group('key'), op=m.group('op'),
                   threshold=float(m.group('thr')),
                   window=float(m.group('win')),
                   burn=float(burn) if burn is not None else 1.0,
                   **overrides)

    def violates(self, value: float) -> bool:
        return not _OPS[self.op](float(value), self.threshold)

    def describe(self) -> str:
        tail = '' if self.burn == 1.0 else f':{self.burn:g}'
        return (f'{self.key}{self.op}{self.threshold:g}'
                f'@{self.window:g}{tail}')

    @property
    def alarm_fraction(self) -> float:
        return min(1.0, self.burn * self.budget)


def summary_lines(view: Dict[str, dict]) -> List[str]:
    """One human line per objective from a :meth:`SLOEngine.status_view`
    dict — the exit-summary spelling (the CLI's ``obs:`` lines)."""
    out = []
    for name, v in sorted(view.items()):
        tail = (' — NO DATA matched; check the key spelling against '
                '/metrics' if v.get('no_data') else '')
        out.append(f"slo {name}: {v['state']} (spec {v['spec']}, "
                   f"breaches={v['breaches']}){tail}")
    return out


class SLOEngine:
    """Evaluate :class:`SLOSpec` objectives into typed verdicts over a
    :class:`GaugeHistory` (windowed specs, driven per sampler tick) or
    directly observed samples (``window=0`` specs).
    Thread-safe; breach records land in the failure log OUTSIDE the
    engine lock, so a dump listener reading :meth:`status_view` can
    never deadlock against the evaluation that triggered it."""

    #: verdict records retained per spec
    KEEP_HISTORY = 64
    #: long-window samples retained in status/postmortem views
    KEEP_SAMPLES = 256
    #: short window = long window / SHORT_DIV (the SRE 1h/5m ratio)
    SHORT_DIV = 12.0

    def __init__(self, history: Optional[GaugeHistory] = None,
                 log: Optional[faults.FailureLog] = None):
        self.history = history
        self.log = faults.global_failure_log() if log is None else log
        self.stats = StatSet()
        self._lock = threading.Lock()
        self._specs: Dict[str, SLOSpec] = {}            # guarded-by: _lock
        self._factories: Dict[str, Callable] = {}       # guarded-by: _lock
        self._state: Dict[str, str] = {}                # guarded-by: _lock
        self._verdicts: Dict[str, collections.deque] = {}  # guarded-by: _lock
        self._samples: Dict[str, list] = {}             # guarded-by: _lock
        self._breaches: Dict[str, int] = {}             # guarded-by: _lock
        self._last_breach: Optional[BaseException] = None  # guarded-by: _lock
        self._hubs: List[object] = []                   # guarded-by: _lock

    # -- spec registry -------------------------------------------------------
    def add(self, spec: SLOSpec,
            err_factory: Optional[Callable] = None) -> SLOSpec:
        """Register one objective.  ``err_factory(spec, value, n, ctx)``
        (optional) builds the typed error a breach raises/logs; the
        default is :class:`faults.SLOBreachError`."""
        with self._lock:
            self._specs[spec.name] = spec
            if err_factory is not None:
                self._factories[spec.name] = err_factory
            self._state.setdefault(spec.name, OK)
            self._verdicts.setdefault(
                spec.name, collections.deque(maxlen=self.KEEP_HISTORY))
            self._breaches.setdefault(spec.name, 0)
        return spec

    def specs(self) -> Dict[str, SLOSpec]:
        with self._lock:
            return dict(self._specs)

    def state(self, name: str) -> str:
        with self._lock:
            return self._state.get(name, OK)

    def breached(self) -> bool:
        """Any objective currently BREACHED — what flips ``/healthz``
        to ``degraded``."""
        with self._lock:
            return any(s == BREACHED for s in self._state.values())

    def breaches(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is not None:
                return self._breaches.get(name, 0)
            return sum(self._breaches.values())

    @property
    def last_breach(self) -> Optional[BaseException]:
        with self._lock:
            return self._last_breach

    def check_strict(self) -> None:
        """Raise the most recent typed breach (run boundaries)."""
        with self._lock:
            err = self._last_breach
        if err is not None:
            raise err

    # -- evaluation ----------------------------------------------------------
    def _default_error(self, spec: SLOSpec, value, n: int,
                       ratio=None) -> faults.SLOBreachError:
        shown = 'n/a' if value is None else f'{value:g}'
        return faults.SLOBreachError(
            f'SLO {spec.name!r} breached: {spec.describe()} — measured '
            f'{shown} over the window ({n} breach(es) total)',
            name=spec.name, measure=value, threshold=spec.threshold,
            window=spec.window, ratio=ratio, breaches=n)

    def _measure(self, spec: SLOSpec, now: float):
        """``(ratio_long, ratio_short, value, samples)`` for one
        windowed spec, or None when no data is in reach.  A key that
        names sampled points directly gets violating-fraction ratios;
        a ``.rate``/quantile suffix over a sampled base key reduces
        each window to one value (ratio 1 or 0)."""
        hist = self.history
        if hist is None:
            return None
        short = max(spec.window / self.SHORT_DIV, 1e-9)
        long_pts = hist.window(spec.key, spec.window, now)
        if long_pts:
            short_pts = hist.window(spec.key, short, now) or long_pts[-1:]

            def frac(pts):
                bad = sum(1 for _t, v in pts if spec.violates(v))
                return bad / len(pts)

            return (frac(long_pts), frac(short_pts), long_pts[-1][1],
                    long_pts)
        base, _, red = spec.key.rpartition('.')
        if red in REDUCERS and hist.has(base):
            vl = hist.reduce(base, red, spec.window, now)
            vs = hist.reduce(base, red, short, now)
            if vl is None and vs is None:
                return None
            rl = 1.0 if vl is not None and spec.violates(vl) else 0.0
            rs = 1.0 if vs is not None and spec.violates(vs) else 0.0
            return (rl, rs, vl if vl is not None else vs,
                    hist.window(base, spec.window, now))
        return None

    def on_tick(self, now: float, history=None) -> None:
        """Sampler listener form of :meth:`evaluate`."""
        self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Evaluate every windowed spec at ``now``; returns the fresh
        verdict records keyed by spec name (per-sample specs keep their
        latest observed verdict)."""
        now = time.monotonic() if now is None else float(now)
        events: List[tuple] = []
        out: Dict[str, dict] = {}
        with self._lock:
            specs = [s for s in self._specs.values() if s.window > 0]
        for spec in specs:
            m = self._measure(spec, now)
            if m is None:
                state, rl, rs, value, samples = OK, None, None, None, []
            else:
                rl, rs, value, samples = m
                f = spec.alarm_fraction
                hot_long, hot_short = rl >= f, rs >= f
                state = (BREACHED if hot_long and hot_short
                         else AT_RISK if hot_long or hot_short else OK)
            # no_data is surfaced on /slos, /metrics, and the exit
            # summary: a spec whose key never matches a sampled gauge
            # (typo, gauge never registered) must read as "watching
            # nothing", not as a reassuring OK
            rec = {'t': now, 'state': state, 'ratio_long': rl,
                   'ratio_short': rs, 'value': value,
                   'samples_n': len(samples), 'no_data': m is None}
            with self._lock:
                prev = self._state.get(spec.name, OK)
                self._state[spec.name] = state
                self._verdicts[spec.name].append(rec)
                self._samples[spec.name] = [
                    [t, v] for t, v in samples[-self.KEEP_SAMPLES:]]
                if state == BREACHED and prev != BREACHED:
                    self._breaches[spec.name] += 1
                    n = self._breaches[spec.name]
                    factory = self._factories.get(spec.name)
                    err = (factory(spec, value, n, {}) if factory
                           else self._default_error(spec, value, n,
                                                    ratio=rl))
                    self._last_breach = err
                    events.append((spec.kind, err))
            out[spec.name] = rec
        # failure-log records fire listeners (flight-recorder dumps that
        # read status_view) — never while holding the engine lock
        for kind, err in events:
            self.log.record(kind, str(err))
        return out

    def observe(self, name: str, value: float, **ctx) -> str:
        """Feed one sample directly to a ``window=0`` spec (the
        per-sample path: every violating sample is its own breach,
        evaluated the moment it is measured).  Returns the verdict
        state for this sample."""
        now = time.monotonic()
        event = None
        with self._lock:
            spec = self._specs[name]
            viol = spec.violates(value)
            state = BREACHED if viol else OK
            self._state[name] = state
            self._verdicts[name].append(
                {'t': now, 'state': state, 'ratio_long': 1.0 if viol
                 else 0.0, 'ratio_short': 1.0 if viol else 0.0,
                 'value': float(value), 'samples_n': 1})
            samples = self._samples.setdefault(name, [])
            samples.append([now, float(value)])
            del samples[:max(0, len(samples) - self.KEEP_SAMPLES)]
            if viol:
                self._breaches[name] += 1
                n = self._breaches[name]
                factory = self._factories.get(name)
                err = (factory(spec, value, n, ctx) if factory
                       else self._default_error(spec, value, n))
                self._last_breach = err
                event = (spec.kind, err, ctx.get('step'))
        if event is not None:
            kind, err, step = event
            self.log.record(kind, str(err), step=step)
        return state

    # -- views / hub integration --------------------------------------------
    def status_view(self) -> dict:
        """The ``/slos`` body (and the flight-dump ``slos`` section):
        per spec — the grammar line, current state, breach count, the
        long window's samples at last evaluation, and the verdict
        history.  Strictly JSON-able (None, never NaN)."""
        with self._lock:
            out = {}
            for name, spec in self._specs.items():
                hist = list(self._verdicts.get(name, ()))
                last = hist[-1] if hist else None
                out[name] = {
                    'spec': spec.describe(),
                    'state': self._state.get(name, OK),
                    'breaches': self._breaches.get(name, 0),
                    'ratio_long': last['ratio_long'] if last else None,
                    'ratio_short': last['ratio_short'] if last else None,
                    'value': last['value'] if last else None,
                    'no_data': (bool(last.get('no_data')) if last
                                else spec.window > 0),
                    'window_samples': list(self._samples.get(name, ())),
                    'history': hist,
                }
            return out

    def _refresh_gauges(self) -> None:
        """Pull-style verdict/ratio rows for ``/metrics`` renders:
        ``cxxnet_slo_verdict{tag="<name>"}`` (0 OK / 1 AT_RISK /
        2 BREACHED), the window ratios, and the breach counters."""
        with self._lock:
            rows = [(name, self._state.get(name, OK),
                     (list(self._verdicts[name]) or [None])[-1],
                     self._breaches.get(name, 0))
                    for name in self._specs]
        for name, state, last, n in rows:
            self.stats.gauge(f'verdict[{name}]', _STATE_CODE[state])
            self.stats.gauge(f'breaches[{name}]', n)
            if last is not None:
                self.stats.gauge(f'no_data[{name}]',
                                 1 if last.get('no_data') else 0)
                if last.get('ratio_long') is not None:
                    self.stats.gauge(f'ratio_long[{name}]',
                                     last['ratio_long'])
                if last.get('ratio_short') is not None:
                    self.stats.gauge(f'ratio_short[{name}]',
                                     last['ratio_short'])

    def register_into(self, hub, name: str = 'slo') -> None:
        """Join a telemetry hub: verdict/ratio gauges under ``name`` on
        ``/metrics``, the status view on ``/statusz``, and the engine
        on the hub's SLO roster (``/slos`` + ``/healthz`` degradation +
        postmortem ``slos`` section)."""
        hub.register_stats(name, self.stats, refresh=self._refresh_gauges)
        hub.register_status(name, self.status_view)
        hub.attach_slo(self)
        with self._lock:
            if (hub, name) not in self._hubs:
                self._hubs.append((hub, name))

    def unregister_from(self, hub, name: str = 'slo') -> None:
        hub.unregister_stats(name)
        hub.unregister_status(name)
        hub.detach_slo(self)
        with self._lock:
            try:
                self._hubs.remove((hub, name))
            except ValueError:
                pass

    def close(self) -> None:
        """Detach from every hub this engine registered into."""
        with self._lock:
            hubs = list(self._hubs)
        for hub, name in hubs:
            self.unregister_from(hub, name)
