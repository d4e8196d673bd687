"""The telemetry hub.

The port's own copy of ``cxxnet_tpu/obs/hub.py`` (plain Python and
numpy).  ``StatSet`` gauges, the subsystems' ``report()`` lines, the
``FailureLog`` and the ``torch.profiler`` ``TraceWindow`` meet here, so
a running process can say what it is doing now and what happened in the
seconds before a fault:

* **TelemetryHub** — a process-wide registry that owns every live
  ``utils.metric.StatSet`` (io chain, batcher, decode engine, KV tiers,
  registry/fleet, program ledger, device memory) plus JSON *status
  providers* (registry state machines, execution-plan choice).
  One hub per process; subsystems register as they come up and the
  ``/metrics`` + ``/statusz`` endpoints (obs/endpoints.py) render from
  it live.
* **Flight recorder** — an always-on, bounded ring of structured span
  events ``(name, subsystem, trace_id, t_start_ns, dur_ns, thread,
  attrs)`` stamped with ``time.monotonic_ns()``.  Recording is
  lock-cheap: each thread appends to its own bounded deque (the GIL
  makes the append atomic); the hub's lock is taken once per thread
  lifetime plus at read time.  :meth:`TelemetryHub.dump` writes the
  merged ring + failure log + stat snapshots as one JSON postmortem —
  armed via :meth:`arm_flight_recorder`, it fires automatically when a
  ``TrainingFault`` (or supervisor give-up) reaches a ``FailureLog``,
  and :meth:`arm_signal_dump` adds ``SIGUSR1`` for live processes.
* **Spans** — :meth:`span` is a context manager (and decorator):
  ``with span('decode.prefill', 'decode', trace_id=req.trace_id): ...``
  Spans nest; a child with no explicit ``trace_id`` inherits the
  innermost enclosing span's on the same thread, and request ids thread
  across threads explicitly (``ServeRequest.trace_id``).  Spans take
  the context-manager (or decorator) form only; a span body is host
  code, and times only what the host does between enter and exit (a
  CUDA launch returns before its kernel ran).
* **Chrome trace export** — :meth:`export_chrome_trace` writes the ring
  as Chrome trace-event JSON that loads in Perfetto next to a
  ``torch.profiler`` trace.  Unlike ``profile_dir`` it composes with
  ``steps_per_dispatch``: spans bracket *dispatches*, not steps, so the
  window's demotion matrix is untouched.

:func:`format_report` is the ONE eval-line formatter every subsystem
``report()`` delegates to, so key spelling cannot drift between the
batcher, decode engine, registries and io chain.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ['TelemetryHub', 'get_hub', 'install_hub', 'span',
           'record_event', 'next_trace_id', 'format_report',
           'format_report_parts']


# --- the one eval-line formatter -------------------------------------------

def format_report(prefix: str, stats) -> str:
    """Render a ``utils.metric.StatSet`` snapshot in the canonical
    eval-line format (``\\tprefix-key:value``; distributions expand to
    ``.p50/.p99/.mean/.n``).  Every subsystem ``report()`` — batcher,
    decode engine, registry, fleet, io — formats through
    this one function, so the key spelling the autoscaler and the tests
    read cannot drift between subsystems."""
    counters, samples = stats.snapshot()
    return format_report_parts(prefix, counters, samples)


def format_report_parts(prefix: str, counters: dict, samples: dict) -> str:
    """The renderer behind :func:`format_report`, over already-snapshot
    state — the atomic drain path (``StatSet.print_and_clear``) feeds
    it the swapped-out epoch directly."""
    out = []
    for key in sorted(counters):
        out.append(f'\t{prefix}-{key}:{counters[key]:g}')
    for key in sorted(samples):
        arr = np.asarray(samples[key])
        out.append(f'\t{prefix}-{key}.p50:{np.quantile(arr, 0.5):g}')
        out.append(f'\t{prefix}-{key}.p99:{np.quantile(arr, 0.99):g}')
        out.append(f'\t{prefix}-{key}.mean:{arr.mean():g}')
        out.append(f'\t{prefix}-{key}.n:{arr.size:g}')
    return ''.join(out)


# --- spans ------------------------------------------------------------------

class _Span:
    """One live span (context-manager form).  ``attrs`` may be mutated
    inside the ``with`` block; the record is written at exit (errors
    stamp ``attrs['error']`` with the exception type).  A disabled hub
    is honored at ENTER time, so the decorator form — which re-enters a
    fresh span per call — respects ``hub.enabled`` flips either way."""

    __slots__ = ('_hub', 'name', 'subsystem', 'trace_id', 'attrs', '_t0',
                 '_off')

    def __init__(self, hub: 'TelemetryHub', name: str, subsystem: str,
                 trace_id: Optional[str], attrs: dict):
        self._hub = hub
        self.name = name
        self.subsystem = subsystem
        self.trace_id = trace_id
        self.attrs = attrs
        self._t0 = 0
        self._off = False

    def __enter__(self):
        h = self._hub
        if not h.enabled:
            self._off = True
            return self
        stack = h._span_stack()
        if self.trace_id is None and stack:
            self.trace_id = stack[-1][0]     # inherit the enclosing span's
        stack.append((self.trace_id, self.name))
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, et, ev, tb):
        if self._off:
            return False
        dur = time.monotonic_ns() - self._t0
        h = self._hub
        stack = h._span_stack()
        if stack:
            stack.pop()
        if et is not None:
            self.attrs['error'] = et.__name__
        if len(stack) >= 1:
            self.attrs.setdefault('parent', stack[-1][1])
        h._record(self.name, self.subsystem, self.trace_id, self._t0, dur,
                  self.attrs)
        return False

    def __call__(self, fn):
        """Decorator form: each call runs under a FRESH span (with the
        enabled check re-evaluated at call time, not decoration time)."""
        import functools
        hub, name, subsystem = self._hub, self.name, self.subsystem
        trace_id, attrs = self.trace_id, self.attrs

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Span(hub, name, subsystem, trace_id, dict(attrs)):
                return fn(*args, **kwargs)
        return wrapped


# --- the hub ---------------------------------------------------------------

class TelemetryHub:
    """Process-wide telemetry registry + flight recorder (module
    docstring).  Thread-safe throughout; recording is per-thread
    lock-free (bounded deques), the hub lock guards only the
    registries and the read/merge/dump paths."""

    #: default flight-recorder ring size (events retained, newest win)
    DEFAULT_RING = 4096
    #: per-process flight dumps retained on disk (oldest pruned)
    DEFAULT_KEEP = 8

    def __init__(self, ring_events: int = DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring = max(16, int(ring_events))
        self.enabled = True            # bench A/B switch; True in prod
        self._tls = threading.local()
        # (thread, deque) per recording thread; dead threads' events are
        # folded into _retired so a dump still sees their tail
        self._bufs: List[Tuple[threading.Thread,
                               collections.deque]] = []   # guarded-by: _lock
        self._retired: collections.deque = collections.deque(
            maxlen=self._ring)                            # guarded-by: _lock
        # bumped by set_ring (under _lock); READ lock-free on the
        # record hot path — a GIL-atomic int compare, worst case one
        # record lands in a pre-resize buffer the merge still sees
        self._gen = 0
        self._stats: Dict[str, Tuple[object, Optional[Callable]]] = {}
        self._status: Dict[str, Callable[[], object]] = {}
        self._trace_n = 0              # guarded-by: _lock
        # events_n is bumped LOCK-FREE on the record hot path: it is a
        # telemetry tally (the ring is the source of truth), and under
        # the GIL a rare lost increment costs a count, never a tear
        self._events_n = 0
        self._t0_ns = time.monotonic_ns()
        # flight-recorder dump state
        self._dump_dir: Optional[str] = None
        self._dump_keep = self.DEFAULT_KEEP
        self._dump_seq = 0             # guarded-by: _lock
        self.dumps: List[str] = []     # guarded-by: _lock
        self._listener = None
        # SLO engines (obs/slo.py) attached via attach_slo: what /slos
        # merges, /healthz degrades on, and a postmortem dump includes
        self._slo_engines: List[object] = []   # guarded-by: _lock

    # -- StatSet / status registries ---------------------------------------
    def register_stats(self, name: str, stats,
                       refresh: Optional[Callable[[], object]] = None):
        """Register a live ``StatSet`` under ``name`` (idempotent: the
        same object re-registers as a no-op; a different object under
        the same name replaces it — subsystems restart).  ``refresh``
        (optional) runs before each render so pull-style gauges
        (registry swap stamps, the program ledger, device memory) are
        current."""
        with self._lock:
            self._stats[name] = (stats, refresh)
        return stats

    def unregister_stats(self, name: str) -> None:
        with self._lock:
            self._stats.pop(name, None)

    def stat_sets(self) -> Dict[str, object]:
        with self._lock:
            return {k: v[0] for k, v in self._stats.items()}

    def attach_slo(self, engine) -> None:
        """Put an SLO engine (obs/slo.py) on the hub's roster: its
        verdicts merge into ``/slos`` and :meth:`slos_view`, a BREACHED
        objective flips :meth:`health` to ``degraded``, and every
        flight dump carries its window samples + verdict history."""
        with self._lock:
            if engine not in self._slo_engines:
                self._slo_engines.append(engine)

    def detach_slo(self, engine) -> None:
        with self._lock:
            try:
                self._slo_engines.remove(engine)
            except ValueError:
                pass

    def slo_engines(self) -> List[object]:
        with self._lock:
            return list(self._slo_engines)

    def slos_view(self) -> dict:
        """Every attached engine's verdicts merged into one dict (the
        ``/slos`` body); empty when no engine is attached."""
        out: Dict[str, object] = {}
        for eng in self.slo_engines():
            try:
                out.update(eng.status_view())
            # a broken engine view must degrade its own entries, never the endpoint or a postmortem dump
            except Exception as e:
                out[f'error:{type(eng).__name__}'] = repr(e)
        return out

    def health(self) -> str:
        """``'ok'``, or ``'degraded'`` while any attached SLO engine
        holds a BREACHED objective.  Both answer HTTP 200 — ``/healthz``
        stays a *liveness* probe (a degraded process is alive and still
        serving); readiness-style consumers read the body or ``/slos``."""
        for eng in self.slo_engines():
            try:
                if eng.breached():
                    return 'degraded'
            # health must fail open (alive) when a verdict read breaks, never take the endpoint down
            except Exception:
                continue
        return 'ok'

    def register_status(self, name: str, provider: Callable[[], object]):
        """Register a ``/statusz`` JSON provider (a zero-arg callable
        returning something JSON-able); same name replaces."""
        with self._lock:
            self._status[name] = provider
        return provider

    def unregister_status(self, name: str) -> None:
        with self._lock:
            self._status.pop(name, None)

    # -- trace ids / span recording ----------------------------------------
    def next_trace_id(self) -> str:
        with self._lock:
            self._trace_n += 1
            return f't{self._trace_n:06d}'

    def _span_stack(self) -> list:
        stack = getattr(self._tls, 'stack', None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_trace_id(self) -> Optional[str]:
        stack = self._span_stack()
        return stack[-1][0] if stack else None

    def _buf(self) -> collections.deque:
        buf = getattr(self._tls, 'buf', None)
        gen = self._gen
        if buf is None or getattr(self._tls, 'gen', -1) != gen:
            buf = self._tls.buf = collections.deque(maxlen=self._ring)
            self._tls.gen = gen
            self._tls.tname = threading.current_thread().name
            with self._lock:
                self._bufs.append((threading.current_thread(), buf))
                if len(self._bufs) > 64:
                    self._prune_bufs_locked()
        return buf

    def _prune_bufs_locked(self) -> None:  # requires-lock: _lock
        live = []
        for t, buf in self._bufs:
            if t.is_alive():
                live.append((t, buf))
            else:
                self._retired.extend(buf)
        self._bufs = live

    def span(self, name: str, subsystem: str = 'app',
             trace_id: Optional[str] = None, **attrs):
        """A context-manager span (also usable as a decorator).  With no
        ``trace_id`` it inherits the innermost enclosing span's on this
        thread (cross-thread propagation is explicit —
        ``ServeRequest.trace_id``).  ``enabled`` is honored at enter
        time (see :class:`_Span`)."""
        return _Span(self, name, subsystem, trace_id, attrs)

    def record_event(self, name: str, subsystem: str = 'app',
                     trace_id: Optional[str] = None,
                     t_start_ns: Optional[int] = None, dur_ns: int = 0,
                     **attrs) -> None:
        """Record one already-measured (or instantaneous) event without
        opening a span — the hot-path spelling (per-request queue waits,
        io batch intervals)."""
        if not self.enabled:
            return
        now = time.monotonic_ns()
        self._record(name, subsystem, trace_id,
                     now if t_start_ns is None else int(t_start_ns),
                     int(dur_ns), attrs)

    def _record(self, name, subsystem, trace_id, t0_ns, dur_ns,
                attrs) -> None:
        buf = self._buf()
        buf.append({
            'name': name, 'subsystem': subsystem, 'trace_id': trace_id,
            't_start_ns': int(t0_ns), 'dur_ns': int(dur_ns),
            'thread': self._tls.tname,
            'attrs': attrs})
        self._events_n += 1

    def set_ring(self, n: int) -> None:
        """Resize the flight-recorder ring (affects the merged view
        immediately; per-thread buffers adopt the new bound as they are
        next touched)."""
        n = max(16, int(n))
        with self._lock:
            self._ring = n
            self._retired = collections.deque(self._retired, maxlen=n)
            self._bufs = [(t, collections.deque(b, maxlen=n))
                          for t, b in self._bufs]
            # every thread's cached ref is now stale: the generation
            # bump makes each re-register a fresh buffer on its next
            # record (_buf), so no event is ever appended to a deque
            # the merge no longer sees
            self._gen += 1

    def events(self, limit: Optional[int] = None) -> List[dict]:
        """The merged flight-recorder ring, oldest first, bounded by the
        ring size (newest win)."""
        with self._lock:
            chunks = [list(self._retired)] + [list(b) for _t, b in
                                              self._bufs]
            bound = self._ring if limit is None else min(self._ring,
                                                         int(limit))
        merged: List[dict] = []
        for c in chunks:
            merged.extend(c)
        merged.sort(key=lambda e: e['t_start_ns'])
        return merged[-bound:]

    # -- renderers ---------------------------------------------------------
    def _refreshed_snapshots(self):
        with self._lock:
            regs = sorted(self._stats.items())
        out = []
        for name, (stats, refresh) in regs:
            if refresh is not None:
                try:
                    refresh()
                # a broken gauge refresher must degrade that one stat set, never the whole /metrics render
                except Exception:
                    pass
            counters, samples = stats.snapshot()
            out.append((name, counters, samples))
        return out

    #: newest samples per distribution a sampler tick reduces over —
    #: bounds the per-tick cost no matter how large an uncleared
    #: serving StatSet grows (a full copy-and-sort of a ~100k-sample
    #: latency list at 20 Hz measurably taxed the decode hot path)
    SAMPLE_TAIL = 512

    def gauge_snapshot(self) -> Dict[str, float]:
        """One flat ``{'<set>.<key>': value}`` snapshot of every
        registered StatSet (refreshed) plus the hub self-gauges — the
        sampler source behind ``obs.sample_every`` (obs/history.py).
        Distributions expand to ``.p50/.p99/.mean`` over the newest
        :attr:`SAMPLE_TAIL` samples (recent behavior is what a
        time-series ring wants, and the bounded read keeps the tick
        O(tail) off the recording threads' lock) plus ``.n`` = total
        retained count, so history keys spell exactly like their
        ``/metrics`` rows."""
        out: Dict[str, float] = {}
        with self._lock:
            regs = sorted(self._stats.items())
        for name, (stats, refresh) in regs:
            if refresh is not None:
                try:
                    refresh()
                # a broken gauge refresher must degrade that one stat set, never the sampler tick
                except Exception:
                    pass
            view = getattr(stats, 'tail_view', None)
            if view is not None:
                counters, samples = view(self.SAMPLE_TAIL)
            else:   # duck-typed stats object: unbounded fallback
                counters, samples = stats.snapshot()
                samples = {k: (v, len(v)) for k, v in samples.items()}
            for key, v in counters.items():
                out[f'{name}.{key}'] = float(v)
            for key, (vals, n) in samples.items():
                arr = np.asarray(vals, dtype=np.float64)
                out[f'{name}.{key}.p50'] = float(np.quantile(arr, 0.5))
                out[f'{name}.{key}.p99'] = float(np.quantile(arr, 0.99))
                out[f'{name}.{key}.mean'] = float(arr.mean())
                out[f'{name}.{key}.n'] = float(n)
        out['obs.events_recorded'] = float(self._events_n)
        out['obs.uptime_s'] = (time.monotonic_ns() - self._t0_ns) / 1e9
        return out

    @staticmethod
    def _prom_name(set_name: str, key: str) -> Tuple[str, str]:
        """``('serve', 'latency_ms[b8]') -> ('cxxnet_serve_latency_ms',
        '{tag="b8"}')`` — bracket suffixes become a ``tag`` label, every
        other character outside ``[a-zA-Z0-9_]`` folds to ``_``."""
        import re
        label = ''
        m = re.match(r'^(.*?)\[([^\]]*)\]$', key)
        if m:
            key = m.group(1)
            tag = m.group(2).replace('\\', '\\\\').replace('"', '\\"')
            label = f'{{tag="{tag}"}}'
        base = re.sub(r'[^a-zA-Z0-9_]', '_', f'{set_name}_{key}')
        return f'cxxnet_{base}', label

    def metrics_text(self) -> str:
        """The whole hub in Prometheus text exposition format — every
        gauge a scraper (or an autoscaler) consumes.
        Counters/gauges export as-is; distributions export
        ``_p50/_p99/_mean/_count`` gauges over the retained samples."""
        series: Dict[str, List[Tuple[str, float]]] = {}

        def put(mname: str, label: str, value: float) -> None:
            series.setdefault(mname, []).append((label, float(value)))

        for name, counters, samples in self._refreshed_snapshots():
            for key, v in counters.items():
                mname, label = self._prom_name(name, key)
                put(mname, label, v)
            for key, vals in samples.items():
                arr = np.asarray(vals)
                mname, label = self._prom_name(name, key)
                put(f'{mname}_p50', label, float(np.quantile(arr, 0.5)))
                put(f'{mname}_p99', label, float(np.quantile(arr, 0.99)))
                put(f'{mname}_mean', label, float(arr.mean()))
                put(f'{mname}_count', label, float(arr.size))
        with self._lock:
            put('cxxnet_obs_events_recorded', '', float(self._events_n))
            put('cxxnet_obs_ring_events', '', float(self._ring))
        put('cxxnet_obs_uptime_seconds', '',
            (time.monotonic_ns() - self._t0_ns) / 1e9)
        lines: List[str] = []
        for mname in sorted(series):
            lines.append(f'# TYPE {mname} gauge')
            for label, value in sorted(series[mname]):
                lines.append(f'{mname}{label} {value:g}')
        return '\n'.join(lines) + '\n'

    def status(self) -> dict:
        """The ``/statusz`` JSON snapshot: uptime, every registered stat
        set's counters, every status provider's view, recorder state."""
        with self._lock:
            providers = sorted(self._status.items())
            dumps = list(self.dumps)
            events_n = self._events_n
            ring = self._ring
        status: Dict[str, object] = {}
        for name, provider in providers:
            try:
                status[name] = provider()
            # a broken provider must degrade its own /statusz entry, never the endpoint
            except Exception as e:
                status[name] = {'error': repr(e)}
        stats = {name: counters
                 for name, counters, _s in self._refreshed_snapshots()}
        return {
            'uptime_s': (time.monotonic_ns() - self._t0_ns) / 1e9,
            'pid': os.getpid(),
            'ring_events': ring,
            'events_recorded': events_n,
            'events_buffered': len(self.events()),
            'stats': stats,
            'status': status,
            'flight_dumps': dumps,
        }

    # -- flight-recorder dumps ---------------------------------------------
    def configure_dump(self, dump_dir: str,
                       keep: int = DEFAULT_KEEP) -> None:
        self._dump_dir = os.fspath(dump_dir)
        self._dump_keep = max(1, int(keep))

    def dump(self, reason: str, log=None) -> Optional[str]:
        """Write one flight-record JSON (ring + failure log + stat
        snapshots) to the configured dump dir; returns its path (None
        when no dir is configured).  Bounded: only the newest ``keep``
        dumps per process survive."""
        if self._dump_dir is None:
            return None
        if log is None:
            from ..runtime import faults
            log = faults.global_failure_log()
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        import re
        tag = re.sub(r'[^a-zA-Z0-9_.-]', '_', str(reason))[:48]
        payload = {
            'reason': str(reason),
            'seq': seq,
            'pid': os.getpid(),
            'monotonic_ns': time.monotonic_ns(),
            'events': self.events(),
            'failure_log': [
                {'kind': r.kind, 'detail': r.detail, 'step': r.step,
                 'monotonic': r.monotonic} for r in log.records()],
            'stats': {name: counters for name, counters, _s in
                      self._refreshed_snapshots()},
        }
        slos = self.slos_view()
        if slos:
            # the breaching window's samples + verdict history ride
            # every postmortem (the SLO-drill acceptance contract)
            payload['slos'] = slos
        os.makedirs(self._dump_dir, exist_ok=True)
        path = os.path.join(self._dump_dir,
                            f'flight_{os.getpid()}_{seq:03d}_{tag}.json')
        with open(path, 'w', encoding='utf-8') as f:
            json.dump(payload, f, default=str)
        with self._lock:
            self.dumps.append(path)
            while len(self.dumps) > self._dump_keep:
                old = self.dumps.pop(0)
                try:
                    os.unlink(old)
                except OSError:
                    pass
        return path

    def arm_flight_recorder(self, dump_dir: str,
                            keep: int = DEFAULT_KEEP) -> None:
        """Arm automatic postmortems: any ``TrainingFault`` or
        ``SLOBreachError`` subclass kind (or a supervisor give-up)
        reaching a ``FailureLog`` dumps the flight record to
        ``dump_dir`` — every chaos drill, SLO breach, and real incident
        ships its own postmortem.  Idempotent; :meth:`disarm` removes
        the listener."""
        from ..runtime import faults
        self.configure_dump(dump_dir, keep=keep)
        if self._listener is not None:
            return

        def listener(rec, log):
            if rec.kind != 'giving_up' \
                    and rec.kind not in faults.training_fault_kinds() \
                    and rec.kind not in faults.slo_breach_kinds():
                return
            try:
                self.dump(rec.kind, log=log)
            # a failed postmortem write must never break the training/serving path that faulted
            except Exception:
                pass

        self._listener = listener
        faults.add_failure_listener(listener)

    def disarm(self) -> None:
        """Remove the failure-log dump listener (tests, CLI teardown)."""
        if self._listener is not None:
            from ..runtime import faults
            faults.remove_failure_listener(self._listener)
            self._listener = None

    def arm_signal_dump(self) -> bool:
        """``kill -USR1 <pid>`` dumps the flight record of a live
        process.  Main-thread only (signal module contract); returns
        False where unavailable (Windows, embedded interpreters)."""
        import signal
        if not hasattr(signal, 'SIGUSR1'):
            return False
        try:
            signal.signal(signal.SIGUSR1,
                          lambda _s, _f: self.dump('SIGUSR1'))
        except ValueError:      # not the main thread
            return False
        return True

    # -- Chrome trace export ------------------------------------------------
    def export_chrome_trace(self, path: str) -> str:
        """Write the flight-recorder ring as Chrome trace-event JSON
        (``ph: X`` complete events, microsecond timestamps).  Loads in
        Perfetto / chrome://tracing — beside a ``profile_dir`` trace
        (whose clock is another: align the two on a shared landmark span,
        such as one ``train.dispatch``)."""
        events = self.events()
        tids: Dict[str, int] = {}
        trace: List[dict] = []
        pid = os.getpid()
        for e in events:
            tid = tids.setdefault(e['thread'], len(tids) + 1)
            args = dict(e['attrs'])
            if e['trace_id'] is not None:
                args['trace_id'] = e['trace_id']
            trace.append({
                'name': e['name'], 'cat': e['subsystem'], 'ph': 'X',
                'ts': e['t_start_ns'] / 1e3,
                'dur': max(e['dur_ns'], 1) / 1e3,
                'pid': pid, 'tid': tid, 'args': args})
        for tname, tid in tids.items():
            trace.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                          'tid': tid, 'args': {'name': tname}})
        with open(path, 'w', encoding='utf-8') as f:
            json.dump({'traceEvents': trace, 'displayTimeUnit': 'ms'},
                      f, default=str)
        return path


# --- the process-wide hub ---------------------------------------------------

_HUB: Optional[TelemetryHub] = None
_HUB_LOCK = threading.Lock()


def get_hub() -> TelemetryHub:
    """The process-wide hub (created on first use)."""
    global _HUB
    h = _HUB
    if h is None:
        with _HUB_LOCK:
            if _HUB is None:
                _HUB = TelemetryHub()
            h = _HUB
    return h


def install_hub(hub: Optional[TelemetryHub]) -> Optional[TelemetryHub]:
    """Swap the process-wide hub (tests); returns the previous one.
    ``None`` resets to a fresh default on next :func:`get_hub`."""
    global _HUB
    with _HUB_LOCK:
        prev, _HUB = _HUB, hub
    return prev


def span(name: str, subsystem: str = 'app',
         trace_id: Optional[str] = None, **attrs):
    """Module-level convenience for ``get_hub().span(...)`` — the one
    spelling production code uses."""
    return get_hub().span(name, subsystem, trace_id, **attrs)


def record_event(name: str, subsystem: str = 'app',
                 trace_id: Optional[str] = None,
                 t_start_ns: Optional[int] = None, dur_ns: int = 0,
                 **attrs) -> None:
    get_hub().record_event(name, subsystem, trace_id,
                           t_start_ns=t_start_ns, dur_ns=dur_ns, **attrs)


def next_trace_id() -> str:
    return get_hub().next_trace_id()
