"""Gauge history: bounded time-series rings over the telemetry hub.

The port's own copy of ``cxxnet_tpu/obs/history.py``.

The hub's ``/metrics`` render answers "what is the value *now*"; an SLO
verdict needs "what has it been doing over the last W seconds".  This
module is the bridge — a :class:`GaugeSampler` thread snapshots every
registered gauge on a fixed cadence (``obs.sample_every``, monotonic
clock) into per-gauge :class:`GaugeHistory` rings, each bounded to the
newest ``maxlen`` points, with windowed rate/quantile reductions the
SLO engine (obs/slo.py) evaluates burn rates over.

Keys are spelled exactly as on ``/metrics`` minus the ``cxxnet_``
prefix, dot-joined: ``<set>.<key>`` for counters/gauges (bracket tags
kept verbatim, ``serve.rows[b8]``), and distributions expand to
``<set>.<key>.p50/.p99/.mean/.n`` per tick — so an operator can read a
gauge off a scrape and point an SLO at the same spelling.

The sampler can be *driven* instead of threaded (``maybe_tick`` /
``tick``): a caller paces sampling from its own loop, and tests pass
explicit ``now`` timestamps for deterministic window arithmetic.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ['GaugeHistory', 'GaugeSampler', 'hub_source']

#: window reductions the SLO grammar may suffix onto a base gauge key
REDUCERS = ('rate', 'mean', 'min', 'max', 'p50', 'p99')


def hub_source(hub) -> Callable[[], Dict[str, float]]:
    """The default sampler source: one flat gauge snapshot of ``hub``
    (every registered StatSet, refreshed, plus the hub self-gauges)."""
    return hub.gauge_snapshot


class GaugeHistory:
    """Per-gauge bounded rings of ``(t_monotonic, value)`` points.
    Thread-safe: the sampler records while the SLO engine (and the
    ``/statusz`` render) read windows concurrently."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._maxlen = max(2, int(maxlen))
        self._rings: Dict[str, collections.deque] = {}  # guarded-by: _lock

    def record(self, now: float, values: Dict[str, float]) -> None:
        """Append one sample per key at time ``now`` (monotonic s)."""
        now = float(now)
        with self._lock:
            for key, v in values.items():
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = collections.deque(
                        maxlen=self._maxlen)
                ring.append((now, float(v)))

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._rings

    def latest(self, key: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            ring = self._rings.get(key)
            return ring[-1] if ring else None

    def window(self, key: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points of ``key`` with ``t >= now - seconds`` (oldest first).
        ``seconds <= 0`` returns just the newest point — the per-sample
        degenerate window.  ``now`` defaults to the newest point's
        timestamp, so a paused sampler still reports its last window."""
        with self._lock:
            ring = self._rings.get(key)
            pts = list(ring) if ring else []
        if not pts:
            return []
        if seconds <= 0:
            return pts[-1:]
        cut = (pts[-1][0] if now is None else float(now)) - float(seconds)
        return [p for p in pts if p[0] >= cut]

    def rate(self, key: str, seconds: float,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed first-to-last rate of change per second (the
        counter-slope reduction: steps/sec, tokens/sec); None with
        fewer than two points or zero elapsed time."""
        pts = self.window(key, seconds, now)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def reduce(self, key: str, reducer: str, seconds: float,
               now: Optional[float] = None) -> Optional[float]:
        """One reduced value over the window: ``rate`` (slope) or
        ``mean``/``min``/``max``/``p50``/``p99`` over the point values;
        None when the window holds no usable data."""
        if reducer == 'rate':
            return self.rate(key, seconds, now)
        pts = self.window(key, seconds, now)
        if not pts:
            return None
        vals = np.asarray([v for _t, v in pts], dtype=np.float64)
        if reducer == 'mean':
            return float(vals.mean())
        if reducer == 'min':
            return float(vals.min())
        if reducer == 'max':
            return float(vals.max())
        if reducer == 'p50':
            return float(np.quantile(vals, 0.5))
        if reducer == 'p99':
            return float(np.quantile(vals, 0.99))
        raise ValueError(f'unknown reducer {reducer!r} '
                         f'(choose from {REDUCERS})')


class GaugeSampler:
    """The sampling loop: every ``period`` seconds pull one gauge dict
    from ``source`` (idiomatically :func:`hub_source`), record it into
    :attr:`history`, and run the tick listeners (the SLO engine).  Runs
    as a ``cxxnet-obs-sampler`` daemon thread via :meth:`start`, or
    caller-paced via :meth:`maybe_tick` (a caller's own loop) /
    :meth:`tick` (tests, with explicit ``now``)."""

    def __init__(self, source: Callable[[], Dict[str, float]],
                 period: float = 0.25,
                 history: Optional[GaugeHistory] = None,
                 maxlen: int = 512):
        self.source = source
        self.period = max(0.01, float(period))
        self.history = GaugeHistory(maxlen) if history is None else history
        self._lock = threading.Lock()
        self._listeners: List[Callable] = []   # guarded-by: _lock
        self._ticks = 0                        # guarded-by: _lock
        self._errors = 0                       # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next = 0.0        # maybe_tick pacing (caller thread only)

    def add_listener(self, fn: Callable) -> Callable:
        """Register ``fn(now, history)`` to run after every tick."""
        with self._lock:
            self._listeners.append(fn)
        return fn

    def stats(self) -> Tuple[int, int]:
        """``(ticks, errors)`` so far."""
        with self._lock:
            return self._ticks, self._errors

    def tick(self, now: Optional[float] = None) -> None:
        """One sample + listener pass, at ``now`` (default monotonic)."""
        now = time.monotonic() if now is None else float(now)
        try:
            values = self.source()
        # a broken gauge source must degrade this one sample, never kill the sampling loop
        except Exception:
            with self._lock:
                self._errors += 1
            return
        self.history.record(now, values)
        with self._lock:
            self._ticks += 1
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(now, self.history)
            # a broken tick listener must not take the sampler (or its sibling listeners) down with it
            except Exception:
                with self._lock:
                    self._errors += 1

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Caller-paced ticking: sample only when a full period elapsed
        since the last one (a caller drives this from its own loop
        instead of spawning a thread)."""
        now = time.monotonic() if now is None else float(now)
        if now < self._next:
            return False
        self._next = now + self.period
        self.tick(now)
        return True

    def start(self) -> 'GaugeSampler':
        """Start the sampling thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name='cxxnet-obs-sampler')
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            self.tick()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop and join the sampling thread (idempotent); True once it
        exited.  The history stays readable after close."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()
