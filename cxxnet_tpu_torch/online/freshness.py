"""Freshness: the first-class SLO of a train-while-serve loop.

The port's own copy of ``cxxnet_tpu/online/freshness.py``.  An online
learning product is only as good as the lag between what the trainer
just learned and what the server answers with.  The tracker measures
that lag per hot swap from three stamps a checkpoint step:

* ``record_step(step)`` — the optimizer step's params were snapshotted
  for checkpoint ``step`` (the trainer's side, the supervisor's
  ``on_save`` hook);
* ``record_swap(step)`` — the registry swapped ``step`` into the live
  engine (``ModelRegistry.on_swap``);
* ``note_served(step)`` — a request completed on ``step``'s params
  (``PredictEngine.on_serve``; only the FIRST request a version closes
  the measurement).

``freshness_s`` = first-serve time − step time, one sample a swap.  The
breach is judged by the generic SLO engine (``obs/slo.py``): a
``window=0`` per-sample spec named ``freshness`` whose error factory
builds the typed ``runtime.faults.FreshnessSLOError`` and whose records
keep the historical ``freshness_slo_breach`` kind.  Every sample above
``slo_s`` counts a breach and shows on the eval line: a breach degrades
what is observed, never availability (the stale model keeps serving;
strict callers raise the typed error at run boundaries through
:meth:`FreshnessTracker.check_strict`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..obs import format_report
from ..obs.slo import SLOEngine, SLOSpec
from ..runtime import faults
from ..utils.metric import StatSet


class FreshnessTracker:
    """Thread-safe step→swap→first-serve lag tracker (module docstring).

    All three probes run on different threads (step loop, registry
    watcher, batcher worker); times are ``time.monotonic()``.
    """

    #: newest checkpoint versions retained in the step/swap stamp maps —
    #: a 24/7 run publishes forever, and only the recent tail can still
    #: close a measurement (StatSet already bounds the sample lists)
    MAX_VERSIONS = 1024

    def __init__(self, slo_s: float = 0.0,
                 log: Optional[faults.FailureLog] = None):
        self.slo_s = float(slo_s)
        self.log = faults.global_failure_log() if log is None else log
        self._lock = threading.Lock()
        self._step_t: Dict[int, float] = {}
        self._swap_t: Dict[int, float] = {}
        self._served = set()          # versions whose first serve is in
        self.stats = StatSet()
        self.swaps = 0
        # breach judgment is the generic engine's (obs/slo.py): one
        # per-sample (window=0) spec, typed-error factory, historical
        # log kind — the tracker only measures
        self.slo = SLOEngine(log=self.log)
        if self.slo_s > 0:
            self.slo.add(
                SLOSpec(name='freshness', key='online.freshness_s',
                        op='<=', threshold=self.slo_s, window=0.0,
                        kind='freshness_slo_breach'),
                err_factory=lambda spec, value, n, ctx:
                    faults.FreshnessSLOError(ctx.get('step', -1), value,
                                             self.slo_s, n))

    @property
    def breaches(self) -> int:
        return self.slo.breaches('freshness')

    @property
    def last_breach(self) -> Optional[faults.FreshnessSLOError]:
        return self.slo.last_breach

    def _prune_locked(self) -> None:
        """Bound the per-version maps to the newest MAX_VERSIONS steps
        (steps are monotone, so oldest = smallest key).  Caller holds
        the lock."""
        for d in (self._step_t, self._swap_t):
            while len(d) > self.MAX_VERSIONS:
                d.pop(min(d))
        if len(self._served) > self.MAX_VERSIONS:
            keep = set(self._swap_t)
            self._served &= keep

    # -- probes ------------------------------------------------------------
    def record_step(self, step: int, t: Optional[float] = None) -> None:
        with self._lock:
            self._step_t[int(step)] = time.monotonic() if t is None else t
            self._prune_locked()

    def record_swap(self, step: int, t: Optional[float] = None) -> None:
        now = time.monotonic() if t is None else t
        with self._lock:
            step = int(step)
            self._swap_t[step] = now
            self.swaps += 1
            t0 = self._step_t.get(step)
            self._prune_locked()
        if t0 is not None:
            # trainer-side half: optimizer step -> live swap
            self.stats.observe('swap_lag_s', now - t0)

    def note_served(self, version) -> Optional[float]:
        """Engine ``on_serve`` probe: close the freshness measurement on
        the FIRST request served per swapped version.  Returns the
        freshness sample when one was recorded (None otherwise).  The
        bootstrap version (served from process start, never swapped) is
        not a freshness sample — the SLO is a property of *swaps*."""
        try:
            version = int(version)
        except (TypeError, ValueError):
            return None
        now = time.monotonic()
        with self._lock:
            if version in self._served or version not in self._swap_t:
                return None
            self._served.add(version)
            t0 = self._step_t.get(version)
        if t0 is None:
            return None
        fresh = now - t0
        self.stats.observe('freshness_s', fresh)
        if self.slo_s > 0:
            # the generic engine judges the sample: a violation counts
            # the breach, builds the typed FreshnessSLOError, and logs
            # the historical kind: one engine for every SLO
            self.slo.observe('freshness', fresh, step=version)
        return fresh

    # -- reporting ---------------------------------------------------------
    def unserved_swaps(self) -> int:
        """Swapped versions no request has touched yet — non-zero means
        traffic is slower than the swap cadence (freshness unmeasurable,
        not necessarily breached)."""
        with self._lock:
            return len(self._swap_t) - len(self._served
                                           & set(self._swap_t))

    def report(self, stats: Optional[StatSet] = None,
               name: str = 'online') -> str:
        """Eval-line-format freshness summary; with ``stats`` given the
        gauges merge into a shared set instead."""
        own = stats is None
        stats = self.stats if own else stats
        with self._lock:
            stats.gauge('swaps', self.swaps)
            stats.gauge('slo_breaches', self.breaches)
        stats.gauge('unserved_swaps', self.unserved_swaps())
        if not own:
            # copy the distributions over so p50/p99 print with the rest
            for q, tag in ((0.5, 'p50'), (0.99, 'p99')):
                for key in ('freshness_s', 'swap_lag_s'):
                    v = self.stats.quantile(key, q)
                    if v == v:                      # has samples
                        stats.gauge(f'{key}.{tag}', v)
        return format_report(name, stats)

    def check_strict(self) -> None:
        """Raise the last typed breach (strict mode, run boundaries)."""
        self.slo.check_strict()
