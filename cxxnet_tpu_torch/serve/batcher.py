"""Dynamic micro-batching: coalesce concurrent requests onto bucket shapes.

PyTorch-side counterpart of ``cxxnet_tpu/serve/batcher.py``.  The batcher
sits between client threads and a ``PredictEngine``:

* a **bounded queue** with admission control — a full queue rejects at
  once with a typed ``ServeOverloadError``;
* a **batching window** — the worker takes the oldest request, then waits
  at most ``max_wait`` seconds (or until ``max_batch`` rows, the engine's
  largest bucket) for more to coalesce; arrival order is kept and a
  request is never split across batches;
* **per-request deadlines** — a request whose deadline passes before its
  batch runs gets a typed ``DeadlineExceededError``, and :meth:`wait` is
  bounded by the same deadline;
* **stats** — per-bucket latency, batch and row counters in a
  ``StatSet``, printed in the eval-line format.

Every submitted request ends in exactly one terminal counter (requests,
expired, abandoned, rejected, engine_errors), counted on the worker side.
An engine that owns completion (the decode engine, ``serve/decode.py``)
exposes ``execute_requests``: the batcher hands it each coalesced batch
and leaves the requests to it, which then counts their outcomes.
Admission pricing (``cost_fn`` / ``max_cost``): the window also closes
when the accumulated cost of its requests would pass ``max_cost`` — the
decode engine with prefix sharing prices a request at the prefill it
really has left.

Telemetry (``obs/``, as JAX's batcher): each request carries one trace id
for its lifetime, across the client, batcher and engine threads; the
flight recorder gets its ``serve.admit``, ``serve.queue`` and
``serve.finish`` events and a ``serve.forward`` span per predict batch;
:meth:`DynamicBatcher.register_into` puts the ``serve`` StatSet on a
hub, the live queue depth folded in per render.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional

import numpy as np

from ..obs import next_trace_id, record_event, span
from ..runtime.faults import (DeadlineExceededError, RequestAbandonedError,
                              ServeError, ServeOverloadError)
from ..utils.bucketing import bucket_for
from ..utils.metric import StatSet

__all__ = ['DynamicBatcher', 'ServeRequest']


class ServeRequest:
    """One in-flight request: payload rows in, scores (or a typed error)
    out, with a completion event the client blocks on.

    ``meta`` carries per-request options for engines that need more than
    rows: the decode engine reads ``max_new`` / ``temperature`` / ``rng``
    from it and streams emitted token ids into ``tokens`` (with their
    emit times in ``token_times``) before setting the event."""

    __slots__ = ('data', 'n', 't_submit', 'deadline', 'deadline_abs',
                 'event', 'result', 'error', 'abandoned', 'meta', 'tokens',
                 'token_times', 'trace_id')

    def __init__(self, data: np.ndarray, deadline: float, meta=None):
        self.data = data
        self.n = int(data.shape[0])
        # one trace id a request lifetime: every event of it (admit,
        # queue, prefill, emit, finish) carries it, across threads
        self.trace_id = next_trace_id()
        self.t_submit = time.monotonic()
        self.deadline = float(deadline)
        self.deadline_abs = self.t_submit + float(deadline)
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.meta = meta or {}
        self.tokens: list = []          # incremental decode emissions
        self.token_times: list = []
        # set by wait() on caller timeout: the worker
        # drops the request at pop time and counts the drop there
        self.abandoned = False


class DynamicBatcher:
    """Coalesce concurrent predict requests into bucket-sized batches.

    ``engine`` is anything with ``predict_scores(np.ndarray)`` and a
    ``buckets`` ladder.  ``max_wait`` trades tail latency for batch
    efficiency; ``deadline`` is the default per-request bound.
    """

    def __init__(self, engine, max_queue: int = 64, max_wait: float = 0.002,
                 deadline: float = 1.0, stats: Optional[StatSet] = None,
                 cost_fn=None, max_cost: int = 0):
        if max_queue <= 0:
            raise ValueError('max_queue must be positive')
        if max_cost > 0 and cost_fn is None:
            raise ValueError('max_cost needs a cost_fn')
        self.engine = engine
        self.max_queue = int(max_queue)
        self.max_wait = float(max_wait)
        self.deadline = float(deadline)
        self.max_batch = int(engine.buckets[-1])
        self.cost_fn = cost_fn
        self.max_cost = int(max_cost)
        # engines that own request completion (the decode engine admits
        # requests into slots and finishes them from its own loop) expose
        # execute_requests; the predict path stays synchronous
        self._exec = getattr(engine, 'execute_requests', None)
        self.stats = stats if stats is not None else StatSet()
        self._cond = threading.Condition()
        self._q: Deque[ServeRequest] = collections.deque()  # guarded-by: _cond
        self._closed = False       # guarded-by: _cond
        self._t0 = time.monotonic()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name='serve-batcher')
        self._worker.start()

    # -- client side -------------------------------------------------------
    def submit_async(self, data: np.ndarray,
                     deadline: Optional[float] = None,
                     meta=None) -> ServeRequest:
        """Enqueue a request; returns immediately.  Raises
        ``ServeOverloadError`` when the queue is full and ``ServeError``
        after ``close()``."""
        data = np.asarray(data)
        if data.ndim < 2:
            raise ValueError('request must be (n, ...) with a row axis')
        req = ServeRequest(data, self.deadline if deadline is None
                           else deadline, meta=meta)
        with self._cond:
            if self._closed:
                raise ServeError('batcher is closed')
            self.stats.inc('submitted')
            if len(self._q) >= self.max_queue:
                self.stats.inc('rejected')
                raise ServeOverloadError(len(self._q), self.max_queue)
            self._q.append(req)
            depth = len(self._q)
            self.stats.peak('queue_peak', depth)
            self._cond.notify()
        record_event('serve.admit', 'serve', req.trace_id, rows=req.n,
                     queue_depth=depth)
        return req

    def wait(self, req: ServeRequest) -> np.ndarray:
        """Block until ``req`` completes; returns its score rows or raises
        its typed error.  Bounded by the request deadline."""
        remaining = req.deadline_abs - time.monotonic()
        if not req.event.wait(timeout=max(0.0, remaining) + 0.05):
            # mark the walk-away; the worker counts the drop when it pops
            # the request (single-owner counting)
            req.abandoned = True
            raise DeadlineExceededError(
                req.deadline, time.monotonic() - req.t_submit, req.n)
        if req.error is not None:
            raise req.error
        return req.result

    def submit(self, data: np.ndarray,
               deadline: Optional[float] = None) -> np.ndarray:
        """Enqueue and block for the scores — the one-call client path."""
        return self.wait(self.submit_async(data, deadline))

    # -- worker side -------------------------------------------------------
    def _expire(self, req: ServeRequest, now: float) -> None:
        req.error = DeadlineExceededError(req.deadline, now - req.t_submit,
                                          req.n)
        self.stats.inc('expired')
        record_event('serve.finish', 'serve', req.trace_id, rows=req.n,
                     error='DeadlineExceededError')
        req.event.set()

    def _drop_abandoned(self, req: ServeRequest) -> None:
        now = time.monotonic()
        if now >= req.deadline_abs:
            self._expire(req, now)
            return
        req.error = RequestAbandonedError(now - req.t_submit)
        self.stats.inc('abandoned')
        record_event('serve.finish', 'serve', req.trace_id, rows=req.n,
                     error='RequestAbandonedError')
        req.event.set()

    def _gather(self, first: ServeRequest) -> List[ServeRequest]:
        """Coalesce from the queue behind ``first`` until the window
        closes, the next request would overflow ``max_batch``, or — with
        a ``cost_fn`` — the accumulated cost would pass ``max_cost`` (the
        first request always rides, whatever its cost)."""
        batch = [first]
        rows = first.n
        cost = self.cost_fn(first) if self.cost_fn is not None else 0
        window_end = time.monotonic() + self.max_wait
        while rows < self.max_batch:
            with self._cond:
                if not self._q:
                    remaining = window_end - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(remaining)
                    if not self._q:
                        continue
                if self._q[0].n + rows > self.max_batch:
                    break          # preserve order: don't skip ahead
                if self.max_cost > 0:
                    nxt_cost = self.cost_fn(self._q[0])
                    if cost + nxt_cost > self.max_cost:
                        self.stats.inc('cost_closed')
                        break      # preserve order: don't skip ahead
                    cost += nxt_cost
                nxt = self._q.popleft()
            if nxt.abandoned:
                self._drop_abandoned(nxt)
                continue
            now = time.monotonic()
            if now >= nxt.deadline_abs:
                self._expire(nxt, now)
                continue
            batch.append(nxt)
            rows += nxt.n
        return batch

    def _execute(self, batch: List[ServeRequest]) -> None:
        now = time.monotonic()
        live = []
        for r in batch:
            if r.abandoned:
                self._drop_abandoned(r)
            elif now >= r.deadline_abs:
                self._expire(r, now)
            else:
                live.append(r)
        if not live:
            return
        # queue wait a request: submit -> window close, on the recorder's
        # monotonic clock
        now_ns = time.monotonic_ns()
        for r in live:
            t0_ns = int(r.t_submit * 1e9)
            record_event('serve.queue', 'serve', r.trace_id,
                         t_start_ns=t0_ns, dur_ns=now_ns - t0_ns)
        if self._exec is not None:
            # engine-owned completion: the engine admits, streams and
            # finishes each request and lands its errors on it; a fault
            # outside any request fails only the requests still open
            try:
                self._exec(live)
                self.stats.observe('coalesced', len(live))
            except Exception as e:  # noqa: BLE001 — surfaced per request
                for r in live:
                    if not r.event.is_set():
                        self.stats.inc('engine_errors')
                        r.error = e
                        r.event.set()
            return
        rows = sum(r.n for r in live)
        try:
            # the concat stays inside the try: a mis-shaped request fails
            # its batch, not the worker thread
            data = (live[0].data if len(live) == 1 else
                    np.concatenate([r.data for r in live], axis=0))
            with span('serve.forward', 'serve', rows=rows,
                      coalesced=len(live)):
                scores = self.engine.predict_scores(data)
        except Exception as e:  # noqa: BLE001 — surfaced per request
            for r in live:
                self.stats.inc('engine_errors')
                r.error = e
                r.event.set()
            return
        bucket = bucket_for(rows, self.engine.buckets) \
            or self.engine.buckets[-1]
        done = time.monotonic()
        off = 0
        for r in live:
            r.result = scores[off:off + r.n]
            off += r.n
            self.stats.inc('requests')
            self.stats.observe(f'latency_ms[b{bucket}]',
                               (done - r.t_submit) * 1e3)
        self.stats.inc(f'batches[b{bucket}]')
        self.stats.inc(f'rows[b{bucket}]', rows)
        self.stats.observe('coalesced', len(live))
        for r in live:
            record_event('serve.finish', 'serve', r.trace_id, rows=r.n,
                         latency_ms=(done - r.t_submit) * 1e3)
            r.event.set()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait(0.05)
                if not self._q:   # closed and drained
                    return
                first = self._q.popleft()
            if first.abandoned:
                self._drop_abandoned(first)
                continue
            now = time.monotonic()
            if now >= first.deadline_abs:
                self._expire(first, now)
                continue
            self._execute(self._gather(first))

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: Optional[float] = None) -> bool:
        """Graceful, idempotent shutdown: stop admitting, finish queued
        requests, join the worker.  True once the worker exited."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if threading.current_thread() is self._worker:
            return False
        self._worker.join(timeout)
        return not self._worker.is_alive()

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def register_into(self, hub, name: str = 'serve') -> None:
        """The ``serve`` stat registration: the batcher's StatSet, with a
        refresh folding the live queue depth in per render."""
        hub.register_stats(
            name, self.stats,
            refresh=lambda: self.stats.gauge('queue_depth', self.depth()))

    def report(self, name: str = 'serve') -> str:
        """Eval-line-format stats snapshot with requests/sec appended
        (rendered by the hub's one formatter)."""
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        self.stats.gauge('reqs_per_sec',
                         self.stats.get('requests') / elapsed)
        return self.stats.print(name)
