"""Double-buffered producer-thread prefetcher.

The port's own copy of ``cxxnet_tpu/utils/thread_buffer.py`` (the
reference's semaphore-driven ``ThreadBuffer``,
``src/utils/thread_buffer.h:22-202``): a background thread runs the
producer while the consumer drains a small bounded queue, hiding the
data pipeline behind device compute.

* ``deadline=`` — a per-item consumer deadline; missing it raises
  ``runtime.faults.PipelineStallError`` instead of blocking forever,
* ``close(timeout=)`` — joins every producer thread this buffer started,
* shutdown never drops the end-of-stream sentinel: the producer waits
  for space while the consumer is alive and drains-then-signals once the
  consumer abandoned it, so a consumer is never left hanging in
  ``q.get()``,
* ``stats`` — an optional ``utils.metric.StatSet``: the producer's
  full-queue stalls (``<stats_name>.full_stall``) and the consumer's
  empty-queue waits (``<stats_name>.starved_ms``) land on it;
* ``fault_scope='batch'`` opts the buffer into the deterministic
  stall-injection hook (``runtime.faults.FaultPlan``), with
  ``fault_base`` added to the producer's item index so a consumer that
  re-winds mid-epoch (the supervisor) keeps injected indices
  epoch-absolute; page and instance buffers stay out of scope.  A
  batch-scoped producer also records each item's production interval
  as an ``io.produce`` event on the telemetry hub's flight recorder.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple, TypeVar

from ..runtime import faults
from ..runtime.faults import PipelineStallError

T = TypeVar('T')

_STOP = object()


class ThreadBuffer:
    """Wraps a factory of iterators; prefetches ``buffer_size`` items ahead."""

    def __init__(self, make_iter: Callable[[], Iterator[T]],
                 buffer_size: int = 2, deadline: Optional[float] = None,
                 first_deadline: Optional[float] = None,
                 fault_scope: Optional[str] = None, fault_base: int = 0):
        self._make_iter = make_iter
        self._buffer_size = max(1, buffer_size)
        self._deadline = deadline
        # the FIRST item may lawfully take longer than the steady-state
        # per-item deadline (epoch setup, cold caches); None = deadline
        self._first_deadline = first_deadline
        self._fault_scope = fault_scope
        self._fault_base = fault_base
        # optional utils.metric.StatSet, assigned late (an io chain
        # resolves its StatSet after set_param)
        self.stats = None
        self.stats_name = 'buffer'
        self._lock = threading.Lock()
        # every live (thread, stop, queue) from __iter__, for close()
        self._runs: List[Tuple[threading.Thread, threading.Event,
                               queue.Queue]] = []  # guarded-by: _lock

    def _run(self, q: queue.Queue, stop: threading.Event, box: list) -> None:
        try:
            from ..obs import record_event
            t_prev = time.monotonic_ns()
            for i, item in enumerate(self._make_iter()):
                if self._fault_scope is not None:
                    faults.pipeline_item(self._fault_scope,
                                         self._fault_base + i)
                    # the production interval of each batch (batch-scoped
                    # buffers only: page and instance buffers would
                    # drown the ring)
                    now_ns = time.monotonic_ns()
                    record_event('io.produce', 'io', t_start_ns=t_prev,
                                 dur_ns=now_ns - t_prev,
                                 index=self._fault_base + i)
                    t_prev = now_ns
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        # consumer slower than this producer: benign for
                        # throughput, but counted — a full buffer plus a
                        # starved pool downstream localizes the bottleneck
                        if self.stats is not None:
                            self.stats.inc(f'{self.stats_name}.full_stall')
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            box.append(e)
        finally:
            # never drop the sentinel: while the consumer is alive a full
            # queue only means it is slow; once it has gone (stop set)
            # nobody frees a slot, so drain one ourselves, then signal
            while True:
                try:
                    q.put_nowait(_STOP)
                    return
                except queue.Full:
                    pass
                if stop.is_set():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                else:
                    try:
                        q.put(_STOP, timeout=0.1)
                        return
                    except queue.Full:
                        continue

    def __iter__(self):
        # restart semantics = BeforeFirst(): a fresh producer each epoch;
        # an abandoned generator (GeneratorExit) sets the stop event and
        # so retires the producer thread
        q: queue.Queue = queue.Queue(maxsize=self._buffer_size)
        stop = threading.Event()
        box: list = []
        thread = threading.Thread(target=self._run, args=(q, stop, box),
                                  daemon=True, name='cxxnet-tb-producer')
        with self._lock:
            self._runs = [r for r in self._runs if r[0].is_alive()]
            self._runs.append((thread, stop, q))
        thread.start()
        index = 0
        try:
            while True:
                dl = self._deadline
                if index == 0 and self._first_deadline is not None:
                    dl = self._first_deadline
                # when instrumented and about to block, time the wait:
                # consumer-starved ms is the number that justifies nworker
                starved = self.stats is not None and q.empty()
                if starved:
                    t0 = time.perf_counter()
                if dl is None:
                    item = q.get()
                else:
                    try:
                        item = q.get(timeout=dl)
                    except queue.Empty:
                        raise PipelineStallError(index, dl) from None
                if starved:
                    self.stats.observe(f'{self.stats_name}.starved_ms',
                                       (time.perf_counter() - t0) * 1e3)
                if item is _STOP:
                    if box:
                        raise box[0]
                    return
                yield item
                index += 1
        finally:
            stop.set()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Shut down every producer this buffer started: set their stop
        events, drain their queues and join the threads.  ``timeout``
        bounds the TOTAL wait; returns True when every producer exited."""
        with self._lock:
            runs, self._runs = self._runs, []
        end = None if timeout is None else time.monotonic() + timeout
        ok = True
        for thread, stop, q in runs:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            remain = None if end is None else max(0.0, end - time.monotonic())
            thread.join(remain)
            if thread.is_alive():
                ok = False
        return ok
