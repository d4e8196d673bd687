"""Order-preserving worker pool for per-instance pipeline stages.

The port's own copy of ``cxxnet_tpu/utils/parallel_pool.py``: the
supply-side scaling stage of the input pipeline.  Image decode +
augmentation for ONE instance is pure, GIL-releasing host work (PIL,
scipy ``affine_transform``, numpy slicing), so fanning it across N
threads multiplies host throughput — the reference runs exactly one
decode thread (``iter_thread_imbin-inl.hpp``).

Contract that keeps the stream **bitwise identical for any worker
count** (the property ``is_replay_stable`` and supervised bitwise
recovery rely on):

* tasks are numbered in SUBMISSION order and results are reassembled in
  that order — workers race only over who computes what, never over
  what the consumer sees;
* the task function must be deterministic in ``(task payload)`` alone —
  callers seed any per-instance RNG from the epoch-absolute instance
  index they bake into the payload (``io/iter_augment.py``), never from
  shared mutable state.

The consumer thread itself feeds the pool (no feeder thread): it tops
the in-flight window up to ``window`` tasks, then blocks on the next
in-order result.  A task that raised re-raises at its position in the
output order, after every earlier result has been yielded — the pool
analogue of ``ThreadBuffer``'s drain-then-error contract.

Observability: pass a ``utils.metric.StatSet`` and the pool records
``<name>.wait_ms`` (consumer blocked on the next in-order result — the
chip-starved signal), ``<name>.stall`` (count of waits), and
``<name>.occupancy`` (worker busy-time / wall-time, 0..1) for the eval
line.

Worker threads are named ``cxxnet-pool-*`` so the test-suite leak
fixture (tests/conftest.py) can assert every pool retired.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar('T')
R = TypeVar('R')

_STOP = object()


class OrderedWorkerPool:
    """Fan ``fn`` over an iterable on ``nworker`` threads, yielding
    results strictly in submission order with a bounded in-flight
    window."""

    def __init__(self, nworker: int, window: Optional[int] = None,
                 stats=None, name: str = 'pool'):
        self.nworker = max(1, int(nworker))
        # window > nworker keeps every worker fed while the consumer
        # drains; window also bounds decoded-instance RAM
        self.window = max(self.nworker + 1,
                          int(window) if window else self.nworker * 4)
        self.stats = stats
        self.name = name

    def imap(self, fn: Callable[[T], R],
             iterable: Iterable[T]) -> Iterator[R]:
        """Generator over ``fn(item)`` in submission order.  Spawns the
        workers on first use and joins them when the generator is
        exhausted, closed (GeneratorExit), or errors."""
        tasks: queue.Queue = queue.Queue()
        results: dict = {}
        cond = threading.Condition()
        busy = [0.0] * self.nworker

        def worker(wid: int) -> None:
            while True:
                task = tasks.get()
                if task is _STOP:
                    return
                seq, item = task
                t0 = time.perf_counter()
                try:
                    ok, val = True, fn(item)
                except BaseException as e:  # re-raised at seq, in order
                    ok, val = False, e
                busy[wid] += time.perf_counter() - t0
                with cond:
                    results[seq] = (ok, val)
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f'cxxnet-pool-{self.name}-{w}')
                   for w in range(self.nworker)]
        for t in threads:
            t.start()
        t_start = time.perf_counter()
        src = iter(iterable)
        submitted = nxt = 0
        exhausted = False
        try:
            while True:
                while not exhausted and submitted - nxt < self.window:
                    try:
                        item = next(src)
                    except StopIteration:
                        exhausted = True
                        break
                    tasks.put((submitted, item))
                    submitted += 1
                if nxt >= submitted:
                    if exhausted:
                        return
                    continue
                with cond:
                    if nxt not in results:
                        t0 = time.perf_counter()
                        while nxt not in results:
                            cond.wait(0.1)
                        if self.stats is not None:
                            self.stats.observe(
                                f'{self.name}.wait_ms',
                                (time.perf_counter() - t0) * 1e3)
                            self.stats.inc(f'{self.name}.stall')
                    ok, val = results.pop(nxt)
                nxt += 1
                if not ok:
                    raise val
                yield val
        finally:
            # retire the workers: discard queued tasks (an abandoned or
            # errored stream must not keep decoding), then sentinel each
            while True:
                try:
                    tasks.get_nowait()
                except queue.Empty:
                    break
            for _ in threads:
                tasks.put(_STOP)
            for t in threads:
                t.join()
            if self.stats is not None:
                wall = max(time.perf_counter() - t_start, 1e-9)
                self.stats.gauge(f'{self.name}.workers', self.nworker)
                self.stats.gauge(f'{self.name}.occupancy',
                                 sum(busy) / (wall * self.nworker))
