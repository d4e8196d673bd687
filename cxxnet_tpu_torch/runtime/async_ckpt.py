"""Asynchronous checkpointing: the save path off the step loop.

The port's own copy of ``cxxnet_tpu/runtime/async_ckpt.py``:

1. **Snapshot** — at the save boundary every tensor of the tree is cloned
   on the card (:func:`snapshot_tree`), enqueued on the compute stream
   with no wait, and an event is recorded after the clones.  The trainer
   updates its parameters, optimizer slots and accumulator in place, so
   the writer must never read the live tensors: the next step would
   change them under it.
2. **Background write** — :class:`AsyncCheckpointer` hands the snapshot
   to a committer thread, which copies it to the host on a stream of its
   own that first waits on the snapshot's event (:func:`host_tree`) and
   writes it with ``nnet.sharded_ckpt.save_tree_native``: leaf files in
   parallel over ``workers`` threads, one directory rename, the crc32
   digest, as a synchronous save writes them.
3. **Double buffer** — at most one save is in flight.  A boundary that
   arrives before the previous write committed blocks until it has
   (never mid-step).

A failed background write (its retries spent) is recorded as
``async_save_failed`` in the failure log and re-raised at the next
barrier (``submit`` / ``wait``); the restore path barriers with
:meth:`AsyncCheckpointer.drain`, which does not re-raise, so a failed
save never blocks a recovery.  Validity gates (the supervisor's NaN-streak
rule) are settled before ``submit``: a queued snapshot is committed.
Each background write runs in a ``ckpt.commit`` span on the writer's
thread (``obs/``), as in JAX.

JAX's multi-host check (``TrainSupervisor._async_usable``: state sharded
across hosts falls back to synchronous saves) is absent, not stubbed: the
port trains in one process, whose state is all on its card.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..nnet.sharded_ckpt import map_with_keys
from . import faults


class Snapshot(dict):
    """A snapshot tree (a dict) and ``ready``, the event of its device
    clones (None when every leaf is on the host)."""
    ready = None


def _map(fn, tree):
    return map_with_keys(lambda _key, leaf: fn(leaf), tree)


def snapshot_tree(tree) -> Snapshot:
    """A copy of ``tree`` a background writer may read while training goes
    on: tensors cloned where they live (a card's clones enqueued on the
    current stream, ``ready`` recorded after them), host leaves copied at
    once (the trainer bumps its counters in place)."""
    cuda = []

    def snap(x):
        if isinstance(x, torch.Tensor):
            y = x.detach().clone()
            if y.is_cuda:
                cuda.append(y)
            return y
        return np.copy(np.asarray(x))

    out = Snapshot(_map(snap, tree))
    if cuda:
        out.ready = torch.cuda.Event()
        out.ready.record(torch.cuda.current_stream(cuda[0].device))
    return out


_COPY_STREAMS = {}
_COPY_LOCK = threading.Lock()


def _copy_stream(device):
    with _COPY_LOCK:
        s = _COPY_STREAMS.get(device)
        if s is None:
            s = _COPY_STREAMS[device] = torch.cuda.Stream(device)
        return s


def host_tree(tree, ready=None):
    """The snapshot on the host, as numpy arrays — the blocking half of
    the copy, for the writer thread.  Card tensors cross on a copy stream
    that first waits on ``ready`` (default: the snapshot's own event), so
    the copy starts once the clones are done, not behind later steps."""
    ready = getattr(tree, 'ready', None) if ready is None else ready
    streams = {}

    def host(x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        if x.is_cuda:
            s = streams.get(x.device)
            if s is None:
                s = streams[x.device] = _copy_stream(x.device)
                if ready is not None:
                    s.wait_event(ready)
            with torch.cuda.stream(s):
                x = x.to('cpu')
        if x.dtype == torch.bfloat16:
            return x          # numpy has no bfloat16: the writer takes it
        return x.numpy()

    return _map(host, tree)


class AsyncCheckpointer:
    """Background checkpoint writer: double-buffered, retried, its
    failures logged.  One committer thread serializes the saves;
    ``workers`` bounds the leaf writes within one save."""

    def __init__(self, workers: int = 2,
                 failure_log: Optional[faults.FailureLog] = None):
        self.workers = max(1, int(workers))
        # `is None`, not truthiness: an empty FailureLog is falsy
        self.failure_log = (faults.global_failure_log()
                            if failure_log is None else failure_log)
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='ckpt_commit')
        # the leaf-write pool, apart from the committer, so one worker
        # cannot deadlock the orchestration on its own pool
        self._io = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix='ckpt_io')
        self._lock = threading.Lock()
        self._future: Optional[Future] = None
        self._in_flight = 0   # guarded-by: _lock
        self.commits = 0      # guarded-by: _lock
        self.submits = 0
        self._closed = False

    def submit(self, fn: Callable[[], object], step: Optional[int] = None,
               label: str = 'ckpt') -> Future:
        """Queue ``fn()`` — the whole write — on the background writer.
        Blocks until the previous save commits (the double buffer) and
        re-raises its deferred failure."""
        if self._closed:
            raise RuntimeError('AsyncCheckpointer is closed')
        self.wait()

        def task():
            from ..obs import span
            with self._lock:
                self._in_flight += 1
            try:
                with span('ckpt.commit', 'ckpt', step=step, label=label):
                    out = fn()
                with self._lock:
                    self.commits += 1
                return out
            except BaseException as e:
                self.failure_log.record(
                    'async_save_failed', f'{label}: {e!r}', step=step)
                raise
            finally:
                with self._lock:
                    self._in_flight -= 1

        self.submits += 1
        self._future = self._committer.submit(task)
        return self._future

    def wait(self) -> None:
        """Barrier: block until the in-flight save (if any) commits, and
        re-raise its failure.  A run's final save always passes here."""
        f, self._future = self._future, None
        if f is not None:
            f.result()

    def drain(self) -> None:
        """The restore path's barrier: wait for the in-flight save but
        swallow its failure (already in the failure log), so recovery
        falls back to the previous good checkpoint."""
        f, self._future = self._future, None
        if f is not None:
            try:
                f.result()
            except BaseException:  # noqa: BLE001 — recorded by task()
                pass

    def pending(self) -> bool:
        f = self._future
        return f is not None and not f.done()

    @property
    def io_pool(self) -> ThreadPoolExecutor:
        """The leaf-write pool (``workers`` wide), for jobs that write
        trees themselves (the CLI's exact-sidecar job)."""
        return self._io

    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def close(self, wait: bool = True) -> None:
        """Drain and shut the pools down.  Idempotent."""
        if self._closed:
            return
        if wait:
            self.drain()
        self._closed = True
        self._committer.shutdown(wait=wait)
        self._io.shutdown(wait=wait)

    def save_sharded_async(self, ckpt_dir: str, step: int, snapshot,
                           retry: Optional[faults.RetryPolicy] = None,
                           on_commit: Optional[Callable[[str], None]] = None
                           ) -> Future:
        """Queue a native step checkpoint of ``snapshot`` (a
        :func:`snapshot_tree` result) at ``step``: the host copy, the
        leaf writes over the io pool, the commit, the digest and then
        ``on_commit(path)`` all run on the writer."""
        from ..nnet.sharded_ckpt import save_tree_native

        def job():
            path = save_tree_native(
                ckpt_dir, step, host_tree(snapshot), retry=retry,
                pool=self._io)
            if on_commit is not None:
                on_commit(path)
            return path

        return self.submit(job, step=step, label=f'save_sharded:step_{step}')
