"""Profiling: the ``profile_dir`` trace window over ``torch.profiler``.

The port's own copy of ``cxxnet_tpu/utils/profiler.py``, with
``torch.profiler`` where JAX uses ``jax.profiler``.  Config surface
(global section)::

    profile_dir = traces        # enables tracing; directory for the trace
    profile_start_batch = 10    # first update() covered (default 10,
    profile_stop_batch = 20     #   skipping warm-up) .. last (exclusive)

The window is batch-based so the first steps (the kernel builds, the
allocator's first blocks) are excluded by default.  It writes
``trace_<pid>.json`` (a Chrome trace: Perfetto, chrome://tracing) and
``launches_<pid>.json`` (each kernel's ``ops/launches`` count over the
window, and the ms the stop and the export took) into ``profile_dir``.
On a card it traces ``ProfilerActivity.CUDA`` too; the device is
synchronized before the start (nothing launched earlier is in flight)
and before the stop (every launch of the window has run), and
``WARM_KERNELS`` empty kernels run on a stream of their own right after
the start; a window that launched kernels but traced no device event
raises rather than keep a host-only trace.

:func:`acquire_trace` arbitrates the one profiler a process may run:
the trace window and the on-demand ``/profile`` session
(``obs/programs.ProfilerSession``) never both start one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Tuple

#: empty kernels (``spin_kernel``) launched right after a start, before
#: the traced work.  In a process that has already run many traces, a
#: start can lose the kernel records of its first launches (on an H100
#: with CUPTI 26: the first 49-59 by correlation id, each launch itself
#: traced); the burst takes that loss in place of the window's kernels
WARM_KERNELS = 256

# --- single-flight arbitration ---------------------------------------------
# torch.profiler (Kineto) runs ONE profiler per process: the config-driven
# TraceWindow and the on-demand /profile session must never both start
# one.  Whoever acquires the slot owns the profiler until release; the
# loser observes busy.
_TRACE_LOCK = threading.Lock()
_TRACE_OWNER: Optional[str] = None        # guarded-by: _TRACE_LOCK


def acquire_trace(owner: str) -> bool:
    """Claim the process-wide profiler slot for ``owner``; False when ANY
    owner holds it — deliberately non-reentrant, so a stop racing a fresh
    start can never hand two sessions the same slot (the caller must not
    start a trace on False)."""
    global _TRACE_OWNER
    with _TRACE_LOCK:
        if _TRACE_OWNER is not None:
            return False
        _TRACE_OWNER = owner
        return True


def release_trace(owner: str) -> None:
    """Release the slot (no-op unless ``owner`` holds it)."""
    global _TRACE_OWNER
    with _TRACE_LOCK:
        if _TRACE_OWNER == owner:
            _TRACE_OWNER = None


def trace_owner() -> Optional[str]:
    with _TRACE_LOCK:
        return _TRACE_OWNER


def start_profiler(sync: bool = True):
    """Start one ``torch.profiler.profile`` (CPU, and CUDA whenever a card
    is present) and return it; ``sync`` first waits for the device, so
    nothing launched before the start is in flight.  Raises when a card
    is present but the profiler cannot trace it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError('torch.profiler cannot trace the CUDA '
                               'device here (no CUPTI): refusing a '
                               'host-only trace')
        acts.append(ProfilerActivity.CUDA)
        if sync:
            torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.start()
    if torch.cuda.is_available() and WARM_KERNELS:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            for _ in range(WARM_KERNELS):
                torch.cuda._sleep(0)
        side.synchronize()
    return prof


def stop_profiler(prof, path: str, launched: int = 0) -> str:
    """Stop ``prof`` (after a device synchronize, so every launch of the
    window has run) and write its Chrome trace to ``path``.  ``launched``
    (the port's kernel launches in the window) > 0 with no kernel event
    in the trace raises: the trace would hide the device."""
    import torch
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    if cuda and launched > 0:
        with open(path) as f:
            traced = any(e.get('cat') == 'kernel'
                         for e in json.load(f).get('traceEvents', ()))
        if not traced:
            raise RuntimeError(f'torch.profiler traced no kernel over a '
                               f'window of {launched} kernel launches '
                               f'({path})')
    return path


class TraceWindow:
    """Start/stop ``torch.profiler`` around a window of training batches
    (``profile_dir`` / ``profile_start_batch`` / ``profile_stop_batch``).
    After :meth:`stop`, ``path`` is the trace file and ``launches`` each
    kernel's launch count over the window."""

    def __init__(self):
        self.profile_dir = ''
        self.start_batch = 10
        self.stop_batch = 20
        self.path: Optional[str] = None
        self.launches: Optional[dict] = None
        self._prof = None
        self._counts0 = None
        self._done = False

    def set_param(self, name: str, val: str) -> None:
        if name == 'profile_dir':
            self.profile_dir = val
        if name == 'profile_start_batch':
            self.start_batch = int(val)
        if name == 'profile_stop_batch':
            self.stop_batch = int(val)

    def configure(self, cfg: List[Tuple[str, str]]) -> None:
        for name, val in cfg:
            self.set_param(name, val)

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def before_update(self, batch_counter: int) -> None:
        """Call before each update; ``batch_counter`` counts from 0."""
        if not self.enabled or self._done:
            return
        if self._prof is None and batch_counter >= self.start_batch:
            # single-flight against the on-demand /profile session: when
            # one is mid-trace, retry at the next batch instead of
            # stacking a second profiler
            if not acquire_trace('profile_dir'):
                return
            from ..ops import launches
            try:
                os.makedirs(self.profile_dir, exist_ok=True)
                self._counts0 = launches.counts()
                self._prof = start_profiler()
            except BaseException:
                release_trace('profile_dir')
                raise
        elif self._prof is not None and batch_counter >= self.stop_batch:
            self.stop()

    def stop(self) -> None:
        """Finish the trace (idempotent; also called at the end of
        training)."""
        if self._prof is None:
            return
        from ..ops import launches
        prof, self._prof = self._prof, None
        self._done = True
        try:
            now = launches.counts()
            delta = {k: now[k] - self._counts0.get(k, 0) for k in now
                     if now[k] != self._counts0.get(k, 0)}
            pid = os.getpid()
            t0 = time.perf_counter()
            self.path = stop_profiler(
                prof, os.path.join(self.profile_dir, f'trace_{pid}.json'),
                launched=sum(delta.values()))
            self.launches = delta
            with open(os.path.join(self.profile_dir,
                                   f'launches_{pid}.json'), 'w') as f:
                json.dump({'start_batch': self.start_batch,
                           'stop_batch': self.stop_batch,
                           'stop_ms': (time.perf_counter() - t0) * 1e3,
                           'launches': delta}, f, sort_keys=True)
        finally:
            release_trace('profile_dir')
