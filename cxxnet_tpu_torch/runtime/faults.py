"""The failure taxonomy, the failure log, the retry policy and the
deterministic fault-injection plan, and the error for a key the port
lacks.

The port's own copy of ``cxxnet_tpu/runtime/faults.py``, the part the
training side runs:

* the serve taxonomy (``ServeError`` and its subclasses, the decode
  engine's among them) and the training faults (``DivergenceError``,
  ``PipelineStallError``, ``CheckpointCorruptError``) a supervisor
  restores from, so a caller handles the same typed outcomes from either
  package; ``DistInitError`` and ``ScanStrictError``;
* :class:`FailureLog` (``global_failure_log``, the failure listeners)
  and :class:`RetryPolicy`, whose backoff schedule is JAX's float for
  float (``random.Random((seed << 16) ^ crc32(op_name))``) and whose
  ``call`` records each failed attempt as ``io_retry``;
* :class:`FaultPlan`, the ``train.fault_plan=`` grammar's training
  events (``raise_on_write``, ``stall_write``, ``stall_batch``,
  ``corrupt_shard``, ``nan_at_step``) and the serving half of the chaos
  contract (``corrupt_model``, ``corrupt_kv``, ``slow_step``), each also
  ``@every=K``, driven through the ambient hooks (:func:`install_plan`,
  :func:`checkpoint_write_attempt`, :func:`pipeline_item`,
  :func:`shard_committed`, :func:`model_committed`,
  :func:`kv_record_committed`, :func:`decode_step`) that the checkpoint
  writers, the batch buffers, the KV spill store, the decode loop and
  the trainer's divergence gate call;
* the telemetry kinds: :class:`SLOBreachError` (the ``obs.slo``
  engine's breach) and :class:`RecompileStormError` (the program
  ledger's sentinel), and :func:`training_fault_kinds` /
  :func:`slo_breach_kinds`, the record kinds that arm a flight-recorder
  dump (``obs/hub.py``);
* :class:`FreshnessSLOError`, the train-while-serve freshness breach
  (``online/``): an ``SLOBreachError`` and a ``ServeError``;
* ``MemoryBudgetExceededError``, the serving fleet's typed refusal;
  ``PrefixIndexFullError`` and the tiered KV cache's ``KVTierError``
  family (``KVCorruptRecordError``, ``KVSpillError``).

The elastic events are refused by :meth:`FaultPlan.parse` with
``NotPortedError`` naming their item (``host_loss``, ``partition``),
and so are the elastic faults (``HostLossError``, ``CoordinatorUnreachableError``:
queue A item 9).
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


class NotPortedError(NotImplementedError):
    """A configuration the JAX package accepts but this port does not run
    yet.  The message names the ROADMAP.md item that will port it, so a
    setting is never dropped silently."""

    def __init__(self, what: str, roadmap: str):
        self.what = what
        self.roadmap = roadmap
        super().__init__(
            f'{what} is not ported to cxxnet_tpu_torch yet '
            f'(ROADMAP.md {roadmap})')


class TrainingFault(RuntimeError):
    """A failure a supervisor could recover from (restore the last good
    checkpoint and resume), as opposed to a programming error."""


class DivergenceError(TrainingFault):
    """Training diverged: non-finite loss under ``nan_action=halt`` or the
    consecutive-NaN circuit breaker tripped."""

    def __init__(self, step: int, loss: float, streak: int = 1):
        self.step = int(step)
        self.loss = float(loss)
        self.streak = int(streak)
        super().__init__(
            f'divergence at step {step}: loss={loss!r} '
            f'({streak} consecutive non-finite)')


class PipelineStallError(TrainingFault):
    """The data pipeline missed its per-batch deadline."""

    def __init__(self, batch_index: int, deadline: float):
        self.batch_index = int(batch_index)
        self.deadline = float(deadline)
        super().__init__(
            f'data pipeline stalled: batch {batch_index} not produced '
            f'within {deadline:g}s')


class CheckpointCorruptError(TrainingFault):
    """A checkpoint failed integrity verification on restore."""


def training_fault_kinds() -> set:
    """The record kinds that name a :class:`TrainingFault` (a supervisor
    records a fault under ``type(e).__name__``): what arms a
    flight-recorder dump."""
    return _kinds_under(TrainingFault)


def _kinds_under(base) -> set:
    out, stack = set(), [base]
    while stack:
        cls = stack.pop()
        out.add(cls.__name__)
        stack.extend(cls.__subclasses__())
    return out


class RecompileStormError(RuntimeError):
    """A program of the ledger (``obs/programs.py``) met more shape keys
    than its declared bound: a caller feeds it new shapes, and every new
    one pays a first call's set-up again.  Raised only under
    ``obs.recompile=raise``; the default ``warn`` records this kind into
    the failure log and counts ``recompiles_total``.  Neither a
    :class:`TrainingFault` (a restore replays the same shapes) nor a
    :class:`ServeError` (the trainer's programs are bounded too)."""

    def __init__(self, name: str, shape_key, bound: int, compiles: int):
        self.name = str(name)
        self.shape_key = shape_key
        self.bound = int(bound)
        self.compiles = int(compiles)
        super().__init__(
            f'program {name!r} compiled {compiles} times (shape-key '
            f'{shape_key!r}) but declared a bound of {bound}: recompile '
            'storm — fix the caller\'s shape bucketing, raise the '
            'declared bound, or set obs.recompile=warn to observe only')


class SLOBreachError(RuntimeError):
    """A declarative SLO (``slo.<name>=``, evaluated by ``obs/slo.py``)
    went BREACHED: its gauge violated the threshold over both the long
    and the short burn-rate window.  An observability outcome, never
    control flow in the serving or training path: the engine counts the
    breach and records this kind into the failure log (which arms the
    flight recorder's dump); strict callers raise it at run boundaries
    (``SLOEngine.check_strict``).  Not a :class:`TrainingFault`: a
    restore cannot repair a breached objective."""

    def __init__(self, msg: str, name: str = '', measure=None,
                 threshold=None, window: float = 0.0, ratio=None,
                 breaches: int = 1):
        self.name = str(name)
        self.measure = measure
        self.threshold = threshold
        self.window = float(window)
        self.ratio = ratio
        self.breaches = int(breaches)
        super().__init__(msg)


def slo_breach_kinds() -> set:
    """The record kinds that name an :class:`SLOBreachError`: the second
    family (after :func:`training_fault_kinds`) that arms a dump."""
    return _kinds_under(SLOBreachError)


class ServeError(RuntimeError):
    """Base of the online-serving failure taxonomy: per-request outcomes
    a client handles (shed load, retry elsewhere)."""


class ServeOverloadError(ServeError):
    """Admission control rejected a request: the batcher's bounded queue
    is full."""

    def __init__(self, queue_depth: int, max_queue: int):
        self.queue_depth = int(queue_depth)
        self.max_queue = int(max_queue)
        super().__init__(
            f'serve queue full: {queue_depth}/{max_queue} requests pending')


class DeadlineExceededError(ServeError):
    """A request's deadline elapsed before its batch executed (or before
    the result reached the caller)."""

    def __init__(self, deadline: float, waited: float, rows: int = 0):
        self.deadline = float(deadline)
        self.waited = float(waited)
        self.rows = int(rows)
        super().__init__(
            f'request deadline {deadline:g}s exceeded after {waited:.3f}s')


class RequestAbandonedError(ServeError):
    """The client stopped waiting before the engine ran the request, so
    the worker dropped it without executing (counted once, worker side)."""

    def __init__(self, waited: float = 0.0):
        self.waited = float(waited)
        super().__init__(
            f'request abandoned by client after {waited:.3f}s')


class TokenDeadlineExceededError(DeadlineExceededError):
    """A decode request's deadline elapsed mid-stream: some tokens were
    already emitted when the slot was reclaimed.  ``tokens_emitted`` is
    the partial progress."""

    def __init__(self, deadline: float, waited: float,
                 tokens_emitted: int = 0):
        super().__init__(deadline, waited, rows=1)
        self.tokens_emitted = int(tokens_emitted)
        self.args = (
            f'decode deadline {deadline:g}s exceeded after {waited:.3f}s '
            f'({tokens_emitted} tokens emitted)',)


class DecodeSlotsExhaustedError(ServeError):
    """A decode request this engine can never admit: its prompt bucket or
    horizon exceeds the slot cache, or it needs more KV pages than the
    empty pool holds.  Shed at once rather than queued forever."""

    def __init__(self, reason: str):
        super().__init__(f'decode request inadmissible: {reason}')


class DecodePagesExhaustedError(ServeError):
    """The paged KV pool ran dry mid-stream and this request, the
    youngest, was preempted so older streams could finish.
    ``tokens_emitted`` is the partial progress at shed time."""

    def __init__(self, tokens_emitted: int, pages: int):
        self.tokens_emitted = int(tokens_emitted)
        self.pages = int(pages)
        super().__init__(
            f'KV page pool exhausted ({pages} pages): request preempted '
            f'after {tokens_emitted} tokens')


class PrefixIndexFullError(ServeError):
    """A prompt's shareable prefix pages could not be published to the
    content-addressed prefix index: the ``serve.prefix_share`` page cap
    is smaller than the publish batch itself.  An observability outcome:
    the admission path records it and serves the request unshared."""

    def __init__(self, needed: int, cap: int):
        self.needed = int(needed)
        self.cap = int(cap)
        super().__init__(
            f'prefix index cannot hold {needed} pages '
            f'(serve.prefix_share cap is {cap}): request served unshared')


class KVTierError(ServeError):
    """Base of the tiered KV cache's failures (``serve/kvcache.py``).
    Each is an availability outcome: a tier that cannot deliver its rows
    reports a miss and the request re-prefills, so streams stay twins."""


class KVCorruptRecordError(KVTierError):
    """A spill record failed digest verification, or its header does not
    carry the exact key it was fetched for.  The store quarantines it
    (renamed aside, never re-read) and reports a miss."""

    def __init__(self, path: str, reason: str):
        self.path = str(path)
        self.reason = str(reason)
        super().__init__(
            f'corrupt KV spill record {path}: {reason} — quarantined, '
            'serving falls back to re-prefill')


class KVSpillError(KVTierError):
    """A spill write failed terminally (out of disk, permission loss).
    The entry is dropped — a cache never owes durability — and the
    failure is recorded."""

    def __init__(self, path: str, error: BaseException):
        self.path = str(path)
        super().__init__(f'KV spill to {path} failed: {error!r} — '
                         'entry dropped')


class FreshnessSLOError(SLOBreachError, ServeError):
    """The train-while-serve freshness SLO was breached: a hot-swapped
    model version took longer than ``online.freshness_slo`` seconds to
    travel from its optimizer step to the first request served on it.
    The per-swap (``window=0``) spec of the generic SLO engine, and a
    :class:`ServeError` for embedders that route serving outcomes by
    that base.  The pipeline counts breaches and raises only at run
    boundaries (strict mode): a stale but correct model keeps serving.
    Its breach records keep the historical ``freshness_slo_breach``
    kind, which arms no postmortem dump."""

    def __init__(self, step: int, freshness_s: float, slo_s: float,
                 breaches: int = 1):
        self.step = int(step)
        self.freshness_s = float(freshness_s)
        self.slo_s = float(slo_s)
        SLOBreachError.__init__(
            self,
            f'freshness SLO breached: checkpoint step {step} first served '
            f'{freshness_s:.3f}s after its optimizer step '
            f'(slo={slo_s:g}s, {breaches} breach(es) total)',
            name='freshness', measure=freshness_s, threshold=slo_s,
            breaches=breaches)


class MemoryBudgetExceededError(ServeError):
    """Loading a model would exceed the serve fleet's device-memory
    budget and no cold model could be evicted to make room."""

    def __init__(self, model_id: str, needed: int, budget: int,
                 resident: int):
        self.model_id = str(model_id)
        self.needed = int(needed)
        self.budget = int(budget)
        self.resident = int(resident)
        super().__init__(
            f'model {model_id!r} needs {needed} bytes but the serve '
            f'budget is {budget} with {resident} resident and nothing '
            'evictable (every loaded model is serving)')


class ScanStrictError(RuntimeError):
    """``scan_strict=1`` asserted the K-step window
    (``steps_per_dispatch``) and an ``ExecutionPlan`` demotion would have
    fallen back to per-step.  A configuration outcome, not a
    :class:`TrainingFault`: a run whose config contradicts itself is not
    restored and retried.  ``reason`` is the demotion key of
    ``nnet.execution.DEMOTION_REASONS``."""

    def __init__(self, reason: str, detail: str):
        self.reason = str(reason)
        super().__init__(
            f'scan_strict=1: steps_per_dispatch would demote to per-step '
            f'[{reason}]: {detail}')


class DistInitError(RuntimeError):
    """A distributed world's initialization was misconfigured (rank out
    of range, bad worker count) or exhausted its retry budget.  A
    launch-time outcome, not a :class:`TrainingFault`: there is no
    checkpoint to restore before a world exists."""


class FaultInjected(OSError):
    """A deterministic injected fault.  An ``OSError``, so the storage
    retry policies treat it as a real transient I/O error: the injection
    runs the production retry path."""


class RetryError(OSError):
    """Raised when a :class:`RetryPolicy` exhausts its attempts; carries
    the last underlying error as ``__cause__``."""

    def __init__(self, op_name: str, attempts: int, last: BaseException):
        self.op_name = op_name
        self.attempts = attempts
        super().__init__(
            f'{op_name}: failed after {attempts} attempts: {last!r}')


# --- failure log ----------------------------------------------------------


@dataclass
class FailureRecord:
    kind: str                      # e.g. 'stall', 'divergence', 'io_retry'
    detail: str
    step: Optional[int] = None
    monotonic: float = 0.0


#: called as ``fn(record, log)`` after a record lands in any FailureLog
_FAILURE_LISTENERS: List[Callable] = []


def add_failure_listener(fn: Callable) -> Callable:
    """Register ``fn(record, log)`` on every FailureLog record; returns
    ``fn`` for :func:`remove_failure_listener`."""
    if fn not in _FAILURE_LISTENERS:
        _FAILURE_LISTENERS.append(fn)
    return fn


def remove_failure_listener(fn: Callable) -> None:
    try:
        _FAILURE_LISTENERS.remove(fn)
    except ValueError:
        pass


class FailureLog:
    """Append-only, thread-safe record of faults seen and actions taken.
    A supervisor owns one; code without one reports to
    :func:`global_failure_log`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: List[FailureRecord] = []  # guarded-by: _lock

    def record(self, kind: str, detail: str,
               step: Optional[int] = None) -> FailureRecord:
        rec = FailureRecord(kind, detail, step, time.monotonic())
        with self._lock:
            self._records.append(rec)
        for fn in list(_FAILURE_LISTENERS):     # outside the lock
            try:
                fn(rec, self)
            except Exception:  # noqa: BLE001 — a listener never adds a fault
                pass
        return rec

    def records(self, kind: Optional[str] = None) -> List[FailureRecord]:
        with self._lock:
            out = list(self._records)
        if kind is not None:
            out = [r for r in out if r.kind == kind]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def summary(self) -> str:
        counts: Dict[str, int] = {}
        for r in self.records():
            counts[r.kind] = counts.get(r.kind, 0) + 1
        return ', '.join(f'{k}={v}' for k, v in sorted(counts.items())) \
            or 'no failures'


_GLOBAL_LOG = FailureLog()


def global_failure_log() -> FailureLog:
    return _GLOBAL_LOG


# --- retry policy ---------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff.

    ``delay(k) = min(max_delay, base_delay * multiplier**k) * (1 + j)``
    where ``j`` is uniform in ``[-jitter, +jitter]`` drawn from a seeded
    stream: the schedule is a pure function of (seed, op_name), so runs
    are reproducible.  ``sleep`` is injectable so tests assert the
    schedule without waiting it out."""

    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.1
    seed: int = 0
    retry_on: Tuple[type, ...] = (OSError, TimeoutError)
    sleep: Callable[[float], None] = time.sleep

    def delays(self, op_name: str = '') -> List[float]:
        """The full deterministic backoff schedule (one entry per retry)."""
        rng = random.Random((self.seed << 16)
                            ^ zlib.crc32(op_name.encode()))
        out = []
        for k in range(max(0, self.max_attempts - 1)):
            d = min(self.max_delay, self.base_delay * self.multiplier ** k)
            out.append(d * (1.0 + rng.uniform(-self.jitter, self.jitter)))
        return out

    def call(self, fn: Callable, op_name: str = 'storage_op',
             log: Optional[FailureLog] = None):
        """Run ``fn()`` retrying on ``retry_on`` with the backoff
        schedule, each failed attempt recorded as ``io_retry`` in ``log``
        (the global log by default); raises :class:`RetryError` (chained
        to the last error) once attempts are exhausted."""
        schedule = self.delays(op_name)
        last = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except self.retry_on as e:  # noqa: PERF203 — the slow path
                last = e
                # `is None`, not truthiness: an empty FailureLog is falsy
                (global_failure_log() if log is None else log).record(
                    'io_retry', f'{op_name} attempt {attempt + 1}/'
                    f'{self.max_attempts} failed: {e!r}')
                if attempt < len(schedule):
                    self.sleep(schedule[attempt])
        raise RetryError(op_name, self.max_attempts, last) from last


#: the checkpoint storage policy; writers take ``retry=`` defaulting to it
DEFAULT_IO_RETRY = RetryPolicy()

#: zero-delay variant for tests that only count attempts
NO_WAIT_RETRY = RetryPolicy(base_delay=0.0, max_delay=0.0, jitter=0.0,
                            sleep=lambda _t: None)


# --- deterministic fault injection ---------------------------------------

#: the elastic events of JAX's grammar -> the ROADMAP.md item that will
#: port them
UNPORTED_KINDS = {
    'host_loss': 'queue A item 9',
    'partition': 'queue A item 9',
}


def _parse_event(val: str) -> Tuple[int, Optional[float]]:
    """``"7"`` -> (7, None); ``"5:0.25"`` -> (5, 0.25)."""
    head, _, tail = val.partition(':')
    return int(head), (float(tail) if tail else None)


def _truncate(path: str) -> None:
    size = os.path.getsize(path)
    if size > 1:
        with open(path, 'r+b') as f:
            f.truncate(size // 2)
    else:
        os.unlink(path)


class FaultPlan:
    """A seeded plan of fault events, driven by ambient hooks.

    Event kinds (grammar ``kind=arg[;kind=arg...]``, parsed from the
    ``train.fault_plan=`` value by :meth:`parse`):

    * ``raise_on_write=N`` — the N-th checkpoint storage write attempt
      (1-based, counted across the process) raises :class:`FaultInjected`;
    * ``stall_write=N[:secs]`` — the N-th write attempt first sleeps
      ``secs`` (default 0.5): slow storage, for the async writer's
      backpressure and the restore barrier;
    * ``stall_batch=K[:secs]`` — the batch producer sleeps ``secs``
      (default 30) before handing over batch index K (0-based), tripping
      any consumer deadline shorter than that;
    * ``corrupt_shard=STEP`` — after the step checkpoint for ``STEP``
      commits, one of its payload files (a seeded choice) is truncated,
      so restore-time verification must catch it;
    * ``nan_at_step=S`` — the loss observed at sample step S reads as NaN;
    * ``corrupt_model=N`` — after the N-th model file commits (its bytes
      and digest sidecar both durable), the file is truncated, so a
      hot-reloading registry's digest check must reject it;
    * ``corrupt_kv=N`` — after the N-th tiered-KV spill record commits
      (record and crc32 sidecar durable, fired on the staged file before
      the rename makes it visible), the record is truncated, so the
      store's digest check must quarantine it and the request re-prefill;
    * ``slow_step=N[:secs]`` — the N-th decode engine loop iteration
      (1-based, counted per plan) first sleeps ``secs`` (default 0.05) on
      the loop thread, between token boundaries: the streams stay the
      fault-free run's, only their timing shifts.

    Each also takes the recurring form ``kind@every=K``: the event fires
    on every K-th occurrence of its hook (1-based counts, step multiples
    of K).  One-shot events fire at most once; step-keyed recurring
    events once per distinct step (a supervised replay revisits steps).
    :meth:`fired` lists what triggered (recurring firings tagged
    ``kind@every=K#occurrence``).  The hooks are thread-safe (the stall
    hook runs on the producer thread)."""

    KINDS = ('raise_on_write', 'stall_batch', 'stall_write',
             'corrupt_shard', 'nan_at_step', 'corrupt_model',
             'corrupt_kv', 'slow_step')

    def __init__(self, seed: int = 0,
                 raise_on_write: Tuple[int, ...] = (),
                 stall_batch: Tuple[Tuple[int, Optional[float]], ...] = (),
                 corrupt_shard: Tuple[int, ...] = (),
                 nan_at_step: Tuple[int, ...] = (),
                 stall_write: Tuple[Tuple[int, Optional[float]], ...] = (),
                 corrupt_model: Tuple[int, ...] = (),
                 raise_on_write_every: Tuple[int, ...] = (),
                 stall_batch_every: Tuple[Tuple[int, Optional[float]],
                                          ...] = (),
                 corrupt_shard_every: Tuple[int, ...] = (),
                 nan_at_step_every: Tuple[int, ...] = (),
                 stall_write_every: Tuple[Tuple[int, Optional[float]],
                                          ...] = (),
                 corrupt_model_every: Tuple[int, ...] = (),
                 corrupt_kv: Tuple[int, ...] = (),
                 corrupt_kv_every: Tuple[int, ...] = (),
                 slow_step: Tuple[Tuple[int, Optional[float]], ...] = (),
                 slow_step_every: Tuple[Tuple[int, Optional[float]],
                                        ...] = ()):
        def _periods(vals):
            out = set()
            for k in vals:
                if int(k) <= 0:
                    raise ValueError(f'@every period must be > 0, got {k}')
                out.add(int(k))
            return out

        self.seed = int(seed)
        self._raise_on_write = set(raise_on_write)
        self._stall = {k: (30.0 if s is None else s) for k, s in stall_batch}
        self._stall_write = {n: (0.5 if s is None else s)
                             for n, s in stall_write}
        self._corrupt = set(corrupt_shard)
        self._nan = set(nan_at_step)
        self._corrupt_model = set(corrupt_model)
        self._raise_every = _periods(raise_on_write_every)
        self._stall_every = {int(k): (30.0 if s is None else s)
                             for k, s in stall_batch_every}
        self._stall_write_every = {int(k): (0.5 if s is None else s)
                                   for k, s in stall_write_every}
        self._corrupt_every = _periods(corrupt_shard_every)
        self._nan_every = _periods(nan_at_step_every)
        self._corrupt_model_every = _periods(corrupt_model_every)
        self._corrupt_kv = set(corrupt_kv)
        self._corrupt_kv_every = _periods(corrupt_kv_every)
        self._slow_step = {n: (0.05 if s is None else s)
                           for n, s in slow_step}
        self._slow_step_every = {int(k): (0.05 if s is None else s)
                                 for k, s in slow_step_every}
        if 0 in self._stall_every or 0 in self._stall_write_every \
                or 0 in self._slow_step_every:
            raise ValueError('@every period must be > 0')
        self._nan_fired_steps: set = set()
        self._corrupt_fired_steps: set = set()
        self._write_count = 0
        self._decode_count = 0
        self._commits = {'model': 0, 'kv': 0}
        self._fired: List[str] = []
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> 'FaultPlan':
        from ..utils.config import parse_kv_list
        seed = 0
        kw: Dict[str, list] = {k: [] for k in cls.KINDS}
        kw.update({f'{k}_every': [] for k in cls.KINDS})
        timed = ('stall_batch', 'stall_write', 'slow_step',
                 'stall_batch_every', 'stall_write_every', 'slow_step_every')
        for key, val in parse_kv_list(text):
            if key == 'seed':
                seed = int(val)
                continue
            kind, at, mod = key.partition('@')
            if at and mod != 'every':
                raise ValueError(f'unknown fault_plan event: {key!r}')
            if kind in UNPORTED_KINDS:
                raise NotPortedError(f'train.fault_plan event {key}',
                                     UNPORTED_KINDS[kind])
            name = f'{kind}_every' if at else kind
            if name not in kw:
                raise ValueError(f'unknown fault_plan event: {key!r}')
            kw[name].append(_parse_event(val) if name in timed
                            else int(val))
        return cls(seed=seed, **{k: tuple(v) for k, v in kw.items()})

    # -- introspection --
    def fired(self) -> List[str]:
        with self._lock:
            return list(self._fired)

    def describe(self) -> str:
        """The plan in the grammar, in JAX's order."""
        parts = [f'seed={self.seed}']
        parts += [f'raise_on_write={n}' for n in sorted(self._raise_on_write)]
        parts += [f'raise_on_write@every={k}'
                  for k in sorted(self._raise_every)]
        parts += [f'stall_batch={k}:{s:g}'
                  for k, s in sorted(self._stall.items())]
        parts += [f'stall_batch@every={k}:{s:g}'
                  for k, s in sorted(self._stall_every.items())]
        parts += [f'stall_write={n}:{s:g}'
                  for n, s in sorted(self._stall_write.items())]
        parts += [f'stall_write@every={n}:{s:g}'
                  for n, s in sorted(self._stall_write_every.items())]
        parts += [f'corrupt_shard={s}' for s in sorted(self._corrupt)]
        parts += [f'corrupt_shard@every={s}'
                  for s in sorted(self._corrupt_every)]
        parts += [f'corrupt_model={s}' for s in sorted(self._corrupt_model)]
        parts += [f'corrupt_model@every={s}'
                  for s in sorted(self._corrupt_model_every)]
        parts += [f'nan_at_step={s}' for s in sorted(self._nan)]
        parts += [f'nan_at_step@every={s}' for s in sorted(self._nan_every)]
        parts += [f'slow_step={n}:{s:g}'
                  for n, s in sorted(self._slow_step.items())]
        parts += [f'slow_step@every={k}:{s:g}'
                  for k, s in sorted(self._slow_step_every.items())]
        parts += [f'corrupt_kv={n}' for n in sorted(self._corrupt_kv)]
        parts += [f'corrupt_kv@every={k}'
                  for k in sorted(self._corrupt_kv_every)]
        return ';'.join(parts)

    @staticmethod
    def _periodic_hit(count: int, periods) -> Optional[int]:
        """The period that makes occurrence ``count`` (1-based) fire, or
        None; the smallest matching period names the firing."""
        for k in sorted(periods):
            if count > 0 and count % k == 0:
                return k
        return None

    # -- hooks --
    def on_checkpoint_write(self, path: str) -> None:
        """Every checkpoint storage write attempt calls this first; the
        injected error is retryable (:class:`FaultInjected`)."""
        with self._lock:
            self._write_count += 1
            n = self._write_count
            secs = self._stall_write.pop(n, None)
            if secs is not None:
                self._fired.append(f'stall_write={n}:{secs:g}')
            else:
                k = self._periodic_hit(n, self._stall_write_every)
                if k is not None:
                    secs = self._stall_write_every[k]
                    self._fired.append(f'stall_write@every={k}#{n}')
            hit = n in self._raise_on_write
            if hit:
                self._raise_on_write.discard(n)
                self._fired.append(f'raise_on_write={n}')
            else:
                k = self._periodic_hit(n, self._raise_every)
                if k is not None:
                    hit = True
                    self._fired.append(f'raise_on_write@every={k}#{n}')
        if secs is not None:
            time.sleep(secs)
        if hit:
            raise FaultInjected(
                f'injected fault: checkpoint write #{n} to {path}')

    def on_pipeline_item(self, scope: str, index: int) -> None:
        """Producer-side hook, per item; only ``'batch'``-scoped buffers
        take part.  Recurring stalls count batches 1-based."""
        if scope != 'batch':
            return
        with self._lock:
            secs = self._stall.pop(index, None)
            if secs is not None:
                self._fired.append(f'stall_batch={index}:{secs:g}')
            else:
                k = self._periodic_hit(index + 1, self._stall_every)
                if k is not None:
                    secs = self._stall_every[k]
                    self._fired.append(f'stall_batch@every={k}#{index}')
        if secs is not None:
            time.sleep(secs)

    def has_nan_events(self) -> bool:
        with self._lock:
            return bool(self._nan) or bool(self._nan_every)

    def on_loss(self, step: int, loss: float) -> float:
        with self._lock:
            if step in self._nan:
                self._nan.discard(step)
                self._fired.append(f'nan_at_step={step}')
                return float('nan')
            k = self._periodic_hit(step, self._nan_every)
            if k is not None and step not in self._nan_fired_steps:
                self._nan_fired_steps.add(step)
                self._fired.append(f'nan_at_step@every={k}#{step}')
                return float('nan')
        return loss

    def on_shard_committed(self, step: int, path: str) -> None:
        """Truncate one payload file of a just-committed step checkpoint
        (a seeded pick, never the digest) so restore-time verification
        must reject it."""
        with self._lock:
            if step in self._corrupt:
                self._corrupt.discard(step)
                self._fired.append(f'corrupt_shard={step}')
            else:
                k = self._periodic_hit(step, self._corrupt_every)
                if k is None or step in self._corrupt_fired_steps:
                    return
                self._corrupt_fired_steps.add(step)
                self._fired.append(f'corrupt_shard@every={k}#{step}')
        victims = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                if f == 'ckpt_digest.json':
                    continue
                victims.append(os.path.join(root, f))
        if not victims:
            return
        _truncate(victims[random.Random(self.seed ^ step).randrange(
            len(victims))])

    def on_decode_step(self) -> None:
        """Every decode engine loop iteration calls this first (through
        :func:`decode_step`); the N-th sleeps its seconds there, off the
        engine lock and between token boundaries."""
        with self._lock:
            self._decode_count += 1
            n = self._decode_count
            secs = self._slow_step.pop(n, None)
            if secs is not None:
                self._fired.append(f'slow_step={n}:{secs:g}')
            else:
                k = self._periodic_hit(n, self._slow_step_every)
                if k is not None:
                    secs = self._slow_step_every[k]
                    self._fired.append(f'slow_step@every={k}#{n}')
        if secs is not None:
            time.sleep(secs)

    def on_model_committed(self, path: str) -> None:
        """After the N-th model-file commit (file and digest sidecar both
        durable), truncate the model file: its digest no longer matches,
        so a hot-reloading registry must reject it and keep the previous
        version serving."""
        if self._commit_hit('model', self._corrupt_model,
                            self._corrupt_model_every):
            _truncate(path)

    def on_kv_record_committed(self, path: str) -> None:
        """After the N-th tiered-KV spill record commit (record and
        sidecar durable; fired on the staged file, before the rename),
        truncate the record: the next promote's digest check must
        quarantine it."""
        if self._commit_hit('kv', self._corrupt_kv, self._corrupt_kv_every):
            _truncate(path)

    def _commit_hit(self, kind: str, once: set, every: set) -> bool:
        """Count one ``kind`` commit (``model`` or ``kv``) and say
        whether its ``corrupt_<kind>`` event (one-shot counts ``once``,
        periods ``every``) fires on it."""
        with self._lock:
            self._commits[kind] += 1
            n = self._commits[kind]
            if n in once:
                once.discard(n)
                self._fired.append(f'corrupt_{kind}={n}')
                return True
            k = self._periodic_hit(n, every)
            if k is not None:
                self._fired.append(f'corrupt_{kind}@every={k}#{n}')
                return True
        return False


# --- the ambient plan ------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-wide fault plan (None clears);
    returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    return prev


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def checkpoint_write_attempt(path: str) -> None:
    """Called at the top of every checkpoint storage write attempt."""
    plan = _ACTIVE
    if plan is not None:
        plan.on_checkpoint_write(path)


def pipeline_item(scope: Optional[str], index: int) -> None:
    plan = _ACTIVE
    if plan is not None and scope is not None:
        plan.on_pipeline_item(scope, index)


def shard_committed(step: int, path: str) -> None:
    plan = _ACTIVE
    if plan is not None:
        plan.on_shard_committed(step, path)


def decode_step() -> None:
    """Called once at the top of every decode engine loop iteration (see
    :meth:`FaultPlan.on_decode_step`); a no-op without a plan."""
    plan = _ACTIVE
    if plan is not None:
        plan.on_decode_step()


def model_committed(path: str, staged: Optional[str] = None) -> None:
    """Call when a model file's bytes and digest are both durable.  The
    save-then-digest path (``checkpoint.write_model_digest``) calls it
    after the commit, so a corruption lands on the live file; the
    publish path (``checkpoint.publish_model_file``) passes ``staged=``,
    the file before its rename, so verification always catches it."""
    plan = _ACTIVE
    if plan is not None:
        plan.on_model_committed(path if staged is None else staged)


def kv_record_committed(path: str, staged: Optional[str] = None) -> None:
    """Call when a tiered-KV spill record's bytes and digest sidecar are
    both durable; ``staged=`` is the pre-rename temp file, so an injected
    corruption (``corrupt_kv=N``) lands before the record is visible."""
    plan = _ACTIVE
    if plan is not None:
        plan.on_kv_record_committed(path if staged is None else staged)
