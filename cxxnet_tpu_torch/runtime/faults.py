"""The serving and training error types, and the error for a key the
port lacks.

The port's own copies of the serve taxonomy in
``cxxnet_tpu/runtime/faults.py`` (``ServeError`` and its subclasses,
the decode engine's among them) and of the training faults the trainer
and the input pipeline raise (``DivergenceError``,
``PipelineStallError``), so a caller handles the
same typed outcomes from either package, and of what
``parallel/distributed.py`` needs to join a world: ``DistInitError``,
``RetryError`` and a ``RetryPolicy`` without the failure log, and
``ScanStrictError``, which ``nnet/execution.py`` raises.  The
supervisor, fault plans and the failure log of that module come with
ROADMAP.md queue A item 5.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Callable, List, Tuple


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


class RetryError(OSError):
    """Raised when a :class:`RetryPolicy` exhausts its attempts; carries
    the last underlying error as ``__cause__``."""

    def __init__(self, op_name: str, attempts: int, last: BaseException):
        self.op_name = op_name
        self.attempts = attempts
        super().__init__(
            f'{op_name}: failed after {attempts} attempts: {last!r}')


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

    def call(self, fn: Callable, op_name: str = 'op'):
        """Run ``fn()`` retrying on ``retry_on`` with the backoff
        schedule; raises :class:`RetryError` (chained to the last error)
        once attempts are exhausted."""
        schedule = self.delays(op_name)
        last = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except self.retry_on as e:  # noqa: PERF203 — the slow path
                last = e
                if attempt < len(schedule):
                    self.sleep(schedule[attempt])
        raise RetryError(op_name, self.max_attempts, last) from last
