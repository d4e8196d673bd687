"""Supervised training: watchdog, circuit breaker, restore and resume.

The port's own copy of ``cxxnet_tpu/runtime/supervisor.py``.
:class:`TrainSupervisor` runs a trainer's step loop under supervision::

    RUNNING --fault--> FAILED --(restarts left)--> RESTORING --> RUNNING
                          |                                        ^
                          +--(max_restarts exhausted)--> raise      |
                                   anchor/periodic checkpoints -----+

Faults, each a ``faults.TrainingFault``:

* **pipeline stall** — batches come through a ``utils.thread_buffer.
  ThreadBuffer`` with a per-batch ``deadline``; a producer that misses it
  raises ``PipelineStallError``;
* **divergence** — the trainer's ``nan_action=halt`` / ``nan_breaker``
  gate raises ``DivergenceError`` (the supervisor installs its breaker);
* **corrupt checkpoint** — a restore verifies digests and falls back to
  the newest intact step (``sharded_ckpt.restore_resilient``).

Recovery restores the exact-resume state (params, optimizer slots,
gradient accumulator, counters; ``NetTrainer.save_training_state``) and
re-winds the batch stream to the restored ``sample_counter``.  A step's
random draws are a pure function of the counters, so a run that faulted
and recovered ends bitwise equal to an uninterrupted run from the same
seed.  ``batch_factory(k)`` returns an iterator over batch k, k+1, ... of
the epoch; it is called again after every restore.

Saves, the save barrier and restores run in ``train.save`` /
``train.save_barrier`` / ``train.restore`` spans of the telemetry hub
(``obs/``), as in JAX.  JAX's multi-host ``_async_usable`` check is
absent: the port trains in one process.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..obs import span
from ..utils.thread_buffer import ThreadBuffer
from . import faults


@dataclass
class SupervisorConfig:
    """Knobs for one supervised run (the ``train.*`` keys of main.py)."""

    batch_deadline: Optional[float] = 60.0   # None disables the watchdog
    max_restarts: int = 3                    # per run() call
    nan_breaker: int = 3                     # 0 keeps the trainer's own
    save_every: int = 0                      # steps between periodic saves
    buffer_size: int = 2                     # watchdog prefetch depth
    keep_last: int = 4                       # steps kept (0 = all); also
                                             # the corrupt-fallback depth
    save_async: int = 0                      # 1 = background writer
    save_workers: int = 2                    # leaf-write threads a save
    # the train chain's StatSet when its pool is on (nworker): the
    # watchdog's stalls land there, and the first batch, which also fills
    # the pool's window, gets twice the grace
    pipeline_stats: Optional[object] = None
    retry: faults.RetryPolicy = field(
        default_factory=lambda: faults.DEFAULT_IO_RETRY)
    # called as on_save(step) after every accepted save (anchor,
    # periodic, final), so only where the NaN gate let a save through: a
    # listener that mirrors the params elsewhere (the online pipeline's
    # serving model files) never publishes poisoned params.  Runs on the
    # step loop's thread at a window boundary: keep it snapshot-cheap
    on_save: Optional[Callable[[int], None]] = None


class TrainSupervisor:
    """A trainer's step loop under watchdog and recovery supervision.
    ``run()`` may be called once a round; checkpoints accumulate in
    ``ckpt_dir`` and the restart budget is per call."""

    #: the faults that restore and resume; anything else propagates
    RECOVERABLE = (faults.PipelineStallError, faults.DivergenceError,
                   faults.CheckpointCorruptError)

    def __init__(self, trainer, ckpt_dir: str,
                 config: Optional[SupervisorConfig] = None,
                 failure_log: Optional[faults.FailureLog] = None):
        self.trainer = trainer
        self.ckpt_dir = ckpt_dir
        self.config = config or SupervisorConfig()
        # `is None`, not truthiness: an empty FailureLog is falsy
        self.failure_log = (faults.global_failure_log()
                            if failure_log is None else failure_log)
        self.state = 'IDLE'
        self.restarts_total = 0
        self._async = None
        if self.config.save_async:
            from .async_ckpt import AsyncCheckpointer
            self._async = AsyncCheckpointer(
                workers=self.config.save_workers,
                failure_log=self.failure_log)
        if self.config.nan_breaker and not trainer.nan_breaker:
            trainer.nan_breaker = self.config.nan_breaker

    # --- checkpoints --------------------------------------------------------
    def save(self) -> str:
        """Checkpoint the exact-resume state at the current sample step.
        An existing dir for the step is replaced, never trusted: a
        same-step save from a later round carries other counters.  With
        ``save_async`` the step loop pays the snapshot (device clones)
        and any backpressure from the previous save; the write, the
        digest and the pruning run on the writer.  The caller settles the
        NaN gate before calling."""
        from ..nnet import sharded_ckpt
        tr = self.trainer
        step = tr.sample_counter
        if self._async is not None:
            with span('train.save', 'train', step=step, mode='async'):
                self._async.save_sharded_async(
                    self.ckpt_dir, step, tr.snapshot_training_state(),
                    retry=self.config.retry,
                    on_commit=lambda _p: self._prune())
            if self.config.on_save is not None:
                self.config.on_save(step)
            return sharded_ckpt.step_dir(self.ckpt_dir, step)
        with span('train.save', 'train', step=step, mode='sync'):
            old = sharded_ckpt.step_dir(self.ckpt_dir, step)
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            path = tr.save_training_state(self.ckpt_dir, step,
                                          retry=self.config.retry)
        self._prune()
        if self.config.on_save is not None:
            self.config.on_save(step)
        return path

    def wait_for_saves(self) -> None:
        """Barrier on the async writer (a no-op in sync mode): the
        in-flight save commits and its deferred failure re-raises."""
        if self._async is not None:
            with span('train.save_barrier', 'train'):
                self._async.wait()

    def close(self) -> None:
        """Release the background writer's threads (drains first); sync
        saves still work afterwards."""
        if self._async is not None:
            self._async.close()
            self._async = None

    def _prune(self) -> None:
        """Keep the ``keep_last`` newest intact steps, and as many
        quarantined ``.corrupt`` dirs (full-size checkpoints too)."""
        from ..nnet import sharded_ckpt
        keep = self.config.keep_last
        if not keep:
            return
        for step in sharded_ckpt.all_steps(self.ckpt_dir)[keep:]:
            shutil.rmtree(sharded_ckpt.step_dir(self.ckpt_dir, step),
                          ignore_errors=True)
        for step in sharded_ckpt.quarantined_steps(self.ckpt_dir)[keep:]:
            shutil.rmtree(
                sharded_ckpt.step_dir(self.ckpt_dir, step) + '.corrupt',
                ignore_errors=True)

    def restore(self) -> int:
        """Restore the newest intact checkpoint (quarantining corrupt
        ones) into the trainer, after clearing the per-step state the
        fault may have poisoned.  A pending async save is drained first:
        the newest step may still be committing."""
        if self._async is not None:
            self._async.drain()
        tr = self.trainer
        with span('train.restore', 'train'):
            tr.reset_transient_state()
            step = tr.load_training_state(self.ckpt_dir,
                                          restore_params=True,
                                          fallback=True,
                                          retry=self.config.retry)
        self.failure_log.record('restored', f'resumed from step {step}',
                                step=step)
        return step

    # --- the supervised loop ------------------------------------------------
    def run(self, batch_factory: Callable[[int], Iterator],
            n_steps: Optional[int] = None,
            before_step: Optional[Callable[[int], None]] = None,
            make_stepper: Optional[Callable[[], object]] = None) -> int:
        """The supervised step loop over one epoch of batches; returns
        the updates applied.

        Runs until at least ``n_steps`` updates were applied this call (a
        K-step window may overshoot by up to K-1 inside the dispatch that
        crosses the budget; staged batches beyond it are dropped), or the
        factory's iterator ends.  ``before_step(i)`` runs before each
        batch (i = batches consumed this call).  ``make_stepper`` builds
        a fresh ``nnet.execution.WindowedStepper`` each (re)start
        (``ExecutionPlan.round_stepper(trainer, lookahead=0)``), so a
        fault mid-window abandons the staged batches and the re-wound
        stream pulls them again; the default is the per-step loop.  A
        periodic save fires when a dispatch crosses a ``save_every``
        multiple, after the deferred divergence gate settles and only
        with no NaN streak open.  On a recoverable fault: log, restore,
        re-wind, continue; past ``max_restarts`` the fault propagates."""
        from ..nnet.execution import WindowedStepper
        cfg = self.config
        tr = self.trainer
        base = tr.sample_counter
        # the anchor: recovery never rolls back past this run's entry,
        # unless a NaN streak is open there (the params may be poisoned,
        # and recovery may then roll back past base)
        anchored = tr.nan_streak == 0
        last_saved = None
        if anchored:
            self.save()
            last_saved = tr.sample_counter
        else:
            self.failure_log.record(
                'save_skipped',
                f'anchor skipped: {tr.nan_streak} non-finite loss(es) '
                'open at run() entry', step=tr.sample_counter)
        restarts = 0
        self.state = 'RUNNING'
        while True:
            start = tr.sample_counter - base
            # the first batch after a (re)start includes epoch setup and
            # the re-wind of `start` batches: at least 5x the deadline
            first = None if cfg.batch_deadline is None \
                else cfg.batch_deadline * max(5, start + 1)
            if first is not None and cfg.pipeline_stats is not None:
                first *= 2
            buf = ThreadBuffer(lambda s=start: batch_factory(s),
                               buffer_size=cfg.buffer_size,
                               deadline=cfg.batch_deadline,
                               first_deadline=first,
                               fault_scope='batch',
                               fault_base=start)
            buf.stats = cfg.pipeline_stats
            stepper = (make_stepper() if make_stepper is not None
                       else WindowedStepper(tr, k=1, lookahead=0))
            fed = start
            try:
                for batch in buf:
                    if before_step is not None:
                        before_step(fed)
                    fed += 1
                    delta = stepper.feed(batch)
                    done = tr.sample_counter - base
                    if delta and cfg.save_every \
                            and done % cfg.save_every < delta:
                        # never checkpoint NaN-poisoned params: settle
                        # the deferred gate, skip while a streak is open
                        tr.flush_divergence_check()
                        if tr.nan_streak == 0:
                            self.save()
                            last_saved = tr.sample_counter
                    if n_steps is not None and done >= n_steps:
                        stepper.discard()
                        break
                # the tail (a part-filled window) and the last step's
                # deferred gate settle inside the try
                stepper.finish()
                tr.flush_divergence_check()
            except self.RECOVERABLE as e:
                self.state = 'FAILED'
                # quiesce the producer before restoring: it would go on
                # pulling batches (and firing fault events) underneath
                buf.close(timeout=5.0)
                self.failure_log.record(
                    type(e).__name__, str(e), step=tr.sample_counter)
                restarts += 1
                self.restarts_total += 1
                if restarts > cfg.max_restarts:
                    self.failure_log.record(
                        'giving_up',
                        f'{restarts - 1} restarts exhausted '
                        f'({self.failure_log.summary()})',
                        step=tr.sample_counter)
                    if self._async is not None:
                        self._async.drain()
                    raise
                self.state = 'RESTORING'
                self.restore()
                if anchored and tr.sample_counter < base:
                    raise faults.CheckpointCorruptError(
                        f'restored to step {tr.sample_counter}, before '
                        f'this run\'s anchor {base}')
                if tr.sample_counter < base:
                    base = tr.sample_counter
                self.state = 'RUNNING'
            else:
                if tr.nan_streak != 0:
                    self.failure_log.record(
                        'save_skipped',
                        f'final save skipped: {tr.nan_streak} non-finite '
                        'loss(es) open', step=tr.sample_counter)
                elif last_saved != tr.sample_counter:
                    self.save()
                # the final save always barriers
                self.wait_for_saves()
                self.state = 'IDLE'
                return tr.sample_counter - base
            finally:
                buf.close(timeout=5.0)
