"""ExecutionPlan: one step loop for every training run.

PyTorch counterpart of ``cxxnet_tpu/nnet/execution.py``.

* :class:`ExecutionPlan` resolves the requested ``steps_per_dispatch``
  (K) once per run.  The static demotions are profiling (``profile_dir``:
  a trace window cannot bracket steps inside one window) and ``test_io``
  (nothing is dispatched at all); gradient accumulation and train
  metrics run in the window.
* :class:`WindowedStepper` is the loop body of a round: ``feed`` stages a
  batch (the copy is only enqueued) and runs a window of K steps when it
  fills, or, at K=1, one step with one staged batch riding ahead;
  ``finish`` runs the tail per step.  The one runtime demotion, a batch
  carrying ``extra_data``, demotes the current round only.
* ``scan_strict=1`` turns any demotion into ``runtime.faults.
  ScanStrictError``.

The window is ``NetTrainer.compile_multi_step``: K eager steps behind
one host call, with one readback of the losses when the divergence gate
is armed and the train metrics read one window late; each step is the
per-step path's own code, so a window is bitwise K single steps.

Telemetry, as in JAX: each resolve registers the ``execution_plan``
``/statusz`` provider (K, the demotions, the ledger's ``flops_per_step``
of the trainer the plan last stepped), and a ``train.dispatch`` span
brackets each single step and each K-step window — dispatches, never the
steps inside a window.  JAX's ``measured_probe`` (autotune, ROADMAP.md
queue A item 10) is not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..obs import get_hub, span
from ..runtime import faults

#: every way the K-step window can demote to per-step, keyed by the
#: reason tag that ``scan_strict`` errors and fallback notes carry (JAX's
#: keys)
DEMOTION_REASONS = {
    'profile_dir': 'the trace window brackets per-step dispatches — '
                   'inside a window there is nothing to start/stop the '
                   'profiler between',
    'test_io': 'test_io=1 dispatches no compute at all',
    'extra_data': 'the window carries data+label+mask only; an '
                  'attachtxt chain\'s extra_data demotes this round '
                  '(re-probed next round)',
}

#: reasons resolved once at plan creation vs. detected mid-round
STATIC_REASONS = ('profile_dir', 'test_io')
RUNTIME_REASONS = ('extra_data',)


class ExecutionPlan:
    """The resolved step-loop shape of one training run.  Build with
    :meth:`resolve`, then take one :class:`WindowedStepper` a round
    (:meth:`round_stepper`); window functions are kept on the plan across
    rounds, keyed by ``(K, train_eval)``."""

    def __init__(self, requested_k: int, k: int, strict: bool = False,
                 silent: bool = False):
        self.requested_k = int(requested_k)
        self.k = int(k)
        self.strict = bool(strict)
        self.silent = bool(silent)
        self._noted = set()
        self._scan_fns = {}

    @classmethod
    def resolve(cls, requested_k: int, profiling: bool = False,
                test_io: bool = False, strict: bool = False,
                silent: bool = False) -> 'ExecutionPlan':
        """The effective plan of this run.  Raises ``ScanStrictError``
        when ``strict`` and a static demotion applies; otherwise a
        demotion prints one note per reason."""
        k = max(1, int(requested_k))
        reason = None
        if k > 1:
            if test_io:
                reason = 'test_io'
            elif profiling:
                reason = 'profile_dir'
        plan = cls(requested_k=k, k=(1 if reason else k), strict=strict,
                   silent=silent)
        if reason is not None:
            plan.demote(reason)
        # the run's plan is /statusz state: one provider a process, the
        # latest resolve wins (one plan a run)
        get_hub().register_status(
            'execution_plan',
            lambda p=plan: {'requested_k': p.requested_k, 'k': p.k,
                            'scanned': p.scanned,
                            'demotions': sorted(p._noted),
                            'flops_per_step': p.flops_per_step()})
        return plan

    @property
    def scanned(self) -> bool:
        return self.k > 1

    def flops_per_step(self) -> float:
        """The ledger's flops a step of the trainer this plan last built a
        stepper for (0.0 before its first step)."""
        trainer = getattr(self, '_trainer', None)
        if trainer is None:
            return 0.0
        return trainer.train_step_flops()

    def demote(self, reason: str) -> None:
        """A typed error under ``scan_strict=1``, else a note printed the
        first time each reason occurs."""
        if self.strict:
            raise faults.ScanStrictError(reason, DEMOTION_REASONS[reason])
        self.note(reason)

    def note(self, reason: str) -> Optional[str]:
        """The fallback note for ``reason``: printed (unless silent) and
        returned the first time the reason occurs, None after."""
        if reason in self._noted:
            return None
        self._noted.add(reason)
        msg = (f'steps_per_dispatch={self.requested_k} falls back to '
               f'per-step: {DEMOTION_REASONS[reason]}')
        if not self.silent:
            print(msg, flush=True)
        return msg

    def scan_fn(self, trainer, train_eval: bool):
        key = (self.k, bool(train_eval))
        if key not in self._scan_fns:
            self._scan_fns[key] = trainer.compile_multi_step(
                self.k, train_eval=train_eval)
        return self._scan_fns[key]

    def round_stepper(self, trainer, before_dispatch=None,
                      lookahead: int = 1) -> 'WindowedStepper':
        """A fresh stepper for one round.  ``lookahead`` shapes the
        per-step (K=1 or demoted) path only: 1 keeps one staged batch
        ahead of the step, 0 steps at once (a supervised loop, which
        rewinds by dispatched steps)."""
        self._trainer = trainer        # the /statusz flops_per_step source
        scan = None
        if self.scanned:
            armed = bool(trainer.eval_train and len(trainer.train_metric))
            scan = self.scan_fn(trainer, armed)
        return WindowedStepper(trainer, k=self.k, scan_fn=scan,
                               lookahead=lookahead,
                               before_dispatch=before_dispatch,
                               on_demote=self.demote)


class WindowedStepper:
    """One round's step loop at window granularity.

    ``feed(batch)`` stages the batch and runs whatever became due;
    ``finish()`` runs the staged tail per step (bitwise the same, so a
    round need not divide by K).  At ``k=1`` it is the per-step loop with
    ``lookahead`` staged batches ahead of the step.  Both return the
    updates they ran."""

    def __init__(self, trainer, k: int = 1, scan_fn=None,
                 lookahead: int = 1,
                 before_dispatch: Optional[Callable[[int], None]] = None,
                 on_demote: Optional[Callable[[str], None]] = None):
        if k > 1 and scan_fn is None:
            raise ValueError('k>1 needs a compile_multi_step scan_fn')
        self.trainer = trainer
        self.k = int(k)
        self.scan_fn = scan_fn
        self.lookahead = max(0, int(lookahead))
        self.before_dispatch = before_dispatch or (lambda _u: None)
        self.on_demote = on_demote or (lambda _reason: None)
        self.window = []
        self.updates = 0
        self.demoted = False

    def _step_one(self, staged) -> None:
        self.before_dispatch(self.updates)
        with span('train.dispatch', 'train', k=1, update=self.updates):
            self.trainer.update_staged(staged)
        self.updates += 1

    def feed(self, batch) -> int:
        """Stage one batch and run what became due; the updates this call
        ran (0 while a window fills)."""
        staged = self.trainer.stage_batch(batch)
        u0 = self.updates
        if self.k > 1 and not self.demoted and staged[2]:
            # extra_data: the window does not carry it — demote this
            # round only, mid-round, without rewinding the iterator
            self.demoted = True
            self.on_demote('extra_data')
            for st in self.window:
                self._step_one(st)
            self.window = []
        if self.k == 1 or self.demoted:
            self.window.append(staged)
            while len(self.window) > self.lookahead:
                self._step_one(self.window.pop(0))
        else:
            self.window.append(staged)
            if len(self.window) == self.k:
                # the span brackets the window's dispatch, never a step
                # inside it: a trace window cannot bracket those, which is
                # why profile_dir demotes and a span composes
                with span('train.dispatch', 'train', k=self.k,
                          update=self.updates):
                    self.trainer.update_staged_window(self.scan_fn,
                                                      self.window)
                self.updates += self.k
                self.window = []
        return self.updates - u0

    def finish(self) -> int:
        """Run the staged but unrun batches per step (the round's tail,
        or the K=1 lookahead's last batch); the updates run."""
        u0 = self.updates
        window, self.window = self.window, []
        for st in window:
            self._step_one(st)
        return self.updates - u0

    def discard(self) -> None:
        """Drop the staged but unrun batches (a caller whose step budget
        is met)."""
        self.window = []
