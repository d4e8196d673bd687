"""OnlinePipeline: one process that trains, saves, swaps and serves.

The port's own copy of ``cxxnet_tpu/online/pipeline.py`` (queue A item
10.3 of ROADMAP.md).  A long-lived supervised trainer ingests a
(streaming) batch source through the ordinary iterator chain and
publishes a serving checkpoint every ``save_every`` optimizer steps; a
colocated serving stack — ``PredictEngine`` + ``DynamicBatcher`` +
``ModelRegistry`` — watches the same ``model_dir`` and hot-swaps each
checkpoint under live traffic.  ``FreshnessTracker`` stamps every swap
with its step-to-serving lag and checks it against ``freshness_slo``.

The invariants come from parts that already hold them:

* the trainer's side is a ``runtime.supervisor.TrainSupervisor`` run
  (watchdog, divergence breaker, bitwise restore of the last good
  state, async exact-state saves), and the serving checkpoint rides the
  supervisor's ``on_save`` hook: the NaN gate that guards recovery also
  keeps a poisoned model file from ever being written;
* the serving side never trusts the trainer: a checkpoint's digest is
  verified before it can swap, a corrupt one is rejected and blacklisted
  while the previous version keeps serving, and in-flight requests
  finish on the params they started with (no drops across swaps);
* a model-file write that fails degrades *freshness*, never training or
  availability: the writer's deferred error is logged
  (``async_save_failed``) and counted, and the server keeps the last
  good version.

On a card the publish is ordered by streams: ``snapshot_tree`` clones
the params on the step loop's stream right after the step that produced
them (and before the next in-place update, which that stream runs after
the clones), and the writer copies the clones to the host on a stream
of its own that waits on the snapshot's event.  The serving twin is a
separate ``NetTrainer``: it shares no tensor with the trainer.

``tests/test_torch_online.py`` holds the pipeline against JAX's: the
same published step names, the files' params within the trainers'
tolerance, and a chaos drill that ends bitwise equal to a fault-free
twin.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..nnet import checkpoint as model_io
from ..nnet.execution import ExecutionPlan
from ..obs import get_hub, span
from ..runtime import faults
from ..runtime.async_ckpt import AsyncCheckpointer, host_tree, snapshot_tree
from ..runtime.supervisor import SupervisorConfig, TrainSupervisor
from ..serve import DynamicBatcher, ModelRegistry, PredictEngine
from ..serve.registry import load_into_trainer
from ..utils.metric import StatSet
from .freshness import FreshnessTracker

__all__ = ['OnlineConfig', 'OnlinePipeline']


@dataclass
class OnlineConfig:
    """Knobs for one train-while-serve run (``online.*`` config keys in
    main.py)."""

    model_dir: str = 'models'
    save_every: int = 8            # steps between serving checkpoints
    save_workers: int = 2
    freshness_slo: float = 0.0     # seconds, 0 = measure but never breach
    freshness_strict: bool = False  # raise FreshnessSLOError at run end
    reload_poll: float = 0.05      # registry watch period (s)
    buckets: Tuple[int, ...] = (1, 8, 32)
    max_queue: int = 64
    max_wait: float = 0.002
    deadline: float = 1.0
    dtype: str = 'f32'             # serve.dtype quantized-inference tier
    qps: float = 50.0              # built-in traffic driver rate
    # supervisor knobs (same semantics as train.* keys)
    watchdog_deadline: Optional[float] = 60.0
    max_restarts: int = 3
    nan_breaker: int = 3
    keep_last: int = 4
    save_async: int = 1
    steps_per_dispatch: int = 1
    net_type: int = 0
    silent: bool = False
    retry: faults.RetryPolicy = field(
        default_factory=lambda: faults.DEFAULT_IO_RETRY)


class OnlinePipeline:
    """Run trainer + server as one orchestrated process (module
    docstring).

    ``trainer`` is an initialized :class:`NetTrainer`; ``train_iter`` is
    any replay-stable iterator chain (idiomatically ``iter =
    imgbin_stream``); ``serve_factory`` builds the colocated serving
    twin — a zero-arg callable returning an UNINITIALIZED
    inference-only ``NetTrainer`` of the same architecture (the pipeline
    loads the bootstrap checkpoint into it, so trainer and server never
    share device buffers).  ``request_source`` (optional) feeds the
    built-in traffic driver: a zero-arg callable returning one request's
    float32 rows; external embedders skip it and call :meth:`submit`
    themselves.
    """

    def __init__(self, trainer, train_iter, serve_factory: Callable,
                 cfg: OnlineConfig,
                 request_source: Optional[Callable[[], np.ndarray]] = None,
                 failure_log: Optional[faults.FailureLog] = None):
        from ..io.data import ThreadBufferIterator
        self.trainer = trainer
        self.cfg = cfg
        self.serve_factory = serve_factory
        self.request_source = request_source
        self.log = (faults.global_failure_log() if failure_log is None
                    else failure_log)
        # the supervisor brings its own watchdog buffer: unwrap a
        # conf-level threadbuffer stage (same reasoning as main.py's
        # _make_supervisor — one producer, one fault-index base)
        self._it = train_iter
        if isinstance(self._it, ThreadBufferIterator):
            self._it = self._it.base
        if self._it is not None and not self._it.is_replay_stable():
            msg = ('online train iterator reshuffles per pass: recovery '
                   'restores exact params but the replayed pass is a new '
                   'permutation — the chaos bitwise contract needs a '
                   'replay-stable source (imgbin_stream is)')
            self.log.record('replay_unstable', msg)
            if not cfg.silent:
                print(f'OnlinePipeline: {msg}', flush=True)
        self.tracker = FreshnessTracker(slo_s=cfg.freshness_slo,
                                        log=self.log)
        self.engine: Optional[PredictEngine] = None
        self.batcher: Optional[DynamicBatcher] = None
        self.registry: Optional[ModelRegistry] = None
        self.supervisor: Optional[TrainSupervisor] = None
        self._plan: Optional[ExecutionPlan] = None
        self._ckpt = AsyncCheckpointer(workers=cfg.save_workers,
                                       failure_log=self.log)
        self._last_counter: Optional[int] = None
        self._served_lock = threading.Lock()   # traffic + client threads
        self._served = 0           # guarded-by: _served_lock
        self._client_errors = 0    # guarded-by: _served_lock
        self._traffic_stop = threading.Event()
        self._traffic_thread: Optional[threading.Thread] = None
        self._qps = float(cfg.qps)        # guarded-by: _served_lock
        self._train_throttle = 0.0        # guarded-by: _served_lock
        self._started = False
        self._closed = False

    # -- checkpoint publishing (trainer -> model_dir) -----------------------
    def _model_path(self, counter: int) -> str:
        return os.path.join(self.cfg.model_dir, f'{counter:04d}.model')

    def _model_header(self) -> bytes:
        return (int(self.cfg.net_type).to_bytes(4, 'little', signed=True)
                + self.trainer.model_header())

    def _publish_model(self, counter: int, sync: bool = False) -> str:
        """Publish the trainer's CURRENT params as ``%04d.model`` +
        digest sidecar — snapshot now (device clones the next
        in-place update cannot reach),
        serialize + atomic write + digest on the background writer.
        The freshness clock for ``counter`` starts here: this moment IS
        (modulo a window boundary) the optimizer step that produced the
        params."""
        from ..nnet.trainer import NetTrainer
        tr = self.trainer
        path = self._model_path(counter)
        self.tracker.record_step(counter)
        def job():
            blob = model_io.serialize_blob(net, host_tree(psnap))
            # digest-before-rename publish: the watching registry can
            # never observe this file without its sidecar (and the
            # corrupt_model chaos event is deterministically caught)
            model_io.publish_model_file(
                path,
                lambda f: NetTrainer.write_model_bytes(f, header, blob),
                retry=self.cfg.retry)
            return path

        # the span brackets what the STEP LOOP pays: the snapshot plus
        # either the whole write (sync) or the background hand-off
        with span('online.publish', 'online', step=counter,
                  sync=bool(sync or not self.cfg.save_async)):
            header = self._model_header()
            net = tr.net
            psnap = snapshot_tree(tr.params)
            if sync or not self.cfg.save_async:
                job()
            else:
                # drain (not wait): a failed PREVIOUS model save is
                # already in the failure log as async_save_failed —
                # online, a lost serving checkpoint degrades freshness,
                # never training
                self._ckpt.drain()
                self._ckpt.submit(job, step=counter,
                                  label=f'publish_model:{counter:04d}')
        return path

    def _on_train_save(self, step: int) -> None:
        """Supervisor ``on_save`` listener: every accepted exact-state
        save (NaN gate already passed) also publishes the serving
        checkpoint — one cadence, one validity gate.  Deduped per step:
        each round's anchor save re-lands on the previous final step."""
        if step == self._last_counter:
            return
        self._last_counter = step
        self._publish_model(step)

    # -- serving side -------------------------------------------------------
    def start(self) -> None:
        """Bootstrap the colocated server: publish the trainer's current
        params synchronously, load them into the serving twin, warm every
        bucket program, and start batcher + registry watch + (when a
        ``request_source`` was given) the traffic driver."""
        if self._started:
            return
        cfg = self.cfg
        os.makedirs(cfg.model_dir, exist_ok=True)
        counter = int(self.trainer.sample_counter)
        self._last_counter = counter
        boot = self._publish_model(counter, sync=True)
        serve_tr = load_into_trainer(self.serve_factory(), boot,
                                     retry=cfg.retry)
        self.engine = PredictEngine(serve_tr, cfg.buckets,
                                    dtype=cfg.dtype)
        self.engine.version = counter
        self.engine.on_serve = self.tracker.note_served
        self.engine.warm()
        self.batcher = DynamicBatcher(self.engine, max_queue=cfg.max_queue,
                                      max_wait=cfg.max_wait,
                                      deadline=cfg.deadline)
        self.registry = ModelRegistry(
            self.engine, cfg.model_dir, poll_interval=cfg.reload_poll,
            current=counter, retry=cfg.retry, log=self.log,
            on_swap=self._on_swap)
        self.registry.start()
        # register the live stat sets + status views into the telemetry
        # hub: /metrics serves the batcher/freshness/registry gauges and
        # /statusz the registry state machine while the process runs
        hub = get_hub()
        self.batcher.register_into(hub)
        hub.register_stats('online', self.tracker.stats,
                           refresh=self._refresh_online_gauges)
        self.registry.register_into(hub)
        hub.register_status('online', self.summary)
        # the freshness SLO engine joins the hub roster: its verdict
        # rides /slos + /metrics, and a breached freshness flips
        # /healthz to degraded (the stale model keeps serving — the
        # endpoint stays 200/alive)
        self.tracker.slo.register_into(hub, name='online_slo')
        if self.request_source is not None:
            self._traffic_stop.clear()
            self._traffic_thread = threading.Thread(
                target=self._traffic, daemon=True, name='online-traffic')
            self._traffic_thread.start()
        self._started = True
        if not cfg.silent:
            print(f'online: serving from step {counter} '
                  f'({len(self.engine.buckets)} bucket programs warm), '
                  f'watching {cfg.model_dir} every {cfg.reload_poll:g}s',
                  flush=True)

    def _on_swap(self, counter: int, path: str) -> None:
        self.tracker.record_swap(counter)
        if not self.cfg.silent:
            print(f'online: hot-swapped step {counter} into the live '
                  f'engine ({path})', flush=True)

    def submit(self, rows: np.ndarray,
               deadline: Optional[float] = None) -> np.ndarray:
        """One request through the live stack (typed serving errors
        propagate).  The first request to land on a freshly swapped
        version closes its freshness measurement."""
        if self.batcher is None:
            raise RuntimeError('OnlinePipeline.start() first')
        out = self.batcher.submit(np.asarray(rows, np.float32), deadline)
        with self._served_lock:
            self._served += len(rows)
        return out

    def _traffic(self) -> None:
        """Built-in constant-rate traffic driver (``qps`` requests/sec)
        over ``request_source`` rows — the CLI/bench stand-in for a
        fronting server.  Client-visible errors are counted, never
        raised: the drill's zero-drop assertion reads the counter."""
        while True:
            # re-read the rate every tick: the autoscaler retunes it
            # live through set_qps (the train/serve split surface)
            with self._served_lock:
                period = 1.0 / max(self._qps, 1e-6)
            if self._traffic_stop.wait(period):
                return
            try:
                self.submit(self.request_source())
            except faults.ServeError:
                with self._served_lock:
                    self._client_errors += 1
            except RuntimeError:
                return                       # batcher closed under us

    def set_qps(self, qps: float) -> float:
        """Live-retune the built-in traffic driver's rate (autoscaler /
        operator surface); returns the previous rate.  Takes effect on
        the next tick — no thread restart, no request dropped."""
        qps = float(qps)
        if qps <= 0:
            raise ValueError(f'qps must be > 0, got {qps}')
        with self._served_lock:
            prev, self._qps = self._qps, qps
        return prev

    def set_train_throttle(self, seconds: float) -> float:
        """Per-step training slowdown in seconds (0 = full speed) — the
        autoscaler's train/serve split knob: under serving pressure the
        train half yields device time; on sustained OK it is released.
        Bounded (capped at 1s), reversible, takes effect on the next
        step via the ``before_step`` hook.  Returns the previous value."""
        seconds = min(1.0, max(0.0, float(seconds)))
        with self._served_lock:
            prev, self._train_throttle = self._train_throttle, seconds
        return prev

    def train_throttle(self) -> float:
        with self._served_lock:
            return self._train_throttle

    # -- the training loop --------------------------------------------------
    def _make_supervisor(self) -> TrainSupervisor:
        cfg = self.cfg
        sup_cfg = SupervisorConfig(
            batch_deadline=cfg.watchdog_deadline,
            max_restarts=cfg.max_restarts,
            nan_breaker=cfg.nan_breaker,
            save_every=cfg.save_every,
            keep_last=cfg.keep_last,
            save_async=cfg.save_async,
            save_workers=cfg.save_workers,
            retry=cfg.retry,
            on_save=self._on_train_save,
            pipeline_stats=(None if self._it is None
                            else self._it.pipeline_stats()))
        return TrainSupervisor(
            self.trainer,
            os.path.join(cfg.model_dir, 'supervised_state'), sup_cfg,
            failure_log=self.log)

    def run(self, num_rounds: int = 1,
            evals: Sequence[Tuple[object, str]] = (),
            start_round: int = 1,
            before_step: Optional[Callable[[int], None]] = None,
            out=None) -> dict:
        """The long-lived loop: ``num_rounds`` supervised passes over the
        (streaming) train iterator, serving the whole time.  Each round
        ends with the reference eval line on ``out`` (default stderr)
        extended with the freshness/swap gauges (:meth:`eval_line`).
        Returns :meth:`summary`; in ``freshness_strict`` mode a breached
        SLO raises the typed ``FreshnessSLOError`` AFTER the final round
        (training and serving finish first — the SLO is an alarm, not a
        kill switch)."""
        import itertools
        out = sys.stderr if out is None else out
        self.start()
        sup = self.supervisor = self._make_supervisor()
        self._plan = ExecutionPlan.resolve(
            requested_k=self.cfg.steps_per_dispatch,
            silent=self.cfg.silent)
        it = self._it
        tr = self.trainer

        def factory(k):
            return itertools.islice(iter(it), k, None)

        def throttled(step: int) -> None:
            # the autoscaler's train/serve split: yield device time to
            # serving under pressure (sleep OFF any lock, between
            # dispatches — training math is unchanged, only its pace)
            t = self.train_throttle()
            if t > 0:
                time.sleep(t)
            if before_step is not None:
                before_step(step)

        try:
            for r in range(start_round, start_round + int(num_rounds)):
                tr.start_round(r)
                sup.run(factory, before_step=throttled,
                        make_stepper=lambda: self._plan.round_stepper(
                            tr, lookahead=0))
                tr.flush_divergence_check()
                line = f'[{r}]'
                if not evals:
                    line += tr.evaluate(None, 'train')
                for ev_it, name in evals:
                    line += tr.evaluate(ev_it, name)
                line += self.eval_line()
                out.write(line + '\n')
                out.flush()
        finally:
            sup.close()
            self._ckpt.drain()
        if self.cfg.freshness_strict:
            self.tracker.check_strict()
        return self.summary()

    # -- observability ------------------------------------------------------
    def _refresh_online_gauges(self) -> None:
        """Pull-style gauges for /metrics renders (the eval line gets
        the same values through :meth:`eval_line`)."""
        self.tracker.report()      # gauges swaps/breaches/unserved_swaps
        with self._served_lock:
            self.tracker.stats.gauge('served', self._served)
        self.tracker.stats.gauge('dropped', self.dropped())

    def dropped(self) -> int:
        """Requests that got an error instead of scores — the zero-drop
        acceptance counter (batcher sheds + engine faults + client
        abandonment + client-side typed errors from the built-in
        driver)."""
        if self.batcher is None:
            with self._served_lock:
                return self._client_errors
        s = self.batcher.stats
        return int(s.get('expired') + s.get('rejected')
                   + s.get('engine_errors') + s.get('abandoned'))

    def eval_line(self, name: str = 'online') -> str:
        """Freshness + swap gauges in eval-line format — what rides the
        round eval line."""
        stats = StatSet()
        with self._served_lock:
            stats.gauge('served', self._served)
        stats.gauge('dropped', self.dropped())
        if self.registry is not None:
            stats.gauge('last_swap_step', self.registry.last_swap_step)
            age = self.registry.last_swap_age_s()
            if age == age:
                stats.gauge('last_swap_age_s', age)
        return self.tracker.report(stats, name)

    def serve_report(self) -> str:
        """Full serving-side stats: batcher per-bucket latency ledger +
        registry swap stamps (both eval-line format)."""
        parts = []
        if self.batcher is not None:
            parts.append(self.batcher.report('serve'))
        if self.registry is not None:
            parts.append(self.registry.report(name='registry'))
        return ''.join(parts)

    def summary(self) -> dict:
        """One strictly-JSON-able dict for receipts and tests (unmeasured
        quantiles are None/null, never NaN — the summary line is an
        advertised machine-readable surface)."""
        t = self.tracker

        def q(name, p):
            v = t.stats.quantile(name, p)
            return None if v != v else v

        with self._served_lock:
            served = int(self._served)
        return {
            'steps': int(self.trainer.sample_counter),
            'swaps': int(t.swaps),
            'served': served,
            'dropped': int(self.dropped()),
            'slo_breaches': int(t.breaches),
            'freshness_p50_s': q('freshness_s', 0.5),
            'freshness_p99_s': q('freshness_s', 0.99),
            'swap_lag_p50_s': q('swap_lag_s', 0.5),
            'last_swap_step': (-1 if self.registry is None
                               else int(self.registry.last_swap_step)),
            'save_failures': len(self.log.records('async_save_failed')),
            'restarts': (0 if self.supervisor is None
                         else int(self.supervisor.restarts_total)),
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self, timeout: Optional[float] = None) -> None:
        """Tear the whole loop down (idempotent): traffic, registry
        watch, batcher (drains queued requests), background writers."""
        if self._closed:
            return
        self._closed = True
        hub = get_hub()
        for name in ('serve', 'online', 'registry'):
            hub.unregister_stats(name)
        for name in ('online', 'registry'):
            hub.unregister_status(name)
        self.tracker.slo.close()
        self._traffic_stop.set()
        t = self._traffic_thread
        if t is not None:
            t.join(timeout)
        if self.registry is not None:
            self.registry.close(timeout=timeout)
        if self.batcher is not None:
            self.batcher.close(timeout=timeout)
        if self.supervisor is not None:
            self.supervisor.close()
        self._ckpt.close()
