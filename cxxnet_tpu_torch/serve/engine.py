"""Inference engine: bucketed predict over an inference-only model.

PyTorch counterpart of ``cxxnet_tpu/serve/engine.py:PredictEngine``:

* **inference-only state** — the engine holds the param tree only; a
  trainer built with ``inference_only=1`` (as ``task=serve`` builds it)
  allocates no optimizer state or gradient accumulator;
* **a closed set of batch shapes** — every request is padded up to one of
  a small ladder of batch-size buckets (``utils/bucketing.py``), so the
  forward only ever runs at bucket shapes.  PyTorch compiles nothing:
  the forward runs through a program of the ledger (``obs/programs.py``,
  ``serve.predict``, replicas ``serve.predict.r<i>``), one row a bucket
  (``b<rows>``, ``+fold`` for a folded engine) declared with the bound
  ``len(buckets)``, and ``compile_count`` is its count of shape keys
  met, so a request shape off the ladder trips the recompile sentinel;
* **atomic parameter swap** — :meth:`swap_params` replaces the serving
  weights between batches after validating the tree's structure, shapes
  and dtypes; a batch in flight keeps the snapshot it started with;
* **quantized storage tiers** (``serve.dtype=bf16|int8``) — weight-only,
  as in the JAX engine: the engine stores ``quantize_tree(params,
  dtype)`` (bf16 leaves, or int8 ``QuantLeaf`` for every leaf of two or
  more dims) and expands it to f32 per forward, then runs the f32
  forward; the resident bytes are the quantized tree's.  No int8 GEMM
  runs here.  The swap contract stays the f32 tree (structure and
  shapes; dtypes only on the f32 tier);
* **conv+BN folding** (``fold_bn=1``, ``nnet/fold.py``) — at the f32
  tier only, as in the JAX engine: each foldable BN runs as a
  pass-through and its conv absorbs the BN's affine, frozen at a
  calibration batch's statistics; the fold proves itself on that batch
  or raises ``FoldError``.  A hot swap re-folds the incoming tree; the
  engine's own placed tree is never folded twice.  At bf16 or int8 the
  tier serves unfolded (JAX ``engine.py:102``);
* **pinned replicas** (``device=``) — the params and every batch live
  whole on one device, and on a card each pinned engine runs its
  forwards on its own CUDA stream; :class:`ReplicatedPredictEngine`
  puts N of them behind one batcher (``serve.replicas``).  A placed tree
  carries the event recorded after its copies, and each forward waits
  on it in the engine's stream, so a tree placed, warmed or swapped in
  from another thread's stream is never read early;
* **the registry protocol** (``serve/registry.py``) — ``place_params``,
  ``warm_params``, ``swap_params``, ``busy`` (requests in flight),
  ``resident_bytes``, ``capacity_view`` and the ``on_serve(version)``
  hook (the version each request was computed with).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nnet import quantize
from ..nnet.trainer import NetTrainer, resolve_device
from ..runtime.faults import (DeadlineExceededError, RequestAbandonedError,
                              ServeError)
from ..utils.bucketing import DEFAULT_BUCKETS, chunk_plan, pad_rows

__all__ = ['PredictEngine', 'ReplicatedPredictEngine']


def _as_4d(arr: np.ndarray) -> np.ndarray:
    """Request payloads arrive as (n, c, y, x) nodes or flat (n, d)
    matrices."""
    arr = np.asarray(arr)
    if arr.ndim == 4:
        return arr
    if arr.ndim == 2:
        return arr.reshape(arr.shape[0], 1, 1, arr.shape[1])
    raise ValueError(f'cannot view shape {arr.shape} as a request batch')


def _leaves(tree):
    """(key, field, tensor) of a ``{layer: {field: tensor}}`` tree, in a
    fixed order."""
    return [(k, f, tree[k][f]) for k in sorted(tree) for f in sorted(tree[k])]


class _PlacedTree(dict):
    """A param tree one engine placed: ``owner`` is that engine's token
    (its own placement passes ``place_params`` unchanged: folding or
    quantizing it again would corrupt it), ``ready`` the CUDA event
    recorded after its copies (None on the CPU)."""

    __slots__ = ('owner', 'ready')


class PredictEngine:
    """Bucketed, hot-swappable predict over a loaded model.

    ``trainer`` must be initialized (``init_model`` or ``load_model``).
    Requests are host float32 (or uint8) arrays shaped ``(n, c, y, x)``
    or ``(n, d)``, pre-normalized.  ``device`` pins the engine to one
    device (a replica); by default it serves on the trainer's.
    """

    def __init__(self, trainer: NetTrainer,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: str = 'f32', fold_bn: int = 0, fold_batch=None,
                 device=None, program_name: str = 'serve.predict'):
        if trainer.net is None or trainer.params is None:
            raise ValueError('PredictEngine needs an initialized trainer '
                             '(init_model()/load_model() first)')
        self.serve_dtype = quantize.parse_serve_dtype(dtype)
        self.trainer = trainer
        self.device = (trainer.device if device is None
                       else resolve_device(str(device)))
        # a pinned engine on a card forwards on its own stream, so two
        # replicas' windows overlap; the default engine keeps the
        # caller's stream
        self._stream = (torch.cuda.Stream(device=self.device)
                        if device is not None and self.device.type == 'cuda'
                        else None)
        self._token = object()
        # conv+BN folding: f32 tier only — the pinned proof is an f32
        # statement (JAX engine.py:94-106)
        self._fold_batch_arg = fold_batch
        self._fold_report = None
        self._fold_bn_layers = frozenset()
        if int(fold_bn) and self.serve_dtype == 'f32':
            from ..nnet.fold import plan_conv_bn_pairs
            self._fold_bn_layers = frozenset(
                b for (_, b) in plan_conv_bn_pairs(trainer.net))
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f'bad bucket ladder {buckets!r}')
        from ..obs.programs import get_ledger
        self._program = get_ledger().program(program_name,
                                             bound=len(self.buckets))
        self._suffix = '+fold' if self._fold_bn_layers else ''
        self.swap_count = 0
        self.version: object = 0
        # called as on_serve(version) after each request with the version
        # whose params computed it (captured with the snapshot, so a swap
        # mid-request reports the old one)
        self.on_serve = None
        self._lock = threading.Lock()
        self._inflight = 0               # guarded-by: _lock
        self._ref = [(k, f, tuple(v.shape), v.dtype)
                     for k, f, v in _leaves(trainer.params)]
        self._params = self.place_params(trainer.params)  # guarded-by: _lock
        self._top = trainer.net.cfg.layers[-1].nindex_out[-1]

    # -- forward -----------------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _fwd(self, params, data: np.ndarray) -> np.ndarray:
        """One bucket forward through the ledger program; the row's
        parameter bytes are what the allocator holds for the stored tier
        (``obs.programs.held_bytes``)."""
        from ..obs.programs import cnn_step_flops, held_bytes
        return self._program.run(
            f'b{data.shape[0]}{self._suffix}', self._fwd_run, params, data,
            info=lambda: (cnn_step_flops(self.trainer.net, data.shape[0],
                                         train=False),
                          held_bytes(params),
                          f'{data.dtype}[{",".join(map(str, data.shape))}]'))

    def _fwd_run(self, params, data: np.ndarray) -> np.ndarray:
        with self._on_stream():
            if getattr(params, 'ready', None) is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    params.ready)
            if self.serve_dtype != 'f32':
                # weight-only: the stored tier expanded to f32 here
                params = quantize.dequantize_tree(params, torch.float32)
            values = self.trainer._forward_values(
                params, data, identity_layers=self._fold_bn_layers,
                device=self.device)
            return values[self._top].float().cpu().numpy()

    # -- conv+BN folding ---------------------------------------------------
    def _calib_batch(self) -> np.ndarray:
        """The batch whose statistics the fold freezes: the caller's
        ``fold_batch`` (representative data: every later request is
        normalized with its statistics), else a seeded random batch at
        the largest bucket, which keeps the fold deterministic and its
        proof meaningful but encodes no data statistics."""
        if self._fold_batch_arg is not None:
            return _as_4d(np.asarray(self._fold_batch_arg, np.float32))
        c, y, x = self.trainer.net_cfg.input_shape
        rng = np.random.RandomState(0)
        return rng.randn(self.buckets[-1], c, y, x).astype(np.float32)

    def _fold(self, tree):
        """``tree`` (f32, on the serving device) with every planned
        conv+BN pair folded around the calibration statistics; the pass
        proves itself within the pinned tolerances or raises
        ``FoldError``."""
        from ..nnet.fold import fold_params
        with self._on_stream():
            folded, report = fold_params(
                self.trainer.net, tree, self._calib_batch(),
                self.trainer._ctx(device=self.device))
        self._fold_report = report
        return folded

    def fold_view(self) -> Optional[dict]:
        """The newest fold's report (pairs, proof error, tolerances), or
        None when folding is off."""
        if self._fold_report is None:
            return None
        r = dict(self._fold_report)
        r['bn_layers'] = sorted(r['bn_layers'])
        return r

    @property
    def compile_count(self) -> int:
        """Distinct request shapes the forward has run — bounded by
        ``len(buckets)`` (the JAX engine's compile-cache bound)."""
        return self._program.compiles

    def ledger_bytes(self) -> Optional[int]:
        """The bytes the allocator held for the stored tree at the newest
        ledger row's first call — what ``budget_drift`` cross-checks
        :meth:`resident_bytes` (elements only) against.  None before the
        first forward."""
        e = self._program.newest_entry()
        if e is None or e.argument_bytes <= 0:
            return None
        return int(e.argument_bytes)

    # -- parameters --------------------------------------------------------
    @property
    def params(self):
        with self._lock:
            return self._params

    def place_params(self, host_params):
        """Validate a ``{layer: {field: array or tensor}}`` f32 tree
        against the serving model (dtypes only on the f32 tier), quantize
        it into the serving tier (or fold it, under ``fold_bn``) and move
        it to the serving device.  This engine's own placement comes back
        unchanged."""
        if isinstance(host_params, _PlacedTree) \
                and host_params.owner is self._token:
            return host_params
        got = _leaves(host_params)
        if [(k, f) for k, f, _ in got] != [(k, f) for k, f, _, _ in self._ref]:
            raise ValueError('swap_params: param tree structure differs '
                             'from the serving model')
        dev = self.device
        strict = self.serve_dtype == 'f32'
        placed = {}
        for (k, f, v), (_, _, shape, dt) in zip(got, self._ref):
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))
            if tuple(t.shape) != shape or (strict and t.dtype != dt):
                raise ValueError(
                    f'swap_params: leaf {k}/{f} {tuple(t.shape)}/{t.dtype} '
                    f'!= serving {shape}/{dt} — a shape change needs a new '
                    'engine, not a hot swap')
            placed.setdefault(k, {})[f] = t
        placed = quantize.quantize_tree(placed, self.serve_dtype)
        placed = {k: {f: v.to(dev) for f, v in fs.items()}
                  for k, fs in placed.items()}
        if self._fold_bn_layers:
            placed = self._fold(placed)
        out = _PlacedTree(placed)
        out.owner = self._token
        out.ready = None
        if dev.type == 'cuda':
            out.ready = torch.cuda.Event()
            out.ready.record(torch.cuda.current_stream(dev))
        return out

    def warm_params(self, params) -> None:
        """One smallest-bucket forward with ``params`` (placed first if
        they are not this engine's), finished before it returns: the tree
        is resident and read once before a swap makes it serve."""
        c, y, x = self.trainer.net_cfg.input_shape
        self._fwd(self.place_params(params),
                  np.zeros((self.buckets[0], c, y, x), np.float32))

    def resident_bytes(self) -> int:
        """Bytes of the stored param tree (an int8 leaf counts its payload
        and its scales)."""
        return quantize.tree_nbytes(self.params)

    def busy(self) -> bool:
        """True while a request's forward runs: the fleet budgeter never
        evicts an engine that is serving."""
        with self._lock:
            return self._inflight > 0

    def capacity_view(self) -> dict:
        """Declared capacity with the live shape count and residency."""
        return {'buckets': list(self.buckets),
                'compile_count': int(self.compile_count),
                'resident_bytes': int(self.resident_bytes()),
                'busy': bool(self.busy())}

    def swap_params(self, params, version: object = None) -> None:
        """Atomically make ``params`` the serving weights; in-flight
        batches keep the snapshot they captured."""
        placed = self.place_params(params)
        with self._lock:
            self._params = placed
            self.swap_count += 1
            if version is not None:
                self.version = version

    def _snapshot(self):
        with self._lock:
            return self._params

    def _snapshot_versioned(self):
        """(params, version) captured together: a request reports the
        version whose params computed it, even when a swap lands
        mid-request."""
        with self._lock:
            return self._params, self.version

    # -- prediction --------------------------------------------------------
    def warm(self) -> int:
        """Run every bucket once up front; returns ``compile_count``."""
        c, y, x = self.trainer.net_cfg.input_shape
        params = self._snapshot()
        for b in self.buckets:
            self._fwd(params, np.zeros((b, c, y, x), np.float32))
        return self.compile_count

    def predict_scores(self, data: np.ndarray) -> np.ndarray:
        """Final-node scores for ``n`` request rows: ``(n, k)`` float32.
        The input is padded to the smallest fitting bucket (oversize
        requests split into max-bucket chunks); pad rows never leave the
        engine.  The param snapshot is taken once per request: a request
        is never served by two versions."""
        data = _as_4d(data)
        n = data.shape[0]
        params, version = self._snapshot_versioned()
        outs: List[np.ndarray] = []
        with self._lock:
            self._inflight += 1
        try:
            for off, take, bucket in chunk_plan(n, self.buckets):
                chunk = pad_rows(data[off:off + take], bucket)
                if chunk.dtype != np.float32 and chunk.dtype != np.uint8:
                    chunk = chunk.astype(np.float32)
                outs.append(self._fwd(params, chunk)[:take])
        finally:
            with self._lock:
                self._inflight -= 1
        if self.on_serve is not None:
            self.on_serve(version)
        if not outs:
            return np.empty((0, 1), np.float32)
        return np.concatenate(outs, axis=0).reshape(n, -1)

    def predict(self, data: np.ndarray) -> np.ndarray:
        """Class id (argmax; raw value for single-score nets) per row."""
        return NetTrainer._pred_transform(self.predict_scores(data))


class _FleetPlaced(list):
    """One placed tree per replica: tells a fleet placement apart from a
    host tree in the registry's place, warm and swap sequence."""


class ReplicatedPredictEngine:
    """Data-parallel ``PredictEngine`` replicas behind ONE batcher
    (``serve.replicas=N``; JAX ``serve/engine.py:430``).

    Each replica pins the full param tree and its batches to one device
    (``PredictEngine(device=...)``, its own CUDA stream on a card);
    coalesced windows go round-robin to the replicas' workers, so N
    windows run at once.  The forward is the same for every replica:
    scores do not depend on which replica answered.  ``devices`` (default:
    every CUDA device) may name one device several times.

    Hot swap is fleet-atomic: :meth:`swap_params` gates new windows,
    drains every replica's queue and in-flight batch, then swaps all
    replicas before traffic resumes — no two versions ever answer at
    once.

    The batcher protocol is engine-owned completion
    (``execute_requests`` + ``buckets``); the budgeter's surface is
    ``resident_bytes``, ``busy`` and ``resident_bytes_per_device``.
    """

    def __init__(self, trainer: NetTrainer,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: str = 'f32', replicas: int = 2, devices=None,
                 stats=None, fold_bn: int = 0, fold_batch=None):
        n = int(replicas)
        if n < 1:
            raise ValueError('serve.replicas must be >= 1')
        devs = (list(devices) if devices is not None else
                [torch.device('cuda', i)
                 for i in range(torch.cuda.device_count())])
        if n > len(devs):
            raise ValueError(f'serve.replicas={n} exceeds the '
                             f'{len(devs)} available devices')
        self.engines = [
            PredictEngine(trainer, buckets, dtype, fold_bn=fold_bn,
                          fold_batch=fold_batch, device=devs[i],
                          program_name=f'serve.predict.r{i}')
            for i in range(n)]
        self.buckets = self.engines[0].buckets
        self.stats = stats
        self._cond = threading.Condition()
        # guarded-by: _cond (per-replica window queues + dispatch state)
        self._qs: List[collections.deque] = [collections.deque()
                                             for _ in range(n)]
        self._rr = 0
        self._inflight = [0] * n
        self._draining = False
        self._closed = False
        self._threads = []
        for i in range(n):
            t = threading.Thread(target=self._worker, args=(i,),
                                 daemon=True, name=f'cxxnet-replica-{i}')
            t.start()
            self._threads.append(t)

    # -- batcher protocol (engine-owned completion) ------------------------
    def execute_requests(self, batch) -> None:
        """One coalesced window to the next replica's queue (strict
        round-robin; the batcher's worker returns at once).  A draining
        swap holds NEW windows here; queued ones keep flowing, so the
        drain ends under live traffic."""
        with self._cond:
            while self._draining and not self._closed:
                self._cond.wait(0.05)
            if self._closed:
                raise ServeError('replicated engine is closed')
            self._qs[self._rr].append(list(batch))
            self._rr = (self._rr + 1) % len(self.engines)
            self._cond.notify_all()

    def _worker(self, i: int) -> None:
        while True:
            with self._cond:
                while not self._qs[i] and not self._closed:
                    self._cond.wait(0.05)
                if self._closed:
                    # fail queued windows typed, never strand a waiter
                    while self._qs[i]:
                        for r in self._qs[i].popleft():
                            r.error = ServeError(
                                'replicated engine is closed')
                            r.event.set()
                    return
                batch = self._qs[i].popleft()
                self._inflight[i] += 1
            try:
                self._run_batch(i, batch)
            finally:
                with self._cond:
                    self._inflight[i] -= 1
                    self._cond.notify_all()

    def _run_batch(self, i: int, batch) -> None:
        # shed, then forward, as the batcher's own leg does: a request
        # that expired or was abandoned while queued does not ride the
        # forward, and it is counted here (completion is engine-owned)
        now = time.monotonic()
        live = []
        for r in batch:
            if getattr(r, 'abandoned', False):
                r.error = RequestAbandonedError(now - r.t_submit)
                if self.stats is not None:
                    self.stats.inc('abandoned')
                r.event.set()
            elif now >= r.deadline_abs:
                r.error = DeadlineExceededError(
                    r.deadline, now - r.t_submit, r.n)
                if self.stats is not None:
                    self.stats.inc('expired')
                r.event.set()
            else:
                live.append(r)
        if not live:
            return
        try:
            data = (live[0].data if len(live) == 1 else
                    np.concatenate([r.data for r in live], axis=0))
            scores = self.engines[i].predict_scores(data)
        except BaseException as e:  # noqa: BLE001 — surfaced per request
            for r in live:
                if self.stats is not None:
                    self.stats.inc('engine_errors')
                r.error = e
                r.event.set()
            return
        done = time.monotonic()
        off = 0
        for r in live:
            r.result = scores[off:off + r.n]
            off += r.n
            if self.stats is not None:
                self.stats.inc('requests')
                self.stats.inc(f'replica_rows[r{i}]', r.n)
                self.stats.observe('latency_ms', (done - r.t_submit) * 1e3)
            r.event.set()

    # -- fleet-atomic hot swap ---------------------------------------------
    def place_params(self, host_params) -> _FleetPlaced:
        """Registry protocol: one placed tree per replica (each on its
        own device)."""
        return _FleetPlaced(e.place_params(host_params)
                            for e in self.engines)

    def _as_fleet(self, params) -> _FleetPlaced:
        if isinstance(params, _FleetPlaced):
            if len(params) != len(self.engines):
                raise ValueError('fleet placement arity != replicas')
            return params
        return self.place_params(params)

    def warm_params(self, params) -> None:
        """Warm every replica's forward with the candidate tree before
        the swap (the registry's warm, replica by replica)."""
        for e, p in zip(self.engines, self._as_fleet(params)):
            e.warm_params(p)

    def swap_params(self, params, version: object = None) -> None:
        """Drain ALL replicas (queued and in flight), swap every one,
        then reopen dispatch: requests never see a mixed-version fleet."""
        placed = self._as_fleet(params)   # device copies before the gate
        with self._cond:
            self._draining = True
            while any(self._qs) or any(self._inflight):
                self._cond.wait(0.05)
        try:
            for eng, p in zip(self.engines, placed):
                eng.swap_params(p, version)
        finally:
            with self._cond:
                self._draining = False
                self._cond.notify_all()

    # -- engine surface -----------------------------------------------------
    @property
    def trainer(self) -> NetTrainer:
        """The replicas' shared trainer: what the registry's loader checks
        a checkpoint's structure against (JAX's replicated engine has
        none, so its registry rejects every checkpoint there)."""
        return self.engines[0].trainer

    @property
    def swap_count(self) -> int:
        return self.engines[0].swap_count

    @property
    def version(self):
        return self.engines[0].version

    @version.setter
    def version(self, v) -> None:
        for e in self.engines:
            e.version = v

    @property
    def compile_count(self) -> int:
        return sum(e.compile_count for e in self.engines)

    def warm(self) -> int:
        for e in self.engines:
            e.warm()
        return self.compile_count

    def resident_bytes(self) -> int:
        """Fleet total (every replica holds a full copy)."""
        return sum(e.resident_bytes() for e in self.engines)

    def resident_bytes_per_device(self) -> List[int]:
        """One entry per distinct device, in the order of first use: the
        replicas that share a device summed, as the budgeter prices its
        most loaded device."""
        per: Dict[torch.device, int] = {}
        for e in self.engines:
            per[e.device] = per.get(e.device, 0) + e.resident_bytes()
        return list(per.values())

    def busy(self) -> bool:
        with self._cond:
            return any(self._inflight) or any(bool(q) for q in self._qs)

    def capacity_view(self) -> dict:
        with self._cond:
            queued = sum(len(q) for q in self._qs)
        return {'buckets': list(self.buckets),
                'replicas': len(self.engines),
                'compile_count': int(self.compile_count),
                'resident_bytes': int(self.resident_bytes()),
                'queued_windows': queued,
                'busy': bool(self.busy())}

    def predict_scores(self, data: np.ndarray) -> np.ndarray:
        """Batcher-less path: the next replica in turn (after a draining
        swap, by the same no-mixed-version rule)."""
        with self._cond:
            while self._draining:
                self._cond.wait(0.05)
            i = self._rr
            self._rr = (self._rr + 1) % len(self.engines)
            self._inflight[i] += 1
        try:
            return self.engines[i].predict_scores(data)
        finally:
            with self._cond:
                self._inflight[i] -= 1
                self._cond.notify_all()

    def predict(self, data: np.ndarray) -> np.ndarray:
        return NetTrainer._pred_transform(self.predict_scores(data))

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop the workers; windows still queued fail with
        ``ServeError``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        ok = True
        for t in self._threads:
            t.join(timeout)
            ok = not t.is_alive() and ok
        return ok
