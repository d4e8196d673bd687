"""Model registry: checkpoint hot reload without dropping requests, and
the multi-model fleet under a device-memory budget.

PyTorch counterpart of ``cxxnet_tpu/serve/registry.py``.  The training
side writes ``model_dir/%04d.model`` files by temp + fsync + rename
(``nnet/checkpoint.py``), so a reader never sees a partial file.  A
:class:`ModelRegistry` watches ``model_dir`` for a newer counter,
verifies the file against its ``.crc32`` digest sidecar, loads the
params through the retried model-file reader, warms them on the device
and swaps them into the live engine.  Batches in flight finish on the
params they started with; every batch dispatched after the swap serves
the new ones (the engines' snapshot semantics, ``serve/engine.py``).

Reload state machine (one cycle per detected counter, recorded in
:attr:`ModelRegistry.transitions`)::

    IDLE -> DETECTED -> VERIFYING -> LOADING -> WARMING -> SWAPPED
                           |            |
                           +-> REJECTED-+   (recorded to the failure log;
                                             retried up to ``max_attempts``
                                             polls, then blacklisted)

A REJECTED checkpoint never reaches the engine: the previous version
keeps serving.  :class:`MultiModelRegistry` serves N models on one card
under a :class:`MemoryBudgeter`, loading on demand and evicting the
coldest model that is neither pinned, leased nor busy; its
``kv_share_dir`` root and :meth:`MultiModelRegistry.kv_engine_kwargs`
wire each model's engines into the tiered KV cache.

Telemetry (``obs/``, as JAX's registries): a reload runs in a
``registry.reload`` span and its swap in a ``registry.swap`` span;
:meth:`ModelRegistry.register_into` puts the swap stamps on a hub's
``/metrics`` and the state machine on its ``/statusz``; the fleet's
``budget_drift`` holds the budgeter's closed-form resident bytes (the
trees' elements) against the engines' ledger rows
(``PredictEngine.ledger_bytes``: the bytes the allocator held for the
stored trees at the forwards' first calls, its blocks on a card).
"""

from __future__ import annotations

import contextlib
import os
import re
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..obs import span

from ..nnet import checkpoint
from ..nnet.net_config import NetConfig
from ..runtime import faults
from ..utils.metric import StatSet

__all__ = ['ModelRegistry', 'MultiModelRegistry', 'MemoryBudgeter',
           'load_model_params', 'newest_model_file', 'load_into_trainer',
           'fleet_factory']

_MODEL_RE = re.compile(r'^(\d+)\.model$')


def newest_model_file(model_dir: str,
                      pattern=None) -> Optional[Tuple[int, str]]:
    """Highest-counter model file in ``model_dir`` as ``(counter, path)``
    (None when none match): the one scan every fleet factory and the
    registry share."""
    rx = _MODEL_RE if pattern is None else re.compile(pattern)
    best: Optional[Tuple[int, str]] = None
    try:
        names = os.listdir(os.fspath(model_dir))
    except OSError:
        return None
    for name in names:
        m = rx.match(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), os.path.join(model_dir, name))
    return best


def load_into_trainer(trainer, path: str, retry=None):
    """Load a model file into ``trainer`` through the retried reader
    (skipping the net-type prefix): the fleet factories' load path."""

    def _read(f):
        f.read(4)
        trainer.load_model(f)

    checkpoint.read_model_file(path, _read, retry=retry)
    return trainer


def fleet_factory(make_trainer: Callable, model_dir: str, buckets,
                  dtype: str = 'f32') -> Callable:
    """Factory for one fleet model: a trainer from ``make_trainer()``,
    loaded from the newest checkpoint in ``model_dir`` through the
    retried reader, behind a ``PredictEngine`` at ``dtype``.  The
    closure holds no trainer: the engine owns every reference, so an
    eviction frees the device memory.  The trainer's own f32 tree is
    dropped once the engine has placed it: the engine's tree is the only
    one resident, as the budgeter counts it (a quantized tier would
    otherwise keep the f32 tree beside it, and a hot swap the old one).
    Shared by ``wrapper.Net.serve_start(models=)`` and the CLI's
    ``serve.models``."""
    from .engine import PredictEngine

    def factory():
        best = newest_model_file(model_dir)
        if best is None:
            raise FileNotFoundError(f'no model files in {model_dir}')
        tr = load_into_trainer(make_trainer(), best[1])
        engine = PredictEngine(tr, buckets, dtype=dtype)
        tr.params = None
        return engine
    return factory


def load_model_params(engine, path: str, retry=None):
    """Read a model file and return its param tree on the host, checked
    against ``engine``'s net structure (layer count and types must match:
    a hot swap cannot change the architecture).  Raises
    ``CheckpointCorruptError`` on a truncated blob, ``ValueError`` on a
    structural mismatch; transient I/O errors retry under ``retry``."""

    def read(f):
        f.read(4)                      # net_type prefix
        cfg = NetConfig()
        cfg.load_net(f)
        f.read(8)                      # epoch_counter, irrelevant here
        (blob_len,) = struct.unpack('<Q', f.read(8))
        blob = f.read(blob_len)
        if len(blob) != blob_len:
            raise faults.CheckpointCorruptError(
                f'{path}: model blob truncated '
                f'({len(blob)}/{blob_len} bytes)')
        return cfg, blob

    cfg, blob = checkpoint.read_model_file(path, read, retry=retry)
    serving = engine.trainer.net_cfg.layers
    if len(cfg.layers) != len(serving) or any(
            a.type != b.type for a, b in zip(cfg.layers, serving)):
        raise ValueError(
            f'{path}: net structure differs from the serving model '
            f'({len(cfg.layers)} vs {len(serving)} layers) — '
            'hot reload cannot change architecture')
    return checkpoint.blob_to_params(engine.trainer.net, blob,
                                     torch.device('cpu'))


class ModelRegistry:
    """Watch ``model_dir`` and hot-swap newer checkpoints into ``engine``.

    ``current`` is the counter being served (the loaded model's, so the
    first poll does not reload it; -1 adopts whatever appears first).
    ``on_swap(counter, path)`` runs after each swap.  ``pattern`` and
    ``loader`` watch other files than model files (decode models:
    ``serve/decode.py`` ``LM_PATTERN`` / ``lm_loader``); ``attempts`` is
    the counter -> failed cycles map, shared by a fleet so a blacklist
    outlives an eviction.
    """

    def __init__(self, engine, model_dir: str, poll_interval: float = 1.0,
                 current: int = -1, retry: Optional[faults.RetryPolicy] = None,
                 log: Optional[faults.FailureLog] = None,
                 on_swap: Optional[Callable[[int, str], None]] = None,
                 pattern: Optional[str] = None,
                 loader: Optional[Callable] = None,
                 attempts: Optional[dict] = None):
        self.engine = engine
        self.model_dir = os.fspath(model_dir)
        self.poll_interval = float(poll_interval)
        self.current = int(current)
        self.retry = faults.DEFAULT_IO_RETRY if retry is None else retry
        self.log = faults.global_failure_log() if log is None else log
        self.on_swap = on_swap
        self._re = _MODEL_RE if pattern is None else re.compile(pattern)
        self._loader = load_model_params if loader is None else loader
        self.transitions: List[Tuple[str, str]] = []  # guarded-by: _lock
        # swap stamps: the counter adopted last and when it swapped in
        # (the serving half of the freshness metric)
        self.swaps = 0                       # guarded-by: _lock
        self.last_swap_step: int = -1        # guarded-by: _lock (-1: never)
        self.last_swap_time: Optional[float] = None   # guarded-by: _lock
        # the seconds of the last cycle's stages, for a reload's cost
        self.last_timings: Dict[str, float] = {}      # guarded-by: _lock
        self._attempts: dict = {} if attempts is None else attempts
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        engine.version = self.current

    # -- observability -----------------------------------------------------
    _MAX_TRANSITIONS = 512

    def _note(self, state: str, detail: str) -> None:
        with self._lock:
            self.transitions.append((state, detail))
            # a long-lived server must not grow this without bound
            if len(self.transitions) > self._MAX_TRANSITIONS:
                del self.transitions[:len(self.transitions)
                                     - self._MAX_TRANSITIONS]

    def states(self) -> List[str]:
        with self._lock:
            return [s for s, _ in self.transitions]

    # -- scanning ----------------------------------------------------------
    def candidates_on_disk(self) -> List[Tuple[int, str]]:
        """Model files newer than the serving counter, newest first."""
        out: List[Tuple[int, str]] = []
        try:
            names = os.listdir(self.model_dir)
        except OSError:
            return out
        for name in names:
            m = self._re.match(name)
            # current is one int advanced only by the poll thread: a
            # stale read is one poll late
            if m and int(m.group(1)) > self.current:
                out.append((int(m.group(1)),
                            os.path.join(self.model_dir, name)))
        out.sort(reverse=True)
        return out

    def latest_on_disk(self) -> Optional[Tuple[int, str]]:
        """Newest (counter, path) model file in ``model_dir``, or None."""
        cand = self.candidates_on_disk()
        return cand[0] if cand else None

    # -- one reload cycle --------------------------------------------------
    def poll_once(self) -> bool:
        """Adopt the newest loadable checkpoint past the serving one.
        Candidates are tried newest first, so a blacklisted newest file
        falls back to the next good one.  True when a swap happened.
        Never raises for a bad checkpoint: the rejection is recorded and
        counted toward that counter's blacklist, and the old version
        keeps serving."""
        for counter, path in self.candidates_on_disk():
            if self._attempts.get(counter, 0) >= self.retry.max_attempts:
                continue                  # blacklisted: persistent reject
            self._note('DETECTED', path)
            times = {}
            try:
                with span('registry.reload', 'serve', counter=counter):
                    t = time.perf_counter()
                    self._note('VERIFYING', path)
                    reason = checkpoint.verify_model_digest(path)
                    if reason:
                        raise faults.CheckpointCorruptError(
                            f'{path}: {reason}')
                    times['verify_s'] = time.perf_counter() - t
                    t = time.perf_counter()
                    self._note('LOADING', path)
                    params = self._loader(self.engine, path,
                                          retry=self.retry)
                    times['load_s'] = time.perf_counter() - t
                    t = time.perf_counter()
                    self._note('WARMING', path)
                    placed = self.engine.place_params(params)
                    self.engine.warm_params(placed)
                    times['warm_s'] = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001 — rejected and counted
                # ANY failure (I/O, structure, device OOM in the warm)
                # rejects and counts: an uncounted error would rerun the
                # whole cycle every poll forever
                self._attempts[counter] = self._attempts.get(counter, 0) + 1
                self._note('REJECTED', f'{path}: {e!r}')
                self.log.record('serve_reload_reject',
                                f'checkpoint {counter} rejected: {e!r}')
                continue
            t = time.perf_counter()
            with span('registry.swap', 'serve', counter=counter):
                self.engine.swap_params(placed, version=counter)
            times['swap_s'] = time.perf_counter() - t
            self.current = counter
            with self._lock:
                self.swaps += 1
                self.last_swap_step = counter
                self.last_swap_time = time.monotonic()
                self.last_timings = times
            self._note('SWAPPED', path)
            if self.on_swap is not None:
                self.on_swap(counter, path)
            return True
        return False

    # -- freshness stamps ---------------------------------------------------
    def last_swap_age_s(self) -> float:
        """Seconds since the last swap (NaN before the first one)."""
        with self._lock:
            t = self.last_swap_time
        return float('nan') if t is None else time.monotonic() - t

    def report(self, stats=None, name: str = 'registry') -> str:
        """Swap stamps and the blacklist in eval-line format (optionally
        onto a shared ``StatSet``)."""
        stats = StatSet() if stats is None else stats
        with self._lock:
            stats.gauge('swaps', self.swaps)
            stats.gauge('last_swap_step', self.last_swap_step)
            t = self.last_swap_time
        if t is not None:
            stats.gauge('last_swap_age_s', time.monotonic() - t)
        stats.gauge('blacklisted',
                    sum(1 for v in self._attempts.copy().values()
                        if v >= self.retry.max_attempts))
        return stats.print(name)

    def status_view(self) -> dict:
        """The state machine's tail and the swap stamps, as one dict."""
        current = self.current
        with self._lock:
            return {'current': current,
                    'swaps': self.swaps,
                    'last_swap_step': self.last_swap_step,
                    'transitions': [s for s, _ in self.transitions[-12:]]}

    def register_into(self, hub, name: str = 'registry'):
        """Register the swap stamps (``/metrics``, refreshed per render)
        and the state-machine view (``/statusz``) into a telemetry hub;
        returns the hub-owned StatSet."""
        stats = StatSet()
        hub.register_stats(name, stats,
                           refresh=lambda: self.report(stats=stats))
        hub.register_status(name, self.status_view)
        return stats

    # -- watcher lifecycle -------------------------------------------------
    def start(self) -> None:
        """Start the polling watcher thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name='serve-registry')
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher outlives it
                self.log.record('serve_reload_error',
                                f'registry poll failed: {e!r}')

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop the watcher (idempotent, re-entrant safe)."""
        self._stop.set()
        t = self._thread
        if t is None or t is threading.current_thread():
            return True
        t.join(timeout)
        return not t.is_alive()


# --- multi-model fleet ----------------------------------------------------


class MemoryBudgeter:
    """Device-memory ledger for a fleet of serving models.

    Tracks each model's resident bytes against a budget (0 = unbounded):
    a scalar (a single-device engine, on device 0) or a per-device vector
    (replicated engines, ``resident_bytes_per_device()``).  The budget is
    per device, and ``over_budget()`` prices the most loaded one.  It
    frees nothing itself: :class:`MultiModelRegistry` asks it who is over
    and evicts."""

    def __init__(self, budget_bytes: int = 0):
        self.budget = int(budget_bytes)       # guarded-by: _lock
        self._resident: Dict[str, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def set_budget(self, budget_bytes: int) -> int:
        """Retune the budget live (0 = unbounded); accounting only, the
        registry evicts on its next pass.  Returns the previous one."""
        with self._lock:
            prev, self.budget = self.budget, int(budget_bytes)
        return prev

    def account(self, model_id: str, nbytes) -> None:
        """Ledger one model: a scalar or a per-device vector (positional;
        a scalar is device 0)."""
        with self._lock:
            if isinstance(nbytes, (list, tuple)):
                self._resident[model_id] = tuple(int(b) for b in nbytes)
            else:
                self._resident[model_id] = int(nbytes)

    def release(self, model_id: str) -> int:
        with self._lock:
            ent = self._resident.pop(model_id, 0)
            return sum(ent) if isinstance(ent, tuple) else ent

    def usage(self) -> int:
        """Fleet-total resident bytes (every device summed)."""
        with self._lock:
            return sum(sum(e) if isinstance(e, tuple) else e
                       for e in self._resident.values())

    def usage_per_device(self) -> List[int]:
        """Per-device load: vectors add positionally, scalars land on
        device 0; the widest vector sets the length."""
        with self._lock:
            n = max((len(e) for e in self._resident.values()
                     if isinstance(e, tuple)), default=1)
            out = [0] * n
            for e in self._resident.values():
                if isinstance(e, tuple):
                    for i, b in enumerate(e):
                        out[i] += b
                else:
                    out[0] += e
            return out

    def resident(self) -> Dict[str, int]:
        with self._lock:
            return {k: (sum(e) if isinstance(e, tuple) else e)
                    for k, e in self._resident.items()}

    def over_budget(self) -> int:
        """Bytes past the budget on the most loaded device (0 inside it
        or unbounded)."""
        if self.budget <= 0:
            return 0
        return max(0, max(self.usage_per_device()) - self.budget)


class _ManagedModel:
    """One fleet entry: how to build its engine, where its checkpoints
    live, and its load and eviction state."""

    __slots__ = ('model_id', 'factory', 'engine', 'model_dir', 'pattern',
                 'loader', 'current', 'attempts', 'registry', 'last_used',
                 'pinned', 'leases')

    def __init__(self, model_id, factory, model_dir, pattern, loader,
                 current, pinned):
        self.model_id = model_id
        self.factory = factory
        self.engine = None
        self.model_dir = model_dir
        self.pattern = pattern
        self.loader = loader
        self.current = int(current)
        self.attempts: dict = {}       # the blacklist outlives evictions
        self.registry: Optional[ModelRegistry] = None
        self.last_used = 0.0
        self.pinned = bool(pinned)
        self.leases = 0                # callers inside lease() blocks


def _sync_tree(tree) -> None:
    """Wait for the device work that produced ``tree``'s tensors."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, torch.Tensor):
            if node.is_cuda:
                torch.cuda.synchronize(node.device)
            return


class _DraftAdapter:
    """The ``ModelRegistry`` engine shim for speculative-decode drafts:
    verified checkpoints go to the target ``DecodeEngine``'s draft slot
    (``place_draft_params`` / ``swap_draft_params``).  The target is
    looked up through the fleet on every call, under a lease, so a swap
    after an evict-and-reload lands on the live engine."""

    __slots__ = ('fleet', 'model_id', 'version')

    def __init__(self, fleet, model_id):
        self.fleet = fleet
        self.model_id = model_id
        self.version = -1

    def place_params(self, host_params):
        with self.fleet.lease(self.model_id) as engine:
            return engine.place_draft_params(host_params)

    def warm_params(self, placed) -> None:
        _sync_tree(placed)

    def swap_params(self, placed, version: object = None) -> None:
        with self.fleet.lease(self.model_id) as engine:
            engine.swap_draft_params(placed, version=version)
        self.version = version


class MultiModelRegistry:
    """N models on one card under a device-memory budget.

    Each model is registered with a ``factory`` (a zero-argument callable
    building its engine, a ``PredictEngine`` or ``DecodeEngine``; the
    factory owns EVERY reference to the model's device state, so an
    eviction really frees the memory) and optionally a ``model_dir`` to
    hot-reload from (a per-model :class:`ModelRegistry`, its blacklist
    kept across evictions).

    * ``get(model_id)`` loads on demand and touches the LRU clock;
    * after a load, models are evicted coldest first (oldest
      ``last_used``) until the ledger fits — never a busy, pinned or
      leased model, and never the one just requested;
    * when nothing evictable is left and the ledger is still over, the
      load is rolled back and ``MemoryBudgetExceededError`` raised.
    """

    def __init__(self, mem_budget: int = 0, poll_interval: float = 1.0,
                 log: Optional[faults.FailureLog] = None,
                 kv_share_dir: Optional[str] = None):
        self.budgeter = MemoryBudgeter(mem_budget)
        self.poll_interval = float(poll_interval)
        self.log = faults.global_failure_log() if log is None else log
        # the fleet's root for the tiered KV cache: engine factories take
        # their serve.kv_* wiring from kv_engine_kwargs(), so replicas of
        # one model share a directory and different models never alias
        self.kv_share_dir = (None if kv_share_dir is None
                             else os.fspath(kv_share_dir))
        self._models: Dict[str, _ManagedModel] = {}  # guarded-by: _lock
        self._drafts: List[ModelRegistry] = []       # guarded-by: _lock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evictions = 0

    # -- registration / loading -------------------------------------------
    def add_model(self, model_id: str, factory: Callable,
                  model_dir: Optional[str] = None,
                  pattern: Optional[str] = None,
                  loader: Optional[Callable] = None,
                  current: int = -1, pinned: bool = False,
                  load: bool = False) -> None:
        with self._lock:
            if model_id in self._models:
                raise ValueError(f'model {model_id!r} already registered')
            self._models[model_id] = _ManagedModel(
                model_id, factory, model_dir, pattern, loader, current,
                pinned)
        if load:
            self.get(model_id)

    def kv_engine_kwargs(self, model_id: str, kv_host_mb: int = 0,
                         kv_disk_mb: int = 0) -> dict:
        """The ``kv_*`` kwargs an engine factory passes to
        ``DecodeEngine`` / ``DecodeService`` to join the fleet's tiered KV
        cache: a per-process local record dir and a per-model share dir
        under ``kv_share_dir`` (records carry no model identity, so two
        models at the same checkpoint number must not share one flat
        directory).  Empty without a root or with both tiers off."""
        if self.kv_share_dir is None \
                or (kv_host_mb <= 0 and kv_disk_mb <= 0):
            return {}
        kw = {'kv_host_mb': int(kv_host_mb)}
        if kv_disk_mb > 0:
            kw.update(
                kv_disk_mb=int(kv_disk_mb),
                kv_dir=os.path.join(self.kv_share_dir, 'local',
                                    f'{model_id}.{os.getpid()}'),
                kv_share_dir=os.path.join(self.kv_share_dir, 'shared',
                                          model_id))
        return kw

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def loaded(self) -> List[str]:
        with self._lock:
            return sorted(m for m, e in self._models.items()
                          if e.engine is not None)

    def _entry(self, model_id: str) -> _ManagedModel:  # requires-lock: _lock
        entry = self._models.get(model_id)
        if entry is None:
            raise KeyError(f'unknown model {model_id!r}')
        return entry

    def get(self, model_id: str):
        """The engine for ``model_id``, loaded on demand, LRU-touched,
        the budget enforced after a cold load.  The reference is safe
        from eviction only while the engine is ``busy()``: a caller about
        to run a forward should take :meth:`lease`."""
        with self._lock:
            entry = self._entry(model_id)
            if entry.engine is None:
                self._load(entry)
            entry.last_used = time.monotonic()
            return entry.engine

    def lease(self, model_id: str):
        """Context manager: the engine for ``model_id``, never evicted
        until the block exits."""

        @contextlib.contextmanager
        def _leased():
            with self._lock:
                entry = self._entry(model_id)
                if entry.engine is None:
                    self._load(entry)
                entry.last_used = time.monotonic()
                entry.leases += 1
                engine = entry.engine
            try:
                yield engine
            finally:
                with self._lock:
                    entry.leases -= 1
        return _leased()

    def _load(self, entry: _ManagedModel) -> None:  # requires-lock: _lock
        entry.engine = entry.factory()
        per_dev = getattr(entry.engine, 'resident_bytes_per_device', None)
        self.budgeter.account(
            entry.model_id,
            per_dev() if per_dev is not None
            else int(entry.engine.resident_bytes()))
        if entry.model_dir is not None:
            entry.registry = ModelRegistry(
                entry.engine, entry.model_dir, current=entry.current,
                pattern=entry.pattern, loader=entry.loader,
                attempts=entry.attempts, log=self.log,
                on_swap=lambda c, p, e=entry: setattr(e, 'current', c))
        try:
            self._enforce_budget(protect=entry.model_id)
        except faults.MemoryBudgetExceededError:
            self._evict(entry)      # roll back: the cold load loses
            raise

    def _evictable(self, entry: _ManagedModel) -> bool:
        return (entry.engine is not None and not entry.pinned
                and entry.leases == 0
                and not getattr(entry.engine, 'busy', lambda: False)())

    def _enforce_budget(self, protect: str) -> None:  # requires-lock: _lock
        while self.budgeter.over_budget():
            victims = [e for e in self._models.values()
                       if e.model_id != protect and self._evictable(e)]
            if not victims:
                resident = self.budgeter.resident()
                raise faults.MemoryBudgetExceededError(
                    protect, resident.get(protect, 0),
                    self.budgeter.budget, sum(resident.values()))
            self._evict(min(victims, key=lambda e: e.last_used))

    def _evict(self, entry: _ManagedModel) -> None:  # requires-lock: _lock
        freed = self.budgeter.release(entry.model_id)
        if entry.registry is not None:
            entry.registry.close(timeout=5.0)
            entry.registry = None
        eng = entry.engine
        entry.engine = None
        if eng is not None and hasattr(eng, 'close'):
            eng.close(timeout=5.0)
        self.evictions += 1
        self.log.record('serve_evicted',
                        f'model {entry.model_id!r} evicted '
                        f'({freed} bytes freed)')

    def evict(self, model_id: str) -> None:
        """Unload a model explicitly (it reloads on its next ``get``)."""
        with self._lock:
            entry = self._entry(model_id)
            if entry.engine is not None:
                self._evict(entry)

    def evict_coldest(self) -> Optional[str]:
        """Evict the coldest evictable model under the rules budget
        enforcement obeys (never busy, pinned or leased); its id, or None
        when nothing was evictable."""
        with self._lock:
            victims = [e for e in self._models.values()
                       if self._evictable(e)]
            if not victims:
                return None
            coldest = min(victims, key=lambda e: e.last_used)
            self._evict(coldest)
            return coldest.model_id

    # -- speculative-decode drafts -----------------------------------------
    def attach_draft(self, model_id: str, draft_dir: str,
                     pattern: Optional[str] = None,
                     loader: Optional[Callable] = None,
                     current: int = -1) -> ModelRegistry:
        """Watch ``draft_dir`` for newer draft checkpoints and swap them
        into ``model_id``'s decode engine's draft slot through the same
        verify and blacklist machinery (a draft changes only the
        acceptance rate, never a stream).  The engine must have been
        built with a draft model.  Returns the watching registry (it
        polls with the fleet)."""
        with self.lease(model_id) as engine:
            if getattr(engine, '_draft_cfg', None) is None:
                raise ValueError(
                    f'model {model_id!r} has no draft slot (build its '
                    'engine with draft=(params, cfg))')
        reg = ModelRegistry(_DraftAdapter(self, model_id), draft_dir,
                            current=current, pattern=pattern, loader=loader,
                            log=self.log)
        with self._lock:
            self._drafts.append(reg)
        return reg

    # -- hot swap ----------------------------------------------------------
    def swap_model(self, model_id: str, host_params,
                   version: object = None) -> None:
        """Warm, then swap, a new param tree into a model's live engine
        (a decode engine drains its streams first: no drops)."""
        engine = self.get(model_id)
        placed = engine.place_params(host_params)
        engine.warm_params(placed)
        engine.swap_params(placed, version=version)

    def poll_once(self) -> int:
        """One reload cycle over every loaded, watched model and every
        attached draft watcher; the number of swaps."""
        with self._lock:
            regs = [e.registry for e in self._models.values()
                    if e.registry is not None] + list(self._drafts)
        return sum(1 for r in regs if r.poll_once())

    # -- watcher / observability -------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name='serve-fleet')
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher outlives it
                self.log.record('serve_reload_error',
                                f'fleet poll failed: {e!r}')

    def close(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        with self._lock:
            for reg in self._drafts:
                reg.close(timeout=timeout)
            self._drafts.clear()
            for entry in self._models.values():
                if entry.registry is not None:
                    entry.registry.close(timeout=timeout)
                    entry.registry = None
                if entry.engine is not None and hasattr(entry.engine,
                                                        'close'):
                    entry.engine.close(timeout)

    def report(self, stats=None, name: str = 'fleet') -> str:
        """The budget ledger in eval-line format (optionally onto a
        shared ``StatSet``)."""
        stats = StatSet() if stats is None else stats
        stats.gauge('resident_bytes', self.budgeter.usage())
        per_dev = self.budgeter.usage_per_device()
        if len(per_dev) > 1:  # replicated fleet: the per-device vector
            for i, b in enumerate(per_dev):
                stats.gauge(f'resident_bytes[d{i}]', int(b))
        stats.gauge('budget_bytes', self.budgeter.budget)
        stats.gauge('models_loaded', len(self.loaded()))
        stats.gauge('models_total', len(self.models()))
        stats.gauge('evictions', self.evictions)
        for mid, nb in sorted(self.budgeter.resident().items()):
            stats.gauge(f'bytes[{mid}]', nb)
        drift = self.budget_drift()
        if drift is not None:
            stats.gauge('budget_drift', round(drift, 4))
        return stats.print(name)

    def budget_drift(self) -> Optional[float]:
        """Signed relative drift of the budgeter's closed-form resident
        bytes against the ledger rows' (``engine.ledger_bytes()``: what
        the allocator held for the trees), summed over every loaded
        engine that has served: the
        ``fleet.budget_drift`` gauge.  None until a loaded engine has a
        row."""
        closed = truth = 0
        with self._lock:
            engines = [e.engine for e in self._models.values()
                       if e.engine is not None]
        for eng in engines:
            lb = getattr(eng, 'ledger_bytes', lambda: None)()
            if lb is None or lb <= 0:
                continue
            closed += eng.resident_bytes()
            truth += lb
        if truth <= 0:
            return None
        return closed / truth - 1.0
