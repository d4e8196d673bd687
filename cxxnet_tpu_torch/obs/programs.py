"""The program ledger, device-memory gauges, MFU and the on-demand
profiler.

The port's own copy of ``cxxnet_tpu/obs/programs.py``, recast for eager
PyTorch.  There is no compiler here, so each of JAX's compiler-truth
numbers becomes what eager execution can state:

* **program ledger** — each call site claims a :class:`LedgerProgram`
  (a name and an optional declared bound on its shape keys) and runs its
  callable through :meth:`LedgerProgram.run` with the call's shape key.
  A key already met dispatches the callable directly (one dict lookup);
  the first call at a new key registers one :class:`ProgramEntry`
  (name, shape key, signature) and is timed.  Recast fields:

  - ``compile_ms`` is the first call's host wall ms at that key (kernel
    builds, the allocator's first blocks and the library's first
    plans land there; nothing is synchronized, so device work still
    queued is not in it);
  - ``flops`` is the port's own count of the products the call runs, at
    2 · MACs each, from the shapes the net or the LM config already
    states (:func:`cnn_step_flops`, :func:`lm_flops`) — never a cost
    model.  Elementwise work is not counted, so it stays below JAX's
    XLA count of the same step;
  - ``argument_bytes`` is the call's parameter and state bytes (the
    param tree, plus the optimizer slots and the gradient accumulator
    of a train step, plus the KV pools of a decode step);
  - there are no ``bytes_accessed`` / ``output_bytes`` / ``temp_bytes``
    / ``peak_bytes`` fields: nothing here could fill them.

  Served raw on ``/programs``, summarized in ``/statusz``, exported as
  gauges on ``/metrics``.
* **recompile sentinel** — a program that meets more shape keys than
  its declared bound bumps ``recompiles_total`` and records the typed
  ``faults.RecompileStormError`` kind; ``obs.recompile=raise`` raises it
  at the offending call site, before the call runs (default ``warn``).
* **device-memory gauges** — :class:`DeviceMemory` fills ``hbm.*`` per
  CUDA device from the caching allocator
  (``torch.cuda.memory_stats``: ``bytes_in_use`` is
  ``allocated_bytes.all.current``, ``peak_bytes``
  ``allocated_bytes.all.peak``) and the driver (``limit_bytes`` is the
  total of ``torch.cuda.mem_get_info``); neither call synchronizes the
  device.  ``supported`` is 1 there.  Without a card (``supported`` 0)
  it walks the live ``torch.Tensor`` objects, one count per storage —
  JAX's ``jax.live_arrays()`` walk.
* **MFU** — :func:`peak_flops` is a table of NVIDIA parts keyed by
  ``torch.cuda.get_device_name`` (dense bf16 tensor-core peaks;
  ``CXXNET_PEAK_TFLOPS`` overrides); :func:`mfu` divides flops/step ×
  measured steps/sec by it.  The CPU's peak is 0.0: MFU is then
  unreported, never 0.
* **on-demand profiler** — :class:`ProfilerSession` backs the
  ``/profile?ms=N`` endpoint: one ``torch.profiler`` window at a time
  into the obs dir, with ``ProfilerActivity.CUDA`` whenever a card is
  present, mutually exclusive with a ``profile_dir`` ``TraceWindow``
  (``utils/profiler.acquire_trace``).  It does not demote the K-step
  window: an on-demand trace observes what is live.
"""

from __future__ import annotations

import collections
import gc
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ['ProgramLedger', 'LedgerProgram', 'ProgramEntry', 'get_ledger',
           'install_ledger', 'DeviceMemory', 'register_hbm',
           'ProfilerSession', 'profile_session', 'peak_flops', 'mfu',
           'PEAK_BF16_TFLOPS', 'cnn_step_flops', 'lm_flops', 'tree_bytes']


# --- per-part peak FLOPs (MFU denominators) ---------------------------------

#: dense bf16 tensor-core peak TFLOP/s of NVIDIA parts, by a substring of
#: ``torch.cuda.get_device_name`` (first match wins, so a named variant
#: precedes its family), from NVIDIA's data sheets.  THE table: the
#: train line's ``train-mfu`` and the chip smoke both divide by it.
PEAK_BF16_TFLOPS: Tuple[Tuple[str, float], ...] = (
    ('H100 PCIe', 756.0), ('H100 NVL', 835.0), ('H100', 989.0),
    ('H200', 989.0), ('H800', 989.0), ('A100', 312.0), ('L40S', 362.0),
)


def _cuda_index(device) -> Optional[int]:
    """The CUDA ordinal ``device`` names (None: CPU, or no card)."""
    import torch
    if device is None:
        return 0 if torch.cuda.is_available() else None
    if isinstance(device, int):
        return device
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    return 0 if dev.index is None else dev.index


def peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of one card.  ``CXXNET_PEAK_TFLOPS``
    overrides (how a CPU run or an untabulated part gets a denominator);
    0.0 on the CPU or an untabulated part — MFU is then unreported."""
    env = os.environ.get('CXXNET_PEAK_TFLOPS')
    if env:
        return float(env) * 1e12
    idx = _cuda_index(device)
    if idx is None:
        return 0.0
    import torch
    name = torch.cuda.get_device_name(idx)
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in name:
            return tflops * 1e12
    return 0.0


def mfu(flops_per_step: float, steps_per_sec: float,
        device=None) -> Optional[float]:
    """Model FLOPs utilization, or None when the peak (or the flops) is
    unknown."""
    peak = peak_flops(device)
    if peak <= 0 or flops_per_step <= 0 or steps_per_sec <= 0:
        return None
    return flops_per_step * steps_per_sec / peak


# --- the products a call runs ------------------------------------------------

def _conv_macs(layer, spec_in, spec_out) -> int:
    p = layer.param
    return (spec_out.y * spec_out.x * p.num_channel
            * (spec_in.c // p.num_group) * p.kernel_height * p.kernel_width)


def cnn_step_flops(net, batch: int, train: bool = True) -> float:
    """The products of one forward (``train=False``) or one train step of
    ``net`` at ``batch`` rows, 2 · MACs each: every conv and fullc layer's
    forward; in a train step also every weight gradient and every input
    gradient but those of layers reading a data node (nothing upstream
    wants them).  From ``net.node_specs``, the shapes the net inferred;
    elementwise work, pooling, LRN and the updater are not counted."""
    cfg = net.cfg
    n_data = 1 + int(getattr(cfg, 'extra_data_num', 0))
    macs = 0
    for i, info in enumerate(cfg.layers):
        layer = net.layers[i]
        kind = getattr(layer, 'type_name', '')
        if kind not in ('conv', 'fullc'):
            continue
        sin = net.node_specs[info.nindex_in[0]]
        sout = net.node_specs[info.nindex_out[0]]
        if kind == 'conv':
            per = _conv_macs(layer, sin, sout)
        else:
            per = sin.flat_size * sout.flat_size
        per *= int(batch)
        macs += per
        if train:
            macs += per                                  # weight gradient
            if info.nindex_in[0] >= n_data:
                macs += per                              # input gradient
    return 2.0 * macs


def lm_flops(cfg, rows: int, attn_pairs: int, head_rows: int) -> float:
    """The products of one TransformerLM call, 2 · MACs each: ``rows``
    token rows through every block's q, k, v, o projections and its two
    FFN matrices, ``attn_pairs`` (query, key) pairs through the scores
    and the weighted values of every block, and ``head_rows`` rows
    through the vocabulary head."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_stage = rows * (4 * d * d + 2 * d * f) + 2 * attn_pairs * d
    return 2.0 * (cfg.num_stages * per_stage + head_rows * d * v)


def tree_bytes(*trees) -> int:
    """Bytes of every leaf of nested dicts, lists and tuples: a tensor's
    elements, or a leaf's own ``nbytes`` (an int8 ``QuantLeaf``'s payload
    and scales, a numpy array)."""
    import torch
    total = 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(getattr(t, 'nbytes', None), int):
            total += t.nbytes
    return int(total)


def held_bytes(*trees) -> int:
    """Bytes the allocator holds for the tensors of ``trees``: each
    distinct storage once (a view or an alias counts its buffer), at the
    size of its caching-allocator block on a card (the allocator's
    rounding and an unsplit remainder included), at the storage's own
    bytes on the CPU.  The serving rows' ``argument_bytes``: what the
    fleet's ``budget_drift`` holds the element count
    (``quantize.tree_nbytes``) against."""
    import torch
    held: Dict[Tuple[str, int, int], int] = {}
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            held[(t.device.type, t.device.index or 0, st.data_ptr())] = \
                st.nbytes()
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(getattr(t, 'q', None), torch.Tensor):
            stack.extend((t.q, t.scale))     # an int8 QuantLeaf
    if any(k[0] == 'cuda' for k in held):
        blocks = {('cuda', seg['device'], b['address']): b['size']
                  for seg in torch.cuda.memory_snapshot()
                  for b in seg['blocks']}
        held = {k: blocks.get(k, n) for k, n in held.items()}
    return int(sum(held.values()))


# --- the ledger -------------------------------------------------------------

class ProgramEntry:
    """One (program name, shape key) row of the ledger, filled at the
    first call at that key."""

    __slots__ = ('name', 'shape_key', 'signature', 'compile_ms', 'flops',
                 'argument_bytes', 'compiles', 'calls', 'steps', 'seq')

    def __init__(self, name: str, shape_key: str, signature: str,
                 steps: int, seq: int):
        self.name = name
        self.shape_key = shape_key
        self.signature = signature
        self.compile_ms = 0.0
        self.flops = 0.0
        self.argument_bytes = 0
        self.compiles = 0
        self.calls = 0
        self.steps = max(1, int(steps))
        self.seq = seq

    def view(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


#: what a call site's ``info`` callable returns at a new key:
#: ``(flops, argument_bytes, signature)``
Info = Callable[[], Tuple[float, int, str]]


class LedgerProgram:
    """One named program family in the ledger (claimed through
    :meth:`ProgramLedger.program`).  ``bound`` is the declared shape-key
    bound the recompile sentinel enforces."""

    def __init__(self, ledger: 'ProgramLedger', name: str,
                 bound: Optional[int] = None):
        self.ledger = ledger
        self.name = name
        self.bound = None if bound is None else int(bound)
        # mutated under the ledger's lock; read lock-free on the call
        # path (a dict membership test is atomic under the GIL)
        self.compiles = 0
        self._keys: Dict[str, ProgramEntry] = {}
        self._warned = False

    def run(self, key, fn, *args, info: Optional[Info] = None,
            steps: int = 1, **kwargs):
        """``fn(*args, **kwargs)``.  The first call at shape key ``key``
        registers its row (``info()`` gives the flops, parameter bytes and
        signature; ``steps`` normalizes the flops of a K-step window) and
        is timed; later calls at the key count and dispatch."""
        key = str(key)
        entry = self._keys.get(key)
        if entry is not None:
            entry.calls += 1
            return fn(*args, **kwargs)
        flops, nbytes, sig = info() if info is not None else (0.0, 0, '')
        entry = self.ledger.record_first(self, key, sig, flops, nbytes,
                                         steps)
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            self.ledger.record_ms(entry, (time.monotonic() - t0) * 1e3)

    def entries(self) -> List[ProgramEntry]:
        """This family's rows, oldest first (each filled at its first
        call: there is no lazy probe to run)."""
        return self.ledger.entries_for(self.name)

    def newest_entry(self) -> Optional[ProgramEntry]:
        es = self.entries()
        return es[-1] if es else None

    def flops_per_step(self) -> float:
        """Newest flops-bearing row's flops over its step count (0.0 when
        nothing ran)."""
        for e in reversed(self.entries()):
            if e.flops > 0:
                return e.flops / e.steps
        return 0.0

    def argument_bytes(self) -> int:
        """Newest row's parameter and state bytes (0 before a call)."""
        e = self.newest_entry()
        return e.argument_bytes if e is not None else 0


class ProgramLedger:
    """Process-wide registry of program rows (module docstring).
    Thread-safe; rows are bounded (oldest pruned)."""

    MAX_ENTRIES = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._recompile = 'warn'       # obs.recompile: warn | raise | off
        self._names: Dict[str, int] = {}          # guarded-by: _lock
        self._entries: 'collections.OrderedDict[Tuple[str, str], ProgramEntry]' = \
            collections.OrderedDict()             # guarded-by: _lock
        self._seq = 0                  # guarded-by: _lock
        self.compiles_total = 0        # guarded-by: _lock
        self.recompiles_total = 0      # guarded-by: _lock
        self.compile_ms_total = 0.0    # guarded-by: _lock
        self._stats = None

    # -- program claims ----------------------------------------------------
    def program(self, name: str,
                bound: Optional[int] = None) -> LedgerProgram:
        """Claim a program name.  A re-claimed base name gets a ``#N``
        suffix (each engine or trainer owns its sentinel state and its
        rows; the ledger keeps both histories)."""
        with self._lock:
            n = self._names.get(name, 0)
            self._names[name] = n + 1
            full = name if n == 0 else f'{name}#{n + 1}'
        return LedgerProgram(self, full, bound=bound)

    def set_recompile(self, mode: str) -> None:
        if mode not in ('warn', 'raise', 'off'):
            raise ValueError(
                f'obs.recompile must be warn|raise|off, got {mode!r}')
        self._recompile = mode

    @property
    def recompile_mode(self) -> str:
        return self._recompile

    # -- recording ---------------------------------------------------------
    def record_first(self, program: LedgerProgram, key: str, signature: str,
                     flops: float, argument_bytes: int,
                     steps: int = 1) -> ProgramEntry:
        """Register ``program``'s first call at shape key ``key`` (a
        second thread racing to the same key gets the first's row).
        Under ``obs.recompile=raise`` a storm raises
        ``faults.RecompileStormError`` here, before the call runs."""
        with self._lock:
            entry = program._keys.get(key)
            if entry is not None:
                entry.calls += 1
                return entry
            program.compiles += 1
            self._seq += 1
            entry = ProgramEntry(program.name, key, signature, steps,
                                 self._seq)
            entry.flops = float(flops)
            entry.argument_bytes = int(argument_bytes)
            entry.compiles = 1
            entry.calls = 1
            ek = (program.name, key)
            self._entries[ek] = entry
            while len(self._entries) > self.MAX_ENTRIES:
                self._entries.popitem(last=False)
            program._keys[key] = entry
            self.compiles_total += 1
            storm = (program.bound is not None
                     and program.compiles > program.bound
                     and self._recompile != 'off')
            if storm:
                self.recompiles_total += 1
            warn_now = storm and not program._warned \
                and self._recompile == 'warn'
            if warn_now:
                program._warned = True
            mode = self._recompile
        from .hub import record_event
        record_event(f'compile.{program.name}', 'obs', key=key)
        if storm:
            from ..runtime import faults
            err = faults.RecompileStormError(program.name, key,
                                             program.bound,
                                             program.compiles)
            if mode == 'raise':
                # the call never runs: the next call at this key meets
                # it anew and raises again, as a JAX retrace does
                with self._lock:
                    program._keys.pop(key, None)
            faults.global_failure_log().record('RecompileStormError',
                                               str(err))
            if mode == 'raise':
                raise err
            if warn_now:
                import sys
                sys.stderr.write(f'obs: {err}\n')
        return entry

    def record_ms(self, entry: ProgramEntry, ms: float) -> None:
        """The first call's wall ms of ``entry`` (once)."""
        with self._lock:
            if entry.compile_ms == 0.0:
                entry.compile_ms = float(ms)
                self.compile_ms_total += float(ms)

    # -- views -------------------------------------------------------------
    def entries_for(self, name: str) -> List[ProgramEntry]:
        with self._lock:
            return sorted((e for (n, _k), e in self._entries.items()
                           if n == name), key=lambda e: e.seq)

    def entries(self) -> List[ProgramEntry]:
        with self._lock:
            return sorted(self._entries.values(), key=lambda e: e.seq)

    def view(self) -> dict:
        """The ``/programs`` body: every row plus the totals."""
        entries = self.entries()
        with self._lock:
            totals = (self.compiles_total, self.recompiles_total,
                      self.compile_ms_total)
        return {
            'programs': [e.view() for e in entries],
            'compiles_total': totals[0],
            'recompiles_total': totals[1],
            'compile_ms_total': round(totals[2], 3),
            'recompile_mode': self._recompile,
        }

    def summary(self) -> dict:
        """The ``/statusz`` one-liner: counts and first-call cost."""
        with self._lock:
            n = len(self._entries)
            totals = (self.compiles_total, self.recompiles_total,
                      self.compile_ms_total)
        return {
            'programs': n,
            'compiles_total': totals[0],
            'recompiles_total': totals[1],
            'compile_ms_total': round(totals[2], 3),
            'recompile_mode': self._recompile,
        }

    @staticmethod
    def _base_name(name: str) -> str:
        return name.split('#', 1)[0]

    def _refresh_stats(self) -> None:
        stats = self._stats
        if stats is None:
            return
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.seq)
            counts = (len(self._entries), self.compiles_total,
                      self.recompiles_total, self.compile_ms_total)
        stats.gauge('programs', counts[0])
        stats.gauge('compiles_total', counts[1])
        stats.gauge('recompiles_total', counts[2])
        stats.gauge('compile_ms_total', round(counts[3], 3))
        # base-name aggregation keeps the label cardinality bounded by
        # the program families, not the row cap
        agg: Dict[str, List[float]] = {}
        for e in entries:
            a = agg.setdefault(self._base_name(e.name), [0.0, 0.0, 0.0])
            a[0] = max(a[0], e.flops / e.steps)
            a[1] = max(a[1], float(e.argument_bytes))
            a[2] += e.compile_ms
        for base, (flops, nbytes, cms) in agg.items():
            stats.gauge(f'flops[{base}]', flops)
            stats.gauge(f'argument_bytes[{base}]', nbytes)
            stats.gauge(f'compile_ms[{base}]', round(cms, 3))

    def register_into(self, hub) -> None:
        """Join the telemetry hub: a ``programs`` StatSet on ``/metrics``
        (and so the history sampler and the SLO engine) plus a
        ``programs`` ``/statusz`` provider."""
        if self._stats is None:
            from ..utils.metric import StatSet
            self._stats = StatSet()
        hub.register_stats('programs', self._stats,
                           refresh=self._refresh_stats)
        hub.register_status('programs', self.summary)


# --- device-memory (hbm.*) gauges -------------------------------------------

class DeviceMemory:
    """Per-device memory gauges (``hbm.*``): ``bytes_in_use[dN]`` /
    ``peak_bytes[dN]`` / ``limit_bytes[dN]`` / ``headroom_frac[dN]`` from
    the CUDA caching allocator and the driver, ``supported`` 1 (a card
    this process never allocated on, but the current one, is left out);
    without a
    card, a walk of the live tensors (``supported`` 0; peak is then the
    in-process monotone max, and headroom is unreported — there is no
    limit to be under)."""

    def __init__(self):
        self._peak_seen: Dict[int, float] = {}

    def fill(self, stats) -> None:
        """Refresh hook: write the current gauges into ``stats`` (per
        ``/metrics`` render and per sampler tick).  Reads the allocator's
        counters and the driver's totals only: never synchronizes."""
        import torch
        if torch.cuda.is_available():
            current = torch.cuda.current_device()
            for i in range(torch.cuda.device_count()):
                tag = f'd{i}'
                ms = torch.cuda.memory_stats(i)
                in_use = float(ms.get('allocated_bytes.all.current', 0))
                peak = float(ms.get('allocated_bytes.all.peak', in_use))
                if peak == 0 and i != current:
                    # a card this process never allocated on: asking its
                    # driver for the totals would open a context there
                    continue
                _free, total = torch.cuda.mem_get_info(i)
                stats.gauge(f'bytes_in_use[{tag}]', in_use)
                stats.gauge(f'peak_bytes[{tag}]', peak)
                stats.gauge(f'limit_bytes[{tag}]', float(total))
                stats.gauge(f'headroom_frac[{tag}]',
                            max(0.0, 1.0 - in_use / float(total)))
            stats.gauge('supported', 1)
            return
        in_use = self._live_bytes()
        peak = max(self._peak_seen.get(0, 0.0), in_use)
        self._peak_seen[0] = peak
        stats.gauge('bytes_in_use[d0]', in_use)
        stats.gauge('peak_bytes[d0]', peak)
        stats.gauge('supported', 0)

    @staticmethod
    def _live_bytes() -> float:
        """Bytes of every live ``torch.Tensor`` on the CPU, one count per
        storage (keyed by its data pointer): views and aliases of one
        buffer count once."""
        import torch
        seen: Dict[int, int] = {}
        for obj in gc.get_objects():
            try:
                # type(), not isinstance: a module proxy in the heap may
                # warn on attribute access
                if not issubclass(type(obj), torch.Tensor) or obj.is_meta \
                        or obj.device.type != 'cpu':
                    continue
                st = obj.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            # a tensor freed or swapped mid-walk must not kill the fill
            except (RuntimeError, ReferenceError):
                continue
        return float(sum(seen.values()))


def register_hbm(hub):
    """Register the ``hbm`` StatSet (with a :class:`DeviceMemory`
    refresh) into ``hub``; returns the StatSet."""
    from ..utils.metric import StatSet
    dm = DeviceMemory()
    stats = StatSet()
    hub.register_stats('hbm', stats, refresh=lambda: dm.fill(stats))
    return stats


# --- on-demand profiler session ---------------------------------------------

class ProfilerSession:
    """One on-demand ``torch.profiler`` window at a time — the
    ``/profile?ms=N`` endpoint's engine.  Mutually exclusive with a
    ``profile_dir`` TraceWindow through ``utils/profiler.acquire_trace``;
    a second request while one runs answers ``busy``.  The window runs
    on a named daemon thread of its own, which starts and stops the
    profiler, so the requesting scrape returns once it started; the
    window's Chrome trace lands in ``path`` when it stops."""

    MIN_MS = 50.0
    MAX_MS = 60_000.0

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Optional[str] = None   # guarded-by: _lock
        self._seq = 0                        # guarded-by: _lock
        self.sessions = 0                    # guarded-by: _lock
        self.last_error: Optional[str] = None

    def start(self, out_dir: str, ms: float = 1000.0) -> dict:
        """Begin one bounded trace into ``out_dir``; returns a JSON-able
        result (``started``/``path``/``ms``, or ``busy`` naming the
        holder).  On a card a profiler that cannot trace the device
        raises instead of writing a host-only trace."""
        from ..utils import profiler as _prof
        ms = min(self.MAX_MS, max(self.MIN_MS, float(ms)))
        with self._lock:
            if self._active is not None:
                return {'started': False, 'busy': self._active}
            if not _prof.acquire_trace('obs.profile'):
                return {'started': False,
                        'busy': _prof.trace_owner() or 'profile_dir'}
            self._seq += 1
            path = os.path.join(out_dir,
                                f'profile_{os.getpid()}_{self._seq:03d}')
            self._active = path
        # the profiler starts and stops on one thread of its own (Kineto
        # may crash when another thread stops it); the scrape waits only
        # for the start
        started = threading.Event()
        box: list = []
        t = threading.Thread(target=self._window,
                             args=(path, ms / 1e3, started, box),
                             daemon=True, name='cxxnet-obs-profile')
        t.start()
        started.wait()
        if box:
            raise box[0]
        return {'started': True, 'path': path, 'ms': ms}

    def _window(self, path: str, seconds: float, started, box) -> None:
        from ..ops import launches
        from ..utils import profiler as _prof
        prof = None
        try:
            os.makedirs(path, exist_ok=True)
            counts0 = launches.counts()
            # no synchronize: the window takes what runs from here on
            prof = _prof.start_profiler(sync=False)
        except BaseException as e:  # noqa: BLE001 — re-raised by start()
            box.append(e)
        started.set()
        try:
            if prof is not None:
                time.sleep(seconds)
                now = launches.counts()
                _prof.stop_profiler(prof, os.path.join(path, 'trace.json'),
                                    launched=sum(now[k] - counts0.get(k, 0)
                                                 for k in now))
        # a failed stop must still release the slot, or /profile answers
        # busy forever; the error is kept for /statusz
        except Exception as e:  # noqa: BLE001 — kept as last_error
            self.last_error = repr(e)
        finally:
            # release-then-clear: until _active clears a racing start()
            # answers busy, so the slot is never released out from under
            # a session that just acquired it
            _prof.release_trace('obs.profile')
            with self._lock:
                self._active = None
                if prof is not None:
                    self.sessions += 1

    def status(self) -> dict:
        with self._lock:
            return {'active': self._active, 'sessions': self.sessions,
                    'last_error': self.last_error}


_PROFILE: Optional[ProfilerSession] = None
_LEDGER: Optional[ProgramLedger] = None
_MOD_LOCK = threading.Lock()


def profile_session() -> ProfilerSession:
    """The process-wide profiler session (created on first use)."""
    global _PROFILE
    p = _PROFILE
    if p is None:
        with _MOD_LOCK:
            if _PROFILE is None:
                _PROFILE = ProfilerSession()
            p = _PROFILE
    return p


def get_ledger() -> ProgramLedger:
    """The process-wide program ledger (created on first use)."""
    global _LEDGER
    led = _LEDGER
    if led is None:
        with _MOD_LOCK:
            if _LEDGER is None:
                _LEDGER = ProgramLedger()
            led = _LEDGER
    return led


def install_ledger(ledger: Optional[ProgramLedger]
                   ) -> Optional[ProgramLedger]:
    """Swap the process-wide ledger (tests); returns the previous one.
    ``None`` resets to a fresh default on next :func:`get_ledger`."""
    global _LEDGER
    with _MOD_LOCK:
        prev, _LEDGER = _LEDGER, ledger
    return prev
