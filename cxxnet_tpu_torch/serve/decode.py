"""Continuous-batching decode engine over a paged KV cache.

PyTorch counterpart of ``cxxnet_tpu/serve/decode.py``:

* **slots** — each decode step advances a fixed number of request slots
  at once (idle slots compute into scratch page 0 and are ignored).  A
  request the ``DynamicBatcher`` hands over is prefilled on the admitting
  thread and joins a free slot at the next token boundary; it emits
  tokens one per step and leaves on EOS, its horizon or its deadline;
* **paged KV cache** — K/V live in a pool of fixed-size pages per stage,
  ``(stages, pages, page_size, heads, hd)`` on the engine's device; each
  slot's page table maps its cache positions to physical pages, which are
  allocated as the stream grows and freed (refcounted) when it ends.
  When the pool runs dry the youngest stream is preempted with a typed
  ``DecodePagesExhaustedError``;
* **greedy speculative decoding** (``spec_k >= 2`` with a draft model) —
  the draft proposes K-1 tokens per slot from its own dense per-slot
  cache, the target verifies the (slots, K) window in one
  ``verify_step[_paged]`` and accepts the longest agreeing prefix plus
  its own corrected token, so the stream is token-equal to the target
  decoding alone;
* **stream twins** — the prefill and the step run through the same
  ``models/transformer.py`` functions as ``transformer.generate``, with
  batch-invariant step shapes and attention kernels whose arithmetic
  depends only on a stream's own live rows, so every served stream equals
  ``generate(engine.params, prompt, max_new, engine.cfg,
  flash=engine.use_flash)`` with the same seed, bitwise, whenever it
  joined and whoever shared its steps.

**Prefix sharing** (``prefix_share`` > 0, a page cap): a content-addressed
index maps ``(model version, pad width, logical page, exact padded token
span)`` -> physical page for every full prompt page a prefill produced.
A request whose prompt prefix hits the index splices the shared pages
into its page table (refcounted: a page frees only when the last table
and the index let go) and writes only its tail's rows
(``transformer.prefill_tail_kv``, which walks the whole prompt: a row
need not keep its bits at another row count, and the streams must); a
full shared page is never written again (decode writes only past the
prompt bucket).  So a hit saves pages, not prefill arithmetic.  The
port's index also keys each entry by the prompt bucket whose prefill
computed it, for the same reason, so a hit never crosses buckets.  The
**tiered KV cache** (``kv_host_mb``, ``kv_disk_mb``, ``kv_dir``,
``kv_share_dir``; ``serve/kvcache.py``, ``serve/kvstore.py``) sits behind
the index: an evicted entry demotes to host RAM and spills to disk, and
a later probe promotes it.  The tiers' key is JAX's, which names no
bucket, so a promoted record's rows may come from another bucket's
prefill (or another package's): a promote takes the record out of the
tiers and indexes the fresh page, but the page holds the prompt's own
rows from its full prefill, never the record's.  A share directory lets
replicas (of either package) adopt each other's records.
**Prefill workers** (``prefill_workers`` > 0): the batcher's hand-off is
a queue push, and ``cxxnet-prefill-<name>-<i>`` threads run admission.

**Quantized tiers** (``dtype=bf16|int8``, ``serve.dtype``): the engine
serves with a bfloat16 compute config, for the target and the draft
alike, so the params, the KV pool, the draft cache and the block math
all follow ``cfg.dtype``; the params are quantized once at load and swap
time (``nnet/quantize.quantize_lm_tree``: int8 matmul leaves as
``QuantLeaf``, the rest bf16), never on the hot path.  ``engine.params``
and ``engine.cfg`` stay the stream oracle on every tier.

The attention has two legs behind ``serve.flash_decode``: the paged
kernels (``ops/attention.py``, CUDA on the card) read the pages in place;
the gather leg (``0``) copies each slot's pages into a dense cache per
step and runs the dense ``decode_step``.  ``auto`` takes the kernels on
the card and the gather leg on the CPU.

Sampling: a request's ``rng`` is an int seed, and pick n of its stream
draws from ``transformer.sample_keys(seed, max_new)[n]`` a ``(vocab,)``
Gumbel noise, as the JAX engine's ``_pick_one`` / ``_pick_slots`` do
(``split(PRNGKey(seed), max_new + 1)``, computed without JAX by
``utils/prng.py``): sampled streams are the JAX engine's up to a near-tie
of the perturbed top two, as greedy streams are up to a near-tie.

Threads: the loop thread (``cxxnet-decode-<name>``) owns the pools and
the draft cache; prefill runs on the admitting thread (or a prefill
worker) and its rows are written into pages by the loop at the next
token boundary.  All device work goes to the device's default stream, in
the order the threads enqueue it, and runs under
``torch.inference_mode()``; so with the tiers on, a publish's
device-to-host copy of the new pages' host mirrors waits behind the
decode steps already queued.  It runs outside the engine lock and is
timed (``publish_copy_ms``).

Hot reload: a ``serve/registry.ModelRegistry`` with ``pattern=LM_PATTERN,
loader=lm_loader`` watches ``%04d.lm`` files; :meth:`DecodeEngine.
warm_params` places a verified tree and waits for its copies, and the
swap drains (streams finish on the tree they started with).

Telemetry (``obs/``, at JAX's sites): the engine's calls run through
four programs of the ledger — ``decode.step`` (one shape key, the
declared bound 1), ``decode.prefill`` and ``decode.tail_prefill`` (one
key a prompt bucket) and ``decode.spec`` (one a window width) — whose
rows count the LM's projection and attention products
(``obs/programs.lm_flops``; a step's attention at the whole slot cache,
the dense leg's shape); a request's trace id rides its prefill span and
its ``decode.prefix_hit`` / ``decode.emit`` / ``decode.finish`` events,
and each step and spec round records a ``decode.step`` /
``decode.spec_verify`` event timed through the step's readback.
:meth:`DecodeService.register_into` puts the ``decode`` StatSet (and the
tiers' ``kv`` one, so ``slo.kv_hit=kv.hit_rate>=...`` resolves) on a
hub.  A ``FaultPlan``'s ``slow_step`` events sleep at the top of the
loop, off the lock: streams keep their tokens, only timing shifts.

Not ported yet (``NotPortedError``): tensor-parallel ``shard``
(ROADMAP.md queue A item 9), with or without the options above; live
admission caps and the autoscaler (item 10).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import transformer as T
from ..nnet import checkpoint, quantize
from ..nnet.trainer import resolve_device
from ..obs import record_event, span
from ..obs.programs import get_ledger, lm_flops, tree_bytes
from ..ops.attention import decode_use_flash, gather_pages
from ..ops.precision import full_f32
from ..runtime import faults as _faults
from ..runtime.faults import (DeadlineExceededError, DecodePagesExhaustedError,
                              DecodeSlotsExhaustedError, NotPortedError,
                              PrefixIndexFullError, RequestAbandonedError,
                              ServeError, TokenDeadlineExceededError)
from ..utils.metric import StatSet

__all__ = ['DecodeEngine', 'DecodeService', 'save_lm_params',
           'load_lm_params', 'lm_loader', 'LM_PATTERN']


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _prompt_bucket(s0: int) -> int:
    """The engine's prompt size class: ``generate``'s bucketing rule."""
    return T._size_class(s0, floor=8)


def _seed_of(rng) -> int:
    """A request's sampling seed: an int (numpy ints included)."""
    if isinstance(rng, (bool, np.bool_)) or not isinstance(
            rng, (int, np.integer)):
        raise ValueError(f'rng must be an int seed in this port, got '
                         f'{type(rng).__name__}')
    return int(rng)


def _flatten(tree, prefix=''):
    """``{'embed': leaf, 'stages/wq': leaf, ...}`` of a nested param dict,
    leaves as given."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flatten(tree[k], f'{prefix}{k}/'))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


class _PlacedLM(dict):
    """A tree one engine placed; ``owner`` is ``(engine token, slot)``:
    that engine's own placement passes ``_place`` unchanged (an int8 tree
    cannot be quantized twice)."""

    __slots__ = ('owner',)


class _Slot:
    """Host-side record of one occupied decode slot."""

    __slots__ = ('req', 'w', 'pos', 'kidx', 'last_tok', 'temp', 'keys',
                 'max_new', 'join_seq', 'last_emit')

    def __init__(self, req, s0b, w, tok0, keys, temp, max_new, join_seq):
        self.req = req
        self.w = int(w)
        self.pos = int(s0b)       # next cache position to write
        self.kidx = 1             # next pick index (tok0 used 0)
        self.last_tok = int(tok0)
        self.temp = float(temp)
        self.keys = keys          # (max_new + 1, 2) uint32, None if greedy
        self.max_new = int(max_new)
        self.join_seq = int(join_seq)
        self.last_emit = time.monotonic()


class DecodeEngine:
    """Slot-based continuous decode over a paged KV pool.

    ``params``/``cfg`` are a ``models.transformer`` tree (tensors or the
    JAX package's numpy leaves) and config (``cfg.causal`` required).
    ``slots`` is the step width; ``pages``/``page_size`` size the
    physical pool (page 0 is scratch, so ``pages - 1`` are allocatable);
    ``max_prompt``/``max_new_bound`` bound one request and fix the slot
    cache length ``cache_len`` (page-aligned).  ``device`` is the card
    unless ``'cpu'`` is given (no card and no ``'cpu'``: raise).
    ``dtype`` is ``serve.dtype`` (``f32``, ``bf16`` or ``int8``; the
    swap contract stays the f32 tree's structure and shapes on every
    tier).  ``flash_decode`` is ``serve.flash_decode``; ``spec_k``/``draft``
    (``(params, cfg)``) turn on speculative decoding.  ``prefix_share``
    (the index's page cap), ``kv_host_mb`` / ``kv_disk_mb`` / ``kv_dir``
    / ``kv_share_dir`` (the tiers behind it) and ``prefill_workers`` are
    the ``serve.*`` keys of the same names.

    Requests arrive through :meth:`execute_requests` (the batcher hands
    over each coalesced batch; the engine owns completion) or
    :meth:`submit_direct`.  Per-request ``meta``: ``max_new`` (default
    ``max_new_bound``), ``temperature`` (0 = greedy) and ``rng`` (an int
    seed, required when sampling).  Emitted ids stream into
    ``req.tokens``; ``req.result`` is the final int32 array.  A stream
    ends at its first EOS, where ``generate`` keeps emitting EOS.
    """

    def __init__(self, params, cfg, *, slots: int = 4, pages: int = 64,
                 page_size: int = 16, max_prompt: int = 64,
                 max_new_bound: int = 64, eos_id: Optional[int] = None,
                 stats: Optional[StatSet] = None, name: str = 'lm',
                 dtype: str = 'f32', flash_decode=None,
                 prefix_share: int = 0, spec_k: int = 0, draft=None,
                 kv_host_mb: int = 0, kv_disk_mb: int = 0,
                 kv_dir: Optional[str] = None,
                 kv_share_dir: Optional[str] = None, shard: str = '',
                 prefill_workers: int = 0, device='cuda'):
        if shard and str(shard).strip() not in ('', 'tp:1', '1'):
            raise NotPortedError(f'serve.shard={shard}', 'queue A item 9')
        if not cfg.causal:
            raise ValueError('DecodeEngine requires a causal config')
        T.check_config(cfg)
        if slots < 1 or pages < 2 or page_size < 1:
            raise ValueError('need slots >= 1, pages >= 2 (page 0 is '
                             'scratch), page_size >= 1')
        if spec_k < 0 or (spec_k >= 2 and draft is None):
            raise ValueError('spec_k >= 2 needs a draft model '
                             '(draft=(params, cfg)); spec_k must be >= 0')
        if prefix_share < 0:
            raise ValueError('prefix_share must be >= 0 (a page cap; '
                             '0 disables sharing)')
        if kv_host_mb < 0 or kv_disk_mb < 0:
            raise ValueError('kv_host_mb / kv_disk_mb must be >= 0')
        if (kv_host_mb or kv_disk_mb) and prefix_share <= 0:
            raise ValueError('the tiered KV cache sits behind the '
                             'prefix index: serve.kv_host_mb/kv_disk_mb '
                             'need serve.prefix_share > 0')
        if kv_disk_mb > 0 and not kv_dir:
            raise ValueError('serve.kv_disk_mb > 0 needs serve.kv_dir= '
                             '(the tier-2 record directory)')
        if kv_share_dir and kv_disk_mb <= 0:
            raise ValueError('serve.kv_share_dir shares tier-2 records: '
                             'it needs serve.kv_disk_mb > 0')
        self.device = resolve_device(str(device))
        self.serve_dtype = quantize.parse_serve_dtype(dtype)
        if self.serve_dtype != 'f32':
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        self.use_flash = decode_use_flash(flash_decode, self.device)
        self.cfg = cfg
        self.name = name
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.n_pages = int(pages)
        self.max_prompt = int(max_prompt)
        self.max_new_bound = int(max_new_bound)
        self.eos_id = eos_id
        self.stats = stats if stats is not None else StatSet()
        horizon = _prompt_bucket(self.max_prompt) + self.max_new_bound
        self.pages_per_slot = _ceil_div(horizon, self.page_size)
        self.cache_len = self.pages_per_slot * self.page_size
        hd = cfg.d_model // cfg.num_heads
        pool_shape = (cfg.num_stages, self.n_pages, self.page_size,
                      cfg.num_heads, hd)
        self._ref = self._leaf_specs(params)
        self._token = object()
        self._cond = threading.Condition()
        with torch.inference_mode():
            self._kpool = torch.zeros(pool_shape, dtype=cfg.dtype,
                                      device=self.device)
            self._vpool = torch.zeros_like(self._kpool)
            self._params = self.place_params(params)  # guarded-by: _cond
        self._free_pages: List[int] = list(
            range(self.n_pages - 1, 0, -1))       # guarded-by: _cond
        self._page_refs = np.zeros(self.n_pages,
                                   np.int32)       # guarded-by: _cond
        self._free_min = self.n_pages - 1          # guarded-by: _cond
        # the content-addressed index of full prompt pages: key (version,
        # w, logical page, exact padded span, prompt bucket) -> {page, host
        # K/V rows (with the tiers, for a demote; else None)}; an
        # OrderedDict is the LRU, capped at prefix_share
        self._prefix_cap = int(prefix_share)
        self._prefix: collections.OrderedDict = (
            collections.OrderedDict())             # guarded-by: _cond
        # the tiers behind the index (serve/kvcache.py): called under
        # _cond (demote / take) or with no lock (prefetch); lock order
        # _cond -> the cache's own lock, never back
        self._kv = None
        self.kv_stats: Optional[StatSet] = None
        if kv_host_mb > 0 or kv_disk_mb > 0:
            from .kvcache import KVStore, TieredKVCache
            self.kv_stats = StatSet()
            store = None
            if kv_disk_mb > 0:
                store = KVStore(kv_dir, kv_disk_mb * (1 << 20),
                                share_dir=kv_share_dir,
                                stats=self.kv_stats, name=name)
            self._kv = TieredKVCache(host_bytes=kv_host_mb * (1 << 20),
                                     store=store, stats=self.kv_stats)
        self._table = np.zeros((self.slots, self.pages_per_slot),
                               np.int32)           # guarded-by: _cond
        self._slots: List[object] = [None] * self.slots  # guarded-by: _cond
        self._joinq: collections.deque = (
            collections.deque())                  # guarded-by: _cond
        self._admitting = 0   # guarded-by: _cond (admit..join window)
        self._join_seq = 0    # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self._pending_params = None   # guarded-by: _cond
        self._pending_version = None  # guarded-by: _cond
        self.version: object = 0
        self.swap_count = 0
        # speculative decoding: the draft keeps a DENSE per-slot cache,
        # advanced only inside spec windows
        self._spec_k = int(spec_k)
        self._draft_params = None          # guarded-by: _cond
        self._pending_draft = None         # guarded-by: _cond
        self._pending_draft_version = None  # guarded-by: _cond
        self.draft_version: object = -1
        self._draft_cfg = None
        if draft is not None:
            dparams, dcfg = draft
            if not dcfg.causal:
                raise ValueError('draft model must be causal')
            T.check_config(dcfg)
            if self.serve_dtype != 'f32':
                dcfg = dataclasses.replace(dcfg, dtype=torch.bfloat16)
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f'draft vocab {dcfg.vocab_size} != target '
                    f'{cfg.vocab_size}: the verify window compares '
                    'token ids, the vocabularies must match')
            self._draft_cfg = dcfg
            self._draft_ref = self._leaf_specs(dparams)
            dhd = dcfg.d_model // dcfg.num_heads
            with torch.inference_mode():
                self._draft_params = self.place_draft_params(dparams)
                self._kdc = torch.zeros(
                    (dcfg.num_stages, self.slots, self.cache_len,
                     dcfg.num_heads, dhd), dtype=dcfg.dtype,
                    device=self.device)
                self._vdc = torch.zeros_like(self._kdc)
        # disaggregated prefill: worker threads own admission, so one long
        # cold prompt never holds up the prompts behind it; their rows
        # reach the loop through the same join queue
        self._prefillq: collections.deque = (
            collections.deque())                   # guarded-by: _cond
        self._prefill_threads: list = []
        # the ledger's programs (JAX decode.py:399): the step is one shape
        # by construction (preallocated pools), so bound=1 makes any drift
        # a recompile-sentinel event; prefill, tail and spec are ladders
        led = get_ledger()
        self._prog_step = led.program('decode.step', bound=1)
        self._prog_prefill = led.program('decode.prefill')
        self._prog_tail = led.program('decode.tail_prefill')
        self._prog_spec = led.program('decode.spec')
        self._loop = threading.Thread(target=self._run, daemon=True,
                                      name=f'cxxnet-decode-{name}')
        self._loop.start()
        for i in range(max(0, int(prefill_workers))):
            t = threading.Thread(target=self._prefill_worker, daemon=True,
                                 name=f'cxxnet-prefill-{name}-{i}')
            t.start()
            self._prefill_threads.append(t)

    # -- parameters ----------------------------------------------------------
    @staticmethod
    def _leaf_specs(params):
        """(path, shape) of every leaf of the f32 tree: the hot-swap
        contract on every tier."""
        return [(k, tuple(v.shape))
                for k, v in sorted(_flatten(params).items())]

    def _place(self, host_params, ref, what):
        """Check a host (or device) f32 tree against the contract ``ref``
        — structure and shapes, and the dtype only on the f32 tier, as
        the quantized tiers convert every float leaf anyway — quantize it
        into the serving tier and copy it to the engine's device.  This
        engine's own placement for the same slot comes back as it is."""
        if isinstance(host_params, _PlacedLM) \
                and host_params.owner == (self._token, what):
            return host_params
        flat = _flatten(host_params)
        got = [(k, tuple(v.shape)) for k, v in sorted(flat.items())]
        if [k for k, _ in got] != [k for k, _ in ref]:
            raise ValueError(f'{what}: param tree structure differs from '
                             'the serving model')
        for (k, shape), (_, want) in zip(got, ref):
            if shape != want:
                raise ValueError(
                    f'{what}: leaf {k} {shape} != serving {want} — a shape '
                    'change needs a new engine, not a hot swap')
        tensors = {}
        for k, v in flat.items():
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, np.float32))
            if self.serve_dtype == 'f32' and t.dtype != torch.float32:
                raise ValueError(f'{what}: leaf {k} is {t.dtype}; the '
                                 'f32 tier serves float32 leaves')
            tensors[k] = t
        tree = quantize.quantize_lm_tree(_nest(tensors), self.serve_dtype,
                                         out_dtype=torch.bfloat16)
        with torch.inference_mode():
            out = _PlacedLM(_nest({k: v.to(self.device, copy=True)
                                   for k, v in _flatten(tree).items()}))
        out.owner = (self._token, what)
        return out

    @property
    def params(self):
        with self._cond:
            return self._params

    def place_params(self, host_params):
        """Validate an f32 param tree against the serving model (structure
        and shapes), quantize it into the serving tier and copy it to the
        engine's device."""
        return self._place(host_params, self._ref, 'swap_params')

    def warm_params(self, params) -> None:
        """Place ``params`` (unless they are this engine's placement)
        and wait for the copies: the registry's warm before a swap."""
        self.place_params(params)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def swap_params(self, params, version: object = None) -> None:
        """Hot-swap with DRAIN semantics: in-flight streams finish on the
        params they started with, new admissions wait and join under the
        new tree once the last pre-swap stream leaves.  Zero requests are
        dropped.  Blocks until the swap is applied."""
        placed = self.place_params(params)
        with self._cond:
            if self._closed:
                raise ServeError('decode engine is closed')
            while self._pending_params is not None:
                self._cond.wait(0.05)
            self._pending_params = placed
            self._pending_version = version
            self._cond.notify_all()
            while self._pending_params is not None and not self._closed:
                self._cond.wait(0.05)

    def place_draft_params(self, host_params):
        if self._draft_cfg is None:
            raise ValueError('engine was built without a draft model')
        return self._place(host_params, self._draft_ref,
                           'swap_draft_params')

    def swap_draft_params(self, params, version: object = None) -> None:
        """Hot-swap the DRAFT tree with the drain semantics of
        :meth:`swap_params` (a draft changes only the acceptance rate,
        never a stream)."""
        placed = self.place_draft_params(params)
        with self._cond:
            if self._closed:
                raise ServeError('decode engine is closed')
            while self._pending_draft is not None:
                self._cond.wait(0.05)
            self._pending_draft = placed
            self._pending_draft_version = version
            self._cond.notify_all()
            while self._pending_draft is not None and not self._closed:
                self._cond.wait(0.05)

    # -- prefix index (requires-lock helpers) -------------------------------
    def _prefix_keys(self, padded, w, n, s0b):  # requires-lock: _cond
        """Index keys of the first ``n`` full pages of a padded prompt:
        the JAX key ``(version, w, logical page, exact padded span)``
        (``key[:4]``, the tiers' key) and the prompt bucket ``s0b`` whose
        prefill computes the rows."""
        ps = self.page_size
        row = padded[0]
        return [(self.version, w, lp, row[:(lp + 1) * ps].tobytes(), s0b)
                for lp in range(n)]

    def _prefix_probe(self, padded, w, s0b, touch=True):  # requires-lock: _cond
        """The longest consecutive full-page hit: ``(n_hit, pages)``.  A
        hit must cover every pad slot (``n_hit * ps >= w``, JAX's rule:
        its tail prefill sees only real queries) and leave at least one
        tail token for the last position's logits."""
        ps = self.page_size
        pages = []
        for key in self._prefix_keys(padded, w, (s0b - 1) // ps, s0b):
            ent = self._prefix.get(key)
            if ent is None:
                break
            if touch:
                self._prefix.move_to_end(key)
            pages.append(ent['page'])
        if len(pages) * ps < w:
            return 0, []
        return len(pages), pages

    def _demote(self, key, ent) -> None:  # requires-lock: _cond
        """Hand an index entry down-tier (current version only)."""
        if self._kv is not None and key[0] == self.version:
            self._kv.demote(key[:4], ent['hk'], ent['hv'])

    def _prefix_evict_one(self, demote: bool = True) -> bool:  # requires-lock: _cond
        """Drop the LRU index entry (its page frees when the index held
        the last reference); with tiers its rows demote, except on a
        params swap (``demote=False``: the old model's rows)."""
        if not self._prefix:
            return False
        key, ent = self._prefix.popitem(last=False)
        if demote:
            self._demote(key, ent)
        self._release_pages([ent['page']])
        return True

    def _prefix_publish(self, padded, w, s0b, pages, hk_pages,  # requires-lock: _cond
                        hv_pages):
        """Index every not-yet-indexed full page of a just-prefilled
        prompt; ``hk_pages``/``hv_pages`` its full pages' host mirrors,
        (stages, page_size, heads, hd) each, with the tiers on (None for a
        page not copied: a hit page, which is not published again), else
        None.  LRU-evicts at the cap; a prompt with more fresh pages than
        the whole cap records ``PrefixIndexFullError`` and is served
        unshared."""
        ps = self.page_size
        n_pub = s0b // ps
        keys = self._prefix_keys(padded, w, n_pub, s0b)
        fresh = [i for i, k in enumerate(keys) if k not in self._prefix
                 and (hk_pages is None or hk_pages[i] is not None)]
        if not fresh:
            return
        if len(fresh) > self._prefix_cap:
            self.stats.inc('prefix_index_full')
            _faults.global_failure_log().record(
                'prefix_index_full',
                repr(PrefixIndexFullError(n_pub, self._prefix_cap)))
            return
        for i in fresh:
            while len(self._prefix) >= self._prefix_cap:
                if not self._prefix_evict_one():
                    return
            page = int(pages[i])
            self._page_refs[page] += 1   # the index's own reference
            self._prefix[keys[i]] = {
                'page': page,
                'hk': None if hk_pages is None else hk_pages[i],
                'hv': None if hv_pages is None else hv_pages[i]}
            self.stats.inc('prefix_published')

    def _reclaim_index_pages(self, n: int, exclude=()):  # requires-lock: _cond
        """Free up to ``n`` pages by dropping LRU entries whose page only
        the index still holds (forgetting cold prefixes before preempting
        a stream).  ``exclude``: pages that must survive, the hit pages an
        admission is about to splice."""
        freed = 0
        for key in list(self._prefix):
            if freed >= n:
                break
            ent = self._prefix[key]
            if ent['page'] in exclude:
                continue
            if self._page_refs[ent['page']] == 1:
                self._demote(key, ent)
                del self._prefix[key]
                self._release_pages([ent['page']])
                freed += 1
                self.stats.inc('prefix_reclaimed')
        return freed

    def _clear_prefix_index(self) -> None:  # requires-lock: _cond
        """Release every index reference (a params swap: the rows are the
        old model's); never demotes."""
        while self._prefix:
            self._prefix_evict_one(demote=False)

    def _promote_splice(self, padded, w, s0b, n_hit) -> int:  # requires-lock: _cond
        """Promote the tier records of the consecutive full pages past
        ``n_hit`` that tier 1 holds (prefetched outside the lock): each is
        taken out of the tiers, as JAX's promote takes it, and its page is
        indexed at publish like a miss's.  Unlike JAX's, the record's rows
        are dropped: the tiers' key names no bucket (nor package), and the
        prompt's own full prefill writes that page's rows anyway.  Returns
        the count promoted."""
        ps = self.page_size
        max_hit = (s0b - 1) // ps
        if n_hit >= max_hit:
            return 0
        keys = self._prefix_keys(padded, w, max_hit, s0b)
        taken = []
        for lp in range(n_hit, max_hit):
            ent = self._kv.take(keys[lp][:4])
            if ent is None:
                break
            taken.append((keys[lp], ent))
        if taken and (n_hit + len(taken)) * ps < w:
            # JAX's pad-coverage rule: it serves no such chain, so the
            # records go back
            for key, (hk, hv) in taken:
                self._kv.put_back(key[:4], hk, hv)
            return 0
        self.stats.inc('kv_promoted_pages', len(taken))
        return len(taken)

    # -- page accounting (requires-lock helpers) -----------------------------
    def _alloc_pages(self, n: int) -> List[int]:  # requires-lock: _cond
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._page_refs[p] = 1
        self._free_min = min(self._free_min, len(self._free_pages))
        return pages

    def _release_pages(self, pages) -> None:  # requires-lock: _cond
        """Drop one reference per page; a page returns to the free list
        when nothing references it."""
        for p in pages:
            p = int(p)
            self._page_refs[p] -= 1
            if self._page_refs[p] <= 0:
                self._page_refs[p] = 0
                self._free_pages.append(p)
        self._cond.notify_all()

    def prefill_cost(self, req) -> int:
        """The batcher's admission price of ``req``: the prompt rows its
        prefill walks, its bucket.  JAX's prices a hit at its tail; the
        port's hit walks the whole prompt (:func:`transformer.
        prefill_tail_kv`), so hit or miss costs the same."""
        prompt = np.asarray(req.data, np.int32)
        if prompt.ndim != 2 or prompt.shape[0] != 1:
            return max(1, int(prompt.size))
        return _prompt_bucket(prompt.shape[1])

    def kv_occupancy(self):
        """``(host_bytes, disk_bytes)`` of the tiers, or None without
        them; never part of :meth:`resident_bytes`."""
        if self._kv is None:
            return None
        self._kv.refresh_gauges()
        store = self._kv.store
        return (self._kv.host_bytes(),
                0 if store is None else store.disk_bytes())

    def resident_bytes(self) -> int:
        """Device bytes of params + both pools (+ the draft tree and its
        dense cache when spec decoding); an int8 leaf counts its payload
        and its scales."""
        with self._cond:
            trees = [self._params] + ([self._draft_params]
                                      if self._draft_params is not None
                                      else [])
            pools = [self._kpool, self._vpool]
            if self._draft_cfg is not None:
                pools += [self._kdc, self._vdc]
        return int(sum(quantize.tree_nbytes(tree) for tree in trees)
                   + sum(t.numel() * t.element_size() for t in pools))

    def busy(self) -> bool:
        with self._cond:
            return (any(s is not None for s in self._slots)
                    or bool(self._joinq) or self._admitting > 0
                    or bool(self._prefillq))

    # -- admission -----------------------------------------------------------
    @property
    def buckets(self):
        """DynamicBatcher protocol: at most ``slots`` requests (one row
        each) per coalescing window."""
        return (self.slots,)

    def execute_requests(self, batch) -> None:
        """Batcher hand-off: admit each request into a slot (blocking for
        capacity up to its deadline).  Per-request errors land on the
        request, never on the caller.  With prefill workers the hand-off
        is a queue push."""
        for req in batch:
            queued = False
            if self._prefill_threads:
                with self._cond:
                    if not self._closed:
                        self._prefillq.append(req)
                        self._cond.notify_all()
                        queued = True
            if not queued:
                self._admit_one(req)

    def _prefill_worker(self) -> None:
        """A prefill thread: pop queued requests and admit them.  After
        :meth:`close` the queue drains through ``_admit_one``, so every
        request still queued fails typed (``ServeError``)."""
        while True:
            with self._cond:
                while not self._prefillq and not self._closed:
                    self._cond.wait(0.05)
                if not self._prefillq:
                    return          # closed and drained
                req = self._prefillq.popleft()
            self._admit_one(req)

    def _admit_one(self, req) -> None:
        try:
            self._admit(req)
        except Exception as e:  # noqa: BLE001 — a typed per-request outcome
            if isinstance(e, DeadlineExceededError):
                self.stats.inc('expired')
            elif isinstance(e, RequestAbandonedError):
                self.stats.inc('abandoned')
            elif isinstance(e, (DecodeSlotsExhaustedError,
                                DecodePagesExhaustedError)):
                self.stats.inc('shed_inadmissible')
            else:
                self.stats.inc('engine_errors')
            req.error = e
            req.event.set()

    def submit_direct(self, prompt, max_new: int = None,
                      temperature: float = 0.0, rng=None,
                      deadline: float = 30.0):
        """Batcher-less admission: returns the ``ServeRequest``; wait on
        ``req.event``."""
        from .batcher import ServeRequest
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        req = ServeRequest(prompt, deadline,
                           meta={'max_new': max_new,
                                 'temperature': temperature, 'rng': rng})
        self.execute_requests([req])
        return req

    def _admit(self, req) -> None:
        prompt = np.asarray(req.data, np.int32)
        if prompt.ndim != 2 or prompt.shape[0] != 1 or prompt.shape[1] < 1:
            raise ValueError('decode request payload must be one prompt '
                             'row: (1, s0) int tokens')
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f'prompt token ids outside [0, '
                             f'{self.cfg.vocab_size})')
        s0 = prompt.shape[1]
        meta = req.meta or {}
        raw = meta.get('max_new')
        max_new = self.max_new_bound if raw is None else int(raw)
        temp = float(meta.get('temperature') or 0.0)
        rng = meta.get('rng')
        if max_new < 1:
            raise ValueError('max_new must be >= 1')
        if temp > 0 and rng is None:
            raise ValueError('temperature>0 sampling needs an int seed')
        keys = (T.sample_keys(_seed_of(rng), max_new) if temp > 0
                else None)
        s0b = _prompt_bucket(s0)
        w = s0b - s0
        ps = self.page_size
        if max_new > self.max_new_bound:
            raise DecodeSlotsExhaustedError(
                f'max_new={max_new} > engine bound {self.max_new_bound}')
        if s0b + max_new - 1 > self.cache_len:
            raise DecodeSlotsExhaustedError(
                f'prompt bucket {s0b} + max_new {max_new} exceeds the '
                f'slot cache ({self.cache_len} positions)')
        total_pages = (s0b + max_new - 2) // ps + 1 \
            if max_new >= 2 else _ceil_div(s0b, ps)
        if total_pages > min(self.pages_per_slot, self.n_pages - 1):
            raise DecodeSlotsExhaustedError(
                f'request needs {total_pages} KV pages; the pool can '
                f'offer at most {min(self.pages_per_slot, self.n_pages - 1)}')
        n_prompt = _ceil_div(s0b, ps)
        # reserve the prompt pages plus the first decode position's page
        # now; later pages are allocated as the stream grows
        n0 = (s0b // ps + 1) if max_new >= 2 else n_prompt
        padded = np.pad(prompt, ((0, 0), (w, 0)))
        t_admit = time.monotonic()
        if self._kv is not None and (s0b - 1) // ps > 0:
            # disk records rise into the host tier here, with no engine
            # lock held: the take() under the lock below is memory only
            with self._cond:
                want = [k[:4] for k in
                        self._prefix_keys(padded, w, (s0b - 1) // ps, s0b)
                        if k not in self._prefix]
            self._kv.prefetch(want)
        with self._cond:
            while True:
                if self._closed:
                    raise ServeError('decode engine is closed')
                if getattr(req, 'abandoned', False):
                    raise RequestAbandonedError(
                        time.monotonic() - req.t_submit)
                n_hit, hit_pages = (self._prefix_probe(padded, w, s0b)
                                    if self._prefix_cap > 0 else (0, []))
                need = n0 - n_hit
                occupied = sum(1 for s in self._slots if s is not None)
                if (self._pending_params is None
                        and self._pending_draft is None
                        and occupied < self.slots):
                    short = need - len(self._free_pages)
                    if short > 0:
                        # never the hit pages this request will splice
                        self._reclaim_index_pages(short,
                                                  exclude=set(hit_pages))
                    if len(self._free_pages) >= need:
                        break
                remaining = req.deadline_abs - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceededError(
                        req.deadline, time.monotonic() - req.t_submit, 1)
                self._cond.wait(min(remaining, 0.05))
            sid = self._slots.index(None)
            self._slots[sid] = 'RESERVED'
            for p in hit_pages:                    # splice shared pages
                self._page_refs[p] += 1
            pages = list(hit_pages) + self._alloc_pages(need)
            if self._kv is not None:
                n_prom = self._promote_splice(padded, w, s0b, n_hit)
                self.kv_stats.inc('hits' if n_hit + n_prom else 'misses')
            if n_hit:
                self.stats.inc('prefix_hits')
                self.stats.inc('prefix_hit_pages', n_hit)
                if n_hit == (s0b - 1) // ps and s0b % ps:
                    # the partial last page is rematerialized privately
                    # by the tail prefill (the copy-on-write rule)
                    self.stats.inc('cow_copies')
            elif self._prefix_cap > 0:
                self.stats.inc('prefix_misses')
            self._admitting += 1
            params = self._params
            draft_params = self._draft_params
            seq = self._join_seq
            self._join_seq += 1
        try:
            # prefill off the loop thread: joins stay token-aligned.  A hit
            # keeps its tail's rows (t0 = 0: a miss keeps them all)
            t0 = n_hit * ps
            hk_pages = hv_pages = None
            tp = time.monotonic()
            if n_hit:
                record_event('decode.prefix_hit', 'decode', req.trace_id,
                             hit_pages=n_hit)
            with torch.inference_mode(), full_f32():
                toks = torch.from_numpy(padded).to(self.device)
                if n_hit:
                    prog, key = self._prog_tail, f't{t0}+{s0b - t0}'
                    sp = span('decode.tail_prefill', 'decode', req.trace_id,
                              prompt=s0b, tail=s0b - t0)
                else:
                    prog, key = self._prog_prefill, f's{s0b}'
                    sp = span('decode.prefill', 'decode', req.trace_id,
                              prompt=s0b)
                with sp:
                    ks, vs, logits0 = prog.run(
                        key, T.prefill_tail_kv, params, toks, t0, w,
                        self.cfg,
                        info=lambda: (lm_flops(self.cfg, s0b, s0b * s0b, 1),
                                      tree_bytes(params), f'int32[1,{s0b}]'))
                self.stats.inc('prefill_rows', s0b)
                if n_hit:
                    self.stats.inc('tail_rows', s0b - t0)
                dks = dvs = None
                if self._draft_cfg is not None and self._spec_k >= 2:
                    # the draft full-prefills every prompt
                    dks, dvs, _ = T.prefill_kv(draft_params, toks, w,
                                               self._draft_cfg)
                tok0 = int(T.pick_tokens(
                    logits0, [temp], [None if keys is None else keys[0]])[0])
                self.stats.observe('prefill_ms',
                                   (time.monotonic() - tp) * 1e3)
                if self._kv is not None:
                    # the host mirrors a demote hands down-tier come to the
                    # host here, outside the engine lock the loop takes at
                    # every boundary: the new full pages only
                    hk_pages, hv_pages = [None] * n_hit, [None] * n_hit
                    if s0b // ps > n_hit:
                        tc = time.monotonic()
                        hk_pages += self._host_pages(ks[:, 0],
                                                     s0b // ps - n_hit)
                        hv_pages += self._host_pages(vs[:, 0],
                                                     s0b // ps - n_hit)
                        self.stats.observe('publish_copy_ms',
                                           (time.monotonic() - tc) * 1e3)
            now = time.monotonic()
            req.tokens.append(tok0)
            req.token_times.append(now)
            self.stats.inc('tokens')
            record_event('decode.emit', 'decode', req.trace_id,
                         token_index=0)
            done0 = self.eos_id is not None and tok0 == self.eos_id
            with self._cond:
                if done0 or max_new == 1:
                    self._slots[sid] = None
                    self._release_pages(pages)
                    self._finish(req)
                else:
                    # rows still to be written into the pool: the tail
                    # (hit) or the whole prompt (miss)
                    self._joinq.append(
                        {'sid': sid, 'pages': pages,
                         'wpages': pages[n_hit:n_prompt], 's0b': s0b,
                         'w': w, 'ks': ks, 'vs': vs, 'dks': dks,
                         'dvs': dvs, 'tok0': tok0, 'keys': keys,
                         'temp': temp, 'max_new': max_new, 'req': req,
                         'seq': seq})
                    self.stats.inc('joined')
                    if self._prefix_cap > 0 and s0b // ps:
                        self._prefix_publish(padded, w, s0b,
                                             pages[:s0b // ps],
                                             hk_pages, hv_pages)
                self._admitting -= 1
                self.stats.observe('admit_ms', (now - t_admit) * 1e3)
                self._cond.notify_all()
        except BaseException:
            with self._cond:
                self._slots[sid] = None
                self._release_pages(pages)
                self._admitting -= 1
                self._cond.notify_all()
            raise

    def _host_pages(self, rows, n: int) -> list:
        """The first ``n`` full pages of device rows (stages, m, heads,
        hd) as host tensors, one contiguous (stages, page_size, heads, hd)
        page each: one device-to-host copy, pages leading."""
        ps = self.page_size
        paged = rows[:, :n * ps].reshape(rows.shape[0], n, ps,
                                         *rows.shape[2:])
        return list(paged.transpose(0, 1).contiguous().cpu())

    # -- the decode loop -----------------------------------------------------
    def _finish(self, req, error: Optional[BaseException] = None) -> None:
        """Complete a request (slot bookkeeping already done)."""
        if error is not None:
            req.error = error
        else:
            req.result = np.asarray(req.tokens, np.int32)
            self.stats.inc('completed')
            self.stats.observe('stream_len', len(req.tokens))
        record_event('decode.finish', 'decode',
                     getattr(req, 'trace_id', None),
                     tokens=len(req.tokens),
                     error=None if error is None else type(error).__name__)
        req.event.set()

    def _free_slot(self, sid: int) -> None:  # requires-lock: _cond
        row = self._table[sid]
        self._release_pages(int(p) for p in row[row != 0])
        row[:] = 0
        self._slots[sid] = None
        self._cond.notify_all()

    def _write_rows(self, pages, ks, vs) -> None:  # requires-lock: _cond
        """Write (stages, n, heads, hd) device K/V rows into the physical
        ``pages`` in order, the last page padded."""
        ps = self.page_size
        idx = torch.as_tensor(pages, device=self.device)
        for pool, rows in ((self._kpool, ks), (self._vpool, vs)):
            a = torch.nn.functional.pad(
                rows, (0, 0, 0, 0, 0, len(pages) * ps - rows.shape[1]))
            pool[:, idx] = a.reshape(a.shape[0], len(pages), ps,
                                     *a.shape[2:])

    def _integrate_joins(self) -> None:  # requires-lock: _cond
        """Token boundary: splice every admitted request into its slot
        and write its prompt rows (the tail after a hit) into its pages
        and the draft cache.  A prompt's pages are published as its join
        is queued, so a request that hits them joins after those rows are
        written."""
        while self._joinq:
            j = self._joinq.popleft()
            sid = j['sid']
            self._table[sid, :len(j['pages'])] = j['pages']
            if j['wpages']:
                self._write_rows(j['wpages'], j['ks'][:, 0], j['vs'][:, 0])
            if j['dks'] is not None:
                self._kdc[:, sid, :j['s0b']] = j['dks'][:, 0]
                self._vdc[:, sid, :j['s0b']] = j['dvs'][:, 0]
            self._slots[sid] = _Slot(j['req'], j['s0b'], j['w'], j['tok0'],
                                     j['keys'], j['temp'], j['max_new'],
                                     j['seq'])

    def _expire_slots(self, now: float) -> None:  # requires-lock: _cond
        for sid, slot in enumerate(self._slots):
            if not isinstance(slot, _Slot):
                continue
            if now >= slot.req.deadline_abs:
                self.stats.inc('expired')
                self.stats.inc('tokens_shed',
                               slot.max_new - len(slot.req.tokens))
                err = TokenDeadlineExceededError(
                    slot.req.deadline, now - slot.req.t_submit,
                    len(slot.req.tokens))
                req = slot.req
                self._free_slot(sid)
                self._finish(req, err)

    def _alloc_step_pages(self, win: int = 1) -> None:  # requires-lock: _cond
        """Map a page for every slot about to write into an unmapped
        logical page (the whole ``win``-token window when spec decoding).
        A dry pool sheds the youngest stream."""
        order = sorted((s.join_seq, sid) for sid, s in
                       enumerate(self._slots) if isinstance(s, _Slot))
        for _seq, sid in order:
            slot = self._slots[sid]
            if not isinstance(slot, _Slot):
                continue            # shed as a victim earlier this pass
            last = min(slot.pos + win - 1, self.cache_len - 1)
            for lp in range(slot.pos // self.page_size,
                            last // self.page_size + 1):
                if self._table[sid, lp] != 0:
                    continue
                while not self._free_pages:
                    if self._reclaim_index_pages(1):
                        continue
                    victims = [(s.join_seq, vid) for vid, s in
                               enumerate(self._slots)
                               if isinstance(s, _Slot)]
                    _vseq, vid = max(victims)
                    vslot = self._slots[vid]
                    self.stats.inc('shed_pages')
                    self.stats.inc('tokens_shed',
                                   vslot.max_new - len(vslot.req.tokens))
                    err = DecodePagesExhaustedError(
                        len(vslot.req.tokens), self.n_pages - 1)
                    vreq = vslot.req
                    self._free_slot(vid)
                    self._finish(vreq, err)
                    if vid == sid:
                        break
                if not isinstance(self._slots[sid], _Slot):
                    break           # shed as its own victim
                if self._free_pages:
                    self._table[sid, lp] = self._alloc_pages(1)[0]

    def _run(self) -> None:
        """Loop-thread body; a fault outside any request (a kernel that
        fails to launch, a lost device) fails every in-flight stream with
        the error instead of stranding clients until their deadlines."""
        try:
            with torch.inference_mode():
                self._run_inner()
        except Exception as e:  # noqa: BLE001 — the loop must not vanish
            with self._cond:
                self._closed = True
                for sid, slot in enumerate(self._slots):
                    if isinstance(slot, _Slot):
                        req = slot.req
                        self._free_slot(sid)
                        self._finish(req, ServeError(
                            f'decode loop failed: {e!r}'))
                while self._joinq:
                    j = self._joinq.popleft()
                    self._finish(j['req'], ServeError(
                        f'decode loop failed: {e!r}'))
                self._cond.notify_all()

    def _step_inputs(self, table, pos, w, tok):
        """One host-to-device copy of the step's int32 inputs, split into
        contiguous (S, pp) table and (S,) pos / w / tok views."""
        S = self.slots
        flat = np.concatenate([table.ravel(), pos, w, tok]).astype(np.int32)
        dev = torch.from_numpy(flat).to(self.device)
        n = table.size
        return (dev[:n].view(S, -1), dev[n:n + S], dev[n + S:n + 2 * S],
                dev[n + 2 * S:])

    def _gathered(self, table_t):
        st = self.cfg.num_stages
        return (torch.stack([gather_pages(self._kpool[i], table_t)
                             for i in range(st)]),
                torch.stack([gather_pages(self._vpool[i], table_t)
                             for i in range(st)]))

    def _decode(self, params, table_t, pos_t, w_t, tok_t):
        """One decode step of every slot; writes the new K/V rows into the
        pool and returns the logits (S, vocab)."""
        if self.use_flash:
            return T.decode_step_paged(params, self.cfg, tok_t, self._kpool,
                                       self._vpool, table_t, pos_t, w_t)[0]
        kc, vc = self._gathered(table_t)
        logits, _, _, knew, vnew = T.decode_step(params, self.cfg, tok_t, kc,
                                                 vc, pos_t, w_t)
        page, off = T.paged_index(table_t, pos_t.long(), self.page_size)
        self._kpool[:, page, off] = knew
        self._vpool[:, page, off] = vnew
        return logits

    def _spec_round(self, K, params, dparams, table_t, pos_t, w_t, tok_t):
        """K-1 greedy draft proposals over the dense draft cache, then one
        target verify of the (slots, K) window (its K/V rows written into
        the pool).  Returns the window and the target's greedy picks, both
        (S, K) on the host."""
        window = [tok_t.long()]
        dtok = window[0]
        for k in range(K - 1):
            dlogits = T.decode_step(dparams, self._draft_cfg, dtok, self._kdc,
                                    self._vdc, pos_t.long() + k, w_t)[0]
            dtok = dlogits.argmax(-1)
            window.append(dtok)
        toks = torch.stack(window, dim=1)
        if self.use_flash:
            logits = T.verify_step_paged(params, self.cfg, toks, self._kpool,
                                         self._vpool, table_t, pos_t, w_t)[0]
        else:
            kc, vc = self._gathered(table_t)
            logits, _, _, knew, vnew = T.verify_step(params, self.cfg, toks,
                                                     kc, vc, pos_t, w_t)
            page, off = T.paged_index(table_t, pos_t.long(),
                                       self.page_size, K)
            self._kpool[:, page, off] = knew
            self._vpool[:, page, off] = vnew
        return (toks.cpu().numpy(),
                logits.argmax(-1).cpu().numpy().astype(np.int32))

    def _emit(self, slot, sid, token, now) -> bool:  # requires-lock: _cond
        """Append one token to ``slot``'s stream; True when it ended."""
        slot.req.tokens.append(token)
        slot.req.token_times.append(now)
        self.stats.inc('tokens')
        self.stats.observe('token_ms', (now - slot.last_emit) * 1e3)
        slot.last_emit = now
        slot.last_tok = token
        slot.pos += 1
        slot.kidx += 1
        hit_eos = self.eos_id is not None and token == self.eos_id
        if hit_eos or len(slot.req.tokens) >= slot.max_new:
            req = slot.req
            self._free_slot(sid)
            self._finish(req)
            return True
        return False

    def _step_info(self, params, K: int = 1):
        """The ledger row of a decode step (``K`` = 1) or a spec round of
        window K: every slot's K rows (padded to ``step_rows``) through
        the projections and the head, attention over the whole slot
        cache, and the draft's K-1 steps of a round."""
        S = self.slots
        r = T.step_rows(S * K)
        flops = lm_flops(self.cfg, r, S * K * self.cache_len, r)
        if K >= 2:
            rd = T.step_rows(S)
            flops += (K - 1) * lm_flops(self._draft_cfg, rd,
                                        S * self.cache_len, rd)
        return (flops, tree_bytes(params, self._kpool, self._vpool),
                f'int32[{S},{K}]')

    def _run_inner(self) -> None:
        S = self.slots
        while True:
            # chaos surface: a FaultPlan's slow_step events sleep here,
            # off the lock and between token boundaries
            _faults.decode_step()
            with self._cond:
                while True:
                    self._expire_slots(time.monotonic())
                    # joins first: anything admitted before a pending
                    # swap belongs to the old params' in-flight set
                    self._integrate_joins()
                    live = any(isinstance(s, _Slot) for s in self._slots)
                    if ((self._pending_params is not None
                            or self._pending_draft is not None)
                            and not live
                            and not self._joinq and self._admitting == 0):
                        if self._pending_params is not None:
                            self._params = self._pending_params
                            if self._pending_version is not None:
                                self.version = self._pending_version
                            self._pending_params = None
                            self.swap_count += 1
                            # the cached rows are the old model's
                            self._clear_prefix_index()
                        if self._pending_draft is not None:
                            self._draft_params = self._pending_draft
                            self._pending_draft = None
                            if self._pending_draft_version is not None:
                                self.draft_version = (
                                    self._pending_draft_version)
                                self._pending_draft_version = None
                        self._cond.notify_all()
                        continue
                    if live:
                        break
                    if (self._closed and not self._joinq
                            and self._admitting == 0):
                        return
                    self._cond.wait(0.05)
                # speculative window: K proposals only when every live
                # stream is greedy (sampled streams keep their pick
                # schedule) and nobody is within K tokens of its horizon
                live_slots = [s for s in self._slots
                              if isinstance(s, _Slot)]
                K_step = 1
                if (self._spec_k >= 2 and self._draft_params is not None
                        and all(s.temp == 0 for s in live_slots)):
                    rem = min(s.max_new - len(s.req.tokens)
                              for s in live_slots)
                    K_step = max(1, min(self._spec_k, rem))
                self._alloc_step_pages(K_step)
                if not any(isinstance(s, _Slot) for s in self._slots):
                    continue        # every stream was shed this pass
                params = self._params
                dparams = self._draft_params
                table = np.array(self._table)
                pos = np.zeros(S, np.int32)
                w = np.zeros(S, np.int32)
                tok = np.zeros(S, np.int32)
                temps = [0.0] * S
                keys = [None] * S
                stepped = []
                for sid, slot in enumerate(self._slots):
                    if isinstance(slot, _Slot):
                        pos[sid] = slot.pos
                        w[sid] = slot.w
                        tok[sid] = slot.last_tok
                        temps[sid] = slot.temp
                        if slot.keys is not None:
                            keys[sid] = slot.keys[slot.kidx]
                        stepped.append(sid)
            # the pools (and the draft caches) are loop-thread-owned
            # between token boundaries
            t0_ns = time.monotonic_ns()
            with full_f32():
                inputs = self._step_inputs(table, pos, w, tok)
                if K_step >= 2:
                    window, tgt = self._prog_spec.run(
                        f'k{K_step}', self._spec_round, K_step, params,
                        dparams, *inputs,
                        info=lambda: self._step_info(params, K_step))
                else:
                    logits = self._prog_step.run(
                        'step', self._decode, params, *inputs,
                        info=lambda: self._step_info(params))
                    nxt = T.pick_tokens(logits, temps, keys)
            # timed through the host readback above, as JAX's events are
            record_event('decode.spec_verify' if K_step >= 2
                         else 'decode.step', 'decode', t_start_ns=t0_ns,
                         dur_ns=time.monotonic_ns() - t0_ns,
                         slots=len(stepped), window=K_step)
            now = time.monotonic()
            self.stats.inc('decode_steps')
            self.stats.observe('step_occupancy', len(stepped) / S)
            with self._cond:
                if K_step >= 2:
                    self.stats.inc('spec_steps')
                    for sid in stepped:
                        slot = self._slots[sid]
                        if not isinstance(slot, _Slot):
                            continue
                        # the longest draft prefix the target agrees with,
                        # plus the target's own corrected token: every
                        # accepted token IS the target's greedy pick
                        a = 0
                        while (a + 1 < K_step
                               and window[sid, a + 1] == tgt[sid, a]):
                            a += 1
                        self.stats.inc('spec_proposed', K_step - 1)
                        self.stats.inc('spec_accepted', a)
                        self.stats.observe('spec_window', a + 1)
                        for token in tgt[sid, :a + 1]:
                            if self._emit(slot, sid, int(token), now):
                                break
                    continue
                for sid in stepped:
                    slot = self._slots[sid]
                    if isinstance(slot, _Slot):
                        self._emit(slot, sid, int(nxt[sid]), now)

    # -- lifecycle / observability -------------------------------------------
    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting; finish in-flight streams (bounded by their
        horizons and deadlines); join the loop thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if threading.current_thread() is self._loop:
            return False
        ok = True
        for t in self._prefill_threads:
            t.join(timeout)
            ok = not t.is_alive() and ok
        self._loop.join(timeout)
        ok = not self._loop.is_alive() and ok
        if self._kv is not None:
            ok = self._kv.close(timeout) and ok
        return ok

    def report(self, name: Optional[str] = None) -> str:
        """Eval-line stats snapshot with the page-pool and prefix gauges
        (shared pages, index size), the prefill workers' queue and the
        spec-decode acceptance rate; the tiers' gauges go to
        ``kv_stats``."""
        with self._cond:
            free = len(self._free_pages)
            self.stats.gauge('free_pages', free)
            self.stats.gauge('free_pages_min', self._free_min)
            self.stats.gauge('pages_used', self.n_pages - 1 - free)
            self.stats.gauge('pages_shared',
                             int((self._page_refs[1:] > 1).sum()))
            self.stats.gauge('prefix_index_pages', len(self._prefix))
            if self._prefill_threads:
                self.stats.gauge('prefill_workers',
                                 len(self._prefill_threads))
                self.stats.gauge('prefill_queue', len(self._prefillq))
        if self._kv is not None:
            self._kv.refresh_gauges()
        proposed = self.stats.get('spec_proposed')
        if proposed:
            self.stats.gauge('spec_accept_rate',
                             self.stats.get('spec_accepted') / proposed)
        return self.stats.print(name or self.name)


# -- on-disk format for transformer param trees -------------------------------
# ``%04d.lm`` files: an .npz of the flattened tree (``embed``, ``head``,
# ``stages/wq``, ...) written atomically with the ``.crc32`` sidecar —
# the JAX package's format, so either package reads the other's files.

def save_lm_params(path: str, params) -> str:
    """Atomically write a transformer param tree (+ crc32 sidecar)."""
    flat = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in _flatten(params).items()}
    checkpoint.save_model_file(path, lambda f: np.savez(f, **flat))
    checkpoint.write_model_digest(path)
    return path


def load_lm_params(path: str, retry=None):
    """Read a ``save_lm_params`` file (either package's) back into a
    nested dict of numpy leaves."""

    def read(f):
        z = np.load(f, allow_pickle=False)
        return {k: z[k] for k in z.files}

    return _nest(checkpoint.read_model_file(path, read, retry=retry))


#: the decode models' checkpoint names, for ``ModelRegistry(pattern=)``
LM_PATTERN = r'^(\d+)\.lm$'


def lm_loader(engine, path: str, retry=None):
    """Registry ``loader`` for decode models (the structure is checked
    by ``engine.place_params``)."""
    return load_lm_params(path, retry=retry)


class DecodeService:
    """The embeddable continuous-decode stack: a ``DynamicBatcher``
    fronting a ``DecodeEngine``, sharing one StatSet."""

    def __init__(self, params, cfg, *, slots: int = 4, pages: int = 64,
                 page_size: int = 16, max_prompt: int = 64,
                 max_new_bound: int = 64, eos_id: Optional[int] = None,
                 max_queue: int = 64, max_wait: float = 0.002,
                 deadline: float = 30.0, dtype: str = 'f32',
                 flash_decode=None, prefix_share: int = 0,
                 spec_k: int = 0, draft=None, kv_host_mb: int = 0,
                 kv_disk_mb: int = 0, kv_dir: Optional[str] = None,
                 kv_share_dir: Optional[str] = None, shard: str = '',
                 prefill_workers: int = 0, device='cuda'):
        from .batcher import DynamicBatcher
        stats = StatSet()
        self.engine = DecodeEngine(
            params, cfg, slots=slots, pages=pages, page_size=page_size,
            max_prompt=max_prompt, max_new_bound=max_new_bound,
            eos_id=eos_id, stats=stats, dtype=dtype,
            flash_decode=flash_decode, prefix_share=prefix_share,
            spec_k=spec_k, draft=draft, kv_host_mb=kv_host_mb,
            kv_disk_mb=kv_disk_mb, kv_dir=kv_dir,
            kv_share_dir=kv_share_dir, shard=shard,
            prefill_workers=prefill_workers, device=device)
        # with sharing on, admission prices each request at the prefill
        # rows it walks (prefill_cost: its bucket, hit or miss)
        cost_kw = {}
        if prefix_share > 0:
            cost_kw = {'cost_fn': self.engine.prefill_cost,
                       'max_cost': 2 * self.engine.max_prompt}
        self.batcher = DynamicBatcher(self.engine, max_queue=max_queue,
                                      max_wait=max_wait, deadline=deadline,
                                      stats=stats, **cost_kw)

    def submit_async(self, prompt, max_new: int, temperature: float = 0.0,
                     rng=None, deadline: Optional[float] = None):
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        return self.batcher.submit_async(
            prompt, deadline=deadline,
            meta={'max_new': max_new, 'temperature': temperature,
                  'rng': rng})

    def generate(self, prompt, max_new: int, temperature: float = 0.0,
                 rng=None, deadline: Optional[float] = None) -> np.ndarray:
        """Submit one prompt and block for its full token stream."""
        req = self.submit_async(prompt, max_new, temperature, rng,
                                deadline)
        self.batcher.wait(req)
        return req.result

    def report(self, name: str = 'decode') -> str:
        return self.engine.report(name)

    def register_into(self, hub, name: str = 'decode') -> None:
        """The decode stack's hub registration (JAX ``main.py``'s): one
        StatSet backs the engine and the batcher, refreshed with the
        pull-style page and prefix gauges before each render; the tiers'
        ``kv`` StatSet under its own name, occupancy and hit rate folded
        in per render."""
        hub.register_stats(name, self.engine.stats,
                           refresh=lambda: self.report(name))
        if self.engine.kv_stats is not None:
            hub.register_stats('kv', self.engine.kv_stats,
                               refresh=self.engine.kv_occupancy)

    def close(self, timeout: Optional[float] = None) -> None:
        self.batcher.close(timeout)
        self.engine.close(timeout)
