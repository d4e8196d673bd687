"""The tiered KV prefix cache: device pool -> host RAM -> disk.

PyTorch counterpart of ``cxxnet_tpu/serve/kvcache.py``.  It sits behind
the decode engine's content-addressed prefix index (``serve/decode.py``)
and extends an entry's life without touching the index's ownership
rules:

* **tier 0** is the device page pool, owned by the decode loop thread;
* **tier 1** is this module's bounded host-RAM LRU: when the index evicts
  an entry, the page's host K/V row mirrors **demote** here instead of
  dropping.  The demote runs under the engine lock, so it only moves
  memory: an overflow hands the coldest entry to the tier-2 spill queue;
* **tier 2** is :class:`~cxxnet_tpu_torch.serve.kvstore.KVStore`, crc32-
  digested records on disk, optionally shared across replicas.

A later probe that runs past the index promotes: the admitting thread
calls :meth:`prefetch` outside the engine lock (record reads fan out over
a small reader pool), then :meth:`take` under the lock hands the rows to
the engine.  JAX's engine uploads them into a fresh page; the port's
drops them and writes the prompt's own prefill rows there, since the key
(JAX's, so that replicas of either package share records) names no
prompt bucket, and a prefill's rows need not keep their bits at another
row count.  So streams stay bitwise twins through every demote, promote,
spill and adoption.

The cache keeps its own ``kv`` :class:`StatSet`, registered on the
telemetry hub (``DecodeService.register_into``), so ``/metrics``, the
gauge sampler and ``slo.kv_hit=kv.hit_rate>=0.5@60``-style specs read
it.  Host and disk bytes are not part of
``DecodeEngine.resident_bytes()``.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..utils.metric import StatSet
from .kvstore import KVStore, _host_rows

__all__ = ['TieredKVCache', 'KVStore']


class TieredKVCache:
    """Host-tier LRU over spillable prefix-page entries.

    ``host_bytes`` bounds tier 1 (0: no host tier; demotes go straight to
    the store, or drop without one); ``store`` is the optional tier-2
    :class:`KVStore`.  Lock order is always ``engine._cond`` ->
    ``TieredKVCache._lock``; this module never calls into the engine."""

    def __init__(self, *, host_bytes: int = 0,
                 store: Optional[KVStore] = None,
                 stats: Optional[StatSet] = None):
        self.stats = stats if stats is not None else StatSet()
        self._store = store
        self._host_cap = int(host_bytes)
        self._lock = threading.Lock()
        self._host: collections.OrderedDict = (
            collections.OrderedDict())   # guarded-by: _lock
        self._host_bytes = 0             # guarded-by: _lock
        self._readers: Optional[ThreadPoolExecutor] = None  # guarded-by: _lock

    # -- tier 1 --------------------------------------------------------------
    @staticmethod
    def _nbytes(hk, hv) -> int:
        return int(hk.numel() * hk.element_size()
                   + hv.numel() * hv.element_size())

    def demote(self, key, hk, hv) -> None:
        """The index hands an entry down-tier.  The rows are copied (the
        engine's mirrors are views into whole-prompt tensors, and a view
        would pin the prompt's memory against a page-sized budget);
        memory only, safe under the engine lock."""
        hk = _host_rows(hk).clone()
        hv = _host_rows(hv).clone()
        spill = []
        with self._lock:
            if key in self._host:
                self._host.move_to_end(key)
                return
            if self._host_cap > 0:
                self._host[key] = (hk, hv)
                self._host_bytes += self._nbytes(hk, hv)
                while self._host_bytes > self._host_cap and self._host:
                    k, (ck, cv) = self._host.popitem(last=False)
                    self._host_bytes -= self._nbytes(ck, cv)
                    spill.append((k, ck, cv))
            else:
                spill.append((key, hk, hv))
        self.stats.inc('demote_pages')
        for item in spill:
            if self._store is not None:
                self._store.spill(*item)  # async; drop-on-full inside
            else:
                self.stats.inc('host_evicted')

    def take(self, key):
        """Pop ``(hk, hv)`` for an exact key, or None: the promote read.
        The entry leaves tier 1 for the index again."""
        with self._lock:
            ent = self._host.pop(key, None)
            if ent is not None:
                self._host_bytes -= self._nbytes(*ent)
        if ent is not None:
            self.stats.inc('promote_pages')
        return ent

    def put_back(self, key, hk, hv) -> None:
        """Undo a :meth:`take` (the engine refused the promote chain);
        no counters move."""
        with self._lock:
            if key in self._host:
                return
            self._host[key] = (hk, hv)
            self._host_bytes += self._nbytes(hk, hv)

    # -- tier 2 promote path -------------------------------------------------
    def prefetch(self, keys) -> int:
        """Pull the ``keys`` that tier 2 holds up into tier 1, in order,
        stopping at the first miss (page ``lp`` is useless without
        ``lp - 1``).  Runs outside the engine lock; the reads fan out over
        a persistent pool of 4 reader threads.  Returns the number
        promoted to tier 1."""
        store = self._store
        if store is None or not keys:
            return 0
        with self._lock:
            want = [k for k in keys if k not in self._host]
        if not want:
            return 0
        t0 = time.monotonic()
        got = 0
        if len(want) > 1:
            with self._lock:
                if self._readers is None:
                    self._readers = ThreadPoolExecutor(
                        4, thread_name_prefix='cxxnet-kv-read')
                ex = self._readers
            loaded = list(ex.map(store.load, want))
        else:
            loaded = [store.load(want[0])]
        for key, ent in zip(want, loaded):
            if ent is None:
                break
            hk, hv = ent
            with self._lock:
                if key not in self._host:
                    self._host[key] = (hk, hv)
                    self._host_bytes += self._nbytes(hk, hv)
            got += 1
        if got:
            self.stats.inc('disk_promote_pages', got)
        self.stats.observe('promote_ms', (time.monotonic() - t0) * 1e3)
        return got

    # -- observability / lifecycle -------------------------------------------
    def refresh_gauges(self) -> None:
        """Tier occupancy and hit-rate gauges onto the ``kv`` StatSet."""
        with self._lock:
            self.stats.gauge('host_bytes', self._host_bytes)
            self.stats.gauge('host_entries', len(self._host))
        if self._store is not None:
            self.stats.gauge('disk_bytes', self._store.disk_bytes())
            self.stats.gauge('disk_entries', self._store.disk_entries())
        hits = self.stats.get('hits')
        total = hits + self.stats.get('misses')
        if total:
            self.stats.gauge('hit_rate', hits / total)

    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes

    def host_entries(self) -> int:
        with self._lock:
            return len(self._host)

    @property
    def store(self) -> Optional[KVStore]:
        return self._store

    def flush(self, timeout: float = 5.0) -> bool:
        return self._store.flush(timeout) if self._store is not None \
            else True

    def close(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            readers, self._readers = self._readers, None
        if readers is not None:
            readers.shutdown(wait=True)
        if self._store is not None:
            self._store.flush(timeout if timeout is not None else 5.0)
            return self._store.close(timeout)
        return True
