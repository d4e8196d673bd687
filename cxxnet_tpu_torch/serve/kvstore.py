"""The tiered KV cache's tier 2: the on-disk spill record store.

PyTorch counterpart of ``cxxnet_tpu/serve/kvstore.py``, with its own copy
of the record format so that a JAX replica and a port replica can share
one ``serve.kv_share_dir``: for the same key and rows a record is byte
for byte the JAX package's, and each package reads the other's.

One record per evicted prefix page; for a given engine shape every
record has the same size::

    b'CXKV1\\n' | u32 header_len | header JSON | K rows | V rows

The header carries the exact content key of the decode engine's prefix
index — ``(model version, pad width, logical page, exact padded token
span)`` — and every read checks it, so the sha256 file name
(:func:`key_digest`) is a lookup convenience, never a correctness
dependence.  Records commit through the checkpoint publish discipline:
staged write + fsync, the crc32 sidecar computed from the staged bytes
and committed before the rename, then a directory fsync, so a reader
never sees a record without its digest.  The ``corrupt_kv=N`` fault
event fires on the staged file between the digest and the rename.

A record that fails its digest (or whose header is not the key it was
fetched for) is quarantined — renamed aside with a ``.quarantine``
suffix and recorded as a typed ``KVCorruptRecordError`` — and read as a
miss: the request re-prefills.

Spill writes run on a ``cxxnet-kv-store-<name>`` worker thread behind a
drop-on-full queue (the engine's demote hook runs under its lock and
never touches a disk; a cache never owes durability).  ``share_dir``
republishes every committed record there under the same name and
discipline, and a local miss adopts a verified shared record.

Rows are CPU tensors here (``float32`` or ``bfloat16``; numpy arrays are
accepted on the way in): the bf16 serving tier's rows need no numpy
bfloat16 type.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..nnet import checkpoint
from ..runtime import faults
from ..utils.metric import StatSet

__all__ = ['KVStore', 'key_digest', 'encode_record', 'decode_record']

_MAGIC = b'CXKV1\n'
_RECORD_SUFFIX = '.kv'
#: record header dtype names (numpy's spelling, as the JAX package
#: writes them) <-> torch dtypes
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def key_digest(key) -> str:
    """Stable content digest of a prefix key: the record's file name,
    equal across replicas and across the two packages."""
    version, w, lp, span = key
    h = hashlib.sha256()
    h.update(repr(version).encode())
    h.update(b'|%d|%d|' % (int(w), int(lp)))
    h.update(bytes(span))
    return h.hexdigest()


def _host_rows(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor or a numpy array), contiguous."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.detach().to('cpu').contiguous()


def encode_record(key, hk, hv) -> bytes:
    """Serialize one page's host K/V row mirrors and their exact key."""
    version, w, lp, span = key
    hk, hv = _host_rows(hk), _host_rows(hv)
    if hk.shape != hv.shape or hk.dtype != hv.dtype:
        raise ValueError('K/V row mirrors must share shape and dtype')
    if hk.dtype not in _NAMES:
        raise ValueError(f'no record dtype for {hk.dtype}')
    header = json.dumps(
        {'v': repr(version), 'w': int(w), 'lp': int(lp),
         'span': bytes(span).hex(), 'dtype': _NAMES[hk.dtype],
         'shape': list(hk.shape)}, sort_keys=True).encode()
    raw = [t.reshape(-1).view(torch.uint8).numpy().tobytes()
           for t in (hk, hv)]
    return b''.join([_MAGIC, struct.pack('<I', len(header)), header] + raw)


def decode_record(blob: bytes, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parse a record back into CPU tensors ``(hk, hv)``; raises
    ``ValueError`` unless the header carries exactly ``key``."""
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError('bad record magic')
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from('<I', blob, off)
    off += 4
    header = json.loads(blob[off:off + hlen].decode())
    off += hlen
    version, w, lp, span = key
    want = {'v': repr(version), 'w': int(w), 'lp': int(lp),
            'span': bytes(span).hex()}
    got = {k: header.get(k) for k in want}
    if got != want:
        raise ValueError(f'record key mismatch: {got!r} != {want!r}')
    if header.get('dtype') not in _DTYPES:
        raise ValueError(f'record dtype {header.get("dtype")!r}')
    dtype = _DTYPES[header['dtype']]
    shape = tuple(int(s) for s in header['shape'])
    count = int(np.prod(shape))
    n = count * torch.empty((), dtype=dtype).element_size()
    if len(blob) - off != 2 * n:
        raise ValueError(f'record payload is {len(blob) - off} bytes, '
                         f'expected {2 * n}')
    rows = [torch.frombuffer(bytearray(blob[o:o + n]), dtype=dtype,
                             count=count).reshape(shape)
            for o in (off, off + n)]
    return rows[0], rows[1]


class KVStore:
    """Tier-2 record store: a byte budget with LRU-by-mtime eviction, an
    async spill worker, and an optional cross-replica ``share_dir``."""

    def __init__(self, root: str, budget_bytes: int,
                 share_dir: Optional[str] = None,
                 stats: Optional[StatSet] = None, name: str = 'kv',
                 max_queue: int = 256):
        self.root = os.fspath(root)
        self.share_dir = None if share_dir is None else os.fspath(share_dir)
        self.budget_bytes = int(budget_bytes)
        self.stats = stats if stats is not None else StatSet()
        os.makedirs(self.root, exist_ok=True)
        if self.share_dir is not None:
            os.makedirs(self.share_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._disk_bytes = 0             # guarded-by: _lock (record bytes)
        self._disk_entries = 0           # guarded-by: _lock
        # spills awaiting the worker, read through so that a promote
        # between enqueue and commit still finds the entry (a prefix
        # chain breaks on any mid-chain miss)
        self._inflight: dict = {}        # guarded-by: _lock
        self._scan_ledger()
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, daemon=True, name=f'cxxnet-kv-store-{name}')
        self._worker.start()

    # -- ledger --------------------------------------------------------------
    def _records(self):
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in sorted(names)
                if n.endswith(_RECORD_SUFFIX)]

    def _scan_ledger(self) -> None:
        total = entries = 0
        for path in self._records():
            try:
                total += os.path.getsize(path)
                entries += 1
            except OSError:
                pass
        with self._lock:
            self._disk_bytes, self._disk_entries = total, entries

    def disk_bytes(self) -> int:
        with self._lock:
            return self._disk_bytes

    def disk_entries(self) -> int:
        with self._lock:
            return self._disk_entries

    def record_path(self, key) -> str:
        return os.path.join(self.root, key_digest(key) + _RECORD_SUFFIX)

    # -- spill (async; worker thread) ----------------------------------------
    def spill(self, key, hk, hv) -> bool:
        """Enqueue one demoted entry for the worker; False when the queue
        is full (the entry is dropped and counted; never blocks).  A key
        names an immutable span, so an existing record is never stale: a
        re-demote only refreshes its LRU clock."""
        with self._lock:
            queued = key in self._inflight
        path = self.record_path(key)
        if queued or os.path.exists(path):
            if not queued:
                try:
                    os.utime(path)
                except OSError:
                    pass
            self.stats.inc('spill_dedup')
            return True
        hk, hv = _host_rows(hk), _host_rows(hv)
        try:
            self._q.put_nowait((key, hk, hv))
        except queue.Full:
            self.stats.inc('spill_dropped')
            return False
        with self._lock:
            self._inflight[key] = (hk, hv)
        return True

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                if item is not None:
                    self._write_record(*item)
            except Exception as e:  # noqa: BLE001 — the worker survives
                self.stats.inc('spill_errors')
                faults.global_failure_log().record(
                    'kv_spill_error', repr(faults.KVSpillError(self.root, e)))
            finally:
                if item is not None:
                    # retire the read-through entry unless a re-spill
                    # replaced it (identity: the newer enqueue owns it)
                    with self._lock:
                        cur = self._inflight.get(item[0])
                        if cur is not None and cur[0] is item[1]:
                            del self._inflight[item[0]]
                self._q.task_done()
            if item is None:
                return

    def _publish(self, path: str, blob: bytes, chaos: bool) -> None:
        """Commit ``blob`` under ``path``: staged bytes + fsync, the
        digest sidecar of the staged bytes committed before the rename,
        then the rename and a directory fsync.  ``chaos`` lets the
        ``corrupt_kv`` event fire (the primary copy only, so one event is
        one poisoned record)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(
            d, f'.{os.path.basename(path)}.pub.{os.getpid()}')
        try:
            with open(tmp, 'wb') as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            digest = {'size': len(blob),
                      'crc32': zlib.crc32(blob) & 0xFFFFFFFF}
            with checkpoint.atomic_write(
                    checkpoint.model_digest_path(path)) as f:
                f.write(json.dumps(digest).encode())
            if chaos:
                faults.kv_record_committed(path, staged=tmp)
            os.replace(tmp, path)
            try:
                dfd = os.open(d, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def _write_record(self, key, hk, hv) -> None:
        t0 = time.monotonic()
        path = self.record_path(key)
        fresh = not os.path.exists(path)
        blob = encode_record(key, hk, hv)
        self._publish(path, blob, chaos=True)
        self.stats.inc('spills')
        self.stats.observe('spill_ms', (time.monotonic() - t0) * 1e3)
        if fresh:
            with self._lock:
                self._disk_bytes += len(blob)
                self._disk_entries += 1
        self._enforce_budget()
        if self.share_dir is not None:
            share = os.path.join(self.share_dir, os.path.basename(path))
            if not os.path.exists(share):
                self._publish(share, blob, chaos=False)
                self.stats.inc('published')

    def _enforce_budget(self) -> None:
        """Delete the coldest (oldest-mtime) records of the local root
        until under budget; the share dir is every replica's."""
        if self.budget_bytes <= 0:
            return
        with self._lock:
            if self._disk_bytes <= self.budget_bytes:
                return
            total = self._disk_bytes
        aged = []
        for path in self._records():
            try:
                aged.append((os.path.getmtime(path),
                             os.path.getsize(path), path))
            except OSError:
                pass
        aged.sort()
        freed_bytes = freed_entries = 0
        for _mt, size, path in aged:
            if total - freed_bytes <= self.budget_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            try:
                os.unlink(path + '.crc32')
            except OSError:
                pass
            freed_bytes += size
            freed_entries += 1
            self.stats.inc('disk_evicted')
        with self._lock:
            self._disk_bytes = max(0, self._disk_bytes - freed_bytes)
            self._disk_entries = max(0, self._disk_entries - freed_entries)

    # -- promote reads (caller thread) ---------------------------------------
    def _quarantine(self, path: str, reason: str) -> None:
        err = faults.KVCorruptRecordError(path, reason)
        self.stats.inc('corrupt_quarantined')
        faults.global_failure_log().record('kv_corrupt_record', repr(err))
        size = 0
        try:
            size = os.path.getsize(path)
            os.replace(path, path + '.quarantine')
        except OSError:
            pass
        try:
            os.unlink(path + '.crc32')
        except OSError:
            pass
        if os.path.dirname(os.path.abspath(path)) == \
                os.path.abspath(self.root):
            with self._lock:
                self._disk_bytes = max(0, self._disk_bytes - size)
                self._disk_entries = max(0, self._disk_entries - 1)

    def _read_verified(self, path: str, key):
        """``(hk, hv)`` from one record file, or None: a digest mismatch
        and undecodable bytes both quarantine and read as a miss."""
        t0 = time.monotonic()
        reason = checkpoint.verify_model_digest(path)
        if reason is not None:
            self._quarantine(path, reason)
            return None
        try:
            with open(path, 'rb') as f:
                blob = f.read()
            ent = decode_record(blob, key)
        except (OSError, ValueError) as e:
            self._quarantine(path, repr(e))
            return None
        try:
            os.utime(path)               # LRU clock for _enforce_budget
        except OSError:
            pass
        self.stats.observe('read_ms', (time.monotonic() - t0) * 1e3)
        return ent

    def load(self, key):
        """``(hk, hv)`` for ``key``: an in-flight spill first, then the
        local root, else a record adopted from the share dir (committed
        locally too, so the byte budget owns it), else None."""
        with self._lock:
            ent = self._inflight.get(key)
        if ent is not None:
            self.stats.inc('inflight_hits')
            return ent
        path = self.record_path(key)
        if os.path.exists(path):
            ent = self._read_verified(path, key)
            if ent is not None:
                return ent
        if self.share_dir is None:
            return None
        share = os.path.join(self.share_dir, os.path.basename(path))
        if not os.path.exists(share):
            return None
        ent = self._read_verified(share, key)
        if ent is None:
            return None
        self.stats.inc('adopts')
        blob = encode_record(key, *ent)
        fresh = not os.path.exists(path)
        self._publish(path, blob, chaos=False)
        if fresh:
            with self._lock:
                self._disk_bytes += len(blob)
                self._disk_entries += 1
        self._enforce_budget()
        return ent

    # -- lifecycle -----------------------------------------------------------
    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every queued spill committed; False on timeout."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def close(self, timeout: Optional[float] = None) -> bool:
        self._stop.set()
        try:
            self._q.put_nowait(None)     # wake the worker
        except queue.Full:
            pass
        self._worker.join(timeout if timeout is not None else 5.0)
        return not self._worker.is_alive()
