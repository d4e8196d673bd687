"""Step checkpoints in the native tree format.

The port's own copy of the native half of ``cxxnet_tpu/nnet/sharded_ckpt.py``.
A checkpoint is a directory ``<ckpt_dir>/step_<n>/``: one raw-bytes file
per large leaf (``leaf_<i>.bin``), the leaves under 256 KiB packed into
``packed_leaves.bin``, a ``tree_manifest.json`` mapping each leaf's path
to its file, dtype, shape (and offset), and a ``ckpt_digest.json`` sidecar
of ``relpath -> [size, crc32]``.  The leaves are written into a temp dir
(in parallel over a writer pool), the manifest last, one directory rename
commits the step, and the digest lands through ``checkpoint.atomic_write``
after it; then the ``shard_committed`` fault hook fires.

Leaf paths are spelled as ``jax.tree_util.keystr`` spells them
(``['params']['3']['wmat']``, ``['counters']['sample']``) and numbered in
JAX's flatten order (dict keys sorted, sequences in order, None holding no
leaf), without JAX: a tree written here restores in the JAX package's
``restore_sharded`` and the reverse, and the same tree gives byte-identical
files from both writers.  Leaves are torch tensors (copied to the host) or
numpy arrays; 0-d leaves (the counters) stay 0-d; a bfloat16 tensor is
written as its raw 2-byte words under JAX's dtype name ``bfloat16`` (numpy
has none) and read back as a torch bfloat16 tensor.

Deliberate divergence (ROADMAP.md queue C): the JAX package's synchronous
``save_sharded`` writes orbax; the port writes this native format on
every path, and reads only it.  A step dir without a manifest (an orbax
checkpoint) raises :class:`OrbaxCheckpointError` and is never
quarantined.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime import faults

_STEP_RE = re.compile(r'^step_(\d+)$')
_DIGEST_NAME = 'ckpt_digest.json'
_MANIFEST_NAME = 'tree_manifest.json'
_PACKED_NAME = 'packed_leaves.bin'
_PACK_LIMIT = 1 << 18        # leaves under 256 KiB share one blob file

__all__ = ['OrbaxCheckpointError', 'step_dir', 'latest_step', 'all_steps',
           'quarantined_steps', 'write_digest', 'verify_step_dir',
           'save_tree_native', 'restore_sharded', 'quarantine_step',
           'restore_resilient', 'flatten_with_keys', 'map_with_keys']


class OrbaxCheckpointError(ValueError):
    """A step dir without ``tree_manifest.json``: the JAX package's
    orbax format, which the port does not read (ROADMAP.md queue C).  A
    ``ValueError``, so ``restore_resilient`` skips the step without
    quarantining it: its bytes are intact."""

    def __init__(self, path: str):
        self.path = path
        super().__init__(
            f'{path} has no {_MANIFEST_NAME}: it is an orbax checkpoint '
            '(the JAX package\'s synchronous save_sharded format); '
            'cxxnet_tpu_torch writes and reads the native tree format '
            'only (a deliberate divergence, ROADMAP.md queue C)')


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.fspath(ckpt_dir), f'step_{step}')


def _scan_steps(ckpt_dir: str, suffix: str = '') -> List[int]:
    """Step numbers of ``step_<n><suffix>`` dirs, newest first; a temp
    dir or a ``.corrupt`` one fails the anchored match."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if suffix:
            if not name.endswith(suffix):
                continue
            name = name[:-len(suffix)]
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name + suffix)):
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step in ``ckpt_dir`` (None if empty)."""
    steps = _scan_steps(ckpt_dir)
    return steps[0] if steps else None


def all_steps(ckpt_dir: str) -> List[int]:
    """Every complete checkpoint step in ``ckpt_dir``, newest first."""
    return _scan_steps(ckpt_dir)


def quarantined_steps(ckpt_dir: str) -> List[int]:
    """Steps with a ``step_<n>.corrupt`` quarantine dir, newest first."""
    return _scan_steps(ckpt_dir, '.corrupt')


# --- integrity digest -------------------------------------------------------

def _payload_files(path: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f == _DIGEST_NAME:
                continue
            out.append(os.path.relpath(os.path.join(root, f), path))
    return sorted(out)


def _file_crc(p: str) -> int:
    crc = 0
    with open(p, 'rb') as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def write_digest(path: str) -> None:
    """(Re)write ``path``'s digest sidecar from the files on disk."""
    from .checkpoint import atomic_write
    digest = {rel: [os.path.getsize(os.path.join(path, rel)),
                    _file_crc(os.path.join(path, rel))]
              for rel in _payload_files(path)}
    with atomic_write(os.path.join(path, _DIGEST_NAME)) as f:
        f.write(json.dumps(digest).encode())


def verify_step_dir(path: str) -> Optional[str]:
    """Integrity-check one committed checkpoint dir: None when it
    verifies (or has no digest: unverified but plausible), else the
    reason."""
    dig = os.path.join(path, _DIGEST_NAME)
    if not os.path.exists(dig):
        return None
    try:
        with open(dig) as f:
            digest = json.load(f)
    except (OSError, ValueError) as e:
        return f'unreadable digest: {e!r}'
    for rel, (size, crc) in digest.items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return f'missing shard file: {rel}'
        if os.path.getsize(p) != size:
            return f'truncated shard file: {rel}'
        if _file_crc(p) != crc:
            return f'corrupt shard file: {rel}'
    return None


# --- the tree: JAX's flatten order and keystr, without JAX ------------------

def flatten_with_keys(tree, prefix: str = '') -> List[Tuple[str, object]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, lists and tuples in order, None no leaf,
    anything else a leaf; keys spelled ``[repr(key)]`` / ``[i]``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_keys(tree[k], f'{prefix}[{k!r}]')
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_keys(v, f'{prefix}[{i}]')
        return out
    return [(prefix, tree)]


def map_with_keys(fn, tree, prefix: str = ''):
    """``tree`` with each leaf replaced by ``fn(keystr, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, f'{prefix}[{k!r}]')
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, f'{prefix}[{i}]')
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a C-contiguous host array and its dtype name; a
    bfloat16 tensor as its raw 2-byte words named ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).cpu().numpy().view(np.uint16)
            return np.require(arr, requirements='C'), 'bfloat16'
        leaf = t.cpu().numpy()
    # np.require, not ascontiguousarray: the latter promotes 0-d leaves
    # (the counters) to shape (1,)
    arr = np.require(np.asarray(leaf), requirements='C')
    return arr, str(arr.dtype)


def _write_leaf(dirpath: str, fname: str, data) -> Tuple[int, int]:
    """Plain write + fsync of one file of the uncommitted temp dir (the
    directory rename is the atomic unit); ``(size, crc32)`` from the
    in-memory bytes."""
    with open(os.path.join(dirpath, fname), 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    size = data.nbytes if isinstance(data, np.ndarray) else len(data)
    return size, zlib.crc32(data) & 0xFFFFFFFF


def save_tree_native(ckpt_dir: str, step: int, tree, retry=None,
                     pool=None) -> str:
    """Write ``tree`` as ``step_<n>``: large leaves in parallel over
    ``pool`` (a ThreadPoolExecutor; None = one by one), the small ones
    packed, the manifest last, one directory rename to commit.  An
    existing dir for the step is replaced.  The write retries whole under
    ``retry`` (``faults.DEFAULT_IO_RETRY``) and passes the fault hook
    first; the digest is accumulated from the in-memory bytes and lands
    after the commit, then ``shard_committed`` fires.  Returns the
    step dir."""
    path = os.path.abspath(step_dir(ckpt_dir, step))
    tmp = f'{path}.tmp.{os.getpid()}'
    flat = [(key, *_host_leaf(leaf))
            for key, leaf in flatten_with_keys(tree)]
    retry = faults.DEFAULT_IO_RETRY if retry is None else retry
    digest: Dict[str, list] = {}

    def attempt():
        faults.checkpoint_write_attempt(path)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        digest.clear()
        manifest = {}
        jobs = []
        packed, off = [], 0
        for i, (key, arr, dtype) in enumerate(flat):
            if arr.nbytes < _PACK_LIMIT:
                manifest[key] = {'file': _PACKED_NAME, 'dtype': dtype,
                                 'shape': list(arr.shape), 'offset': off}
                packed.append(arr)
                off += arr.nbytes
                continue
            fname = f'leaf_{i:05d}.bin'
            manifest[key] = {'file': fname, 'dtype': dtype,
                             'shape': list(arr.shape)}
            if pool is None:
                digest[fname] = list(_write_leaf(tmp, fname, arr))
            else:
                jobs.append((fname, pool.submit(_write_leaf, tmp, fname,
                                                arr)))
        if packed:
            # .tobytes(), never bytes(): bytes() of a 0-d integer array
            # yields that many NUL bytes
            blob = b''.join(a.tobytes() for a in packed)
            if pool is None:
                digest[_PACKED_NAME] = list(
                    _write_leaf(tmp, _PACKED_NAME, blob))
            else:
                jobs.append((_PACKED_NAME,
                             pool.submit(_write_leaf, tmp, _PACKED_NAME,
                                         blob)))
        for fname, j in jobs:
            digest[fname] = list(j.result())
        mbytes = json.dumps(manifest).encode()
        digest[_MANIFEST_NAME] = [len(mbytes),
                                  zlib.crc32(mbytes) & 0xFFFFFFFF]
        _write_leaf(tmp, _MANIFEST_NAME, mbytes)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        try:   # the commit rename itself durable (best effort)
            dfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    try:
        retry.call(attempt, op_name=f'save_native:step_{step}')
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    from .checkpoint import atomic_write
    with atomic_write(os.path.join(path, _DIGEST_NAME)) as f:
        f.write(json.dumps(digest).encode())
    faults.shard_committed(step, path)
    return path


def _restore_native(path: str, like):
    """A native step dir as a tree shaped like ``like``: a torch leaf of
    ``like`` gives a tensor on its device (its dtype when the stored one
    is the same), a numpy or scalar leaf a numpy array."""
    with open(os.path.join(path, _MANIFEST_NAME)) as f:
        manifest = json.load(f)
    packed = []                  # the shared small-leaf blob, read once

    def load(key, leaf):
        ent = manifest.get(key)
        if ent is None:
            raise ValueError(
                f'native checkpoint {path} has no leaf {key!r} '
                '(restoring under a changed structure?)')
        bf16 = ent['dtype'] == 'bfloat16'
        dt = np.dtype(np.uint16 if bf16 else ent['dtype'])
        shape = tuple(ent['shape'])
        n = int(np.prod(shape)) if shape else 1
        if ent['file'] == _PACKED_NAME:
            if not packed:
                with open(os.path.join(path, _PACKED_NAME), 'rb') as f:
                    packed.append(f.read())
            arr = np.frombuffer(packed[0], dt, count=n,
                                offset=ent.get('offset', 0)).reshape(
                shape).copy()
        else:
            arr = np.fromfile(os.path.join(path, ent['file']), dtype=dt,
                              count=n).reshape(shape)
        if arr.size != n:
            raise ValueError(f'native checkpoint {path}: leaf {key!r} '
                             f'short of its {n} elements')
        if bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            dev = leaf.device if isinstance(leaf, torch.Tensor) else 'cpu'
            return t.to(dev)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(leaf.device)
        return arr

    return map_with_keys(load, like)


def restore_sharded(ckpt_dir: str, like, step: Optional[int] = None,
                    retry: Optional[faults.RetryPolicy] = None):
    """Restore the checkpoint at ``step`` (default: the latest) shaped
    like ``like``; the read retries under ``retry``.  Returns (tree,
    step).  A step dir without a manifest raises
    :class:`OrbaxCheckpointError`."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    path = os.path.abspath(step_dir(ckpt_dir, step))
    # absence is a state, not a transient: no backoff over a missing dir
    if not os.path.isdir(path):
        raise FileNotFoundError(f'no checkpoint dir {path}')
    if not os.path.exists(os.path.join(path, _MANIFEST_NAME)):
        raise OrbaxCheckpointError(path)
    retry = faults.DEFAULT_IO_RETRY if retry is None else retry
    tree = retry.call(lambda: _restore_native(path, like),
                      op_name=f'restore_sharded:step_{step}')
    return tree, step


def quarantine_step(ckpt_dir: str, step: int, reason: str) -> None:
    """Rename a bad ``step_<n>`` to ``step_<n>.corrupt``: later scans skip
    it, its bytes stay for a post-mortem."""
    src = os.path.abspath(step_dir(ckpt_dir, step))
    if os.path.isdir(src):
        dst = src + '.corrupt'
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.replace(src, dst)
    faults.global_failure_log().record(
        'ckpt_quarantined', f'step {step}: {reason}', step=step)


def restore_resilient(ckpt_dir: str, like,
                      retry: Optional[faults.RetryPolicy] = None):
    """Restore the newest checkpoint that passes verification, falling
    back step by step: a step whose digest fails is quarantined; one that
    verifies but fails to restore (an outage, a changed structure, an
    orbax dir) is skipped and left in place.  Raises
    ``faults.CheckpointCorruptError`` when nothing restores and something
    was quarantined, else the last restore error.  Returns (tree,
    step)."""
    steps = all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    log = faults.global_failure_log()
    quarantined = 0
    last_err: Optional[BaseException] = None
    for step in steps:
        reason = verify_step_dir(os.path.abspath(step_dir(ckpt_dir, step)))
        if reason is not None:
            quarantine_step(ckpt_dir, step, reason)
            quarantined += 1
            continue
        try:
            return restore_sharded(ckpt_dir, like, step, retry=retry)
        except (faults.RetryError, OSError, ValueError) as e:
            last_err = e
            log.record('ckpt_restore_failed', repr(e), step=step)
    if not quarantined and last_err is not None:
        raise last_err
    raise faults.CheckpointCorruptError(
        f'no intact checkpoint under {ckpt_dir} '
        f'({quarantined} of {len(steps)} candidates quarantined, '
        f'rest unrestorable)')
