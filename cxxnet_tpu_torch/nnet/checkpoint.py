"""Model-blob serialization: the weight payload of a model file.

PyTorch counterpart of the format half of ``cxxnet_tpu/nnet/checkpoint.py``
— byte-compatible, so a model file the JAX package wrote loads here and
the reverse.  The blob is the concatenation of every non-shared layer's
record, in layer order (``SaveModel``, ``fullc_layer-inl.hpp:46-60``):

* fullc ``wmat`` on disk ``(nhidden, nin)``; in memory ``(nin, nhidden)``,
* conv ``wmat`` on disk ``(ngroup, nch/g, nin/g * kh * kw)``; in memory
  HWIO, as in the JAX package,
* 1-D ``bias`` tensors unchanged.

Tensors are stored as (uint32 ndim, uint32 shape[ndim], float32 data);
fullc, conv, bias and fixconn records start with the 328-byte LayerParam
struct.  Model files are written atomically (``atomic_write``) with the
JAX package's ``<model>.crc32`` integrity sidecar
(``write_model_digest``, checked by ``verify_model_digest``);
``save_model_file``, ``publish_model_file`` (the digest committed before
the rename, for hot-reload watchers) and ``read_model_file`` retry under
a ``runtime.faults.RetryPolicy``, each write attempt passing the
fault-injection hook first, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import zlib
from typing import Dict

import numpy as np
import torch

from ..layers import base as lbase

_LAYER_PARAM = struct.Struct('<ifif f iiiiiiiii iiii 64i')
assert _LAYER_PARAM.size == 328


def _pack_layer_param(p: lbase.LayerParam) -> bytes:
    return _LAYER_PARAM.pack(
        p.num_hidden, p.init_sigma, p.init_sparse, p.init_uniform,
        p.init_bias, p.num_channel, p.random_type, p.num_group,
        p.kernel_height, p.kernel_width, p.stride, p.pad_y, p.pad_x,
        p.no_bias, p.temp_col_max, p.silent, p.num_input_channel,
        p.num_input_node, *([0] * 64))


def _write_tensor(out: bytearray, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out += struct.pack('<I', arr.ndim)
    out += struct.pack(f'<{arr.ndim}I', *arr.shape)
    out += arr.tobytes()


def _read_tensor(buf: bytes, pos: int):
    (ndim,) = struct.unpack_from('<I', buf, pos)
    pos += 4
    shape = struct.unpack_from(f'<{ndim}I', buf, pos)
    pos += 4 * ndim
    n = int(np.prod(shape)) if ndim else 1
    arr = np.frombuffer(buf, np.float32, count=n, offset=pos).reshape(shape)
    pos += 4 * n
    return arr.copy(), pos


# layers whose reference SaveModel begins with the LayerParam struct
_SAVES_PARAM_STRUCT = {lbase.kFullConnect, lbase.kConv, lbase.kBias,
                       lbase.kFixConnect}


def layer_fields(type_id: int):
    """Field save order per layer type (reference SaveModel order)."""
    if type_id in (lbase.kFullConnect, lbase.kConv, lbase.kBatchNorm):
        return ('wmat', 'bias')
    if type_id in (lbase.kPRelu, lbase.kBias):
        return ('bias',)
    return ()


def to_disk_layout(type_id: int, field: str, arr: np.ndarray,
                   num_group: int) -> np.ndarray:
    if type_id == lbase.kFullConnect and field == 'wmat':
        return arr.T                                  # (nin,nh) → (nh,nin)
    if type_id == lbase.kConv and field == 'wmat':
        kh, kw, cin_g, cout = arr.shape
        g = num_group
        # HWIO → (g, cout/g, cin_g, kh, kw) → (g, cout/g, cin_g*kh*kw)
        a = arr.transpose(3, 2, 0, 1).reshape(g, cout // g, cin_g, kh, kw)
        return a.reshape(g, cout // g, cin_g * kh * kw)
    return arr


def from_disk_layout(type_id: int, field: str, arr: np.ndarray,
                     layer) -> np.ndarray:
    if type_id == lbase.kFullConnect and field == 'wmat':
        return arr.T
    if type_id == lbase.kConv and field == 'wmat':
        g, cout_g, flat = arr.shape
        p = layer.param
        cin_g = flat // (p.kernel_height * p.kernel_width)
        a = arr.reshape(g, cout_g, cin_g, p.kernel_height, p.kernel_width)
        return a.transpose(3, 4, 2, 0, 1).reshape(
            p.kernel_height, p.kernel_width, cin_g, g * cout_g)
    return arr


def host_params(params) -> Dict[str, Dict[str, np.ndarray]]:
    """Copy a param tree (tensors, or a host snapshot's arrays) to host
    numpy arrays."""
    return {k: {f: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for f, v in d.items()}
            for k, d in params.items()}


def params_to_blob(net, params) -> bytes:
    """Serialize a param tree (any device) to the reference model blob."""
    return serialize_blob(net, host_params(params))


def serialize_blob(net, host: Dict[str, Dict[str, np.ndarray]]) -> bytes:
    """Serialize a param snapshot already on the host to the reference
    model blob: CPU work only, safe on a background writer (it reads the
    net's static layer structure and nothing of the trainer's state)."""
    out = bytearray()
    for i, info in enumerate(net.cfg.layers):
        if net.layer_primary[i] != i or info.type == lbase.kSharedLayer:
            continue
        layer = net.layers[i]
        fields = layer_fields(info.type)
        if not fields:
            continue
        if info.type in _SAVES_PARAM_STRUCT:
            out += _pack_layer_param(layer.param)
        lp = host.get(str(i), {})
        for f in fields:
            if f not in lp:   # e.g. no_bias fullc still saves a bias slot
                n = layer.param.num_channel or max(layer.param.num_hidden, 1)
                arr = np.zeros((n,), np.float32)
            else:
                arr = to_disk_layout(info.type, f, lp[f],
                                     layer.param.num_group)
            _write_tensor(out, arr)
    return bytes(out)


def blob_to_raw(cfg_layers, blob: bytes) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse a blob into disk-layout arrays keyed by layer index/field."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    pos = 0
    for i, info in enumerate(cfg_layers):
        if info.type == lbase.kSharedLayer:
            continue
        fields = layer_fields(info.type)
        if not fields:
            continue
        if info.type in _SAVES_PARAM_STRUCT:
            pos += _LAYER_PARAM.size
        rec = {}
        for f in fields:
            arr, pos = _read_tensor(blob, pos)
            rec[f] = arr
        params[str(i)] = rec
    return params


def record_to_memory(layer, type_id: int, rec: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """Disk-layout record → in-memory param dict on ``device``."""
    out = {}
    for f, arr in rec.items():
        if f == 'bias' and layer.param.no_bias and \
                type_id in (lbase.kFullConnect, lbase.kConv):
            continue   # slot present on disk but unused in memory
        host = np.ascontiguousarray(from_disk_layout(type_id, f, arr, layer))
        out[f] = torch.from_numpy(host).to(device)
    return out


def blob_to_params(net, blob: bytes, device):
    raw = blob_to_raw(net.cfg.layers, blob)
    return {str(i): record_to_memory(net.layers[i], info.type, raw[str(i)],
                                     device)
            for i, info in enumerate(net.cfg.layers) if str(i) in raw}


@contextlib.contextmanager
def atomic_write(path: str):
    """Open a temp file next to ``path``; on clean exit fsync it and
    rename it over ``path``, so a half-written model file is never
    visible under the final name (``checkpoint.atomic_write`` of the JAX
    package).  On error the temp file is removed."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f'.{os.path.basename(path)}.tmp.{os.getpid()}')
    try:
        with open(tmp, 'wb') as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def model_digest_path(path: str) -> str:
    return os.fspath(path) + '.crc32'


def file_crc32(path: str) -> int:
    """Chunked crc32 of a file's bytes."""
    crc = 0
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def write_model_digest(path: str) -> str:
    """Write the ``<model>.crc32`` sidecar (JSON ``{size, crc32}``) next
    to a saved model file, atomically — the JAX package's format, which
    either package's serving registry verifies before a hot swap.  Ends
    at the chaos drills' commit point (``faults.model_committed``: the
    ``corrupt_model`` event truncates the model here, so a hot-reloading
    registry must catch the mismatch)."""
    from ..runtime import faults
    digest = {'size': os.path.getsize(path), 'crc32': file_crc32(path)}
    side = model_digest_path(path)
    with atomic_write(side) as f:
        f.write(json.dumps(digest).encode())
    faults.model_committed(path)
    return side


def verify_model_digest(path: str):
    """None when ``path`` matches its digest sidecar, or when there is no
    sidecar (unverified but plausible); else the reason, as a string.  A
    malformed sidecar is a reason, never an exception: the registry
    blacklists on reasons."""
    side = model_digest_path(path)
    if not os.path.exists(side):
        return None
    try:
        with open(side, 'rb') as f:
            digest = json.load(f)
        size = os.path.getsize(path)
    except (OSError, ValueError) as e:
        return f'unreadable digest sidecar: {e!r}'
    if not isinstance(digest, dict) \
            or not isinstance(digest.get('size'), int) \
            or not isinstance(digest.get('crc32'), int):
        return f'malformed digest sidecar: {digest!r}'
    if size != digest['size']:
        return f'size {size} != recorded {digest["size"]}'
    crc = file_crc32(path)
    if crc != digest['crc32']:
        return f'crc32 {crc:#x} != recorded {digest["crc32"]:#x}'
    return None


def publish_model_file(path: str, write_fn, retry=None) -> str:
    """Publish a model file for hot-reload watchers: as
    :func:`save_model_file` + :func:`write_model_digest`, but the digest
    is computed from the staged bytes and committed BEFORE the rename, so
    a watcher never sees a model file without its digest.  The
    ``corrupt_model`` hook runs on the staged file, between the digest
    and the rename: an injected corruption is always caught by
    verification."""
    from ..runtime import faults
    retry = faults.DEFAULT_IO_RETRY if retry is None else retry
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f'.{os.path.basename(path)}.pub.{os.getpid()}')

    def attempt():
        faults.checkpoint_write_attempt(path)
        os.makedirs(d, exist_ok=True)
        try:
            with open(tmp, 'wb') as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
            digest = {'size': os.path.getsize(tmp),
                      'crc32': file_crc32(tmp)}
            with atomic_write(model_digest_path(path)) as f:
                f.write(json.dumps(digest).encode())
            faults.model_committed(path, staged=tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    retry.call(attempt, op_name=f'publish_model:{os.path.basename(path)}')
    return path


def save_model_file(path: str, write_fn, retry=None) -> str:
    """Atomically write a model file whose bytes ``write_fn(fileobj)``
    produces; the whole write retries under ``retry`` (default
    ``faults.DEFAULT_IO_RETRY``), each attempt passing the fault hook
    first, so an injected storage error takes the real error's path."""
    from ..runtime import faults
    retry = faults.DEFAULT_IO_RETRY if retry is None else retry

    def attempt():
        faults.checkpoint_write_attempt(path)
        with atomic_write(path) as f:
            write_fn(f)

    retry.call(attempt, op_name=f'save_model:{os.path.basename(path)}')
    return os.fspath(path)


def read_model_file(path: str, read_fn, retry=None):
    """``read_fn(fileobj)`` over a model file, retried under ``retry``;
    a missing file raises ``FileNotFoundError`` at once (absence is a
    state, not a transient)."""
    from ..runtime import faults
    retry = faults.DEFAULT_IO_RETRY if retry is None else retry
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    def attempt():
        with open(path, 'rb') as f:
            return read_fn(f)

    return retry.call(attempt,
                      op_name=f'read_model:{os.path.basename(path)}')
