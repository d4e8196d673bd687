"""Python glue behind the port's C ABI (``runtime/cxxnet_wrapper.cc``).

PyTorch counterpart of ``cxxnet_tpu/capi.py``.  The reference exposed its
C++ trainer through a C ABI (``wrapper/cxxnet_wrapper.h:29-225``) so
other languages could bind it; here the trainer is Python, so the native
``libcxxnetwrapper.so`` embeds CPython and calls the flat functions of
this module, which delegate to :mod:`cxxnet_tpu_torch.wrapper`.  Each
takes only C-friendly types (memoryviews, tuples, strings) and returns a
contiguous float32 ``np.ndarray``, a ``str`` or ``None``, so the C layer
needs no per-call marshalling.

:func:`build_library` compiles the library from the package's own
``runtime/cxxnet_wrapper.cc`` with ``g++`` on first use, into
``runtime/_build/`` (git-ignored); ``python -m cxxnet_tpu_torch.capi``
builds it and prints its path.

The telemetry (``net_obs_*``) and train-while-serve (``net_online_*``)
functions are ported; autotune and the decode stack's scenario and
autoscale functions raise ``NotPortedError`` naming their ROADMAP.md
queue-A item.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

from .runtime.faults import NotPortedError
from .wrapper import DataIter, LMServe, Net

_RUNTIME = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'runtime')
SOURCE = os.path.join(_RUNTIME, 'cxxnet_wrapper.cc')
LIBRARY = os.path.join(_RUNTIME, '_build', 'libcxxnetwrapper.so')


def _python_flags(*args: str) -> list:
    out = subprocess.run(['python3-config', *args], capture_output=True,
                         text=True, check=True).stdout
    return out.split()


def build_library(force: bool = False) -> str:
    """Compile ``libcxxnetwrapper.so`` unless it is newer than its source;
    returns its path.  The flags are ``runtime/Makefile``'s: ``g++ -O2
    -std=c++17 -fPIC -shared`` with ``python3-config --includes`` and
    ``--embed --ldflags``.  Raises ``RuntimeError`` when ``g++`` or the
    Python headers are missing, or the compile fails."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    try:
        includes = _python_flags('--includes')
        ldflags = _python_flags('--embed', '--ldflags')
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f'python3-config is not usable: {e}') from e
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f'{LIBRARY}.{os.getpid()}.tmp'
    cmd = ['g++', '-O2', '-std=c++17', '-fPIC', '-Wall', *includes,
           '-shared', '-o', tmp, SOURCE, *ldflags]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot run g++: {e}') from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'{" ".join(cmd)} failed:\n{r.stderr}')
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _from_buffer(mv, shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.frombuffer(mv, np.float32, count=int(np.prod(shape)))
    return arr.reshape(shape).copy()


def _as_f32(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, np.float32)


def _as_4d(arr: np.ndarray) -> np.ndarray:
    """Shape to 4-d (batch, c, y, x) the way reference nodes are laid out
    (matrices become (batch, 1, 1, len), layer/layer.h:44-55)."""
    arr = _as_f32(arr)
    if arr.ndim == 4:
        return arr
    if arr.ndim == 2:
        return arr.reshape(arr.shape[0], 1, 1, arr.shape[1])
    if arr.ndim == 1:
        return arr.reshape(arr.shape[0], 1, 1, 1)
    raise ValueError(f'cannot view shape {arr.shape} as 4-d node')


# ---- iterator surface (CXNIO*) ------------------------------------------

def io_create(cfg: str) -> DataIter:
    return DataIter(cfg)


def io_next(it: DataIter) -> int:
    return 1 if it.next() else 0


def io_before_first(it: DataIter) -> None:
    it.before_first()


def io_get_data(it: DataIter) -> np.ndarray:
    return _as_4d(it.get_data())


def io_get_label(it: DataIter) -> np.ndarray:
    lab = _as_f32(it.get_label())
    return lab if lab.ndim == 2 else lab.reshape(lab.shape[0], -1)


# ---- net surface (CXNNet*) ----------------------------------------------

def net_create(device: str, cfg: str) -> Net:
    """A net on ``device`` (the card when empty)."""
    return Net(dev=device or 'cuda', cfg=cfg)


def net_set_param(net: Net, name: str, val: str) -> None:
    net.set_param(name, val)


def net_init_model(net: Net) -> None:
    net.init_model()


def net_save_model(net: Net, fname: str) -> None:
    net.save_model(fname)


def net_load_model(net: Net, fname: str) -> None:
    net.load_model(fname)


def net_start_round(net: Net, rnd: int) -> None:
    net.start_round(rnd)


def net_set_weight(net: Net, mv, size: int, layer_name: str,
                   tag: str) -> None:
    cur = net.get_weight(layer_name, tag)
    if cur is None:
        raise KeyError(f'layer {layer_name} has no weight {tag}')
    if int(size) != cur.size:
        raise ValueError(f'set_weight: size {size} != {cur.size}')
    net.set_weight(_from_buffer(mv, cur.shape), layer_name, tag)


def net_get_weight(net: Net, layer_name: str,
                   tag: str) -> Optional[np.ndarray]:
    w = net.get_weight(layer_name, tag)
    return None if w is None else _as_f32(w)


def net_update_iter(net: Net, it: DataIter) -> None:
    net.update(it)


def net_update_batch(net: Net, data_mv, dshape, label_mv, lshape) -> None:
    net.update(_from_buffer(data_mv, tuple(dshape)),
               _from_buffer(label_mv, tuple(lshape)))


def net_predict_batch(net: Net, data_mv, dshape) -> np.ndarray:
    return _as_f32(net.predict(_from_buffer(data_mv, tuple(dshape))))


def net_predict_iter(net: Net, it: DataIter) -> np.ndarray:
    """Whole-iterator predict: per-batch chunks from ``predict_stream``,
    joined once here because the C side takes one buffer."""
    chunks = list(net.predict_stream(it))
    if not chunks:
        return np.empty((0,), np.float32)
    return _as_f32(np.concatenate(chunks, axis=0))


def net_extract_batch(net: Net, data_mv, dshape, node: str) -> np.ndarray:
    return _as_4d(net.extract(_from_buffer(data_mv, tuple(dshape)), node))


def net_extract_iter(net: Net, it: DataIter, node: str) -> np.ndarray:
    chunks = list(net.extract_stream(it, node))
    if not chunks:
        return np.empty((0, 1, 1, 1), np.float32)
    return _as_4d(np.concatenate(chunks, axis=0))


def net_evaluate(net: Net, it: DataIter, name: str) -> str:
    return net.evaluate(it, name)


# ---- serving surface (CXNNetServe*) --------------------------------------

def net_serve_start(net: Net, cfg: str) -> None:
    """Stand up the serving stack.  ``cfg`` is a compact ``k=v[;k=v...]``
    list: ``buckets`` (``:``-separated, e.g. ``1:8:32``), ``max_queue``,
    ``max_wait`` and ``deadline`` (seconds), ``warm`` (0/1), ``models``
    (``|``-separated ``id:dir`` fleet models), ``mem_budget`` (bytes),
    ``dtype`` (``f32``, ``bf16`` or ``int8``), ``replicas`` (>= 2:
    data-parallel engine replicas, one a device, behind the one batcher),
    ``fold_bn`` (0/1: conv+BN folding at the f32 tier, calibrated on a
    seeded batch).  An empty string takes every default."""
    from .utils.config import parse_kv_list
    kw = {}
    for key, val in parse_kv_list(cfg or ''):
        if key == 'buckets':
            kw['buckets'] = val.replace(':', ',')
        elif key == 'max_queue':
            kw['max_queue'] = int(val)
        elif key in ('max_wait', 'deadline'):
            kw[key] = float(val)
        elif key == 'warm':
            kw['warm'] = bool(int(val))
        elif key == 'models':
            kw['models'] = dict(seg.split(':', 1)
                                for seg in val.split('|') if seg)
        elif key == 'mem_budget':
            kw['mem_budget'] = int(val)
        elif key == 'dtype':
            kw['dtype'] = val
        elif key == 'replicas':
            kw['replicas'] = int(val)
        elif key == 'fold_bn':
            kw['fold_bn'] = int(val)
        else:
            raise ValueError(f'unknown serve option: {key!r}')
    net.serve_start(**kw)


def net_serve_predict(net: Net, data_mv, dshape) -> np.ndarray:
    """One request through the micro-batcher: class id per row.  Typed
    serving errors propagate as Python exceptions."""
    return _as_f32(net.serve_predict(_from_buffer(data_mv, tuple(dshape))))


def net_serve_reload(net: Net, fname: str) -> None:
    net.serve_reload(fname)


def net_serve_stats(net: Net) -> str:
    return net.serve_stats()


def net_serve_stop(net: Net) -> None:
    net.serve_stop()


def _not_ported(what: str, item: str):
    def refuse(*args, **kwargs):
        raise NotPortedError(what, item)
    refuse.__name__ = what
    refuse.__doc__ = f'Raises ``NotPortedError`` (ROADMAP.md {item}).'
    return refuse


def net_obs_stats(net: Net) -> str:
    """The process-wide telemetry hub's ``/statusz`` JSON as one string
    (``CXNNetObsStats``): a live trainer's or server's state without an
    HTTP port."""
    return net.obs_stats()


def net_obs_slos(net: Net) -> str:
    """The ``/slos`` JSON as one string (``CXNNetObsSlos``): every attached
    SLO engine's typed verdicts."""
    return net.obs_slos()


def net_obs_programs(net: Net) -> str:
    """The ``/programs`` JSON as one string (``CXNNetObsPrograms``): the
    program ledger's rows and the recompile sentinel's totals."""
    return net.obs_programs()


# autotune: ROADMAP.md queue A item 10
net_autotune = _not_ported('net_autotune', 'queue A item 10')


# ---- train-while-serve surface (CXNNetOnline*) ----------------------------

def net_online_start(net: Net, it: DataIter, cfg: str) -> None:
    """Start the train-while-serve loop: training runs on a background
    thread over ``it`` while the colocated serving stack answers
    ``net_online_predict``.  ``cfg`` is a compact ``k=v[;k=v...]`` list:
    ``model_dir`` (required), ``rounds``, ``save_every``,
    ``freshness_slo`` / ``freshness_strict``, ``reload``, ``buckets``
    (``:``-separated), ``max_queue``, ``max_wait``, ``deadline``,
    ``steps_per_dispatch``, ``watchdog_deadline``, ``dtype`` (the
    serving tier, ``f32`` / ``bf16`` / ``int8``)."""
    from .utils.config import parse_kv_list
    kw = {}
    ints = ('rounds', 'save_every', 'max_queue', 'steps_per_dispatch')
    floats = ('freshness_slo', 'reload', 'max_wait', 'deadline',
              'watchdog_deadline')
    for key, val in parse_kv_list(cfg or ''):
        if key == 'model_dir':
            kw['model_dir'] = val
        elif key == 'buckets':
            kw['buckets'] = val.replace(':', ',')
        elif key == 'dtype':
            kw['dtype'] = val
        elif key == 'freshness_strict':
            kw['freshness_strict'] = bool(int(val))
        elif key in ints:
            kw[key] = int(val)
        elif key in floats:
            kw[key] = float(val)
        else:
            raise ValueError(f'unknown online option: {key!r}')
    if 'model_dir' not in kw:
        raise ValueError('online cfg must set model_dir=')
    net.online_start(it, **kw)


def net_online_predict(net: Net, data_mv, dshape) -> np.ndarray:
    """One request through the live online stack: class id per row.
    Typed serving errors propagate as Python exceptions."""
    return _as_f32(net.online_predict(_from_buffer(data_mv, tuple(dshape))))


def net_online_stats(net: Net) -> str:
    return net.online_stats()


def net_online_wait(net: Net) -> str:
    """Block until the background training run finishes; returns its
    summary as one JSON line (freshness p50 / p99, swaps, served,
    dropped, ...)."""
    import json
    return json.dumps(net.online_wait(), sort_keys=True)


def net_online_stop(net: Net) -> None:
    net.online_stop()


# ---- continuous decode surface (CXNLMServe*) ------------------------------

def lm_serve_start(cfg: str) -> LMServe:
    """Stand up the continuous-batching decode stack for a transformer LM
    from the compact ``k=v[;k=v...]`` spec :meth:`LMServe.from_spec`
    parses (``dev=cpu`` in it runs on the CPU).  Returns the handle the
    other ``lm_serve_*`` calls take."""
    return LMServe.from_spec(cfg)


def lm_serve_generate(svc: LMServe, prompt_mv, n: int, max_new: int,
                      temperature: float = 0.0, seed: int = 0) -> np.ndarray:
    """One decode request: blocks for the whole stream, returns contiguous
    int32 token ids.  Sampling (``temperature > 0``) draws from JAX's key
    schedule of ``seed``."""
    prompt = np.frombuffer(prompt_mv, np.int32, count=int(n))[None]
    rng = int(seed) if temperature > 0 else None
    toks = svc.generate(prompt, int(max_new), float(temperature), rng)
    return np.ascontiguousarray(toks, np.int32)


def lm_serve_stats(svc: LMServe) -> str:
    return svc.report()


lm_serve_scenario = _not_ported('lm_serve_scenario', 'queue A item 10')
lm_serve_autoscale = _not_ported('lm_serve_autoscale', 'queue A item 10')


def lm_serve_stop(svc: LMServe) -> None:
    svc.close()


if __name__ == '__main__':
    print(build_library(force='--force' in sys.argv[1:]))
