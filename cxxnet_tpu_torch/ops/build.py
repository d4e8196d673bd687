"""Build the port's CUDA kernels from ``ops/csrc`` and bind them.

Each ``csrc/*.cu`` source has a plain C interface (one or more entry
points) and is compiled by ``nvcc`` into its own shared library, loaded
with ``ctypes``.  None of
them includes PyTorch's headers, so each builds in seconds instead of
the minutes a ``torch.utils.cpp_extension`` build of a file that does
takes; the wrappers pass ``tensor.data_ptr()`` pointers and PyTorch's
current stream, and each C entry point returns the ``cudaError_t`` of
its launch, which the wrapper turns into an exception.

The build runs at first use, never at import: all sources compile
together, one ``nvcc`` process each, into ``ops/_build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its sources and
flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ``nvcc`` comes from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``
or ``PATH``; if none is found the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')

#: library name -> its .cu source (headers in csrc/ are hashed into all)
SOURCES = {
    'conv_bias_act': 'conv_bias_act.cu',
    'conv_bias_act_bf16': 'conv_bias_act_bf16.cu',
    'lrn': 'lrn.cu',
    'fullc_gemm': 'fullc_gemm.cu',
    'fullc_gemm_bf16': 'fullc_gemm_bf16.cu',
    'lrn_bwd': 'lrn_bwd.cu',
    'fullc_gemm_nt': 'fullc_gemm_nt.cu',
    'fullc_gemm_nt_bf16': 'fullc_gemm_nt_bf16.cu',
    'fullc_gemm_tn': 'fullc_gemm_tn.cu',
    'fullc_gemm_tn_bf16': 'fullc_gemm_tn_bf16.cu',
    'paged_decode': 'paged_decode.cu',
    'paged_verify': 'paged_verify.cu',
    'int8_gemm': 'int8_gemm.cu',
    'flash_fwd': 'flash_fwd.cu',
    'flash_dq': 'flash_dq.cu',
    'flash_dkv': 'flash_dkv.cu',
    'threefry': 'threefry.cu',
}

NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_ll = ctypes.c_longlong

_PAGED_DECODE_ARGS = [_c_void_p] * 7 + [_c_int] * 5 + [_c_float, _c_void_p]
_PAGED_VERIFY_ARGS = [_c_void_p] * 7 + [_c_int] * 6 + [_c_float, _c_void_p]
# pointers, then (bh, sq, sk, d, causal), scale and the stream
_FLASH_FWD_ARGS = [_c_void_p] * 5 + [_c_int] * 5 + [_c_float, _c_void_p]
_FLASH_DQ_ARGS = [_c_void_p] * 7 + [_c_int] * 5 + [_c_float, _c_void_p]
_FLASH_DKV_ARGS = [_c_void_p] * 8 + [_c_int] * 5 + [_c_float, _c_void_p]

_CONV_ARGS = [_c_void_p] * 5 + [_c_int] * 15 + [_c_void_p]
_LRN_FWD_ARGS = [_c_void_p] * 3 + [_c_ll] + [_c_int] * 3 + [_c_float] * 3 \
    + [_c_void_p]
_LRN_BWD_ARGS = [_c_void_p] * 4 + [_c_ll] + [_c_int] * 3 + [_c_float] * 2 \
    + [_c_void_p]
# a, b, c, the split-K workspace; m, n, k, splits; the stream
_GEMM_ARGS = [_c_void_p] * 4 + [_c_int] * 4 + [_c_void_p]
# a, b, c; m, n, k; the stream
_GEMM_TN_ARGS = [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]
# out, the key's two words, n, mode; lo, span, thresh; the stream
_THREEFRY_ARGS = [_c_void_p, ctypes.c_uint, ctypes.c_uint, _c_ll, _c_int] \
    + [_c_float] * 3 + [_c_void_p]

#: entry key -> (library, C function, argtypes); every C function returns
#: the cudaError_t of its launch, except the ``*_splits`` counts.  A
#: ``*_bf16`` / ``*_f16`` key is the kernel's bf16 / f16 build: in the same
#: library as its f32 build, or, for the conv and the three fullc GEMMs, in
#: one library of their own that holds both 16-bit builds (one templated
#: body, ``*_bf16.cu``)
SIGNATURES = {
    'conv_bias_act': ('conv_bias_act', 'conv_bias_act_f32', _CONV_ARGS),
    'conv_bias_act_bf16': ('conv_bias_act_bf16', 'conv_bias_act_bf16',
                           _CONV_ARGS),
    'conv_bias_act_f16': ('conv_bias_act_bf16', 'conv_bias_act_f16',
                          _CONV_ARGS),
    'lrn': ('lrn', 'lrn_fwd_f32', _LRN_FWD_ARGS),
    'lrn_bf16': ('lrn', 'lrn_fwd_bf16', _LRN_FWD_ARGS),
    'lrn_f16': ('lrn', 'lrn_fwd_f16', _LRN_FWD_ARGS),
    'fullc_gemm': ('fullc_gemm', 'fullc_gemm_f32', _GEMM_ARGS),
    'fullc_gemm_bf16': ('fullc_gemm_bf16', 'fullc_gemm_bf16', _GEMM_ARGS),
    'fullc_gemm_f16': ('fullc_gemm_bf16', 'fullc_gemm_f16', _GEMM_ARGS),
    # the split-K ranges of an (m, n, k) product (a count, not an error)
    'fullc_gemm_splits': ('fullc_gemm', 'fullc_gemm_splits', [_c_int] * 3),
    'fullc_gemm_bf16_splits': ('fullc_gemm_bf16', 'fullc_gemm_bf16_splits',
                               [_c_int] * 3),
    'fullc_gemm_f16_splits': ('fullc_gemm_bf16', 'fullc_gemm_f16_splits',
                              [_c_int] * 3),
    'lrn_bwd': ('lrn_bwd', 'lrn_bwd_f32', _LRN_BWD_ARGS),
    'lrn_bwd_bf16': ('lrn_bwd', 'lrn_bwd_bf16', _LRN_BWD_ARGS),
    'lrn_bwd_f16': ('lrn_bwd', 'lrn_bwd_f16', _LRN_BWD_ARGS),
    # g, b, c, the split-K workspace; m, n, k, splits; the stream
    'fullc_gemm_nt': ('fullc_gemm_nt', 'fullc_gemm_nt_f32', _GEMM_ARGS),
    # the 16-bit builds sum their split ranges in a cluster: no workspace
    'fullc_gemm_nt_bf16': ('fullc_gemm_nt_bf16', 'fullc_gemm_nt_bf16',
                           _GEMM_ARGS),
    'fullc_gemm_nt_f16': ('fullc_gemm_nt_bf16', 'fullc_gemm_nt_f16',
                          _GEMM_ARGS),
    'fullc_gemm_nt_splits': ('fullc_gemm_nt', 'fullc_gemm_nt_splits',
                             [_c_int] * 3),
    'fullc_gemm_nt_bf16_splits': ('fullc_gemm_nt_bf16',
                                  'fullc_gemm_nt_bf16_splits', [_c_int] * 3),
    'fullc_gemm_nt_f16_splits': ('fullc_gemm_nt_bf16',
                                 'fullc_gemm_nt_f16_splits', [_c_int] * 3),
    'fullc_gemm_tn': ('fullc_gemm_tn', 'fullc_gemm_tn_f32', _GEMM_TN_ARGS),
    'fullc_gemm_tn_bf16': ('fullc_gemm_tn_bf16', 'fullc_gemm_tn_bf16',
                           _GEMM_TN_ARGS),
    'fullc_gemm_tn_f16': ('fullc_gemm_tn_bf16', 'fullc_gemm_tn_f16',
                          _GEMM_TN_ARGS),
    'paged_decode': ('paged_decode', 'paged_decode_f32', _PAGED_DECODE_ARGS),
    'paged_decode_bf16': ('paged_decode', 'paged_decode_bf16',
                          _PAGED_DECODE_ARGS),
    'paged_verify': ('paged_verify', 'paged_verify_f32', _PAGED_VERIFY_ARGS),
    'paged_verify_bf16': ('paged_verify', 'paged_verify_bf16',
                          _PAGED_VERIFY_ARGS),
    'int8_gemm': ('int8_gemm', 'int8_gemm_s8s32',
                  [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]),
    # the split-K cluster size of an (m, n, k) product (a count)
    'int8_gemm_splits': ('int8_gemm', 'int8_gemm_splits', [_c_int] * 3),
    # an empty kernel on the decode grid (S, H): the launch floor
    'paged_empty': ('paged_decode', 'paged_empty_launch',
                    [_c_int] * 2 + [_c_void_p]),
    'flash_fwd': ('flash_fwd', 'flash_fwd_f32', _FLASH_FWD_ARGS),
    'flash_fwd_bf16': ('flash_fwd', 'flash_fwd_bf16', _FLASH_FWD_ARGS),
    'flash_dq': ('flash_dq', 'flash_dq_f32', _FLASH_DQ_ARGS),
    'flash_dq_bf16': ('flash_dq', 'flash_dq_bf16', _FLASH_DQ_ARGS),
    'flash_dkv': ('flash_dkv', 'flash_dkv_f32', _FLASH_DKV_ARGS),
    'flash_dkv_bf16': ('flash_dkv', 'flash_dkv_bf16', _FLASH_DKV_ARGS),
    'threefry': ('threefry', 'threefry_uniform_f32', _THREEFRY_ARGS),
    'threefry_bf16': ('threefry', 'threefry_uniform_bf16', _THREEFRY_ARGS),
    'threefry_f16': ('threefry', 'threefry_uniform_f16', _THREEFRY_ARGS),
}

_lock = threading.Lock()
_entry: Dict[str, object] = {}     # guarded-by: _lock


def find_nvcc() -> str:
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                           'of cxxnet_tpu_torch build from ops/csrc at first '
                           'use')
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == SOURCES[name] or fn.endswith('.cuh'):
            with open(os.path.join(CSRC, fn), 'rb') as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f'lib{name}.{h.hexdigest()[:16]}.so')


def build_all() -> Dict[str, object]:
    """Compile every missing library (all ``nvcc`` processes started
    together), load them, and return ``{name: C entry point}``.  Raises
    with the compiler's output if any source fails to build."""
    with _lock:
        if len(_entry) == len(SIGNATURES):
            return dict(_entry)
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = {n: _lib_path(n) for n in SOURCES}
        procs = {}
        for name, out in todo.items():
            if os.path.exists(out):
                continue
            tmp = f'{out}.{os.getpid()}.tmp'
            log = open(os.path.join(BUILD_DIR, f'{name}.log'), 'w')
            cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp,
                   os.path.join(CSRC, SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           log, tmp, out, cmd)
        failed = []
        for name, (proc, log, tmp, out, cmd) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
                continue
            os.replace(tmp, out)    # atomic: a reader never sees half a .so
        if failed:
            msgs = []
            for name in failed:
                with open(os.path.join(BUILD_DIR, f'{name}.log')) as f:
                    msgs.append(f'--- {name} ---\n{f.read()}')
            raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(msgs))
        libs = {name: ctypes.CDLL(out) for name, out in todo.items()}
        for key, (lib, fn_name, argtypes) in SIGNATURES.items():
            fn = getattr(libs[lib], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry[key] = fn
        return dict(_entry)


def entry(name: str):
    """The C entry point under key ``name`` of :data:`SIGNATURES`,
    building on first use."""
    with _lock:
        fn = _entry.get(name)
    return fn if fn is not None else build_all()[name]


def build_log(name: str) -> str:
    """The compiler's output of the newest build of ``name`` (``-Xptxas
    -v`` register and shared-memory lines), or '' before any build."""
    path = os.path.join(BUILD_DIR, f'{name}.log')
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


#: the kernel builds' element types: a dtype's suffix on an entry key and
#: a launch count
_SUFFIXES = {'torch.float32': '', 'torch.bfloat16': '_bf16',
             'torch.float16': '_f16'}


def dtype_suffix(kernel: str, dtype) -> str:
    """The suffix of ``kernel``'s build for ``dtype``, on its entry key
    and its launch count: '' for f32, ``'_bf16'`` for bf16, ``'_f16'``
    for f16; any other dtype raises.  (Only the CNN rows 1-7 and the
    threefry draw have f16 builds; the attention kernels check their
    dtype themselves.)"""
    sfx = _SUFFIXES.get(str(dtype))
    if sfx is None:
        raise ValueError(f'{kernel}: no kernel build for {dtype}')
    return sfx


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')
