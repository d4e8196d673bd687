"""Kernel launch counts, safe across threads.

Every wrapper in ``ops/`` adds one to its kernel's count right after the
kernel launched, and nowhere else; a plain version run on the CPU counts
nothing.  A decode engine launches kernels from two threads at once (its
loop steps while an admitting thread prefills), so the counts live behind
one lock instead of in ``fn.launches += 1`` read-modify-writes.  The
bf16 and f16 builds of the CNN kernels (conv, LRN forward and backward,
the three fullc GEMMs) and the bf16 builds of the paged attention
kernels and of the flash-attention kernels count under their own names;
the threefry kernel (JAX's random stream) counts its f32, bf16 and f16
draws as one.
"""

from __future__ import annotations

import threading
from typing import Dict

#: every counted kernel, in report order
KERNELS = ('conv_bias_act', 'lrn_forward', 'lrn_backward', 'fullc_gemm',
           'fullc_gemm_nt', 'fullc_gemm_tn', 'conv_bias_act_bf16',
           'lrn_forward_bf16', 'lrn_backward_bf16', 'fullc_gemm_bf16',
           'fullc_gemm_nt_bf16', 'fullc_gemm_tn_bf16', 'conv_bias_act_f16',
           'lrn_forward_f16', 'lrn_backward_f16', 'fullc_gemm_f16',
           'fullc_gemm_nt_f16', 'fullc_gemm_tn_f16', 'threefry_uniform',
           'paged_flash_decode',
           'paged_flash_verify', 'paged_flash_decode_bf16',
           'paged_flash_verify_bf16', 'int8_matmul', 'flash_fwd',
           'flash_dq', 'flash_dkv', 'flash_fwd_bf16', 'flash_dq_bf16',
           'flash_dkv_bf16')

_lock = threading.Lock()
_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)   # guarded-by: _lock


def add(name: str) -> None:
    """One launch of kernel ``name``."""
    with _lock:
        _counts[name] += 1


def counts() -> Dict[str, int]:
    """A snapshot of every kernel's count."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        for name in _counts:
            _counts[name] = 0
