"""The LRN, fullc GEMM and int8 GEMM kernels, their plain versions, and
the gates that decide which layers take a kernel.

Counterpart of ``cxxnet_tpu/ops/pallas_kernels.py``.  Each kernel here
has a wrapper that checks its inputs and launches the CUDA kernel on a
CUDA tensor (counting the launch), runs the plain version — the same
function step by step on tensors — on a CPU tensor, and raises on
anything else; there is no fallback from the card to the plain version.

* ``lrn_forward`` (``csrc/lrn.cu``) replaces ``_lrn_fwd_kernel``
  (pallas_kernels.py:233) behind ``lrn_pallas`` and ``lrn_hybrid``; its
  backward is ``lrn_backward`` (``csrc/lrn_bwd.cu``, replacing
  ``_lrn_bwd_kernel`` :242 of ``_lrn_vjp_bwd`` :306) in ``full`` mode,
  and the plain ``lrn_hybrid_backward`` (the XLA ops of
  ``_lrn_hybrid_bwd`` :352, no kernel in the JAX package either) in
  ``hybrid`` mode.
* ``fullc_gemm`` (``csrc/fullc_gemm.cu``) replaces ``_matmul_kernel``
  (pallas_kernels.py:383, ``_matmul_impl`` :532) behind
  ``pallas_matmul``; its backward is ``fullc_gemm_nt``
  (``csrc/fullc_gemm_nt.cu``, replacing ``_matmul_nt_kernel`` :433) for
  the input gradient and ``fullc_gemm_tn`` (``csrc/fullc_gemm_tn.cu``,
  replacing ``_matmul_tn_kernel`` :449) for the weight gradient, both
  contracting against the stored layouts, as ``_matmul_vjp_bwd`` :419
  does.  The forward and input-gradient kernels run full f32 on the FMA
  pipes; the weight gradient runs on the TF32 tensor cores with the
  3xTF32 split (three TF32 products a term, each 32-deep slice of the
  batch summed apart), which keeps f32 accuracy.
* ``int8_matmul`` (``csrc/int8_gemm.cu``) replaces ``_int8_matmul_kernel``
  (:1073, ``pallas_int8_matmul`` :1090): s8 x s8 -> s32 with exact
  accumulation, the product under ``nnet/quantize.qdot``.  Every
  ``qdot`` on the card takes it (see ``nnet/quantize.py`` for why that
  differs from the JAX package's ``auto`` and changes no number).

Mixed precision (``compute_type=bfloat16`` and ``=float16``): the LRN
kernels and the three fullc GEMMs have a bf16 and an f16 build each,
counted under their own names (``lrn_forward_bf16`` /
``lrn_forward_f16``, ``lrn_backward_*``, ``fullc_gemm_*``,
``fullc_gemm_nt_*``, ``fullc_gemm_tn_*``): 16-bit operands, f32 sums, one
rounding on the 16-bit store, with the LRN's ``norm`` kept in f32 both
ways (and ``x`` squared in f32, so an f16 ``x`` does not overflow on the
way), as the Pallas kernels do (pallas_kernels.py:233-252, 295-296,
376-396, 433-462).  The LRN builds run on the FMA pipes
(``csrc/lrn.cuh``, one body over float, bf16 bits and ``__half``).  The
forward GEMM multiplies on the 16-bit tensor cores with ``mma.sync``
(``csrc/gemm_bf16.cuh``), the backward GEMMs with ``wgmma``
(``csrc/gemm_wgmma.cuh``), one templated body for bf16 and f16 each.
Their weight gradient comes back 16-bit and autograd widens it into the
f32 parameter's, as JAX's ``.astype`` chain does.  The plain versions are
the same for both 16-bit types: they widen to f32, sum, and round once to
the input's dtype.  Any other dtype raises on the card.

The gates mirror what the JAX package's ``auto`` sends to Pallas on ONE
TPU chip: the port routes the same layers to kernels.  They make no
speed claim for this card; the ``use_pallas=`` net param (``1``/``0``)
forces every kernel on or off, and the tri-state travels in
``ForwardContext.kernel_mode`` instead of the JAX package's process-wide
``CXXNET_PALLAS`` environment variable.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import build, launches

def pallas_mode(value=None) -> str:
    """Parse the ``use_pallas=`` net param into the tri-state kernel mode:
    unset/``auto`` -> ``'auto'`` (per-op gates below), a true spelling ->
    ``'on'`` (every kernel), anything else -> ``'off'`` (the stock
    PyTorch composition)."""
    if value is None or not str(value).strip() \
            or str(value).strip().lower() == 'auto':
        return 'auto'
    return ('on' if str(value).strip().lower() in ('1', 'true', 'yes', 'on')
            else 'off')


def fullc_pallas_shape_class(m: int, k: int, n: int) -> bool:
    """fc8's shape class in the JAX package's gate: lane-ragged N big
    enough to matter (``pallas_kernels.py:119-122``)."""
    return n % 128 != 0 and m >= 128 and k >= 1024 and n >= 512


def fullc_use_pallas(m: int, k: int, n: int, *, is_train: bool,
                     mode: str = 'auto') -> bool:
    """Whether fullc's forward product takes the GEMM kernel: forced by
    ``on``/``off``; in ``auto`` only at eval in fc8's shape class, as the
    JAX gate does on one chip (``pallas_kernels.py:87-116``).  Everything
    else is ``torch.matmul``."""
    if mode == 'off':
        return False
    if mode == 'on':
        return True
    return not is_train and fullc_pallas_shape_class(m, k, n)


def lrn_auto_mode(c: int, mode: str = 'auto') -> str:
    """The LRN implementation at ``c`` channels: ``'full'`` (kernel
    forward and kernel backward), ``'hybrid'`` (kernel forward, plain
    backward) or ``'xla'`` (the cumsum composition of
    ``layers/norm.py``).  The JAX gate on one chip
    (``pallas_kernels.py:125-162``): 128-aligned channels run full,
    8-aligned channels from 96 up run the hybrid, the rest the
    composition.  Eval runs only the forward either way."""
    if mode == 'off':
        return 'xla'
    if mode == 'on':
        return 'full'
    if c % 128 == 0:
        return 'full'
    if c % 8 == 0 and c >= 96:
        return 'hybrid'
    return 'xla'


# --- LRN ----------------------------------------------------------------------

#: the most channels either LRN kernel takes (``LRN_MAX_C`` of
#: ``csrc/lrn.cuh``), the same in both directions
LRN_MAX_C = 8192


def _lrn_window(nsize: int):
    """``_band_matrix``'s window: channel j sums [j - lo, j + hi]."""
    lo = (nsize - 1) // 2
    return lo, nsize - 1 - lo


def lrn_forward_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                      knorm: float):
    """The plain version: square, sum each channel's window of shifted
    slices (zero beyond the channel range), scale, power, multiply.
    Returns ``(y, norm)``, norm f32 in ``x``'s shape."""
    c = x.shape[-1]
    lo, hi = _lrn_window(nsize)
    x32 = x.float()
    sq = F.pad(x32 * x32, (lo, hi))
    win = sq[..., 0:c]
    for q in range(1, nsize):
        win = win + sq[..., q:q + c]
    norm = knorm + (alpha / nsize) * win
    return (x32 * norm.pow(-beta)).to(x.dtype), norm


def _lrn_call(x, nsize, alpha, beta, knorm, need_norm):
    if x.device.type == 'cpu':
        return lrn_forward_plain(x, nsize, alpha, beta, knorm)
    if x.device.type != 'cuda':
        raise RuntimeError(f'lrn_forward: no kernel for device {x.device}')
    sfx = build.dtype_suffix('lrn_forward', x.dtype)
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f'lrn_forward: x must be a contiguous tensor, got '
                         f'{tuple(x.shape)} {x.dtype}')
    c = x.shape[-1]
    if not 0 < c <= LRN_MAX_C:
        raise ValueError(f'lrn_forward: {c} channels; the kernels stage '
                         f'whole rows of at most {LRN_MAX_C} channels')
    if nsize < 1:
        raise ValueError(f'lrn_forward: local_size {nsize} < 1')
    lo, hi = _lrn_window(nsize)
    y = torch.empty_like(x)
    norm = torch.empty(x.shape, device=x.device, dtype=torch.float32) \
        if need_norm else None
    err = build.entry('lrn' + sfx)(
        x.data_ptr(), y.data_ptr(), None if norm is None else norm.data_ptr(),
        x.numel() // c, c, lo, hi, alpha / nsize, beta, knorm,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, 'lrn_forward' + sfx)
    launches.add('lrn_forward' + sfx)
    return y, norm


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nsize, alpha, beta, knorm, hybrid):
        need_norm = ctx.needs_input_grad[0]
        y, norm = _lrn_call(x, nsize, alpha, beta, knorm, need_norm)
        if need_norm:
            ctx.save_for_backward(x, norm)
            ctx.args = (nsize, alpha, beta, hybrid)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, norm = ctx.saved_tensors
        nsize, alpha, beta, hybrid = ctx.args
        bwd = lrn_hybrid_backward if hybrid else lrn_backward
        return bwd(x, gy.contiguous(), norm, nsize, alpha, beta), \
            None, None, None, None, None


def lrn_forward(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                knorm: float, hybrid: bool = False) -> torch.Tensor:
    """Cross-channel LRN over the last axis of ``x`` (NHWC rows); the CUDA
    kernel on the card, :func:`lrn_forward_plain` on the CPU.  The
    gradient is :func:`lrn_backward` (``full`` mode, ``lrn_pallas``) or,
    with ``hybrid``, :func:`lrn_hybrid_backward` (``lrn_hybrid``)."""
    return _LRN.apply(x, int(nsize), float(alpha), float(beta), float(knorm),
                      bool(hybrid))


def _lrn_bwd_terms(x, g, norm, beta):
    """``(g * p, t)`` with ``p = norm^-beta`` and ``t = g x p / norm``,
    in ``_lrn_bwd_kernel``'s order."""
    x32, g32 = x.float(), g.float()
    npow = norm.pow(-beta)
    return g32 * npow, g32 * x32 * npow / norm


def lrn_backward_plain(x: torch.Tensor, g: torch.Tensor, norm: torch.Tensor,
                       nsize: int, alpha: float, beta: float
                       ) -> torch.Tensor:
    """The plain version of ``lrn_backward``: ``t = g x norm^(-beta-1)``,
    each channel j sums t over the transposed window [j - hi, j + lo]
    with shifted slices (the forward's window read backwards), then
    ``dx = g norm^-beta - 2 beta alpha/n x win``."""
    c = x.shape[-1]
    lo, hi = _lrn_window(nsize)
    gp, t = _lrn_bwd_terms(x, g, norm, beta)
    tp = F.pad(t, (hi, lo))
    win = tp[..., 0:c]
    for q in range(1, nsize):
        win = win + tp[..., q:q + c]
    return (gp - 2.0 * beta * (alpha / nsize) * x.float() * win).to(x.dtype)


def lrn_backward(x: torch.Tensor, g: torch.Tensor, norm: torch.Tensor,
                 nsize: int, alpha: float, beta: float) -> torch.Tensor:
    """Gradient of :func:`lrn_forward` with respect to ``x`` from the
    upstream gradient ``g`` and the forward's saved f32 ``norm``; the CUDA
    kernel (``csrc/lrn_bwd.cu``) on the card, :func:`lrn_backward_plain`
    on the CPU."""
    if x.device.type == 'cpu':
        return lrn_backward_plain(x, g, norm, nsize, alpha, beta)
    if x.device.type != 'cuda':
        raise RuntimeError(f'lrn_backward: no kernel for device {x.device}')
    sfx = build.dtype_suffix('lrn_backward', x.dtype)
    for name, t, dtype in (('x', x, x.dtype), ('g', g, x.dtype),
                           ('norm', norm, torch.float32)):
        if t.device != x.device or t.dtype != dtype \
                or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(
                f'lrn_backward: {name} must be a contiguous {dtype} tensor '
                f'of shape {tuple(x.shape)} on {x.device}, got '
                f'{tuple(t.shape)} {t.dtype} on {t.device}')
    c = x.shape[-1] if x.dim() else 0
    if not 0 < c <= LRN_MAX_C:
        raise ValueError(f'lrn_backward: {c} channels; the kernels stage '
                         f'whole rows of at most {LRN_MAX_C} channels')
    if nsize < 1:
        raise ValueError(f'lrn_backward: local_size {nsize} < 1')
    lo, hi = _lrn_window(nsize)
    dx = torch.empty_like(x)
    err = build.entry('lrn_bwd' + sfx)(
        x.data_ptr(), g.data_ptr(), norm.data_ptr(), dx.data_ptr(),
        x.numel() // c, c, lo, hi, beta, 2.0 * beta * alpha / nsize,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, 'lrn_backward' + sfx)
    launches.add('lrn_backward' + sfx)
    return dx


def lrn_hybrid_backward(x: torch.Tensor, g: torch.Tensor, norm: torch.Tensor,
                        nsize: int, alpha: float, beta: float
                        ) -> torch.Tensor:
    """The ``hybrid`` backward: ``_lrn_hybrid_bwd`` (pallas_kernels.py:352)
    step by step, the transposed window summed with a cumulative sum along
    the channels.  The JAX package runs it as XLA ops, not as a kernel, so
    this is plain PyTorch on every device."""
    c = x.shape[-1]
    lo, hi = _lrn_window(nsize)
    gp, t = _lrn_bwd_terms(x, g, norm, beta)
    cums = torch.cumsum(F.pad(t, (hi + 1, lo)), dim=-1)
    win = cums[..., nsize:nsize + c] - cums[..., 0:c]
    return (gp - 2.0 * beta * (alpha / nsize) * x.float() * win).to(x.dtype)


# --- fullc GEMMs --------------------------------------------------------------

def fullc_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     tile_k: int = 512) -> torch.Tensor:
    """The plain version: the K loop of the tiled kernel, one 512-deep
    slice of ``a @ b`` at a time into an f32 accumulator."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, tile_k):
        acc = acc + a[:, k0:k0 + tile_k].float() @ b[k0:k0 + tile_k].float()
    return acc.to(a.dtype)


def fullc_gemm_nt_plain(g: torch.Tensor, b: torch.Tensor,
                        tile_n: int = 512) -> torch.Tensor:
    """The plain version of ``g (m, n) @ b (k, n)^T``: the contraction
    over the shared trailing axis n, one 512-wide slice of both operands
    at a time into an f32 accumulator."""
    m, n = g.shape
    acc = torch.zeros((m, b.shape[0]), dtype=torch.float32, device=g.device)
    for n0 in range(0, n, tile_n):
        acc = acc + g[:, n0:n0 + tile_n].float() \
            @ b[:, n0:n0 + tile_n].float().t()
    return acc.to(g.dtype)


def fullc_gemm_tn_plain(a: torch.Tensor, g: torch.Tensor,
                        tile_m: int = 64) -> torch.Tensor:
    """The plain version of ``a (m, k)^T @ g (m, n)``: the contraction
    over the shared leading (batch) axis m, one 64-row slice of both
    operands at a time into an f32 accumulator."""
    m, k = a.shape
    acc = torch.zeros((k, g.shape[1]), dtype=torch.float32, device=a.device)
    for m0 in range(0, m, tile_m):
        acc = acc + a[m0:m0 + tile_m].float().t() \
            @ g[m0:m0 + tile_m].float()
    return acc.to(a.dtype)


@functools.lru_cache(maxsize=None)
def _split_count(lib, dims, device_index):
    """The split-K ranges C entry ``<lib>_splits`` gives for ``dims`` on
    card ``device_index``: a function of the shape and the card alone,
    asked once (an occupancy query costs more host time than fc8's
    kernel)."""
    with torch.cuda.device(device_index):
        return build.entry(lib + '_splits')(*dims)


# The split-K entries whose ranges sum inside a thread block cluster:
# they take no workspace (a null pointer)
_CLUSTER_SUMMED = frozenset({'fullc_gemm_nt_bf16', 'fullc_gemm_nt_f16'})


def _gemm_launch(kernel, lib, a, b, out_rows, out_cols, contract, dims,
                 split_k: bool = False):
    """Check two 2-d operands of one dtype, launch C entry ``lib`` with
    ``dims`` (its (m, n, k) arguments) into a new ``(out_rows,
    out_cols)`` tensor of that dtype and count the launch on ``kernel``.
    ``split_k`` (the forward GEMM and the input gradient's): the entry
    also takes a ``(splits, out_rows, out_cols)`` f32 workspace (null
    for a library in ``_CLUSTER_SUMMED``) and the split count that
    ``<lib>_splits`` gives for ``dims``."""
    if a.device.type != 'cuda':
        raise RuntimeError(f'{kernel}: no kernel for device {a.device}')
    for name, t in (('a', a), ('b', b)):
        if t.device != a.device or t.dtype != a.dtype \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f'{kernel}: {name} must be a contiguous 2-d {a.dtype} '
                f'tensor on {a.device}, got {tuple(t.shape)} {t.dtype} on '
                f'{t.device}')
    if not contract:
        raise ValueError(f'{kernel}: operands {tuple(a.shape)} and '
                         f'{tuple(b.shape)} do not share the contracted '
                         'axis')
    c = torch.empty((out_rows, out_cols), device=a.device, dtype=a.dtype)
    ptrs = [a.data_ptr(), b.data_ptr(), c.data_ptr()]
    if split_k:
        splits = _split_count(lib, dims, a.device.index)
        ws = (torch.empty((splits, out_rows, out_cols), device=a.device,
                          dtype=torch.float32)
              if splits > 1 and lib not in _CLUSTER_SUMMED else None)
        ptrs.append(0 if ws is None else ws.data_ptr())
        dims = (*dims, splits)
    err = build.entry(lib)(*ptrs, *dims,
                           torch.cuda.current_stream(a.device).cuda_stream)
    build.check_launch(err, kernel)
    launches.add(kernel)
    return c


class _FullcGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(a, b)
        if a.device.type == 'cpu':
            return fullc_gemm_plain(a, b)
        m, k = a.shape
        kernel = 'fullc_gemm' + build.dtype_suffix('fullc_gemm', a.dtype)
        return _gemm_launch(kernel, kernel, a, b, m, b.shape[-1],
                            b.dim() == 2 and b.shape[0] == k,
                            (m, b.shape[-1], k), split_k=True)

    @staticmethod
    def backward(ctx, gc):
        # transpose-free, as _matmul_vjp_bwd (pallas_kernels.py:419-427)
        a, b = ctx.saved_tensors
        gc = gc.contiguous()
        da = fullc_gemm_nt(gc, b) if ctx.needs_input_grad[0] else None
        db = fullc_gemm_tn(a, gc) if ctx.needs_input_grad[1] else None
        return da, db


def fullc_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (m, k) @ b (k, n)`` against the stored ``(nin, nhidden)`` fullc
    weight; the CUDA kernel on the card, :func:`fullc_gemm_plain` on the
    CPU.  Differentiable: the gradients are :func:`fullc_gemm_nt` and
    :func:`fullc_gemm_tn`."""
    return _FullcGemm.apply(a, b)


def fullc_gemm_nt(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``g (m, n) @ b (k, n)^T -> (m, k)`` without transposing ``b``: the
    fullc input gradient against the stored weight, f32, bf16 or f16; the
    CUDA kernel (``csrc/fullc_gemm_nt.cu``, bf16 and f16
    ``csrc/fullc_gemm_nt_bf16.cu``) on the card, :func:`fullc_gemm_nt_plain`
    on the CPU."""
    kernel = 'fullc_gemm_nt' + build.dtype_suffix('fullc_gemm_nt', g.dtype)
    if g.device.type == 'cpu':
        return fullc_gemm_nt_plain(g, b)
    m, n = g.shape
    return _gemm_launch(kernel, kernel, g, b, m, b.shape[0],
                        b.dim() == 2 and b.shape[-1] == n,
                        (m, n, b.shape[0]), split_k=True)


def fullc_gemm_tn(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``a (m, k)^T @ g (m, n) -> (k, n)`` without transposing ``a``: the
    fullc weight gradient in the stored ``(nin, nhidden)`` layout, f32, bf16
    or f16 (``a``'s dtype); the CUDA kernel (``csrc/fullc_gemm_tn.cu``, bf16
    and f16 ``csrc/fullc_gemm_tn_bf16.cu``) on the card,
    :func:`fullc_gemm_tn_plain` on the CPU."""
    kernel = 'fullc_gemm_tn' + build.dtype_suffix('fullc_gemm_tn', a.dtype)
    if a.device.type == 'cpu':
        return fullc_gemm_tn_plain(a, g)
    m, k = a.shape
    return _gemm_launch(kernel, kernel, a, g, k, g.shape[-1],
                        g.dim() == 2 and g.shape[0] == m,
                        (m, g.shape[-1], k))


# --- int8 GEMM ----------------------------------------------------------------

#: the deepest contraction whose int32 sums cannot overflow: k * 127^2 < 2^31
INT8_MAX_K = (2 ** 31 - 1) // (127 * 127)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the product in float64, then int32.  Exact while
    k * 127^2 < 2^53 (every partial sum is an integer float64 holds), on
    the CPU and on the card alike.  (``a @ b`` on int8 tensors would
    return int8 and overflow.)"""
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (m, k) int8 @ b (k, n) int8 -> (m, n) int32``, exact; the CUDA
    kernel (``csrc/int8_gemm.cu``) on the card,
    :func:`int8_matmul_plain` on the CPU."""
    if a.device.type == 'cpu':
        return int8_matmul_plain(a, b)
    if a.device.type != 'cuda':
        raise RuntimeError(f'int8_matmul: no kernel for device {a.device}')
    for name, t in (('a', a), ('b', b)):
        if t.device != a.device or t.dtype != torch.int8 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(
                f'int8_matmul: {name} must be a contiguous 2-d int8 tensor '
                f'on {a.device}, got {tuple(t.shape)} {t.dtype} on '
                f'{t.device}')
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f'int8_matmul: operands {tuple(a.shape)} and '
                         f'{tuple(b.shape)} do not share the contracted axis')
    if k > INT8_MAX_K:
        raise ValueError(f'int8_matmul: k = {k} > {INT8_MAX_K} could '
                         'overflow the int32 accumulator')
    n = b.shape[1]
    c = torch.empty((m, n), device=a.device, dtype=torch.int32)
    err = build.entry('int8_gemm')(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check_launch(err, 'int8_matmul')
    launches.add('int8_matmul')
    return c


def launch_counts() -> dict:
    """Each kernel's launch count, by kernel name (``ops/launches.py``)."""
    return launches.counts()


def reset_launch_counts() -> None:
    launches.reset()
