"""TransformerLM: the training step (the single-device loss, the K-step
loop and the ``(pipe, data, seq, model)`` mesh step at pipe = model = 1)
and the inference half (prefill, KV-cached decode and the
speculative-decoding verify window).

PyTorch counterpart of ``cxxnet_tpu/models/transformer.py``.  The param
tree keeps the JAX package's layout (``embed`` (V, d), ``head`` (d, V),
``stages`` with a leading stage axis: ``ln1_scale``, ``ln1_bias``,
``wq``/``wk``/``wv``/``wo`` (d, d), ``ln2_*``, ``w1`` (d, f), ``w2`` (f,
d)), and :func:`init_params` draws from the caller's
``np.random.RandomState`` in the JAX function's order, so one seed gives
bitwise the same weights in both packages.

Training:

* :func:`reference_loss` is the single-device oracle: embed, every
  stage's :func:`_stage_attn` and dense FFN, the head, f32
  ``log_softmax`` and the mean NLL.  :func:`make_multi_train_step` runs
  K SGD steps of it in one call, updating the params in place (the
  counterpart of JAX's donated ``lax.scan`` carry).
* :func:`make_train_step` runs JAX's ``shard_map`` body on every rank of
  a :func:`build_transformer_mesh` mesh: this rank's ``(data, seq)``
  block of the tokens, the microbatches through :func:`_stage_fn`
  (ring attention over ``seq`` when it is sharded), ``backward`` on
  every rank (the ring's rotations carry the cotangents back), the
  gradients tied by one all-reduce over the ranks each leaf is
  replicated on (:func:`param_specs`) divided by the rank count, and
  SGD.  It runs at ``pipe = model = 1``, one stage per pipe rank as in
  JAX; more pipe or model ranks and MoE raise ``NotPortedError`` (queue
  A item 9).
* Every step runs inside ``ops/precision.full_f32``: f32 products
  without TF32, bf16 products summed in f32.

What differs from the JAX package, and why:

* **Caches are updated in place.**  ``decode_step`` / ``verify_step``
  write the new K/V rows into the caches they are given (JAX returns new
  arrays); the ``*_paged`` variants write into the page pool.  The train
  steps update the params in place and return them.
* **Batch-invariant step shapes.**  The per-token block walk
  (:func:`_walk`) runs every row-wise op (layer norms, projections, the
  FFN, the head) over the step's rows padded to :func:`step_rows` — at
  least ``STEP_ROW_FLOOR`` = 64 — so a decode step of 16 engine slots,
  one of ``generate``'s single stream and a 16x4 verify window all reach
  cuBLAS and the reductions at one shape, and each row's arithmetic is
  the same whoever shares the step.  The pad rows are discarded.
* **Attention on the card** goes through the paged kernels
  (``ops/attention.py``), whose arithmetic depends only on the live rows
  in position order; ``generate`` takes them too (its cache is a private
  pool, one page per row) unless ``flash=0``.  So every stream the
  decode engine serves equals ``generate`` bitwise on the card, as on
  the CPU.  The training step launches no kernel of ``ops/``, as JAX's
  step reaches no Pallas kernel.
* **Sampling** follows JAX's key schedule.  Pick n of a stream seeded
  ``seed`` is ``jax.random.categorical(keys[n], logits / temperature)``
  over ``keys = split(PRNGKey(seed), max_new + 1)``: Gumbel-max, with the
  keys and the float32 uniforms computed bitwise as JAX does by the numpy
  threefry of ``utils/prng.py`` (:func:`sample_keys`,
  :func:`pick_tokens`).  The noise is ``-log(-log(u))`` in float32, whose
  last bit numpy's and XLA's ``log`` may round apart, and the logits
  differ from JAX's in their last bits, so a sampled stream is JAX's up to
  a near-tie of the perturbed top two, as a greedy stream is up to a
  near-tie of the top two.  Inside the port sampled streams are bitwise
  twins.
* **Quantized tiers.**  Every matmul goes through
  ``nnet/quantize.qdot`` and every embedding gather through ``qtake``, at
  the JAX package's call sites: a plain tensor takes ``x @ w`` (the f32
  path is bitwise what it was, and differentiable), an int8 ``QuantLeaf``
  the W8A8 leg over the int8 GEMM kernel.  A ``cfg.dtype =
  torch.bfloat16`` config runs end to end (bf16 caches and pools, f32
  layer norms cast back, f32 logits), as the decode engine's
  ``serve.dtype=bf16|int8`` tiers serve it.
* A stage count other than the pipe dim's size raises ``ValueError``
  naming the rule (JAX fails there with an ``IndexError`` from its
  ``ppermute`` pairs).  MoE configs (``num_experts > 0``) raise
  ``NotPortedError`` (queue A item 9), and :class:`TransformerConfig`
  drops the JAX config's MoE fields (``capacity_factor``,
  ``balance_loss_weight``).  The serving mesh helpers (``shard_scope``,
  ``_rep``) are identities off-mesh and are not carried over.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from ..nnet.quantize import qdot, qtake
from ..ops.attention import (decode_use_flash, dense_attend, live_mask,
                             paged_flash_decode, paged_flash_verify)
from ..ops.precision import full_f32
from ..parallel.pipeline import pipeline_stage_loop, split_microbatches
from ..parallel.sequence import _axis, _local_attention, _ring_local
from ..runtime.faults import NotPortedError
from ..utils import prng

#: rows of the smallest decode-step shape (see the module docstring)
STEP_ROW_FLOOR = 64

AXES = ('pipe', 'data', 'seq', 'model')

@dataclass
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    num_heads: int = 4
    d_ff: int = 128
    num_stages: int = 2          # transformer blocks
    seq_len: int = 64
    num_experts: int = 0         # 0 = dense FFN; > 0 is not ported
    attn: str = 'ring'           # 'ring' | 'local'
    causal: bool = True
    num_microbatches: int = 4
    dtype: torch.dtype = torch.float32
    remat: bool = False          # recompute each block in the backward


def check_config(cfg: TransformerConfig) -> None:
    """Raise for what the port does not run yet."""
    if cfg.num_experts:
        raise NotPortedError(f'num_experts={cfg.num_experts} (MoE)',
                             'queue A item 9')
    if cfg.d_model % cfg.num_heads:
        raise ValueError(f'd_model {cfg.d_model} is not a multiple of '
                         f'num_heads {cfg.num_heads}')


def init_params(rng: np.random.RandomState, cfg: TransformerConfig,
                device='cpu'):
    """Stage params stacked on axis 0, drawn from ``rng`` in the JAX
    package's order (``wq wk wv wo w1 w2``, then ``embed``, then
    ``head``), each float64 draw times its scale cast to ``cfg.dtype``."""
    check_config(cfg)
    s, d, f, v = cfg.num_stages, cfg.d_model, cfg.d_ff, cfg.vocab_size

    def init(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2] if len(shape) > 1
                                         else shape[-1])
        host = np.asarray(rng.randn(*shape) * scale, np.float32)
        return torch.from_numpy(host).to(device=device, dtype=cfg.dtype)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=cfg.dtype, device=device)

    stages = {
        'ln1_scale': const(1.0, s, d), 'ln1_bias': const(0.0, s, d),
        'wq': init(s, d, d), 'wk': init(s, d, d), 'wv': init(s, d, d),
        'wo': init(s, d, d),
        'ln2_scale': const(1.0, s, d), 'ln2_bias': const(0.0, s, d),
    }
    stages['w1'] = init(s, d, f)
    stages['w2'] = init(s, f, d, scale=1.0 / math.sqrt(f))
    return {'embed': init(v, d, scale=0.02), 'head': init(d, v),
            'stages': stages}


def _stage(params, i: int):
    return {k: a[i] for k, a in params['stages'].items()}


def _layer_norm(x, scale, bias):
    """Population variance, ``rsqrt(var + 1e-6)``, in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * scale + bias).to(x.dtype)


def _size_class(n: int, floor: int = 1) -> int:
    """The next power of two at or above ``n`` (at least ``floor``): the
    prompt bucket (floor 8) of ``generate`` and the decode engine."""
    b = max(1, floor)
    while b < n:
        b <<= 1
    return b


def step_rows(m: int) -> int:
    """The padded row count of a ``m``-row decode step or verify window."""
    return _size_class(m, floor=STEP_ROW_FLOOR)


def _causal_mask(s: int, device):
    """The (1, 1, s, s) lower-triangular mask, JAX's ``tril`` of ones."""
    return torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=device))[None, None]


def _stage_attn(p, h, cfg: TransformerConfig, mask, ring=None):
    """One block's attention half: ln1 -> qkv -> attention -> residual
    out-proj -> ln2, THE single copy of the block math (the prefill,
    :func:`reference_loss` and the mesh step's :func:`_stage_fn`).
    ``ring`` ``(group, n, index)`` of the ``seq`` dim takes ring attention
    over the sequence shards in place of local attention under ``mask``.
    Returns ``(h, y2, k, v)`` (k/v for the cache)."""
    mb, s, d = h.shape
    hd = d // cfg.num_heads
    y = _layer_norm(h, p['ln1_scale'], p['ln1_bias'])
    q = qdot(y, p['wq']).reshape(mb, s, cfg.num_heads, hd)
    k = qdot(y, p['wk']).reshape(mb, s, cfg.num_heads, hd)
    v = qdot(y, p['wv']).reshape(mb, s, cfg.num_heads, hd)
    if ring is None:
        attn = _local_attention(q, k, v, 1.0 / math.sqrt(hd), mask)
    else:
        attn = _ring_local(q, k, v, *ring, cfg.causal)
    h = h + qdot(attn.reshape(mb, s, d), p['wo'])
    y2 = _layer_norm(h, p['ln2_scale'], p['ln2_bias'])
    return h, y2, k, v


def _gen_ffn(p, y2):
    """The dense FFN: ``relu(y2 @ w1) @ w2``."""
    return qdot(torch.relu(qdot(y2, p['w1'])), p['w2'])


def prefill_kv(params, prompt, w, cfg: TransformerConfig):
    """The whole (left-padded) prompt through :func:`_stage_attn` in one
    pass.  ``prompt`` (b, s0) int tensor whose first ``w`` slots are
    bucket padding.  Returns ``(ks, vs, logits0)``: ks/vs (stages, b, s0,
    heads, hd) cache rows, logits0 (b, vocab) f32 for the last position."""
    check_config(cfg)
    b, s0 = prompt.shape
    h = qtake(params['embed'], prompt.long())
    # causal over the real tokens only; each pad query attends just its
    # own slot (an all-masked softmax row is NaN, and NaN pad rows would
    # poison the real outputs through the cache)
    ar = torch.arange(s0, device=h.device)
    mask = (((ar[None, :] <= ar[:, None]) & (ar[None, :] >= w))
            | ((ar[None, :] == ar[:, None]) & (ar[:, None] < w)))[None, None]
    ks, vs = [], []
    for i in range(cfg.num_stages):
        p = _stage(params, i)
        h, y2, k, v = _stage_attn(p, h, cfg, mask)
        ks.append(k)
        vs.append(v)
        h = h + _gen_ffn(p, y2)
    logits0 = qdot(h[:, -1], params['head']).float()
    return torch.stack(ks), torch.stack(vs), logits0


def prefill_tail_kv(params, prompt, t0: int, w, cfg: TransformerConfig):
    """Prefix-shared prefill (``serve/decode.py``'s prefix index): the
    cache rows of positions ``[t0, s0)`` of the left-padded ``prompt`` (b,
    s0) and its last position's logits, for a prompt whose first t0 rows
    already sit in shared pages.  Returns ``(ks_tail, vs_tail, logits0)``:
    (stages, b, s0 - t0, heads, hd) rows and (b, vocab) f32 logits.

    The JAX function walks the tail's rows alone over the cached prefix
    K/V; this one walks the whole prompt (:func:`prefill_kv`) and keeps its
    tail.  A GEMM, a layer norm or a softmax need not give a row the same
    bits at another row count (cuBLAS picks its kernel and split by shape;
    one row is a GEMV on the CPU), and the stream twins need the tail's
    rows bitwise the full prefill's.  So a hit saves the prefix's pages,
    not the prefill's arithmetic."""
    ks, vs, logits0 = prefill_kv(params, prompt, w, cfg)
    return ks[:, :, t0:], vs[:, :, t0:], logits0


def _walk(params, cfg: TransformerConfig, toks, attend):
    """THE per-token block walk of ``decode_step`` / ``verify_step`` and
    their paged twins: embed -> [ln1 -> qkv -> attend -> out proj -> ln2
    -> ffn] per stage -> head, over the step's ``b*K`` rows padded to
    :func:`step_rows`.  ``attend(i, q, k, v)`` takes and returns (b, K,
    heads, hd) and does stage ``i``'s cache write and attention.
    Returns logits (b, K, vocab) f32."""
    b, K = toks.shape
    m = b * K
    r = step_rows(m)
    H = cfg.num_heads
    d = cfg.d_model
    hd = d // H
    h = qtake(params['embed'], F.pad(toks.reshape(m).long(), (0, r - m)))
    for i in range(cfg.num_stages):
        p = _stage(params, i)
        y = _layer_norm(h, p['ln1_scale'], p['ln1_bias'])
        q = qdot(y, p['wq'])[:m].reshape(b, K, H, hd)
        k = qdot(y, p['wk'])[:m].reshape(b, K, H, hd)
        v = qdot(y, p['wv'])[:m].reshape(b, K, H, hd)
        attn = attend(i, q, k, v).reshape(m, d)
        h = h + qdot(F.pad(attn, (0, 0, 0, r - m)), p['wo'])
        y2 = _layer_norm(h, p['ln2_scale'], p['ln2_bias'])
        h = h + _gen_ffn(p, y2)
    return qdot(h, params['head'])[:m].float().reshape(b, K, -1)


def _rowvec(x, b: int, device) -> torch.Tensor:
    """A scalar or (b,) position / pad width as a (b,) int64 tensor."""
    t = torch.as_tensor(x, device=device).long()
    return t.expand(b).contiguous() if t.dim() == 0 else t


def decode_step(params, cfg: TransformerConfig, tok, kc, vc, t, w):
    """One KV-cached decode step over a DENSE cache: the body of
    ``generate``'s CPU loop, the gather leg of the decode engine and the
    draft model's proposals.  ``tok`` (b,) int; ``kc``/``vc`` (stages, b,
    total, heads, hd), this step's K/V written in place at ``t``; ``t``,
    ``w`` scalars or (b,) vectors; cache positions outside ``[w, t]`` are
    masked out.  Returns ``(logits, kc, vc, knew, vnew)``: logits (b,
    vocab) f32 and knew/vnew (stages, b, heads, hd), the rows written."""
    total = kc.shape[2]
    b = tok.shape[0]
    hd = cfg.d_model // cfg.num_heads
    scale = 1.0 / math.sqrt(hd)
    t = _rowvec(t, b, kc.device)
    w = _rowvec(w, b, kc.device)
    live = live_mask(total, t, w)
    bi = torch.arange(b, device=kc.device)
    knews, vnews = [], []

    def attend(i, q, k, v):
        kc[i, bi, t] = k[:, 0]
        vc[i, bi, t] = v[:, 0]
        knews.append(k[:, 0])
        vnews.append(v[:, 0])
        return dense_attend(q, kc[i], vc[i], live, scale)

    logits = _walk(params, cfg, tok[:, None], attend)[:, 0]
    return logits, kc, vc, torch.stack(knews), torch.stack(vnews)


def paged_index(table, t, ps, K=None):
    """Physical page and in-page offset of each row's write position
    ``t`` (b,), or of its K-token window ``[t, t + K)``."""
    b = table.shape[0]
    bi = torch.arange(b, device=table.device)
    tq = t if K is None else t[:, None] + torch.arange(K, device=t.device)
    rows = bi if K is None else bi[:, None]
    return table[rows, tq // ps].long(), tq % ps


def decode_step_paged(params, cfg: TransformerConfig, tok, kpool, vpool,
                      table, t, w):
    """One decode step straight over the PAGED pool (``serve.flash_decode``):
    each stage writes the new K/V row into its physical page in place and
    hands attention to :func:`~cxxnet_tpu_torch.ops.attention.paged_flash_decode`,
    which reads the pages through ``table`` (S, pp) int32.  ``t``/``w``
    (b,) int32 per-slot vectors.  Returns ``(logits, kpool, vpool)``.
    Equal to gather + :func:`decode_step` on the CPU, bitwise."""
    b = tok.shape[0]
    ps = kpool.shape[2]
    hd = cfg.d_model // cfg.num_heads
    scale = 1.0 / math.sqrt(hd)
    t32 = _rowvec(t, b, kpool.device).int()
    w32 = _rowvec(w, b, kpool.device).int()
    page, off = paged_index(table, t32.long(), ps)

    def attend(i, q, k, v):
        kpool[i, page, off] = k[:, 0]
        vpool[i, page, off] = v[:, 0]
        return paged_flash_decode(q[:, 0].contiguous(), kpool[i], vpool[i],
                                  table, t32, w32, scale)[:, None]

    logits = _walk(params, cfg, tok[:, None], attend)[:, 0]
    return logits, kpool, vpool


def verify_step(params, cfg: TransformerConfig, toks, kc, vc, t, w):
    """A (b, K)-token WINDOW through the decode block walk in one pass:
    the speculative-decoding verify entry.  Window slot k consumes
    ``toks[:, k]`` at position ``t + k``; all K rows are written (in
    place) before attending, and query k masks the cache to ``[w, t +
    k]``.  ``t``/``w`` (b,) vectors.  Returns ``(logits, kc, vc, knew,
    vnew)``: logits (b, K, vocab) f32, knew/vnew (stages, b, K, heads,
    hd)."""
    total = kc.shape[2]
    b, K = toks.shape
    hd = cfg.d_model // cfg.num_heads
    scale = 1.0 / math.sqrt(hd)
    t = _rowvec(t, b, kc.device)
    w = _rowvec(w, b, kc.device)
    tq = t[:, None] + torch.arange(K, device=kc.device)[None, :]
    live = live_mask(total, t, w, K)
    bi = torch.arange(b, device=kc.device)[:, None]
    knews, vnews = [], []

    def attend(i, q, k, v):
        kc[i, bi, tq] = k
        vc[i, bi, tq] = v
        knews.append(k)
        vnews.append(v)
        return dense_attend(q, kc[i], vc[i], live, scale)

    logits = _walk(params, cfg, toks, attend)
    return logits, kc, vc, torch.stack(knews), torch.stack(vnews)


def verify_step_paged(params, cfg: TransformerConfig, toks, kpool, vpool,
                      table, t, w):
    """:func:`verify_step` straight over the PAGED pool: each stage writes
    its K new rows into their physical pages and hands attention to
    :func:`~cxxnet_tpu_torch.ops.attention.paged_flash_verify`.  Returns
    ``(logits, kpool, vpool)``."""
    b, K = toks.shape
    ps = kpool.shape[2]
    hd = cfg.d_model // cfg.num_heads
    scale = 1.0 / math.sqrt(hd)
    t32 = _rowvec(t, b, kpool.device).int()
    w32 = _rowvec(w, b, kpool.device).int()
    page, off = paged_index(table, t32.long(), ps, K)

    def attend(i, q, k, v):
        kpool[i, page, off] = k
        vpool[i, page, off] = v
        return paged_flash_verify(q.contiguous(), kpool[i], vpool[i],
                                  table, t32, w32, scale)

    logits = _walk(params, cfg, toks, attend)
    return logits, kpool, vpool


# --- sampling -----------------------------------------------------------------

def sample_keys(seed: int, max_new: int) -> np.ndarray:
    """The keys of a sampled stream's picks, as the JAX package derives
    them: ``split(PRNGKey(seed), max_new + 1)``, (max_new + 1, 2) uint32;
    pick n (0 = the prefill's token) draws from row n."""
    return prng.split(prng.prng_key(seed), max_new + 1)


def sample_row(logits, temperature: float, gumbel) -> int:
    """Gumbel-max pick from ``softmax(logits / temperature)``, as
    ``jax.random.categorical``: ``argmax(logits / temperature + gumbel)``
    in float32 on the host."""
    scaled = np.asarray(logits, np.float32) / np.float32(temperature)
    return int(np.argmax(scaled + gumbel))


def pick_tokens(logits: torch.Tensor, temps, keys, rows=None) -> np.ndarray:
    """One token per row of ``logits`` (b, V): greedy argmax (on the
    logits' device) where the row's temperature is 0, else
    :func:`sample_row` with row ``rows[r]`` (default 0) of the Gumbel
    noise of the row's key ``keys[r]`` ((2,) uint32).  ``generate``'s b
    rows share one key and take rows 0..b-1 of one ``(b, V)`` draw; each
    engine slot draws ``(V,)`` from its own key."""
    out = logits.argmax(-1).cpu().numpy().astype(np.int32)
    hot = [r for r, tp in enumerate(temps) if tp > 0]
    if hot:
        host = logits[hot].cpu().numpy()
        for j, r in enumerate(hot):
            g = prng.gumbel_row(keys[r], host.shape[-1],
                                0 if rows is None else rows[r])
            out[r] = sample_row(host[j], temps[r], g)
    return out


# --- offline generation -------------------------------------------------------

def generate(params, prompt, max_new: int, cfg: TransformerConfig,
             temperature: float = 0.0, rng=None, eos_id: int = None,
             flash=None):
    """KV-cached autoregressive decode of a (b, s0) prompt batch: one
    prefill (the prompt left-padded to its size class, floor 8), then
    ``max_new - 1`` decode steps; returns (b, max_new) int32 numpy.
    ``temperature=0`` is greedy; ``> 0`` samples with int seed ``rng``
    (pick n of row r from row r of the ``(b, vocab)`` noise of
    ``sample_keys(rng, max_new)[n]``, as the JAX ``generate`` draws it).  ``eos_id``:
    every position after a row's first EOS is EOS.  ``flash``
    (``serve.flash_decode``'s tri-state) picks the attention: the paged
    kernels over a private pool (the card's default) or the dense
    ``decode_step``."""
    check_config(cfg)
    if not cfg.causal:
        raise ValueError('generate() requires a causal config')
    if temperature > 0 and rng is None:
        raise ValueError('temperature>0 sampling needs an int seed (rng=)')
    if max_new < 1:
        raise ValueError('max_new must be >= 1')
    dev = params['embed'].device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    b, s0 = prompt.shape
    s0b = _size_class(s0, floor=8)
    w = s0b - s0
    prompt = F.pad(prompt, (w, 0))
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    total = s0b + max_new
    temps = [float(temperature)] * b
    keys = sample_keys(rng, max_new) if temperature > 0 else None
    rows = list(range(b))

    def pick(logits, n):
        return pick_tokens(logits, temps,
                           [None if keys is None else keys[n]] * b, rows)

    with torch.inference_mode():
        ks, vs, logits0 = prefill_kv(params, prompt, w, cfg)
        kc = torch.zeros((cfg.num_stages, b, total, H, hd), dtype=ks.dtype,
                         device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :s0b] = ks
        vc[:, :, :s0b] = vs
        paged = decode_use_flash(flash, dev)
        table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
        wv = torch.full((b,), w, dtype=torch.int32, device=dev)
        tok = pick(logits0, 0)
        done = (tok == eos_id) if eos_id is not None else np.zeros(b, bool)
        out = [tok]
        for j in range(max_new - 1):
            tv = torch.full((b,), s0b + j, dtype=torch.int32, device=dev)
            tt = torch.from_numpy(tok).to(dev)
            if paged:
                # the dense cache read as a pool of b pages of `total`
                # rows, page r holding row r: the engine's kernel math
                logits = decode_step_paged(params, cfg, tt, kc, vc, table,
                                           tv, wv)[0]
            else:
                logits = decode_step(params, cfg, tt, kc, vc, tv, wv)[0]
            nxt = pick(logits, j + 1)
            if eos_id is not None:
                nxt = np.where(done, eos_id, nxt).astype(np.int32)
                done = done | (nxt == eos_id)
            tok = nxt
            out.append(tok)
    return np.stack(out, axis=1).astype(np.int32)



# --- training -----------------------------------------------------------------

def _nll(h, head, labels):
    """The head in the params' dtype, then f32 ``log_softmax`` and the mean
    negative log-likelihood of ``labels``."""
    logp = torch.log_softmax((h @ head).float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def reference_loss(params, tokens, labels, cfg: TransformerConfig):
    """Single-device oracle: same math, no mesh, sequential stages.
    ``tokens`` / ``labels`` (b, s) int64 tensors on the params' device."""
    check_config(cfg)
    h = params['embed'][tokens]
    mask = _causal_mask(h.shape[1], h.device) if cfg.causal else None
    for i in range(cfg.num_stages):
        p = _stage(params, i)
        h, y, _, _ = _stage_attn(p, h, cfg, mask)
        h = h + _gen_ffn(p, y)
    return _nll(h, params['head'], labels)


def _leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _value_and_grad(leaves, fn):
    """``fn()`` -> ``(loss, aux)`` and d loss / d each of ``leaves``, with
    the leaves' ``requires_grad`` restored after."""
    was = [w.requires_grad for w in leaves]
    for w in leaves:
        w.requires_grad_(True)
    try:
        loss, aux = fn()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for w, r in zip(leaves, was):
            w.requires_grad_(r)
    return loss.detach(), aux, grads


def _sgd(leaves, grads, lr: float) -> None:
    """JAX's ``(w - lr * g).astype(w.dtype)``, in place: ``lr * g`` rounds
    to the leaf's dtype, then the difference does."""
    with torch.no_grad():
        for w, g in zip(leaves, grads):
            w.sub_(lr * g)


def _token_tensor(x, device):
    """Host or device int tokens as an int64 tensor on ``device``."""
    return torch.as_tensor(x, device=device).long()


def make_multi_train_step(cfg: TransformerConfig, n_steps: int,
                          lr: float = 0.1):
    """Single-device ``n_steps``-step training loop in ONE call:
    ``(params, tok_stack, lab_stack) -> (params, last_loss)``, the stacks
    (nstack, B, seq_len) int cycled round-robin (step t takes ``t %
    nstack``).  Each step is :func:`reference_loss`, its gradient and SGD,
    the params updated in place and returned; the loss is a 0-d f32
    tensor on the params' device."""
    check_config(cfg)

    def multi(params, tok_stack, lab_stack):
        dev = params['embed'].device
        toks = _token_tensor(tok_stack, dev)
        labs = _token_tensor(lab_stack, dev)
        nstack = toks.shape[0]
        leaves = _leaves(params)
        loss = None
        with full_f32():
            for t in range(n_steps):
                i = t % nstack
                loss, _, grads = _value_and_grad(leaves, lambda: (
                    reference_loss(params, toks[i], labs[i], cfg), None))
                _sgd(leaves, grads, lr)
        return params, loss

    multi.n_steps = n_steps
    return multi


# --- the (pipe, data, seq, model) mesh step -------------------------------------

def param_specs(cfg: TransformerConfig):
    """The mesh dims each leaf is sharded over, one entry per array dim
    (None = not sharded): JAX's ``PartitionSpec`` tuples for the dense
    tree."""
    check_config(cfg)
    col = ('pipe', None, 'model')        # qkv: heads sharded over model
    stages = {
        'ln1_scale': ('pipe', None), 'ln1_bias': ('pipe', None),
        'wq': col, 'wk': col, 'wv': col,
        'wo': ('pipe', 'model', None),   # row-parallel out-proj
        'ln2_scale': ('pipe', None), 'ln2_bias': ('pipe', None),
        'w1': ('pipe', None, 'model'),   # col-parallel
        'w2': ('pipe', 'model', None),   # row-parallel
    }
    return {'embed': (None, None), 'head': (None, None), 'stages': stages}


def _map_with_specs(fn, tree, specs):
    """Apply ``fn(leaf, spec)`` over parallel nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _replicated_axes(spec):
    return tuple(a for a in AXES if a not in spec)


def build_transformer_mesh(n_devices: int, pp: int, dp: int, sp: int,
                           tp: int, devices=None) -> DeviceMesh:
    """A ``(pipe, data, seq, model)`` ``DeviceMesh`` of shape ``(pp, dp, sp,
    tp)`` over the ranks of the joined world (``devices`` None: the first
    ``n_devices``; else the given ranks), ``cuda`` under NCCL, ``cpu``
    under gloo.  Every rank of the world calls it."""
    if pp * dp * sp * tp != n_devices:
        raise ValueError(f'pp*dp*sp*tp = {pp * dp * sp * tp} '
                         f'!= {n_devices} devices')
    if not dist.is_initialized():
        raise RuntimeError('build_transformer_mesh needs a joined world '
                           '(parallel.distributed.init_distributed)')
    ranks = list(range(n_devices)) if devices is None else \
        [int(r) for r in devices]
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(
        pp, dp, sp, tp), mesh_dim_names=AXES)


def _stage_fn(p, x, *, cfg: TransformerConfig, ring=None):
    """One transformer block on the local activation shard x (mb, s_local,
    D), ``p`` this stage's params: attention (ring attention over the
    ``seq`` group ``ring`` when the sequence is sharded, else local
    attention, causal by ``tril``) and the dense FFN.  Returns ``(y,
    aux)``, aux the dense FFN's zero MoE statistics."""
    mask = (_causal_mask(x.shape[1], x.device)
            if cfg.causal and ring is None else None)
    h, y2, _, _ = _stage_attn(p, x, cfg, mask, ring)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + _gen_ffn(p, y2), {'balance_loss': zero, 'drop_frac': zero}


def _loss_local(params, tokens, labels, *, cfg: TransformerConfig,
                ring=None):
    """Local shard loss: embed -> microbatches through the stage loop ->
    head -> mean NLL.  Returns ``(loss, aux)``.  With ``cfg.remat`` each
    stage is recomputed in the backward; a ring's rotations replay there
    in the same order on every rank."""
    h = params['embed'][tokens]                          # (b, s, D)
    xs = split_microbatches(h, cfg.num_microbatches)
    stage = functools.partial(_stage_fn, cfg=cfg, ring=ring)
    if cfg.remat:
        stage = functools.partial(checkpoint, stage, use_reentrant=False)
    hs, aux = pipeline_stage_loop(stage, params['stages'], xs,
                                  num_stages=cfg.num_stages, has_aux=True)
    return _nll(hs.reshape(h.shape), params['head'], labels), aux


def _make_step_body(cfg: TransformerConfig, mesh: DeviceMesh, lr: float):
    """The per-rank train-step body of :func:`make_train_step`:
    ``(params, tokens, labels) -> (params, loss, aux)`` on this rank's
    token block, the params replicated and updated in place."""
    shape = dict(zip(AXES, mesh.shape))
    tp, sp = shape['model'], shape['seq']
    if cfg.num_heads % tp:
        raise ValueError('num_heads must divide model axis')
    if sp > 1 and cfg.attn != 'ring':
        raise ValueError(
            f"attn='{cfg.attn}' on a seq-sharded mesh (seq={sp}) would "
            "attend block-diagonally; use attn='ring'")
    specs = param_specs(cfg)
    if shape['pipe'] > 1:
        raise NotPortedError(f"pipe={shape['pipe']} (pipeline parallelism)",
                             'queue A item 9')
    if tp > 1:
        raise NotPortedError(f'model={tp} (tensor parallelism)',
                             'queue A item 9')
    if cfg.num_stages != shape['pipe']:
        raise ValueError(
            f"num_stages={cfg.num_stages} on a pipe axis of "
            f"{shape['pipe']}: the mesh step runs one stage per pipe rank")
    n_ranks = math.prod(shape.values())
    # Tie the replicas: sum each leaf's gradient over the dims it is
    # replicated on, then divide by the rank count (the gradient of the
    # mean loss).  At pipe = model = 1 every leaf is replicated over
    # every dim of size > 1, so ONE group over the mesh's ranks ties all.
    live = tuple(a for a in AXES if shape[a] > 1)
    ties = _leaves(_map_with_specs(
        lambda _, spec: tuple(a for a in _replicated_axes(spec)
                              if shape[a] > 1), specs, specs))
    assert all(t == live for t in ties), (ties, live)
    group = dist.new_group(mesh.mesh.flatten().tolist()) if live else None
    ring = _axis(mesh, 'seq') if sp > 1 and cfg.attn == 'ring' else None

    def body(params, tokens, labels):
        leaves = _leaves(params)
        loss, aux, grads = _value_and_grad(leaves, lambda: _loss_local(
            params, tokens, labels, cfg=cfg, ring=ring))
        if group is not None:
            grads = _all_reduce_sum(grads, group)
            dist.all_reduce(loss, group=group)
        _sgd(leaves, [g / n_ranks for g in grads], lr)
        return params, loss / n_ranks, aux

    return body


def _all_reduce_sum(tensors, group):
    """Sum the tensors (of one dtype, the config's) over ``group``: one
    all-reduce of them flattened into one buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(cfg: TransformerConfig, mesh: DeviceMesh,
                    lr: float = 0.1):
    """The mesh train step, called by every rank of ``mesh``:
    ``(params, tokens, labels) -> (params, loss, aux)``.  ``params`` is
    this rank's replica (updated in place and returned); ``tokens`` /
    ``labels`` are the global (B, seq_len) int arrays, of which rank
    ``(d, s)`` takes rows ``d*B/dp ...`` and columns ``s*S/sp ...`` (JAX's
    ``P('data', 'seq')``); ``loss`` is the mean over all ranks, and ``aux``
    reports the MoE ``balance_loss`` and ``drop_frac`` (zeros: dense
    FFN)."""
    body = _make_step_body(cfg, mesh, lr)
    dp = mesh.size(AXES.index('data'))
    sp = mesh.size(AXES.index('seq'))
    di, si = mesh.get_local_rank('data'), mesh.get_local_rank('seq')

    def step(params, tokens, labels):
        dev = params['embed'].device
        tokens, labels = (_token_tensor(x, dev) for x in (tokens, labels))
        b, s = tokens.shape
        if b % dp or s % sp:
            raise ValueError(f'tokens {tuple(tokens.shape)} do not split '
                             f'over data={dp} x seq={sp}')
        bl, sl = b // dp, s // sp
        if bl % cfg.num_microbatches:
            raise ValueError(f'local batch {bl} not divisible by '
                             f'microbatches {cfg.num_microbatches}')
        rows, cols = slice(di * bl, (di + 1) * bl), slice(si * sl,
                                                          (si + 1) * sl)
        with full_f32():
            return body(params, tokens[rows, cols], labels[rows, cols])

    return step
