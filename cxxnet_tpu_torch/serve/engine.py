"""Inference engine: bucketed predict over an inference-only model.

PyTorch counterpart of ``cxxnet_tpu/serve/engine.py:PredictEngine``:

* **inference-only state** — the engine holds the param tree only; a
  trainer built with ``inference_only=1`` (as ``task=serve`` builds it)
  allocates no optimizer state or gradient accumulator;
* **a closed set of batch shapes** — every request is padded up to one of
  a small ladder of batch-size buckets (``utils/bucketing.py``), so the
  forward only ever runs at bucket shapes.  PyTorch compiles nothing, so
  ``compile_count`` counts the distinct bucket shapes the forward has
  run: it stays at most ``len(buckets)``, and the tests assert it;
* **atomic parameter swap** — :meth:`swap_params` replaces the serving
  weights between batches after validating the tree's structure, shapes
  and dtypes; a batch in flight keeps the snapshot it started with;
* **quantized storage tiers** (``serve.dtype=bf16|int8``) — weight-only,
  as in the JAX engine: the engine stores ``quantize_tree(params,
  dtype)`` (bf16 leaves, or int8 ``QuantLeaf`` for every leaf of two or
  more dims) and expands it to f32 per forward, then runs the f32
  forward; the resident bytes are the quantized tree's.  No int8 GEMM
  runs here.  The swap contract stays the f32 tree (structure and
  shapes; dtypes only on the f32 tier);
* **conv+BN folding** (``fold_bn=1``, ``nnet/fold.py``) — at the f32
  tier only, as in the JAX engine: each foldable BN runs as a
  pass-through and its conv absorbs the BN's affine, frozen at a
  calibration batch's statistics; the fold proves itself on that batch
  or raises ``FoldError``.  A hot swap re-folds the incoming tree; the
  engine's own placed tree is never folded twice.  At bf16 or int8 the
  tier serves unfolded (JAX ``engine.py:102``).

``ReplicatedPredictEngine`` comes with ROADMAP.md queue A item 8.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nnet import quantize
from ..nnet.trainer import NetTrainer
from ..utils.bucketing import DEFAULT_BUCKETS, chunk_plan, pad_rows

__all__ = ['PredictEngine']


def _as_4d(arr: np.ndarray) -> np.ndarray:
    """Request payloads arrive as (n, c, y, x) nodes or flat (n, d)
    matrices."""
    arr = np.asarray(arr)
    if arr.ndim == 4:
        return arr
    if arr.ndim == 2:
        return arr.reshape(arr.shape[0], 1, 1, arr.shape[1])
    raise ValueError(f'cannot view shape {arr.shape} as a request batch')


def _leaves(tree):
    """(key, field, tensor) of a ``{layer: {field: tensor}}`` tree, in a
    fixed order."""
    return [(k, f, tree[k][f]) for k in sorted(tree) for f in sorted(tree[k])]


class PredictEngine:
    """Bucketed, hot-swappable predict over a loaded model.

    ``trainer`` must be initialized (``init_model`` or ``load_model``).
    Requests are host float32 (or uint8) arrays shaped ``(n, c, y, x)``
    or ``(n, d)``, pre-normalized.
    """

    def __init__(self, trainer: NetTrainer,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: str = 'f32', fold_bn: int = 0, fold_batch=None):
        if trainer.net is None or trainer.params is None:
            raise ValueError('PredictEngine needs an initialized trainer '
                             '(init_model()/load_model() first)')
        self.serve_dtype = quantize.parse_serve_dtype(dtype)
        self.trainer = trainer
        # conv+BN folding: f32 tier only — the pinned proof is an f32
        # statement, and a quantized tree re-entering place_params could
        # not be told apart from a fresh one (JAX engine.py:94-106)
        self._fold_batch_arg = fold_batch
        self._fold_report = None
        self._last_placed = None   # the newest fold+place, by identity
        self._fold_bn_layers = frozenset()
        if int(fold_bn) and self.serve_dtype == 'f32':
            from ..nnet.fold import plan_conv_bn_pairs
            self._fold_bn_layers = frozenset(
                b for (_, b) in plan_conv_bn_pairs(trainer.net))
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f'bad bucket ladder {buckets!r}')
        self.swap_count = 0
        self.version: object = 0
        self._lock = threading.Lock()
        self._shapes_seen: set = set()   # guarded-by: _lock
        self._ref = [(k, f, tuple(v.shape), v.dtype)
                     for k, f, v in _leaves(trainer.params)]
        if self.serve_dtype != 'f32':
            placed = self.place_params(trainer.params)
        elif self._fold_bn_layers:
            placed = self._fold(trainer.params)
        else:
            placed = trainer.params
        self._params = placed            # guarded-by: _lock
        self._top = trainer.net.cfg.layers[-1].nindex_out[-1]

    # -- forward -----------------------------------------------------------
    def _fwd(self, params, data: np.ndarray) -> np.ndarray:
        with self._lock:
            self._shapes_seen.add(tuple(data.shape))
        if self.serve_dtype != 'f32':
            # weight-only: the stored tier expanded to f32 for this forward
            params = quantize.dequantize_tree(params, torch.float32)
        values = self.trainer.forward_values(
            params, data, identity_layers=self._fold_bn_layers)
        return values[self._top].float().cpu().numpy()

    # -- conv+BN folding ---------------------------------------------------
    def _calib_batch(self) -> np.ndarray:
        """The batch whose statistics the fold freezes: the caller's
        ``fold_batch`` (representative data: every later request is
        normalized with its statistics), else a seeded random batch at
        the largest bucket, which keeps the fold deterministic and its
        proof meaningful but encodes no data statistics."""
        if self._fold_batch_arg is not None:
            return _as_4d(np.asarray(self._fold_batch_arg, np.float32))
        c, y, x = self.trainer.net_cfg.input_shape
        rng = np.random.RandomState(0)
        return rng.randn(self.buckets[-1], c, y, x).astype(np.float32)

    def _fold(self, tree):
        """``tree`` (f32, on the serving device) with every planned
        conv+BN pair folded around the calibration statistics; the pass
        proves itself within the pinned tolerances or raises
        ``FoldError``."""
        from ..nnet.fold import fold_params
        folded, report = fold_params(self.trainer.net, tree,
                                     self._calib_batch(), self.trainer._ctx())
        self._fold_report = report
        return folded

    def fold_view(self) -> Optional[dict]:
        """The newest fold's report (pairs, proof error, tolerances), or
        None when folding is off."""
        if self._fold_report is None:
            return None
        r = dict(self._fold_report)
        r['bn_layers'] = sorted(r['bn_layers'])
        return r

    @property
    def compile_count(self) -> int:
        """Distinct request shapes the forward has run — bounded by
        ``len(buckets)`` (the JAX engine's compile-cache bound)."""
        with self._lock:
            return len(self._shapes_seen)

    # -- parameters --------------------------------------------------------
    @property
    def params(self):
        with self._lock:
            return self._params

    def place_params(self, host_params):
        """Validate a ``{layer: {field: array or tensor}}`` f32 tree
        against the serving model (dtypes only on the f32 tier), quantize
        it into the serving tier (or fold it, under ``fold_bn``) and move
        it to the serving device.  This method's own folded output comes
        back unchanged: folding it again would corrupt the weights."""
        if self._fold_bn_layers and host_params is self._last_placed:
            return host_params
        got = _leaves(host_params)
        if [(k, f) for k, f, _ in got] != [(k, f) for k, f, _, _ in self._ref]:
            raise ValueError('swap_params: param tree structure differs '
                             'from the serving model')
        dev = self.trainer.device
        strict = self.serve_dtype == 'f32'
        placed = {}
        for (k, f, v), (_, _, shape, dt) in zip(got, self._ref):
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))
            if tuple(t.shape) != shape or (strict and t.dtype != dt):
                raise ValueError(
                    f'swap_params: leaf {k}/{f} {tuple(t.shape)}/{t.dtype} '
                    f'!= serving {shape}/{dt} — a shape change needs a new '
                    'engine, not a hot swap')
            placed.setdefault(k, {})[f] = t
        placed = quantize.quantize_tree(placed, self.serve_dtype)
        placed = {k: {f: v.to(dev) for f, v in fs.items()}
                  for k, fs in placed.items()}
        if self._fold_bn_layers:
            placed = self._last_placed = self._fold(placed)
        return placed

    def resident_bytes(self) -> int:
        """Bytes of the stored param tree (an int8 leaf counts its payload
        and its scales)."""
        return quantize.tree_nbytes(self.params)

    def swap_params(self, params, version: object = None) -> None:
        """Atomically make ``params`` the serving weights; in-flight
        batches keep the snapshot they captured."""
        placed = self.place_params(params)
        with self._lock:
            self._params = placed
            self.swap_count += 1
            if version is not None:
                self.version = version

    # -- prediction --------------------------------------------------------
    def warm(self) -> int:
        """Run every bucket once up front; returns ``compile_count``."""
        c, y, x = self.trainer.net_cfg.input_shape
        params = self.params
        for b in self.buckets:
            self._fwd(params, np.zeros((b, c, y, x), np.float32))
        return self.compile_count

    def predict_scores(self, data: np.ndarray) -> np.ndarray:
        """Final-node scores for ``n`` request rows: ``(n, k)`` float32.
        The input is padded to the smallest fitting bucket (oversize
        requests split into max-bucket chunks); pad rows never leave the
        engine.  The param snapshot is taken once per request."""
        data = _as_4d(data)
        n = data.shape[0]
        params = self.params
        outs: List[np.ndarray] = []
        for off, take, bucket in chunk_plan(n, self.buckets):
            chunk = pad_rows(data[off:off + take], bucket)
            if chunk.dtype != np.float32 and chunk.dtype != np.uint8:
                chunk = chunk.astype(np.float32)
            outs.append(self._fwd(params, chunk)[:take])
        if not outs:
            return np.empty((0, 1), np.float32)
        return np.concatenate(outs, axis=0).reshape(n, -1)

    def predict(self, data: np.ndarray) -> np.ndarray:
        """Class id (argmax; raw value for single-score nets) per row."""
        return NetTrainer._pred_transform(self.predict_scores(data))
