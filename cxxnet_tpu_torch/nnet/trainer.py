"""The trainer: configuration, model init / load / save, the train step,
evaluation and predict.

PyTorch counterpart of ``cxxnet_tpu/nnet/trainer.py``.  One device, no
mesh: ``dev=`` picks it.  ``dev=cpu`` runs on the CPU (every kernel
wrapper then takes its plain version); any other value — the default,
``gpu``, ``cuda``, ``gpu:N`` (the kind prefix is advisory, as in the JAX
package) — runs on CUDA device N and raises when there is no card,
rather than dropping to the CPU.

Reference semantics kept from the JAX trainer:

* ``update_period`` — gradients accumulate across k minibatches in
  ``grad_acc``; the optimizer applies on the k-th
  (``nnet_impl:149-150,181-184``), and ``epoch_counter`` counts the
  applied updates (it drives the LR schedules and is saved in model
  files), while ``sample_counter`` counts minibatches;
* JAX's random stream: ``key = PRNGKey(seed)``; the initial weights
  come from ``fold_in(key, 0xC0FFEE)`` (``trainer.py:239,244``), then per
  layer; each train step's noise from ``fold_in(key, 1 + sample_counter
  * 131 + round)`` (``trainer.py:846-847``), then per layer, drawn by
  the ``threefry`` kernel on the card (``ops/threefry.py``);
* metrics: ``metric = error`` / ``metric[label,node] = logloss``;
  train metrics from the step's own forward outputs when
  ``eval_train=1`` (read back at once, where the JAX trainer defers the
  readback one step); evaluation leaves out ``num_batch_padd`` pad rows;
* ``nan_action = none|skip|halt`` and the ``nan_breaker`` circuit
  breaker, checked one step late as in the JAX trainer;
* the model file (``SaveModel``, nnet_impl:82-87): NetConfig + int64
  epoch counter + length-prefixed weight blob.

``compute_type=bfloat16`` runs the activations in bf16 (f32 host
batches are cast on the host before the copy, as the JAX trainer casts
with ``ml_dtypes``; uint8 batches ship raw and are cast on the device);
a batch with a ``NormSpec`` (``device_normalize=1``) ships raw and is
normalized on the device in f32, then cast (JAX ``_apply_input_norm``);
the parameters, the optimizer state, the loss and the model files stay
f32, and each layer casts its parameters to the activations' dtype.
``float16`` is not ported yet (``NotPortedError``).

The optimizer and the gradient accumulator update their tensors in
place.  Train steps and forwards run their library calls in full f32
(``ops/precision.py``: no TF32 in cuBLAS or cuDNN).
``compile_multi_step`` (the scanned K-step window) comes with ROADMAP.md
queue A item 4, the exact-resume state (optimizer state in a sidecar)
with item 5; both raise ``NotPortedError``.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..layers import ForwardContext
from ..ops.kernels import REST_OF_ITEM_3, pallas_mode
from ..ops.precision import full_f32
from ..runtime.faults import DivergenceError, NotPortedError
from ..updater import apply_updates, create_updater_hyper, init_opt_state
from ..utils.bucketing import chunk_plan, pad_rows, parse_buckets
from ..utils import prng
from ..utils.metric import MetricSet
from . import checkpoint
from .net import LabelInfo, Net
from .net_config import NetConfig

ConfigEntry = Tuple[str, str]


def resolve_device(dev: str) -> torch.device:
    """``dev=`` value → torch device.  ``cpu`` (or ``cpu:...``) is the
    CPU; anything else is CUDA device N (``gpu:N``/``cuda:N``, default 0)
    and requires a card."""
    text = str(dev).strip().lower()
    if text.startswith('cpu'):
        return torch.device('cpu')
    ordinal = 0
    if ':' in text:
        first = text.split(':', 1)[1].replace('-', ',').split(',')[0]
        ordinal = int(first) if first else 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            f'dev={dev}: no CUDA device is available; pass dev=cpu to run '
            'the port on the CPU')
    if ordinal >= torch.cuda.device_count():
        raise RuntimeError(f'dev={dev}: only {torch.cuda.device_count()} '
                           'CUDA device(s)')
    return torch.device('cuda', ordinal)


class NetTrainer:
    """Config-driven trainer (the INetTrainer surface of
    ``nnet/nnet.h:18-92``)."""

    def __init__(self, cfg: Optional[List[ConfigEntry]] = None):
        self.batch_size = 100
        self.update_period = 1
        self.sample_counter = 0
        self.eval_train = 1
        self.epoch_counter = 0
        self.seed = 0
        self.round = 0
        self.max_round = 1
        self.inference_only = 0    # no optimizer state (serving)
        self.pred_buckets = None   # closed batch-size ladder for predict
        self.nan_action = 'none'
        self.nan_breaker = 0       # consecutive non-finite losses -> raise
        self.nan_streak = 0
        self._pending_loss = None  # (step, device loss), checked one late
        self.kernel_mode = 'auto'  # use_pallas= net param
        self.device: Optional[torch.device] = None   # dev= (default gpu)
        self.dtype = torch.float32
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        self.eval_nodes: List[Tuple[str, int]] = []
        self.cfg: List[ConfigEntry] = []
        self.net_cfg = NetConfig()
        self.net: Optional[Net] = None
        self.params = None
        self.opt_state = None
        self.grad_acc = None
        self.hypers: Dict[str, Dict[str, object]] = {}
        self.last_loss: Optional[torch.Tensor] = None   # newest step's loss
        # relu / max-pooling choices that train steps record or replay
        # (layers/base.py Decisions); None in normal training
        self.decisions = None
        # NormSpec id -> (spec, (mean, scale) device tensors), LRU, <= 8
        self._norm_dev: Dict[int, tuple] = {}
        if cfg:
            for name, val in cfg:
                self.set_param(name, val)

    # --- configuration ----------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == 'dev':
            self.device = resolve_device(val)
        if name == 'batch_size':
            self.batch_size = int(val)
        if name == 'update_period':
            self.update_period = int(val)
        if name == 'eval_train':
            self.eval_train = int(val)
        if name == 'seed':
            self.seed = int(val)
        if name == 'max_round':
            self.max_round = int(val)
        if name == 'inference_only':
            self.inference_only = int(val)
        if name == 'test_on_server' and int(val):
            raise NotPortedError('test_on_server (replica consistency)',
                                 'queue A item 9')
        if name == 'pred_buckets':
            v = val.strip()
            self.pred_buckets = None if v in ('', '0', 'none') \
                else parse_buckets(v)
        if name == 'nan_action':
            if val not in ('none', 'skip', 'halt'):
                raise ValueError(
                    f'nan_action must be none|skip|halt, got {val}')
            self.nan_action = val
        if name == 'nan_breaker':
            self.nan_breaker = int(val)
        if name == 'use_pallas':
            self.kernel_mode = pallas_mode(val)
        if name == 'compute_type':
            # the activations' dtype; params, optimizer state, the loss
            # and model files stay f32 (JAX trainer.py:166-171)
            if val not in ('float32', 'bfloat16', 'float16'):
                raise ValueError(f'unknown compute_type {val}')
            if val == 'float16':
                raise NotPortedError(f'compute_type={val}', REST_OF_ITEM_3)
            self.dtype = getattr(torch, val)
        if name == 'metric' or name.startswith('metric['):
            # forms: metric / metric[field] / metric[field,node]; the node
            # part may itself end in a bracket (metric[extra,top[-1]])
            if name == 'metric':
                field, node = 'label', ''
            else:
                inner = name[len('metric['):]
                if inner.endswith(']'):
                    inner = inner[:-1]
                field, _, node = inner.partition(',')
            self.metric.add_metric(val, field)
            self.train_metric.add_metric(val, field)
            self.eval_nodes.append((node, 0 if node else -1))
        self.cfg.append((name, val))

    # --- construction -----------------------------------------------------
    def init_net(self) -> None:
        """Build the Net and the per-weight updater hyperparameters from
        the accumulated config, and pick the device."""
        if self.device is None:
            self.device = resolve_device('gpu')
        self.net_cfg.configure(self.cfg)
        self.net = Net(self.net_cfg)
        last = self.net.cfg.layers[-1].nindex_out[-1]
        self._eval_node_ids = [last if name == '' else
                               self.net.node_index(name)
                               for name, _ in self.eval_nodes]
        self.hypers = {}
        for i, layer in enumerate(self.net.layers):
            if self.net.layer_primary[i] != i or not layer.param_fields:
                continue
            self.hypers[str(i)] = {
                tag: create_updater_hyper(self.net_cfg.updater_type, tag,
                                          self.net_cfg.defcfg,
                                          self.net_cfg.layercfg[i])
                for tag in layer.param_fields}

    def init_model(self) -> None:
        self._init_seeded_params()
        self._post_params_init()

    def _init_seeded_params(self) -> None:
        self.init_net()
        self.params = self.net.init_params(
            prng.fold_in(prng.prng_key(self.seed), 0xC0FFEE), self.device)

    def _post_params_init(self) -> None:
        if self.inference_only:
            # serving holds params only: no optimizer slots or gradient
            # accumulator are allocated, and update() refuses
            self.opt_state = None
            self.grad_acc = None
            return
        self.opt_state = init_opt_state(self.net_cfg.updater_type,
                                        self.params)
        self.grad_acc = {lk: {fk: torch.zeros_like(w)
                              for fk, w in fields.items()}
                         for lk, fields in self.params.items()}

    def _ctx(self, is_train: bool = False, rng_key=None) -> ForwardContext:
        return ForwardContext(is_train=is_train, rng_key=rng_key,
                              round=self.round, max_round=self.max_round,
                              device=self.device, dtype=self.dtype,
                              kernel_mode=self.kernel_mode)

    # --- training ---------------------------------------------------------
    def start_round(self, round_: int) -> None:
        self.round = round_

    def _norm_args(self, spec):
        """Device constants ``(mean, scale)`` for a batch carrying the
        deferred-normalization ``spec`` (``io/data.NormSpec``), or None.
        Built once per spec (it is chain-constant) and kept in a bounded
        LRU, keyed per spec instance — train and eval chains may
        normalize differently, and a trainer cycling many iterators must
        not pin every spec's constants (JAX ``_norm_args``)."""
        if spec is None:
            return None
        cached = self._norm_dev.pop(id(spec), None)
        if cached is None or cached[0] is not spec:
            cached = (spec, (
                torch.as_tensor(spec.resolved_mean()).to(self.device),
                torch.tensor(spec.scale, dtype=torch.float32,
                             device=self.device)))
            if len(self._norm_dev) >= 8:
                self._norm_dev.pop(next(iter(self._norm_dev)))
        self._norm_dev[id(spec)] = cached
        return cached[1]

    def _label_tensor(self, label) -> torch.Tensor:
        return torch.as_tensor(np.asarray(label, np.float32)).to(self.device)

    def update(self, batch) -> None:
        """One minibatch (a ``DataBatch``) through forward, backward and,
        every ``update_period`` batches, the optimizer — the reference's
        hot loop (``nnet_impl:141-185``)."""
        if self.inference_only:
            raise RuntimeError(
                'trainer was built inference_only=1 (no optimizer state); '
                'it can predict/evaluate but not train')
        do_update = (self.sample_counter + 1) % self.update_period == 0
        keys = [(lk, fk) for lk, fields in self.params.items()
                for fk in fields]
        leaves = [self.params[lk][fk] for lk, fk in keys]
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        bs, padd = batch.batch_size, batch.num_batch_padd
        mask = None
        if padd and batch.pad_synthetic:
            # filler rows of a short tail batch carry no loss; real rows
            # keep the reference's 1/batch_size weight
            mask = torch.ones(bs, dtype=torch.float32, device=self.device)
            mask[bs - padd:] = 0.0
        label = self._label_tensor(batch.label)
        ctx = self._ctx(is_train=True, rng_key=prng.fold_in(
            prng.prng_key(self.seed),
            1 + self.sample_counter * 131 + self.round))
        ctx.decisions = self.decisions
        with torch.enable_grad(), full_f32():
            values, loss = self.net.forward(
                self.params, batch.data, ctx,
                labels=self.net.make_label_info(label), loss_mask=mask,
                norm=self._norm_args(batch.norm_spec))
            if loss.requires_grad:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                grads = [None] * len(leaves)
        with torch.no_grad():
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
            if self.nan_action == 'skip':
                # a non-finite loss, or a finite loss whose backward
                # overflowed, would poison the weights: drop this batch
                ok = torch.isfinite(loss)
                for g in grads:
                    ok = ok & torch.isfinite(g).all()
                grads = [torch.where(ok, g, torch.zeros_like(g))
                         for g in grads]
            for (lk, fk), g in zip(keys, grads):
                self.grad_acc[lk][fk].add_(g)
            if do_update:
                apply_updates(self.net_cfg.updater_type, self.hypers,
                              self.params, self.grad_acc, self.opt_state,
                              self.epoch_counter)
                for fields in self.grad_acc.values():
                    for g in fields.values():
                        g.zero_()
        loss = loss.detach()
        self.last_loss = loss
        self._observe_loss(loss)
        if self.eval_train and len(self.train_metric):
            self._add_train_eval(values, loss, batch, bs - padd)
        if do_update:
            self.epoch_counter += 1
        self.sample_counter += 1

    def _add_train_eval(self, values, loss, batch, n) -> None:
        if self.nan_action == 'skip' and not torch.isfinite(loss).item():
            return   # a poisoned batch's outputs would wreck the metrics
        info = LabelInfo(np.asarray(batch.label), self.net_cfg.label_name_map,
                         self.net_cfg.label_range)
        self.train_metric.add_eval(
            [values[i].detach().float().cpu().numpy()[:n]
             for i in self._eval_node_ids], info.slice(n))

    def _observe_loss(self, loss) -> None:
        """Divergence gate, armed by ``nan_action=halt`` or a nonzero
        ``nan_breaker``: the step's loss is stashed and the previous
        step's checked, so the gate costs no wait on the step just
        launched (``cxxnet_tpu/nnet/trainer.py:872-900``); divergence
        surfaces one update late, and :meth:`flush_divergence_check`
        settles the last step."""
        if self.nan_action != 'halt' and not self.nan_breaker:
            return
        prev, self._pending_loss = (self._pending_loss,
                                    (self.sample_counter, loss))
        if prev is not None:
            self._check_loss(*prev)

    def flush_divergence_check(self) -> None:
        prev, self._pending_loss = self._pending_loss, None
        if prev is not None:
            self._check_loss(*prev)

    def _check_loss(self, step: int, loss) -> None:
        lf = float(loss)
        if np.isfinite(lf):
            self.nan_streak = 0
            return
        self.nan_streak += 1
        if self.nan_action == 'halt' or (
                self.nan_breaker and self.nan_streak >= self.nan_breaker):
            raise DivergenceError(step, lf, self.nan_streak)

    def compile_multi_step(self, n_steps: int, train_eval: bool = False):
        raise NotPortedError('compile_multi_step (steps_per_dispatch)',
                             'queue A item 4')

    def save_training_state(self, *args, **kwargs):
        raise NotPortedError('the exact-resume state (exact_ckpt)',
                             'queue A item 5')

    load_training_state = snapshot_training_state = save_training_state

    # --- evaluation / prediction ------------------------------------------
    def forward_values(self, params, data, norm_spec=None) -> list:
        """Every node's value for one host batch (NCHW numpy or tensor),
        without autograd; ``norm_spec`` normalizes a raw batch on the
        device."""
        with torch.inference_mode(), full_f32():
            return self.net.forward(params, data, self._ctx(),
                                    norm=self._norm_args(norm_spec))[0]

    def evaluate(self, data_iter, name: str) -> str:
        """Metrics over an iterator in the reference's stderr format
        ``\\tname-metric:value``; the train metrics gathered since the
        last call come first (and are cleared) when ``eval_train`` is
        set (``nnet_impl:224-245``).  ``data_iter=None`` returns just the
        train part."""
        ret = ''
        if self.eval_train and len(self.train_metric):
            ret += self.train_metric.print('train')
            self.train_metric.clear()
        if data_iter is None:
            return ret
        self.metric.clear()
        for batch in data_iter:
            values = self.forward_values(self.params, batch.data,
                                         batch.norm_spec)
            n = batch.batch_size - batch.num_batch_padd
            info = LabelInfo(np.asarray(batch.label),
                             self.net_cfg.label_name_map,
                             self.net_cfg.label_range)
            self.metric.add_eval(
                [values[i].float().cpu().numpy()[:n]
                 for i in self._eval_node_ids], info.slice(n))
        return ret + self.metric.print(name)

    def _forward_nodes(self, data, node_ids: List[int],
                       norm_spec=None) -> List[np.ndarray]:
        values = self.forward_values(self.params, data, norm_spec)
        return [values[i].float().cpu().numpy() for i in node_ids]

    def _forward_node_bucketed(self, data, nid: int,
                               norm_spec=None) -> np.ndarray:
        """One node's host output with the batch split/padded onto the
        ``pred_buckets`` ladder (``utils/bucketing.py``); pad rows are
        sliced off before concatenation."""
        data = np.asarray(data)
        outs = []
        for off, take, b in chunk_plan(data.shape[0], self.pred_buckets):
            values = self.forward_values(self.params,
                                         pad_rows(data[off:off + take], b),
                                         norm_spec)
            outs.append(values[nid].float().cpu().numpy()[:take])
        if not outs:
            return np.empty((0,), np.float32)
        return np.concatenate(outs, axis=0)

    def _top_node(self) -> int:
        return self.net.cfg.layers[-1].nindex_out[-1]

    def _forward_node(self, data, nid: int, norm_spec=None) -> np.ndarray:
        """One node's host output for every row of ``data``, through the
        ``pred_buckets`` ladder when one is set."""
        if self.pred_buckets:
            return self._forward_node_bucketed(data, nid, norm_spec)
        return self._forward_nodes(data, [nid], norm_spec)[0]

    def predict_scores(self, data, norm_spec=None) -> np.ndarray:
        """Final-node scores, one row per instance of ``data`` (NCHW);
        ``norm_spec`` (a batch's ``NormSpec``) normalizes raw pixels on
        the device."""
        return self._forward_node(data, self._top_node(), norm_spec)

    def predict(self, data, norm_spec=None) -> np.ndarray:
        """Argmax of the final node per instance (``TransformPred``,
        nnet_impl:286-298)."""
        return self._pred_transform(self.predict_scores(data, norm_spec))

    def forward_stream(self, batches, nid: int):
        """One node's host output per ``DataBatch`` of an iterator, pad
        rows trimmed (``task=pred|pred_raw|extract``).  Batch by batch:
        the readback of batch i waits for its forward before batch i+1
        is launched.  The JAX trainer overlaps the two; here both would
        queue on one CUDA stream, where a copy of batch i issued after
        batch i+1's launch waits for batch i+1 as well."""
        for batch in batches:
            out = self._forward_node(batch.data, nid, batch.norm_spec)
            yield out[:batch.batch_size - batch.num_batch_padd]

    def predict_stream(self, batches):
        """Per-batch predictions over an iterator of ``DataBatch``es, pad
        rows trimmed (``task=pred``); each batch's ``NormSpec`` applies."""
        for out in self.forward_stream(batches, self._top_node()):
            yield self._pred_transform(out)

    def extract_feature(self, batch, node_name: str) -> np.ndarray:
        """A named node's output (``top[-k]`` counts back from the last
        node) for the real rows of one ``DataBatch``."""
        out = self._forward_node(batch.data, self.net.node_index(node_name),
                                 batch.norm_spec)
        return out[:batch.batch_size - batch.num_batch_padd]

    @staticmethod
    def _pred_transform(out: np.ndarray) -> np.ndarray:
        if out.ndim > 1 and out.shape[1] != 1:
            return np.argmax(out, axis=1).astype(np.float32)
        return out.reshape(-1).astype(np.float32)

    # --- model files ------------------------------------------------------
    def model_header(self) -> bytes:
        """NetConfig + epoch counter: the bytes ahead of the weight blob."""
        b = io.BytesIO()
        self.net_cfg.save_net(b)
        b.write(struct.pack('<q', self.epoch_counter))
        return b.getvalue()

    @staticmethod
    def write_model_bytes(fo: BinaryIO, header: bytes, blob: bytes) -> None:
        """The model-file layout: header, u64 blob length, blob."""
        fo.write(header)
        fo.write(struct.pack('<Q', len(blob)))
        fo.write(blob)

    def save_model(self, fo: BinaryIO) -> None:
        self.write_model_bytes(
            fo, self.model_header(),
            checkpoint.params_to_blob(self.net, self.params))

    def load_model(self, fi: BinaryIO) -> None:
        self.net_cfg = NetConfig()
        self.net_cfg.load_net(fi)
        (self.epoch_counter,) = struct.unpack('<q', fi.read(8))
        (blob_len,) = struct.unpack('<Q', fi.read(8))
        blob = fi.read(blob_len)
        # init_net re-runs configure on the loaded structure, which checks
        # the config's netconfig against it
        self.init_net()
        self.params = checkpoint.blob_to_params(self.net, blob, self.device)
        self._post_params_init()

    def copy_model_from(self, fi: BinaryIO) -> None:
        """Finetune (``nnet_impl:101-134``): the configured net starts from
        its seeded init, then every layer whose name matches a named layer
        of the model file takes that layer's weights; the epoch counter
        restarts at 0."""
        self._init_seeded_params()
        old_cfg = NetConfig()
        old_cfg.load_net(fi)
        fi.read(8)   # the old epoch counter, discarded
        (blob_len,) = struct.unpack('<Q', fi.read(8))
        old_raw = checkpoint.blob_to_raw(old_cfg.layers, fi.read(blob_len))
        self.epoch_counter = 0
        for i, old_info in enumerate(old_cfg.layers):
            if not old_info.name or str(i) not in old_raw:
                continue
            for j, new_info in enumerate(self.net_cfg.layers):
                if new_info.name == old_info.name:
                    print(f'Copying layer {old_info.name}')
                    self.params[str(j)] = checkpoint.record_to_memory(
                        self.net.layers[j], new_info.type, old_raw[str(i)],
                        self.device)
        self._post_params_init()
