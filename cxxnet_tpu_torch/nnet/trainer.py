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
  ``eval_train=1``, read back one step (one window) late, as the JAX
  trainer's ``_pending_train_eval``; evaluation leaves out
  ``num_batch_padd`` pad rows;
* ``nan_action = none|skip|halt`` and the ``nan_breaker`` circuit
  breaker, checked one step late as in the JAX trainer;
* the model file (``SaveModel``, nnet_impl:82-87): NetConfig + int64
  epoch counter + length-prefixed weight blob.

``compute_type=bfloat16`` or ``=float16`` runs the activations in that
16-bit dtype (f32 host batches are cast on the host before the copy, to
nearest even: the JAX trainer casts a bf16 batch with ``ml_dtypes`` and
an f16 batch on the device, the same rounding; uint8 batches ship raw
and are cast on the device); a batch with a ``NormSpec``
(``device_normalize=1``) ships raw and is normalized on the device in
f32, then cast (JAX ``_apply_input_norm``); the parameters, the optimizer
state, the loss and the model files stay f32, and each layer casts its
parameters to the activations' dtype.  As in JAX there is no loss
scaling: an f16 activation past 65504 is inf, and a gradient below
f16's subnormals is 0, and ``nan_action`` sees what JAX's would.

The optimizer and the gradient accumulator update their tensors in
place.  Train steps and forwards run their library calls in full f32
(``ops/precision.py``: no TF32 in cuBLAS or cuDNN).

A step is split as in the JAX trainer: :meth:`NetTrainer.stage_batch`
enqueues the batch's copies to the card (each batch's host tensors go
through a small ring of reused pinned buffers and cross on a copy stream,
``non_blocking``; the step's stream waits on the copy's event), and
:meth:`NetTrainer.update_staged` runs the step; ``update`` is the two in
turn.  ``compile_multi_step`` is the K-step window of
``steps_per_dispatch`` (``nnet/execution.py``): K of the same eager steps
behind one call, bitwise K single steps.

Each step, window and forward runs through a program of the process-wide
ledger (``obs/programs.py``: ``train.step``, ``train.multi_step``,
``train.forward``, keyed by batch shape, as JAX's trainer claims them);
its first call at a shape records the products it runs
(``cnn_step_flops``), which :meth:`NetTrainer.train_step_flops` reads
back for the MFU gauge without an extra pass.

The exact-resume state (``save_training_state`` /
``snapshot_training_state`` / ``load_training_state``) is the tree
``{'params', 'opt_state', 'grad_acc', 'counters': {epoch, sample,
round}}`` in the native step-checkpoint format (``nnet/sharded_ckpt.py``),
keyed as the JAX trainer's tree, so either package restores the other's.
The parameters update in place, so a snapshot for a background writer
clones every leaf on the device, ordered on the compute stream, and
records the event the writer's host copy waits on
(``runtime/async_ckpt.py``).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..layers import ForwardContext
from ..ops.kernels import pallas_mode
from ..ops.precision import full_f32
from ..runtime import faults
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


class StagedBatch(tuple):
    """A batch staged by :meth:`NetTrainer.stage_batch`: JAX's ``(data,
    label, extra, mask, host_label, bs, num_batch_padd, norm)``, and
    ``ready``, the event of its copies on a card (None on the CPU)."""
    ready = None


class _PinnedStaging:
    """The host-to-card copies of a trainer's batches.  Each batch's host
    tensors are written (cast on the way, ``Tensor.copy_``) into one slot
    of a ring of ``SLOTS`` reused pinned buffers, then copied to the card
    ``non_blocking`` on a copy stream, so staging returns before the
    bytes cross.  Pinning a fresh buffer a batch costs more than the copy,
    and a ``non_blocking`` copy from pageable memory synchronizes, hence
    the ring.  A slot is refilled only after its last copies completed
    (their event), and ``record_stream`` tells the caching allocator that
    the device tensors, allocated on the copy stream, are read on the
    compute stream."""

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: List[Optional[tuple]] = [None] * self.SLOTS
        self._next = 0

    def copy(self, host: Dict[str, tuple]):
        """``{role: (cpu tensor, dtype)}`` -> ``({role: device tensor},
        event)``; the step's stream must wait on the event."""
        i, self._next = self._next, (self._next + 1) % self.SLOTS
        bufs, done = self._slots[i] or ({}, None)
        if done is not None:
            done.synchronize()        # the slot's last copies have landed
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self.stream):
            for role, (t, dtype) in host.items():
                nbytes = t.numel() * torch.empty((), dtype=dtype).element_size()
                buf = bufs.get(role)
                if buf is None or buf.numel() < nbytes:
                    buf = bufs[role] = torch.empty(nbytes, dtype=torch.uint8,
                                                   pin_memory=True)
                pinned = buf[:nbytes].view(dtype).view(t.shape)
                pinned.copy_(t)
                dev = torch.empty(t.shape, dtype=dtype, device=self.device)
                dev.copy_(pinned, non_blocking=True)
                dev.record_stream(compute)
                out[role] = dev
            done = torch.cuda.Event()
            done.record(self.stream)
        self._slots[i] = (bufs, done)
        return out, done


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
        self._pending_train_eval = None   # a step's or window's eval outputs
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
        self._staging: Optional['_PinnedStaging'] = None   # card copies
        self._ones_mask_cache: Dict[tuple, torch.Tensor] = {}
        self._ledger_programs: Optional[dict] = None   # claimed on first use
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

    def _ctx(self, is_train: bool = False, rng_key=None,
             rnd: Optional[int] = None, device=None) -> ForwardContext:
        """The forward's context; ``device`` (default: the trainer's)
        pins a serving replica's forward to its own device."""
        return ForwardContext(is_train=is_train, rng_key=rng_key,
                              round=self.round if rnd is None else rnd,
                              max_round=self.max_round,
                              device=self.device if device is None
                              else device, dtype=self.dtype,
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

    # --- staging: the batch's copies to the device ----------------------
    def _require_trainable(self) -> None:
        if self.inference_only:
            raise RuntimeError(
                'trainer was built inference_only=1 (no optimizer state); '
                'it can predict/evaluate but not train')

    def stage_batch(self, batch) -> 'StagedBatch':
        """Begin a batch's copy to the device and return the handle
        :meth:`update_staged` takes, JAX's ``(data, label, extra, mask,
        host_label, bs, num_batch_padd, norm)``.  On a card the copies
        are only enqueued (``_PinnedStaging``), so staging batch i+1
        before batch i's step overlaps the copy with compute; on the CPU
        staging is ``torch.as_tensor``.  The data is cast as
        ``Net._input_to_device_layout`` casts it: a float batch to the
        compute dtype on the host, a uint8 or ``NormSpec`` batch raw.
        ``batch.extra_data`` (an ``attachtxt`` chain's) goes with the
        batch on the same copies, cast as JAX's ``_shard_batch`` casts
        it: f64 to f32, f32 to a bf16 compute dtype (an f16 compute dtype
        leaves it f32, as JAX does)."""
        norm = self._norm_args(batch.norm_spec)
        data = batch.data if isinstance(batch.data, torch.Tensor) \
            else torch.from_numpy(np.asarray(batch.data))
        dtype = data.dtype
        if norm is None and data.is_floating_point():
            dtype = self.dtype
            if data.dtype == torch.float64:
                data = data.float()
        host = {'data': (data, dtype),
                'label': (torch.from_numpy(np.asarray(batch.label,
                                                      np.float32)),
                          torch.float32)}
        bs, padd = batch.batch_size, batch.num_batch_padd
        if padd and batch.pad_synthetic:
            # filler rows of a short tail batch carry no loss; real rows
            # keep the reference's 1/batch_size weight
            mask = np.ones(bs, np.float32)
            mask[bs - padd:] = 0.0
            host['mask'] = (torch.from_numpy(mask), torch.float32)
        for k, ex in enumerate(batch.extra_data):
            ex = ex if isinstance(ex, torch.Tensor) \
                else torch.from_numpy(np.asarray(ex))
            if ex.dtype == torch.float64:
                ex = ex.float()
            host[f'extra{k}'] = (ex, self.dtype if ex.dtype == torch.float32
                                 and self.dtype == torch.bfloat16
                                 else ex.dtype)
        ready = None
        if self.device.type == 'cuda':
            if self._staging is None:
                self._staging = _PinnedStaging(self.device)
            dev, ready = self._staging.copy(host)
        else:
            dev = {role: t.to(dt) for role, (t, dt) in host.items()}
        host_label = (np.asarray(batch.label)
                      if self.eval_train and len(self.train_metric) else None)
        extra = tuple(dev[f'extra{k}'] for k in range(len(batch.extra_data)))
        staged = StagedBatch((dev['data'], dev['label'], extra,
                              dev.get('mask'),
                              host_label, bs, padd, norm))
        staged.ready = ready
        return staged

    def _await(self, staged) -> None:
        """The step's stream waits for ``staged``'s copies (a card)."""
        if getattr(staged, 'ready', None) is not None:
            torch.cuda.current_stream(self.device).wait_event(staged.ready)

    # --- the step ----------------------------------------------------------
    def update(self, batch) -> None:
        """One minibatch (a ``DataBatch``) through forward, backward and,
        every ``update_period`` batches, the optimizer — the reference's
        hot loop (``nnet_impl:141-185``)."""
        self.update_staged(self.stage_batch(batch))

    def update_staged(self, staged) -> None:
        """The training step of a batch staged by :meth:`stage_batch`."""
        self._require_trainable()
        (data, label, extra, mask, host_label, bs, padd, norm) = staged
        self._await(staged)
        do_update = (self.sample_counter + 1) % self.update_period == 0
        old_pending, self._pending_train_eval = self._pending_train_eval, None
        bs = int(data.shape[0])
        loss, values = self._program('train.step').run(
            f'b{bs}', self._step, data, label, mask, norm,
            self.sample_counter, self.epoch_counter, self.round, do_update,
            extra, info=lambda: self._ledger_info(data, True))
        self.last_loss = loss
        self._observe_loss(loss)
        if host_label is not None:
            # read back one step late: by the next step (or evaluate) the
            # outputs are ready (JAX update_staged)
            self._pending_train_eval = (
                loss, [values[i].detach() for i in self._eval_node_ids],
                self._host_label_info(host_label), bs - padd)
        if old_pending is not None:
            self._drain_train_eval(old_pending)
        if do_update:
            self.epoch_counter += 1
        self.sample_counter += 1

    def _step(self, data, label, mask, norm, sc: int, epoch: int, rnd: int,
              do_update: bool, extra=()):
        """Forward, backward, the ``nan_action=skip`` mask, the gradient
        accumulation and, when ``do_update``, the optimizer at ``epoch``:
        the step at sample counter ``sc`` of round ``rnd``, as one eager
        sequence shared by the per-step path and the window (which carries
        no ``extra`` data).  Returns the detached loss and every node's
        value."""
        keys = [(lk, fk) for lk, fields in self.params.items()
                for fk in fields]
        leaves = [self.params[lk][fk] for lk, fk in keys]
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        ctx = self._ctx(is_train=True, rng_key=prng.fold_in(
            prng.prng_key(self.seed), 1 + sc * 131 + rnd), rnd=rnd)
        ctx.decisions = self.decisions
        with torch.enable_grad(), full_f32():
            values, loss = self.net.forward(
                self.params, data, ctx,
                labels=self.net.make_label_info(label), loss_mask=mask,
                norm=norm, extra_data=extra)
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
                              epoch)
                for fields in self.grad_acc.values():
                    for g in fields.values():
                        g.zero_()
        return loss.detach(), values

    # --- the program ledger -----------------------------------------------
    def _program(self, name: str):
        """This trainer's ledger program ``name`` (``train.step``,
        ``train.multi_step``, ``train.forward``), claimed on first use."""
        progs = self._ledger_programs
        if progs is None:
            from ..obs.programs import get_ledger
            led = get_ledger()
            progs = self._ledger_programs = {
                n: led.program(n) for n in ('train.step', 'train.multi_step',
                                            'train.forward')}
        return progs[name]

    def _ledger_info(self, data, train: bool, params=None, steps: int = 1):
        """``(flops, argument_bytes, signature)`` of a call on ``data``:
        the products of ``steps`` train steps (or one forward), the
        parameter bytes (plus the optimizer slots and the accumulator of
        a train step)."""
        from ..obs.programs import cnn_step_flops, tree_bytes
        bs = int(data.shape[0])
        nbytes = (tree_bytes(self.params, self.opt_state, self.grad_acc)
                  if train else tree_bytes(self.params if params is None
                                           else params))
        dt = str(getattr(data, 'dtype', '')).replace('torch.', '')
        sig = f'{dt}[{",".join(str(int(d)) for d in data.shape)}]'
        return (steps * cnn_step_flops(self.net, bs, train), nbytes, sig)

    def train_step_flops(self) -> float:
        """The products of one full optimizer step, from the ledger rows
        of the steps this trainer already ran (per-step or a K-step
        window, its flops over its K): the largest per-step figure, no
        extra pass; 0.0 before the first step (JAX compiles a probe then;
        here the rows fill at the first call)."""
        best = 0.0
        for name in ('train.multi_step', 'train.step'):
            for e in self._program(name).entries():
                if e.flops > 0:
                    best = max(best, e.flops / e.steps)
        return best

    def _host_label_info(self, host_label) -> LabelInfo:
        return LabelInfo(np.asarray(host_label), self.net_cfg.label_name_map,
                         self.net_cfg.label_range)

    def _drain_train_eval(self, pending) -> None:
        """Feed a deferred step's (a tuple) or window's (a dict) eval-node
        outputs to ``train_metric``; a window is read back once, then fed
        step by step, as K single drains would feed it."""
        if isinstance(pending, dict):
            losses = pending['losses'].cpu().numpy()
            evals = [e.float().cpu().numpy() for e in pending['evals']]
            for t, (info, n) in enumerate(zip(pending['infos'],
                                              pending['ns'])):
                if self.nan_action == 'skip' and not np.isfinite(losses[t]):
                    continue
                self.train_metric.add_eval([e[t][:n] for e in evals],
                                           info.slice(n))
            return
        loss, evals, info, n = pending
        if self.nan_action == 'skip' and not np.isfinite(float(loss)):
            return   # a poisoned batch's outputs would wreck the metrics
        self.train_metric.add_eval(
            [e.float().cpu().numpy()[:n] for e in evals], info.slice(n))

    def flush_train_metrics(self) -> None:
        """Settle the deferred train-metric readback: ``train_metric``
        then holds every step so far (``evaluate`` calls it)."""
        pending, self._pending_train_eval = self._pending_train_eval, None
        if pending is not None:
            self._drain_train_eval(pending)

    def _observe_loss(self, loss) -> None:
        """Divergence gate, armed by ``nan_action=halt`` or a nonzero
        ``nan_breaker``: the step's loss is stashed and the previous
        step's checked, so the gate costs no wait on the step just
        launched (``cxxnet_tpu/nnet/trainer.py:872-900``); divergence
        surfaces one update late, and :meth:`flush_divergence_check`
        settles the last step."""
        if not self._gate_armed():
            return
        prev, self._pending_loss = (self._pending_loss,
                                    (self.sample_counter, loss))
        if prev is not None:
            self._check_loss(*prev)

    def _gate_armed(self) -> bool:
        """The divergence gate reads losses back only when something acts
        on them: ``nan_action=halt``, a breaker, or an installed fault
        plan with NaN events."""
        plan = faults.active_plan()
        return (self.nan_action == 'halt' or bool(self.nan_breaker)
                or (plan is not None and plan.has_nan_events()))

    def flush_divergence_check(self) -> None:
        prev, self._pending_loss = self._pending_loss, None
        if prev is not None:
            self._check_loss(*prev)

    def reset_transient_state(self) -> None:
        """Clear the per-step state a fault may have poisoned, before a
        checkpoint is restored: the deferred metric readback, the
        deferred divergence gate, the NaN streak, and the train metrics
        (not in the exact-resume tree: replayed batches must not count
        twice)."""
        self._pending_train_eval = None
        self._pending_loss = None
        self.nan_streak = 0
        self.train_metric.clear()

    def _check_loss(self, step: int, loss) -> None:
        lf = float(loss)
        plan = faults.active_plan()
        if plan is not None:
            lf = plan.on_loss(step, lf)
        if np.isfinite(lf):
            self.nan_streak = 0
            return
        self.nan_streak += 1
        if self.nan_action == 'halt' or (
                self.nan_breaker and self.nan_streak >= self.nan_breaker):
            raise DivergenceError(step, lf, self.nan_streak)

    # --- the K-step window (steps_per_dispatch) -------------------------
    def compile_multi_step(self, n_steps: int, train_eval: bool = False):
        """The ``n_steps``-step window (JAX ``compile_multi_step``): a
        callable ``fn(datas, labels, masks, sc0, epoch0, rnd, norm=None)
        -> (losses, evals)`` that runs the steps in order, step ``t`` on
        ``datas[t % len(datas)]`` (a list of staged batches or a
        ``(nstack, batch, ...)`` stack; a mask may be None), with
        ``fn.n_steps``, ``fn.train_eval`` and ``fn.update_period``
        attached.  Step ``t`` is the per-step path's own
        :meth:`_step` at sample counter ``sc0 + t``: its key is
        ``fold_in(key, 1 + (sc0 + t) * 131 + rnd)`` and it applies the
        optimizer when ``(sc0 + t + 1) % P == 0``, the accumulator
        carrying across windows, so a window is bitwise ``n_steps``
        single steps.  ``losses`` is the ``(n_steps,)`` loss vector;
        under ``train_eval`` ``evals`` holds each eval node's outputs
        stacked ``(n_steps, batch, ...)``.  Drive it through
        :meth:`update_staged_window` or :meth:`update_n_on_device`,
        which keep the counters coherent.  No CUDA graph: each step's
        launches go out from the host as the per-step path's do."""
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f'compile_multi_step: n_steps={n_steps}')
        period = max(1, int(self.update_period))
        tag = f'k{n_steps}{"e" if train_eval else ""}'

        def multi_step(datas, labels, masks, sc0, epoch0, rnd, norm=None):
            # one ledger row per (K, train_eval, batch): its flops are the
            # K steps', normalized by steps=K
            return self._program('train.multi_step').run(
                f'{tag}b{int(datas[0].shape[0])}', window, datas, labels,
                masks, sc0, epoch0, rnd, norm, steps=n_steps,
                info=lambda: self._ledger_info(datas[0], True,
                                               steps=n_steps))

        def window(datas, labels, masks, sc0, epoch0, rnd, norm=None):
            nstack = len(datas)
            epoch = int(epoch0)
            losses, evals = [], []
            for t in range(n_steps):
                i = t % nstack
                do_update = (sc0 + t + 1) % period == 0
                loss, values = self._step(datas[i], labels[i], masks[i],
                                          norm, sc0 + t, epoch, rnd,
                                          do_update)
                if do_update:
                    epoch += 1
                losses.append(loss)
                if train_eval:
                    evals.append([values[j].detach()
                                  for j in self._eval_node_ids])
            stacked = [torch.stack(node) for node in zip(*evals)]
            return torch.stack(losses), stacked

        multi_step.n_steps = n_steps
        multi_step.train_eval = bool(train_eval)
        multi_step.update_period = period
        return multi_step

    def update_n_on_device(self, multi_fn, data_stack, label_stack,
                           n_steps: Optional[int] = None, mask_stack=None,
                           norm=None, train_eval=None):
        """Run a :meth:`compile_multi_step` window over device stacks
        (tensors ``(nstack, batch, ...)`` or sequences of per-batch
        tensors), keeping the counters coherent: ``n_steps`` must match
        the window's, ``mask_stack`` defaults to all ones
        (:meth:`_ones_mask_stack`), ``norm`` is ``_norm_args`` of a raw
        batch's spec, and ``train_eval`` a ``(label_infos, ns)`` pair, one
        per step, for a window compiled with ``train_eval=True``: its
        outputs feed ``train_metric`` one window late.  The epoch counter
        follows the update cadence baked into the window.  Returns the
        last step's loss (a device scalar)."""
        self._require_trainable()
        compiled = getattr(multi_fn, 'n_steps', None)
        if n_steps is None:
            n_steps = compiled
        elif compiled is not None and n_steps != compiled:
            raise ValueError(
                f'n_steps={n_steps} does not match the step count '
                f'{compiled} compiled into multi_fn')
        if mask_stack is None:
            mask_stack = self._ones_mask_stack(
                (len(data_stack), data_stack[0].shape[0]))
        sc0 = self.sample_counter
        old_pending, self._pending_train_eval = self._pending_train_eval, None
        losses, evals = multi_fn(data_stack, label_stack, mask_stack, sc0,
                                 self.epoch_counter, self.round, norm)
        period = getattr(multi_fn, 'update_period',
                         max(1, self.update_period))
        self.epoch_counter += sum(1 for t in range(n_steps)
                                  if (sc0 + t + 1) % period == 0)
        self.sample_counter += n_steps
        self.last_loss = losses[-1]
        if train_eval is not None:
            infos, ns = train_eval
            self._pending_train_eval = {'losses': losses, 'evals': evals,
                                        'infos': infos, 'ns': ns}
        if old_pending is not None:
            self._drain_train_eval(old_pending)
        self._gate_losses(losses, sc0)
        return losses[-1]

    def _gate_losses(self, losses, sc0: int) -> None:
        """The divergence gate over a window's losses: read back once,
        and only when ``nan_action=halt`` or ``nan_breaker`` arms it;
        every step is checked at its own step index."""
        if not self._gate_armed():
            return
        for t, loss in enumerate(losses.cpu().numpy()):
            self._check_loss(sc0 + t, loss)

    def _ones_mask_stack(self, shape):
        """A cached all-ones ``(nstack, batch)`` loss mask on the device."""
        key = tuple(int(d) for d in shape)
        cached = self._ones_mask_cache.get(key)
        if cached is None:
            cached = torch.ones(key, dtype=torch.float32, device=self.device)
            self._ones_mask_cache[key] = cached
        return cached

    def update_staged_window(self, multi_fn, staged_list):
        """One window over ``multi_fn.n_steps`` batches staged by
        :meth:`stage_batch` (``steps_per_dispatch``): the staged tensors
        go in as they are (no device stack), tail-batch masks with them,
        and each step waits for its batch's copy.  Counters, the LR
        schedule, dropout keys, the divergence gate and the train
        metrics match K single steps bitwise.  Returns the last loss."""
        self._require_trainable()
        if len(staged_list) != multi_fn.n_steps:
            raise ValueError(
                f'window of {len(staged_list)} batches does not match the '
                f'step count {multi_fn.n_steps} compiled into multi_fn')
        for s in staged_list:
            if s[2]:
                raise ValueError(
                    'the window does not carry extra_data (attachtxt '
                    'chains); use the per-step path')
        armed = bool(self.eval_train and len(self.train_metric))
        if armed and not getattr(multi_fn, 'train_eval', False):
            raise ValueError(
                'eval_train=1 with train metrics needs a multi_fn compiled '
                'with train_eval=True, or the window\'s metrics are lost')
        train_eval = None
        if getattr(multi_fn, 'train_eval', False):
            train_eval = ([self._host_label_info(s[4]) for s in staged_list],
                          [s[5] - s[6] for s in staged_list])
        for s in staged_list:
            self._await(s)
        return self.update_n_on_device(
            multi_fn, [s[0] for s in staged_list],
            [s[1] for s in staged_list], mask_stack=[s[3] for s in staged_list],
            norm=staged_list[0][7], train_eval=train_eval)

    # --- the exact-resume state -------------------------------------------
    def _state_tree(self, counters_at=None) -> dict:
        """``{'params', 'opt_state', 'grad_acc', 'counters'}``, the JAX
        trainer's tree; the counters are 0-d int64 arrays."""
        epoch, sample, rnd = counters_at or (
            self.epoch_counter, self.sample_counter, self.round)
        return {'params': self.params, 'opt_state': self.opt_state,
                'grad_acc': self.grad_acc,
                'counters': {'epoch': np.asarray(epoch, np.int64),
                             'sample': np.asarray(sample, np.int64),
                             'round': np.asarray(rnd, np.int64)}}

    def save_training_state(self, ckpt_dir: str, step: int,
                            retry=None) -> str:
        """Write the exact-resume state (params, optimizer slots, the
        gradient accumulator, the counters) as the native step checkpoint
        ``ckpt_dir/step_<step>``, synchronously.  The reference model file
        drops the optimizer state (``nnet_impl:82-87``); this sidecar
        makes ``continue=1`` bit-exact mid-momentum.  The JAX trainer
        writes orbax here; the port writes the native format, which JAX's
        ``restore_sharded`` reads (a divergence, ROADMAP.md queue C)."""
        from . import sharded_ckpt
        self._require_trainable()
        return sharded_ckpt.save_tree_native(ckpt_dir, step,
                                             self._state_tree(),
                                             retry=retry)

    def snapshot_training_state(self):
        """A snapshot of the exact-resume tree for a background writer:
        every tensor cloned on the device (enqueued on the compute stream,
        no wait), the counters copied, and the clones' event recorded as
        the snapshot's ``ready`` — the next in-place step cannot change
        what the writer copies.  Any validity gate (the supervisor's
        NaN-streak rule) is settled before the snapshot.  The three
        methods refuse an ``inference_only`` trainer, as ``update`` does:
        it holds no optimizer state."""
        from ..runtime.async_ckpt import snapshot_tree
        self._require_trainable()
        return snapshot_tree(self._state_tree())

    def load_training_state(self, ckpt_dir: str,
                            step: Optional[int] = None,
                            restore_params: bool = False,
                            fallback: bool = False, retry=None) -> int:
        """Restore :meth:`save_training_state` output (the latest step by
        default) into this initialized trainer, in place; returns the
        step.  By default only the optimizer side (slots, accumulator,
        counters) is adopted and the weights stay what the caller loaded
        (the model file, which the sidecar's params duplicate), so a stale
        sidecar costs momentum, never weights; ``restore_params=True``
        adopts the params too.  ``fallback=True`` takes the newest step
        that verifies, quarantining corrupt ones
        (``sharded_ckpt.restore_resilient``)."""
        from . import sharded_ckpt
        self._require_trainable()
        like = self._state_tree((0, 0, 0))
        if fallback:
            tree, got = sharded_ckpt.restore_resilient(ckpt_dir, like,
                                                       retry=retry)
        else:
            tree, got = sharded_ckpt.restore_sharded(ckpt_dir, like, step,
                                                     retry=retry)
        parts = ['opt_state', 'grad_acc'] + (['params'] if restore_params
                                             else [])
        pairs = [(key, dst, src) for part in parts
                 for (key, dst), (_, src) in zip(
                     sharded_ckpt.flatten_with_keys(like[part], f'[{part!r}]'),
                     sharded_ckpt.flatten_with_keys(tree[part]))]
        for key, dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f'{ckpt_dir} step {got}: {key} has shape '
                                 f'{tuple(src.shape)}, the net '
                                 f'{tuple(dst.shape)}')
        with torch.no_grad():
            for _, dst, src in pairs:
                dst.copy_(src)
        c = tree['counters']
        self.epoch_counter = int(c['epoch'])
        self.sample_counter = int(c['sample'])
        self.round = int(c['round'])
        return got

    # --- evaluation / prediction ------------------------------------------
    def forward_values(self, params, data, norm_spec=None,
                       identity_layers=frozenset(), device=None,
                       extra_data=()) -> list:
        """Every node's value for one host batch (NCHW numpy or tensor),
        without autograd; ``norm_spec`` normalizes a raw batch on the
        device; ``identity_layers`` run as pass-throughs (folded BNs);
        ``device`` runs the batch on ``params``' device when a serving
        replica pins another than the trainer's (nothing of the trainer
        is written, so replicas may call this from several threads);
        ``extra_data`` feeds the extra data nodes.  The call runs through
        this trainer's ledger program ``train.forward``, keyed by its
        batch rows."""
        return self._program('train.forward').run(
            f'b{int(data.shape[0])}', self._forward_values, params, data,
            norm_spec, identity_layers, device, extra_data,
            info=lambda: self._ledger_info(data, False, params))

    def _forward_values(self, params, data, norm_spec=None,
                        identity_layers=frozenset(), device=None,
                        extra_data=()) -> list:
        """:meth:`forward_values` outside the ledger (a serving engine
        runs it through its own program)."""
        with torch.inference_mode(), full_f32():
            return self.net.forward(params, data, self._ctx(device=device),
                                    norm=self._norm_args(norm_spec),
                                    identity_layers=identity_layers,
                                    extra_data=extra_data)[0]

    def evaluate(self, data_iter, name: str) -> str:
        """Metrics over an iterator in the reference's stderr format
        ``\\tname-metric:value``; the train metrics gathered since the
        last call come first (and are cleared) when ``eval_train`` is
        set (``nnet_impl:224-245``).  ``data_iter=None`` returns just the
        train part."""
        ret = ''
        self.flush_train_metrics()
        if self.eval_train and len(self.train_metric):
            ret += self.train_metric.print('train')
            self.train_metric.clear()
        if data_iter is None:
            return ret
        self.metric.clear()
        for batch in data_iter:
            values = self.forward_values(self.params, batch.data,
                                         batch.norm_spec,
                                         extra_data=batch.extra_data)
            n = batch.batch_size - batch.num_batch_padd
            info = LabelInfo(np.asarray(batch.label),
                             self.net_cfg.label_name_map,
                             self.net_cfg.label_range)
            self.metric.add_eval(
                [values[i].float().cpu().numpy()[:n]
                 for i in self._eval_node_ids], info.slice(n))
        return ret + self.metric.print(name)

    def _forward_nodes(self, data, node_ids: List[int], norm_spec=None,
                       extra_data=()) -> List[np.ndarray]:
        values = self.forward_values(self.params, data, norm_spec,
                                     extra_data=extra_data)
        return [values[i].float().cpu().numpy() for i in node_ids]

    def _forward_node_bucketed(self, data, nid: int, norm_spec=None,
                               extra_data=()) -> np.ndarray:
        """One node's host output with the batch split/padded onto the
        ``pred_buckets`` ladder (``utils/bucketing.py``), the extra data
        cut and padded as the data; pad rows are sliced off before
        concatenation."""
        data = np.asarray(data)
        extras = [np.asarray(e) for e in extra_data]
        outs = []
        for off, take, b in chunk_plan(data.shape[0], self.pred_buckets):
            values = self.forward_values(
                self.params, pad_rows(data[off:off + take], b), norm_spec,
                extra_data=[pad_rows(e[off:off + take], b) for e in extras])
            outs.append(values[nid].float().cpu().numpy()[:take])
        if not outs:
            return np.empty((0,), np.float32)
        return np.concatenate(outs, axis=0)

    def _top_node(self) -> int:
        return self.net.cfg.layers[-1].nindex_out[-1]

    def _forward_node(self, data, nid: int, norm_spec=None,
                      extra_data=()) -> np.ndarray:
        """One node's host output for every row of ``data``, through the
        ``pred_buckets`` ladder when one is set."""
        if self.pred_buckets:
            return self._forward_node_bucketed(data, nid, norm_spec,
                                               extra_data)
        return self._forward_nodes(data, [nid], norm_spec, extra_data)[0]

    def predict_scores(self, data, norm_spec=None,
                       extra_data=()) -> np.ndarray:
        """Final-node scores, one row per instance of ``data`` (NCHW);
        ``norm_spec`` (a batch's ``NormSpec``) normalizes raw pixels on
        the device; ``extra_data`` (a batch's) feeds the extra nodes."""
        return self._forward_node(data, self._top_node(), norm_spec,
                                  extra_data)

    def predict(self, data, norm_spec=None, extra_data=()) -> np.ndarray:
        """Argmax of the final node per instance (``TransformPred``,
        nnet_impl:286-298)."""
        return self._pred_transform(self.predict_scores(data, norm_spec,
                                                        extra_data))

    def forward_stream(self, batches, nid: int):
        """One node's host output per ``DataBatch`` of an iterator, pad
        rows trimmed (``task=pred|pred_raw|extract``).  Batch by batch:
        the readback of batch i waits for its forward before batch i+1
        is launched.  The JAX trainer overlaps the two; here both would
        queue on one CUDA stream, where a copy of batch i issued after
        batch i+1's launch waits for batch i+1 as well."""
        for batch in batches:
            out = self._forward_node(batch.data, nid, batch.norm_spec,
                                     batch.extra_data)
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
                                 batch.norm_spec, batch.extra_data)
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
