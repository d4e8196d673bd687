"""User-level ``DataIter`` and ``Net`` with the reference wrapper's
surface.

PyTorch counterpart of ``cxxnet_tpu/wrapper.py``: ``DataIter`` (the
reference's cursor protocol over a config-built iterator chain) and
``Net`` — ``set_param``, ``init_model``, ``load_model``, ``save_model``,
``start_round``, ``update``, ``evaluate``, ``predict``,
``predict_scores``, ``extract``, the whole-iterator streams
``predict_stream`` and ``extract_stream``, ``get_weight`` /
``set_weight`` in the reference's disk layout, and the serving stack
(``serve_start`` with its replicas and multi-model fleet,
``serve_scores``, ``serve_predict``, ``serve_reload``, ``serve_stats``,
``serve_stop``); the module-level ``train`` and ``train_iter``.
``Net(dev='cuda')`` — the default — runs on the card and raises at
construction when there is none; ``Net(dev='cpu')`` runs on the CPU.
Model files are the CLI's ``models/%04d.model`` format: a 4-byte net
type, then the trainer's model bytes — so a file the JAX package wrote
loads here.  ``LMServe`` is the continuous-batching decode stack behind
one compact ``k=v;...`` spec (``from_spec``).  ``obs_stats``,
``obs_slos`` and ``obs_programs`` return the telemetry hub's
``/statusz``, ``/slos`` and ``/programs`` bodies as JSON strings.  The
train-while-serve loop (``online/``): ``online_start`` trains on a
background thread named ``online-train`` while ``online_scores`` /
``online_predict`` go through the colocated serving stack;
``online_stats``, ``online_wait`` and ``online_stop``.
"""

from __future__ import annotations

import sys
from typing import Iterator, Optional

import numpy as np
import torch

from .io.data import DataBatch, create_iterator
from .nnet import checkpoint
from .nnet.trainer import NetTrainer, resolve_device
from .utils.config import parse_config_string


class DataIter:
    """Config-driven data iterator with the reference's cursor protocol
    (``wrapper.py:32-95`` of the JAX package)."""

    def __init__(self, cfg: str):
        pairs = parse_config_string(cfg)
        self._it = create_iterator(pairs)
        # pairs after `iter = end` are section defaults (batch_size,
        # input_shape, ...) applied to the whole chain
        seen_end = False
        for name, val in pairs:
            if name == 'iter' and val == 'end':
                seen_end = True
            elif seen_end:
                self._it.set_param(name, val)
        self._it.init()
        self._cursor: Optional[Iterator] = None
        self._batch: Optional[DataBatch] = None
        self.head = True
        self.tail = False

    def before_first(self) -> None:
        self._cursor = iter(self._it)
        self._batch = None
        self.head = True
        self.tail = False

    def next(self) -> bool:
        if self._cursor is None:
            self.before_first()
        try:
            self._batch = next(self._cursor)
            self.head = False
            return True
        except StopIteration:
            self.tail = True
            self._batch = None
            return False

    def check_valid(self) -> None:
        if self.head:
            raise RuntimeError('iterator at head state; call next() first')
        if self.tail:
            raise RuntimeError('iterator reached end')

    @property
    def value(self) -> DataBatch:
        self.check_valid()
        return self._batch

    def get_data(self) -> np.ndarray:
        # post-augment float data (the reference wrapper's contract):
        # under device_normalize=1 the batch carries raw pixels and the
        # deferred spec, applied here so a caller sees the same values
        # either way
        batch = self.value
        if batch.norm_spec is not None:
            return batch.norm_spec.apply(batch.data)
        return np.asarray(batch.data, np.float32)

    def get_label(self) -> np.ndarray:
        return np.asarray(self.value.label, np.float32)

    def close(self, timeout: Optional[float] = None) -> bool:
        """Join the threads of a ``threadbuffer`` chain."""
        self._cursor = None
        return self._it.close(timeout)


class Net:
    """Neural net object (reference ``Net``, wrapper/cxxnet.py:105-280)."""

    def __init__(self, dev: str = 'cuda', cfg: str = ''):
        resolve_device(dev)   # no card and no dev='cpu': raise here
        self._pairs = list(parse_config_string(cfg)) if cfg else []
        self._pairs.append(('dev', dev))
        self._trainer: Optional[NetTrainer] = None
        self._engine = None     # serve.PredictEngine after serve_start
        self._batcher = None    # serve.DynamicBatcher after serve_start
        self._fleet = None      # serve.MultiModelRegistry (models=)
        self._online = None     # online.OnlinePipeline after online_start
        self._online_thread = None
        self._online_result = {}

    def _require(self) -> NetTrainer:
        if self._trainer is None:
            raise RuntimeError('call init_model()/load_model() first')
        return self._trainer

    @property
    def trainer(self) -> NetTrainer:
        return self._require()

    def set_param(self, name, value) -> None:
        self._pairs.append((str(name), str(value)))

    def init_model(self) -> None:
        self._trainer = NetTrainer(self._pairs)
        self._trainer.init_model()

    def load_model(self, fname: str) -> None:
        self._trainer = NetTrainer(self._pairs)
        with open(fname, 'rb') as f:
            f.read(4)   # net_type prefix
            self._trainer.load_model(f)

    def save_model(self, fname: str, net_type: int = 0) -> None:
        with open(fname, 'wb') as f:
            f.write(int(net_type).to_bytes(4, 'little', signed=True))
            self._require().save_model(f)

    def start_round(self, round_counter: int) -> None:
        self._require().start_round(round_counter)

    def update(self, data, label=None) -> None:
        """One training step on a ``DataIter`` positioned on a batch, a
        ``DataBatch`` (its ``NormSpec`` applies), or a ``(batch, channel,
        y, x)`` array with its labels."""
        tr = self._require()
        if isinstance(data, DataIter):
            data = data.value
        if isinstance(data, DataBatch):
            tr.update(data)
            return
        data = np.asarray(data, np.float32)
        if data.ndim != 4:
            raise ValueError('Net.update: need 4-d (batch, channel, y, x)')
        if label is None:
            raise ValueError('Net.update: need label')
        label = np.asarray(label, np.float32)
        if label.ndim == 1:
            label = label[:, None]
        if label.shape[0] != data.shape[0]:
            raise ValueError('Net.update: data/label size mismatch')
        tr.update(DataBatch(data, label))

    def evaluate(self, data: 'DataIter', name: str) -> str:
        """Metrics over the whole iterator (rewound first), in the
        reference's ``\\tname-metric:value`` format."""
        if not isinstance(data, DataIter):
            raise TypeError('evaluate needs a DataIter')
        data.before_first()
        return self._require().evaluate(iter(data._it), name)

    @staticmethod
    def _as_batch(data) -> np.ndarray:
        data = np.asarray(data, np.float32)
        if data.ndim != 4:
            raise ValueError('need 4-d (batch, channel, y, x) to predict')
        return data

    def predict(self, data) -> np.ndarray:
        """Class id per instance of a ``DataIter``'s current batch (pad
        rows dropped, its ``NormSpec`` applied on the device) or of a
        ``(batch, channel, y, x)`` array."""
        return NetTrainer._pred_transform(self.predict_scores(data))

    def predict_scores(self, data) -> np.ndarray:
        """Final-node scores per instance of a ``DataIter``'s current
        batch (pad rows dropped) or of a ``(batch, c, y, x)`` array."""
        tr = self._require()
        if isinstance(data, DataIter):
            b = data.value
            out = tr.predict_scores(b.data, b.norm_spec, b.extra_data)
            return out[:b.batch_size - b.num_batch_padd]
        return tr.predict_scores(self._as_batch(data))

    def extract(self, data, name: str) -> np.ndarray:
        """Node ``name`` (a node name or ``top[-k]``) per instance of a
        ``DataIter``'s current batch (pad rows dropped) or of an array."""
        tr = self._require()
        if isinstance(data, DataIter):
            return tr.extract_feature(data.value, name)
        data = np.asarray(data, np.float32)
        return tr.extract_feature(
            DataBatch(data, np.zeros((data.shape[0], 1), np.float32)), name)

    def predict_stream(self, data: 'DataIter'):
        """Per-batch predictions over the whole iterator (rewound first),
        pad rows trimmed: host memory O(batch)."""
        if not isinstance(data, DataIter):
            raise TypeError('predict_stream needs a DataIter')
        tr = self._require()
        data.before_first()
        yield from tr.predict_stream(iter(data._it))

    def extract_stream(self, data: 'DataIter', name: str):
        """Per-batch outputs of node ``name`` over the whole iterator
        (rewound first), pad rows trimmed."""
        if not isinstance(data, DataIter):
            raise TypeError('extract_stream needs a DataIter')
        tr = self._require()
        data.before_first()
        yield from tr.forward_stream(iter(data._it), tr.net.node_index(name))

    # --- weight access (the reference's visitor) --------------------------
    def _resolve(self, layer_name: str):
        tr = self._require()
        idx = tr.net_cfg.get_layer_index(layer_name)
        return tr, idx, tr.net_cfg.layers[idx].type

    def get_weight(self, layer_name: str, tag: str) -> Optional[np.ndarray]:
        """Layer ``layer_name``'s ``wmat`` or ``bias`` as a host f32 array
        in the model file's layout (fullc ``(nhidden, nin)``, conv
        ``(ngroup, nchannel/ngroup, cin/ngroup * kh * kw)``), or None
        when the layer has no such weight."""
        if tag not in ('bias', 'wmat'):
            raise ValueError('tag must be bias or wmat')
        tr, idx, type_id = self._resolve(layer_name)
        rec = tr.params.get(str(idx), {})
        if tag not in rec:
            return None
        arr = rec[tag].detach().float().cpu().numpy()
        return checkpoint.to_disk_layout(type_id, tag, arr,
                                         tr.net.layers[idx].param.num_group)

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        """Replace a weight given in :meth:`get_weight`'s layout.  The
        param tree is replaced, not written into: a serving engine built
        before keeps the weights it had."""
        if tag not in ('bias', 'wmat'):
            raise ValueError('tag must be bias or wmat')
        tr, idx, type_id = self._resolve(layer_name)
        key = str(idx)
        if key not in tr.params or tag not in tr.params[key]:
            raise KeyError(f'layer {layer_name} has no weight {tag}')
        old = tr.params[key][tag]
        mem = checkpoint.from_disk_layout(
            type_id, tag, np.asarray(weight, np.float32), tr.net.layers[idx])
        if tuple(mem.shape) != tuple(old.shape):
            raise ValueError(f'set_weight: shape {mem.shape} != '
                             f'{tuple(old.shape)}')
        params = dict(tr.params)
        params[key] = dict(params[key])
        params[key][tag] = torch.from_numpy(np.ascontiguousarray(mem)).to(
            device=old.device, dtype=old.dtype)
        tr.params = params

    # --- online serving ---------------------------------------------------
    def serve_start(self, buckets='1,8,32', max_queue: int = 64,
                    max_wait: float = 0.002, deadline: float = 1.0,
                    warm: bool = True, models=None, mem_budget: int = 0,
                    dtype: str = 'f32', replicas: int = 0, fold_bn: int = 0,
                    fold_batch=None) -> None:
        """Stand up the serving stack over this net's params: a bucketed
        ``PredictEngine`` (``dtype``: the ``f32``, ``bf16`` or ``int8``
        storage tier) plus a ``DynamicBatcher``.  ``replicas >= 2`` puts
        that many ``ReplicatedPredictEngine`` replicas, one a CUDA device,
        behind the batcher.  ``models`` (a ``{model_id: model_dir}`` dict
        of checkpoints of this net's architecture) serves a fleet through
        a ``MultiModelRegistry`` under ``mem_budget`` bytes, at the same
        ``dtype`` — route to one with ``serve_scores(..., model=id)``.
        ``fold_bn=1`` folds conv+BN pairs into the conv at the f32 tier
        (frozen statistics of ``fold_batch``, NCHW, or of a seeded random
        batch; ``nnet/fold.py``).  ``serve_stop()`` tears it down."""
        from .serve import (DynamicBatcher, MultiModelRegistry,
                            PredictEngine, ReplicatedPredictEngine)
        from .utils.bucketing import parse_buckets
        from .utils.metric import StatSet
        if self._batcher is not None:
            raise RuntimeError('serving already started; serve_stop() first')
        tr = self._require()
        bks = parse_buckets(buckets) if isinstance(buckets, str) \
            else tuple(buckets)
        if replicas >= 2:
            self._engine = ReplicatedPredictEngine(
                tr, bks, dtype=dtype, replicas=replicas, stats=StatSet(),
                fold_bn=fold_bn, fold_batch=fold_batch)
        else:
            self._engine = PredictEngine(tr, bks, dtype=dtype,
                                         fold_bn=fold_bn,
                                         fold_batch=fold_batch)
        if warm:
            self._engine.warm()
        self._batcher = DynamicBatcher(self._engine, max_queue=max_queue,
                                       max_wait=max_wait, deadline=deadline,
                                       stats=getattr(self._engine, 'stats',
                                                     None))
        self._fleet = None
        if models:
            self._fleet = MultiModelRegistry(mem_budget=mem_budget)
            for mid, mdir in dict(models).items():
                self._fleet.add_model(
                    mid, self._fleet_factory(mdir, bks, dtype),
                    model_dir=mdir)

    def _fleet_factory(self, model_dir: str, buckets, dtype: str = 'f32'):
        """Factory for one fleet model (``serve.registry.fleet_factory``)
        over an isolated inference-only trainer from this net's
        config."""
        from .serve.registry import fleet_factory
        pairs = list(self._pairs)
        return fleet_factory(
            lambda: NetTrainer(pairs + [('inference_only', '1')]),
            model_dir, buckets, dtype)

    def _require_serving(self):
        if self._batcher is None:
            raise RuntimeError('call serve_start() first')
        return self._batcher

    @property
    def engine(self):
        """The live engine (after ``serve_start``)."""
        self._require_serving()
        return self._engine

    @property
    def fleet(self):
        """The ``MultiModelRegistry`` of ``serve_start(models=...)``, or
        None."""
        return self._fleet

    def serve_scores(self, data, deadline: Optional[float] = None,
                     model: Optional[str] = None) -> np.ndarray:
        """Submit one request through the batcher; blocks for the final
        node's score rows.  Raises the typed serving errors.  ``model=``
        routes to a fleet model, straight to its engine under a lease (no
        eviction during the forward); a cold model may load first, so
        ``deadline`` is refused there rather than ignored."""
        if model is not None:
            if self._fleet is None:
                raise RuntimeError('serve_start(models=...) first')
            if deadline is not None:
                raise ValueError(
                    'deadline is not enforced on the fleet path (a cold '
                    'model may need to load); pass deadline=None')
            with self._fleet.lease(model) as engine:
                return engine.predict_scores(np.asarray(data, np.float32))
        return self._require_serving().submit(
            np.asarray(data, np.float32), deadline)

    def serve_predict(self, data, deadline: Optional[float] = None,
                      model: Optional[str] = None) -> np.ndarray:
        """Like :meth:`predict`, through the serving stack."""
        return NetTrainer._pred_transform(
            self.serve_scores(data, deadline, model=model))

    def serve_reload(self, fname: str) -> None:
        """Hot-swap a checkpoint into the live engine: the registry's
        verify, load, warm and swap, without the watching."""
        from .runtime.faults import CheckpointCorruptError
        from .serve.registry import load_model_params
        if self._engine is None:
            raise RuntimeError('call serve_start() first')
        reason = checkpoint.verify_model_digest(fname)
        if reason:
            raise CheckpointCorruptError(f'{fname}: {reason}')
        placed = self._engine.place_params(
            load_model_params(self._engine, fname))
        self._engine.warm_params(placed)
        self._engine.swap_params(placed, version=fname)

    def serve_stats(self, name: str = 'serve') -> str:
        """Per-bucket latency/throughput counters in eval-line format,
        with the fleet's memory ledger when ``models=`` is serving."""
        out = self._require_serving().report(name)
        if self._fleet is not None:
            out += self._fleet.report()
        return out

    def serve_stop(self, timeout: Optional[float] = None) -> None:
        """Drain and tear down the serving stack (idempotent): the
        batcher, the replicas' workers and the fleet."""
        if self._batcher is not None:
            self._batcher.close(timeout)
            self._batcher = None
        if self._engine is not None and hasattr(self._engine, 'close'):
            self._engine.close(timeout)
        if self._fleet is not None:
            self._fleet.close(timeout)
            self._fleet = None
        self._engine = None

    # --- train-while-serve --------------------------------------------------
    def online_start(self, train_data, model_dir: str, rounds: int = 1,
                     save_every: int = 8, freshness_slo: float = 0.0,
                     freshness_strict: bool = False, reload: float = 0.05,
                     buckets='1,8,32', max_queue: int = 64,
                     max_wait: float = 0.002, deadline: float = 1.0,
                     qps: float = 50.0, request_source=None,
                     steps_per_dispatch: int = 1,
                     watchdog_deadline: float = 60.0,
                     dtype: str = 'f32') -> None:
        """Run the train-while-serve loop over this net: training starts
        on a background thread while the colocated serving stack answers
        :meth:`online_scores` / :meth:`online_predict`, hot-reloading the
        checkpoint published every ``save_every`` steps.  ``train_data``
        is a ``DataIter`` (or an iterator chain); a ``request_source``
        arms the built-in traffic driver (``qps`` requests a second).
        ``online_wait()`` joins the training thread and returns the
        summary; ``online_stop()`` tears everything down."""
        import threading

        from .online import OnlineConfig, OnlinePipeline
        from .utils.bucketing import parse_buckets
        if self._online is not None:
            raise RuntimeError('online already started; online_stop() first')
        tr = self._require()
        it = train_data._it if isinstance(train_data, DataIter) \
            else train_data
        bks = parse_buckets(buckets) if isinstance(buckets, str) \
            else tuple(buckets)
        cfg = OnlineConfig(
            model_dir=model_dir, save_every=save_every,
            freshness_slo=freshness_slo, freshness_strict=freshness_strict,
            reload_poll=reload, buckets=bks, max_queue=max_queue,
            max_wait=max_wait, deadline=deadline, dtype=dtype,
            qps=qps, watchdog_deadline=watchdog_deadline or None,
            steps_per_dispatch=steps_per_dispatch, silent=True)
        pairs = list(self._pairs)
        pipe = OnlinePipeline(
            tr, it, lambda: NetTrainer(pairs + [('inference_only', '1')]),
            cfg, request_source=request_source)
        pipe.start()                      # serving is live before return
        self._online = pipe
        self._online_result = {}

        def _train():
            try:
                self._online_result['summary'] = pipe.run(rounds)
            except BaseException as e:     # surfaced by online_wait
                self._online_result['error'] = e

        self._online_thread = threading.Thread(
            target=_train, daemon=True, name='online-train')
        self._online_thread.start()

    def _require_online(self):
        if self._online is None:
            raise RuntimeError('call online_start() first')
        return self._online

    def online_scores(self, data, deadline: Optional[float] = None):
        """One request through the live online stack (the final node's
        score rows); typed serving errors propagate."""
        return self._require_online().submit(
            np.asarray(data, np.float32), deadline)

    def online_predict(self, data, deadline: Optional[float] = None):
        """Class id per row through the online stack."""
        return NetTrainer._pred_transform(self.online_scores(data, deadline))

    def online_stats(self, name: str = 'online') -> str:
        """Freshness and swap gauges and the serving counters, in
        eval-line format."""
        pipe = self._require_online()
        return pipe.eval_line(name) + pipe.serve_report()

    def online_wait(self, timeout: Optional[float] = None) -> dict:
        """Join the training thread; re-raises its error or returns the
        run's summary (freshness p50 / p99, swaps, served, dropped...)."""
        self._require_online()
        t = self._online_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError('online training still running')
        res = self._online_result or {}
        if 'error' in res:
            raise res['error']
        return res.get('summary', self._online.summary())

    def online_stop(self, timeout: Optional[float] = None) -> None:
        """Tear the online loop down (idempotent); joins the training
        thread first, so ``close`` never races a live step loop."""
        if self._online is None:
            return
        t = self._online_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    'online training still running — tearing the stack '
                    'down under a live step loop would corrupt the run')
        self._online.close(timeout)
        self._online = None
        self._online_thread = None

    # --- telemetry ----------------------------------------------------------
    def obs_stats(self) -> str:
        """One JSON snapshot of the process-wide telemetry hub, the body
        ``/statusz`` serves: uptime, every registered StatSet's counters,
        the status views (registry state machine, execution plan, program
        ledger) and the flight recorder's state.  Needs no model: the hub
        is process-wide."""
        import json

        from .obs import get_hub
        return json.dumps(get_hub().status(), sort_keys=True, default=str)

    def obs_slos(self) -> str:
        """The attached SLO engines' typed verdicts as one JSON object,
        the body ``/slos`` serves (``{}`` without an engine)."""
        import json

        from .obs import get_hub
        return json.dumps(get_hub().slos_view(), sort_keys=True,
                          default=str)

    def obs_programs(self) -> str:
        """The program ledger as one JSON object, the body ``/programs``
        serves: each (program, shape key) row with its first-call ms,
        products and parameter bytes, and the recompile sentinel's
        totals."""
        import json

        from .obs.programs import get_ledger
        return json.dumps(get_ledger().view(), sort_keys=True,
                          default=str)


def _new_net(cfg: str, param) -> Net:
    """A ``Net`` on the last ``dev`` of ``param`` (else the card) with
    ``param`` set and its model initialized."""
    pairs = list(param.items() if isinstance(param, dict) else param)
    dev = next((str(v) for k, v in reversed(pairs) if k == 'dev'), 'cuda')
    net = Net(dev=dev, cfg=cfg)
    for k, v in pairs:
        net.set_param(k, v)
    net.init_model()
    return net


def train_iter(cfg: str, data: DataIter, num_round: int, param,
               eval_data: Optional[DataIter] = None) -> Net:
    """Train a net from ``cfg`` and ``param`` (a dict or pairs) for
    ``num_round`` passes over ``data``; after each pass the metrics over
    ``eval_data`` go to stderr (reference ``wrapper/cxxnet.py:281``)."""
    net = _new_net(cfg, param)
    for r in range(num_round):
        net.start_round(r)
        data.before_first()
        counter = 0
        while data.next():
            net.update(data)
            counter += 1
            if counter % 100 == 0:
                print(f'[{r}] {counter} batch passed')
        if eval_data is not None:
            sys.stderr.write(net.evaluate(eval_data, 'eval') + '\n')
    return net


def train(cfg: str, data, label, num_round: int, param) -> Net:
    """Train a net from ``cfg`` and ``param`` on one array batch, one
    update a round (reference ``wrapper/cxxnet.py:300``)."""
    net = _new_net(cfg, param)
    for r in range(num_round):
        net.start_round(r)
        net.update(data=data, label=label)
    return net


class LMServe:
    """Python-embedder surface for the continuous-batching decode stack
    (``serve/decode.py``), the LM counterpart of :class:`Net`'s serving
    surface (JAX ``wrapper.py:587``).

    Built from a compact ``k=v[;k=v...]`` spec: model ``vocab`` /
    ``d_model`` / ``heads`` / ``d_ff`` / ``stages`` / ``seq``, params from
    ``model_in`` (a ``%04d.lm`` file) or a ``seed`` init, engine shape
    ``slots`` / ``pages`` / ``page_size`` / ``max_prompt`` / ``max_new``
    / ``eos``, batcher knobs ``max_queue`` / ``max_wait`` / ``deadline``,
    attention leg ``flash_decode`` (``auto`` / ``0`` / ``1``), greedy
    speculative decoding ``spec_k`` with ``draft.*`` keys
    (``draft.d_model=16;draft.stages=1;draft.seed=1`` or
    ``draft.model_in=``; the draft's vocab defaults to the target's), the
    serving tier ``dtype`` (``f32``, ``bf16`` or ``int8``; the ``dtype``
    argument is the default) and ``dev`` (the card unless ``cpu``; the
    ``dev`` argument is the default), prefix sharing ``prefix_share``,
    the KV tiers behind it (``kv_host_mb`` / ``kv_disk_mb`` / ``kv_dir``
    / ``kv_share_dir``) and ``prefill_workers``.  ``experts`` and
    ``shard`` raise ``NotPortedError``."""

    def __init__(self, svc):
        self.svc = svc

    @classmethod
    def from_spec(cls, cfg: str, dev: str = 'cuda',
                  dtype: str = 'f32') -> 'LMServe':
        from .models import transformer as T
        from .serve.decode import DecodeService, load_lm_params
        from .utils.config import parse_kv_list

        def build_model(kw, model_in, seed):
            tcfg = T.TransformerConfig(**kw)
            params = (load_lm_params(model_in) if model_in
                      else T.init_params(np.random.RandomState(seed),
                                         tcfg))
            return params, tcfg

        cfg_kw = {'attn': 'local'}
        draft_kw = {'attn': 'local'}
        svc_kw = {'device': dev, 'dtype': dtype}
        seed, model_in, eos = 0, None, None
        draft_seed, draft_model_in, has_draft = 0, None, False
        names = {'vocab': 'vocab_size', 'd_model': 'd_model',
                 'heads': 'num_heads', 'd_ff': 'd_ff',
                 'stages': 'num_stages', 'experts': 'num_experts',
                 'seq': 'seq_len'}
        ints = ('slots', 'pages', 'page_size', 'max_prompt', 'max_queue',
                'prefix_share', 'spec_k', 'kv_host_mb', 'kv_disk_mb',
                'prefill_workers')
        for key, val in parse_kv_list(cfg or ''):
            if key in names:
                cfg_kw[names[key]] = int(val)
            elif key in ints:
                svc_kw[key] = int(val)
            elif key == 'max_new':
                svc_kw['max_new_bound'] = int(val)
            elif key in ('max_wait', 'deadline'):
                svc_kw[key] = float(val)
            elif key == 'seed':
                seed = int(val)
            elif key == 'model_in':
                model_in = val
            elif key == 'eos':
                eos = None if int(val) < 0 else int(val)
            elif key == 'dev':
                svc_kw['device'] = val
            elif key in ('dtype', 'flash_decode', 'kv_dir', 'kv_share_dir',
                         'shard'):
                svc_kw[key] = val
            elif key.startswith('draft.'):
                has_draft = True
                sub = key[len('draft.'):]
                if sub in names:
                    draft_kw[names[sub]] = int(val)
                elif sub == 'seed':
                    draft_seed = int(val)
                elif sub == 'model_in':
                    draft_model_in = val
                else:
                    raise ValueError(f'unknown lm_serve option: {key!r}')
            else:
                raise ValueError(f'unknown lm_serve option: {key!r}')
        params, tcfg = build_model(cfg_kw, model_in, seed)
        if has_draft:
            draft_kw.setdefault('vocab_size', tcfg.vocab_size)
            svc_kw['draft'] = build_model(draft_kw, draft_model_in,
                                          draft_seed)
        return cls(DecodeService(params, tcfg, eos_id=eos, **svc_kw))

    @property
    def engine(self):
        return self.svc.engine

    @property
    def batcher(self):
        return self.svc.batcher

    def generate(self, prompt, max_new: int, temperature: float = 0.0,
                 rng=None, deadline: Optional[float] = None) -> np.ndarray:
        """One prompt through the batcher and the engine; blocks for its
        whole token stream (``rng``: an int seed when sampling)."""
        return self.svc.generate(prompt, max_new, temperature, rng,
                                 deadline)

    def report(self, name: str = 'decode') -> str:
        return self.svc.report(name)

    def close(self, timeout: Optional[float] = None) -> None:
        self.svc.close(timeout)
