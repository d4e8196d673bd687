"""Config-file-driven task CLI: ``task=train|finetune|pred|pred_raw|
extract|serve|online``.

PyTorch counterpart of ``cxxnet_tpu/main.py`` (the reference's CLI,
``src/cxxnet_main.cpp:16-478``)::

    python -m cxxnet_tpu_torch.main config.conf [k=v ...]

The counter and checkpoint choreography is the JAX package's: model
files are ``model_dir/%04d.model`` with an int ``net_type`` prefix (and
the ``.crc32`` sidecar); ``continue=1`` resumes from the newest one;
``model_in`` starts from a given file (one the JAX package wrote loads
too); the eval output goes to **stderr** as
``[round]\\tname-metric:value``, followed, when the train chain is
instrumented (``nworker``), by its pipeline counters as ``\\tio-key:value``;
``test_io=1`` runs the loop without compute.  ``steps_per_dispatch=K``
(or ``train.steps_per_dispatch``) runs each round in windows of K steps
(``nnet/execution.py``), bitwise the per-step run; ``scan_strict=1``
makes a demotion to per-step (``test_io``) raise ``ScanStrictError``.

The training runtime (JAX ``main.py``, doc/fault_tolerance.md):
``exact_ckpt=1`` writes the exact-resume state (optimizer slots,
accumulator, counters) beside each model file as
``model_dir/exact_state/step_<counter>`` in the native step format, and
``continue=1`` restores the one matching the model it resumes from, so
the resumed run is bitwise the uninterrupted one; ``save_async=1``
(``save_workers`` threads a save) snapshots at the round boundary and
writes on a background writer, the last save barriered before exit;
``train.supervise=1`` runs each round under ``runtime.supervisor.
TrainSupervisor`` (``train.watchdog_deadline``, ``train.max_restarts``,
``train.nan_breaker``, ``train.save_every``, ``train.keep_last``; its
checkpoints in ``model_dir/supervised_state``); ``train.fault_plan=``
installs a ``runtime.faults.FaultPlan`` before ``init``.
The data sections take the
``mnist``, ``img``, ``imgbin``, ``imgbinx`` and ``imgbin_stream`` sources
and the
``attachtxt`` stage (``io/data.py``), so the reference ImageNet confs
train as written and ``extra_data_num`` nets read their side vectors
(a round whose batches carry them runs per step under
``steps_per_dispatch``); ``conv_lowering`` and ``micro_batch`` reach
every conv layer (``layers/conv.py``), ``train.micro_batch`` is held as
the JAX CLI holds it (its autotuner's baseline); ``task=pred`` writes
one line per real instance, a tail batch's pad rows dropped.  ``dev=``
picks the device as in ``nnet/trainer.py``: the card unless ``dev=cpu``.

``task=finetune`` trains a net whose named layers start from the
same-named layers of ``model_in`` (the rest from the seeded init, the
epoch counter from 0); ``task=pred_raw`` writes the last node's scores,
one space-separated ``%g`` row per instance; ``task=extract`` writes the
node ``extract_node_name`` (default ``top[-1]``) per instance, as ``%g``
text or, with ``output_format`` other than ``txt``, raw little-endian
float32.  ``task=serve`` (``serve.mode=predict``, the default) drives the
``pred=`` section through the serving stack (``serve/``: a bucketed
``PredictEngine`` on ``serve.buckets`` and a ``DynamicBatcher``), writes
the predictions in ``task=pred``'s format and order, and prints the
batcher's counters to stderr; ``serve.fold_bn=1`` folds each conv+BN
pair into its conv at the f32 tier (``nnet/fold.py``); ``serve.replicas=N``
(N >= 2) serves through N ``ReplicatedPredictEngine`` replicas, one a
card; ``serve.reload=S`` hot-reloads each newer ``model_dir`` checkpoint,
polled every S seconds (``serve/registry.ModelRegistry``);
``serve.models=id=dir;...`` stands a ``MultiModelRegistry`` fleet of
models of the conf's architecture up beside it, under
``serve.mem_budget`` bytes.  These four keys apply to
``serve.mode=predict`` only: in decode mode they raise ``ValueError``.

``task=serve serve.mode=decode`` stands the continuous decode stack
(``serve/decode.py``) up over a TransformerLM built from ``serve.lm``
(a ``k=v;...`` spec; params from ``serve.lm_model_in`` or a
``serve.lm_seed`` init) and drives ``serve.requests`` seeded prompts of
mixed lengths through it, at ``serve.dtype`` (``f32``, ``bf16`` or
``int8``); the token streams go to ``pred=``'s file, the first three are
checked against offline ``transformer.generate`` and the stats go to
stderr.

``task=online`` (``online/``) is the train-while-serve loop: a
supervised trainer over the ``data=`` section (idiomatically ``iter =
imgbin_stream``, a growing file) publishes a serving checkpoint every
``online.save_every`` optimizer steps, named by step, while a colocated
engine, batcher and registry hot-swap them (``online.reload`` seconds a
poll) under the ``pred=`` section's rows replayed at ``online.qps``.
``online.freshness_slo`` (seconds) judges each swap's step-to-serving
lag, ``online.freshness_strict=1`` raises ``FreshnessSLOError`` after the
run; ``save_async`` is on unless the conf sets it.  Each round's eval
line carries the ``online-*`` gauges; the serving counters and one
``online summary: {...}`` JSON line print at the end.  ``continue=1``
adopts the newest step-named model file and publishes past it.

Telemetry (``obs/``, JAX ``main.py``'s keys): every run arms the
telemetry hub's flight recorder (``obs.ring_events`` events, dumps in
``obs.dump_dir``, default ``model_dir/flight``, on a training fault, a
supervisor give-up, an SLO breach or ``SIGUSR1``), joins the program
ledger (``obs.recompile=warn|raise|off``) and, with ``obs.hbm=1`` (the
default), the ``hbm.*`` device-memory gauges.  ``obs.port=N`` (0: an
ephemeral port, announced into ``CXXNET_OBS_PORT_FILE`` when set) serves
``/metrics``, ``/statusz``, ``/healthz``, ``/slos``, ``/programs`` and,
with ``obs.profile=1``, ``/profile?ms=N``; ``slo.<name>=<set>.<key><op>
<threshold>@<window>[:burn]`` (or ``obs.sample_every=S``) starts the
gauge sampler and the SLO engine, whose verdicts print at exit;
``obs.trace_export=path`` writes the flight recorder as a Chrome trace
at exit.  ``profile_dir`` (with ``profile_start_batch`` /
``profile_stop_batch``) traces a window of updates with
``torch.profiler`` (``utils/profiler.TraceWindow``; it demotes a K-step
window).  After each round's eval line a training run writes its own
stderr line, ``train-steps_per_sec``, ``train-flops_per_step`` (the
ledger's products a step) and, where the card's peak is known,
``train-mfu``: the eval lines stay the same with telemetry on or off.

Every other task, and the keys of the subsystems not ported yet, raise
``NotPortedError`` naming their ROADMAP.md queue-A item; none is
ignored silently.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

from .io.data import create_iterator
from .nnet import checkpoint
from .nnet.execution import ExecutionPlan
from .nnet.trainer import NetTrainer
from .parallel import distributed
from .runtime.faults import NotPortedError
from .utils.config import apply_cli_overrides, parse_config_file
from .utils.profiler import TraceWindow

ConfigEntry = Tuple[str, str]

#: tasks of the JAX CLI this port does not run yet -> ROADMAP.md item
_UNPORTED_TASKS = {'autotune': 'queue A item 10'}

#: tasks that read no data or eval section
_PRED_ONLY = ('pred', 'pred_raw', 'serve')
#: tasks that read the pred section (task=online replays it as traffic)
_PRED_READERS = ('pred', 'pred_raw', 'extract', 'serve', 'online')

#: key prefixes of unported subsystems -> ROADMAP.md item
_UNPORTED_PREFIXES = (('dist.', 'queue A item 9'),)

#: single keys of unported subsystems -> (the values that leave the
#: subsystem off, ROADMAP.md item)
_UNPORTED_KEYS = {
    'autotune': ((), 'queue A item 10'),
    # the elastic launcher's merged scrape and trace (obs/fleet.py)
    'obs.fleet_port': (('-1',), 'queue A item 9'),
    'obs.trace_merge': (('',), 'queue A item 9'),
    # the decode stack's options the port does not run yet
    'serve.shard': (('', 'tp:1'), 'queue A item 9'),
    'serve.scenario': ((), 'queue A item 10'),
    'serve.autoscale': ((), 'queue A item 10'),
    # a multi-process world: the CNN trainer's data parallelism
    'dist_num_worker': (('0', '1'), 'queue A item 9'),
    'dist_worker_rank': (('0',), 'queue A item 9'),
}

#: the serving keys this port runs -> (attribute, type)
_SERVE_KEYS = {
    'serve.mode': ('serve_mode', str), 'serve.lm': ('serve_lm', str),
    'serve.buckets': ('serve_buckets', str),
    'serve.lm_seed': ('serve_lm_seed', int),
    'serve.lm_model_in': ('serve_lm_model_in', str),
    'serve.slots': ('serve_slots', int), 'serve.pages': ('serve_pages', int),
    'serve.page_size': ('serve_page_size', int),
    'serve.max_prompt': ('serve_max_prompt', int),
    'serve.max_new': ('serve_max_new', int), 'serve.eos': ('serve_eos', int),
    'serve.requests': ('serve_requests', int),
    'serve.temperature': ('serve_temperature', float),
    'serve.seed': ('serve_seed', int),
    'serve.flash_decode': ('serve_flash', str),
    'serve.draft': ('serve_draft', str), 'serve.spec_k': ('serve_spec_k', int),
    'serve.prefix_share': ('serve_prefix_share', int),
    'serve.kv_host_mb': ('serve_kv_host_mb', int),
    'serve.kv_disk_mb': ('serve_kv_disk_mb', int),
    'serve.kv_dir': ('serve_kv_dir', str),
    'serve.kv_share_dir': ('serve_kv_share_dir', str),
    'serve.prefill_workers': ('serve_prefill_workers', int),
    'serve.max_queue': ('serve_max_queue', int),
    'serve.max_wait': ('serve_max_wait', float),
    'serve.deadline': ('serve_deadline', float),
    'serve.dtype': ('serve_dtype', str),
    'serve.fold_bn': ('serve_fold_bn', int),
    'serve.reload': ('serve_reload', float),
    'serve.models': ('serve_models', str),
    'serve.mem_budget': ('serve_mem_budget', int),
    'serve.replicas': ('serve_replicas', int),
}

#: the training-loop and runtime keys this port runs -> (attribute,
#: type); the other ``train.`` keys are refused
_RUN_KEYS = {
    'steps_per_dispatch': ('steps_per_dispatch', int),
    'train.steps_per_dispatch': ('steps_per_dispatch', int),
    'scan_strict': ('scan_strict', int),
    'train.scan_strict': ('scan_strict', int),
    'exact_ckpt': ('exact_ckpt', int),
    'save_async': ('save_async', int),
    'save_workers': ('save_workers', int),
    'train.fault_plan': ('fault_plan', str),
    'train.supervise': ('supervise', int),
    'train.watchdog_deadline': ('watchdog_deadline', float),
    'train.max_restarts': ('max_restarts', int),
    'train.nan_breaker': ('nan_breaker', int),
    'train.save_every': ('save_every', int),
    'train.keep_last': ('keep_last', int),
    # the conv split (JAX main.py:197-198): as every key outside the
    # netconfig, ``micro_batch`` also reaches each layer through the net
    # config's global defaults; ``train.micro_batch`` is held here only,
    # as the baseline of JAX's autotuner (queue A item 10)
    'micro_batch': ('micro_batch', int),
    'train.micro_batch': ('micro_batch', int),
}


#: the train-while-serve keys (task=online) -> (attribute, type)
_ONLINE_KEYS = {
    'online.save_every': ('online_save_every', int),
    'online.freshness_slo': ('online_freshness_slo', float),
    'online.freshness_strict': ('online_freshness_strict', int),
    'online.reload': ('online_reload', float),
    'online.qps': ('online_qps', float),
}


#: the telemetry keys this port runs -> (attribute, type); JAX main.py's
#: obs.* but the launcher's two above
_OBS_KEYS = {
    'obs.port': ('obs_port', int),
    'obs.trace_export': ('obs_trace_export', str),
    'obs.ring_events': ('obs_ring_events', int),
    'obs.dump_dir': ('obs_dump_dir', str),
    'obs.sample_every': ('obs_sample_every', float),
    'obs.recompile': ('obs_recompile', str),
    'obs.profile': ('obs_profile', int),
    'obs.hbm': ('obs_hbm', int),
}


def _check_ported(name: str, val: str) -> None:
    if name == 'param_server' and val.strip().lower() == 'dist':
        raise NotPortedError('param_server=dist', 'queue A item 9')
    if name in _UNPORTED_KEYS:
        off, item = _UNPORTED_KEYS[name]
        if val.strip().lower() not in off:
            raise NotPortedError(f'{name}={val}', item)
        return
    if name in _SERVE_KEYS or name in _RUN_KEYS or name in _OBS_KEYS \
            or name in _ONLINE_KEYS:
        return
    if name.startswith(('train.', 'obs.', 'online.')):
        # no other train., obs. or online. key exists in the JAX package
        # either: refused rather than passed on unread
        kind = {'train.': 'training', 'obs.': 'telemetry',
                'online.': 'online'}[name[:name.index('.') + 1]]
        raise ValueError(f'unknown {kind} key {name}')
    for prefix, item in _UNPORTED_PREFIXES:
        if name.startswith(prefix):
            raise NotPortedError(name, item)


def _check_world_env(cfg) -> None:
    """Refuse the multi-process world the environment asks for: a
    coordinator address with ``CXXNET_NUM_WORKER > 1`` makes the JAX CLI
    join one (``parallel/distributed.maybe_init_distributed``) and train
    data-parallel, which this port does not run yet.  Any other world goes
    through ``maybe_init_distributed`` as in the JAX CLI, which notes a
    coordinator address beside a 1-process world on stderr and runs
    solo."""
    world = distributed.requested_world(cfg)
    if world is not None and world[0] is not None and world[1] > 1:
        coord, nproc, _ = world
        raise NotPortedError(
            f'a {nproc}-process world (CXXNET_NUM_WORKER={nproc}, '
            f'coordinator {coord})', 'queue A item 9')
    distributed.maybe_init_distributed(cfg)


class LearnTask:
    def __init__(self):
        self.task = 'train'
        self.net_type = 0
        self.reset_net_type = -1
        self.print_step = 100
        self.continue_training = 0
        self.save_period = 1
        self.start_counter = 0
        self.name_model_in = 'NULL'
        self.name_model_dir = 'models'
        self.num_round = 10
        self.max_round = 2147483647
        self.silent = 0
        self.test_io = 0
        self.name_pred = 'pred.txt'
        self.extract_node_name = ''    # task=extract node (top[-1] if unset)
        self.output_format = 1         # 1: %g text; 0: raw <f4
        self.device = 'cuda'           # dev=: the card unless dev=cpu
        self.serve_mode = 'predict'    # serve.mode: predict | decode
        self.serve_buckets = '1,8,32'  # serve.buckets batch-size ladder
        # continuous decode serving (task=serve serve.mode=decode)
        self.serve_lm = ''             # serve.lm transformer spec (k=v;...)
        self.serve_lm_seed = 0         # serve.lm_seed init seed (no model_in)
        self.serve_lm_model_in = 'NULL'  # serve.lm_model_in %04d.lm file
        self.serve_slots = 4           # serve.slots decode step width
        self.serve_pages = 64          # serve.pages KV pool (physical pages)
        self.serve_page_size = 16      # serve.page_size tokens per page
        self.serve_max_prompt = 64     # serve.max_prompt longest prompt
        self.serve_max_new = 16        # serve.max_new decode horizon/bound
        self.serve_eos = -1            # serve.eos id (-1 = none)
        self.serve_requests = 16       # serve.requests decode drive size
        self.serve_temperature = 0.0   # serve.temperature decode sampling
        self.serve_seed = 0            # serve.seed drive prompt/rng seed
        self.serve_flash = 'auto'      # serve.flash_decode: auto | 0 | 1
        self.serve_draft = ''          # serve.draft spec (like serve.lm)
        self.serve_spec_k = 0          # serve.spec_k window width (0/1=off)
        self.serve_prefix_share = 0    # serve.prefix_share index pages (0=off)
        # the tiered KV cache behind the index (needs prefix_share > 0)
        self.serve_kv_host_mb = 0      # serve.kv_host_mb tier-1 RAM (0=off)
        self.serve_kv_disk_mb = 0      # serve.kv_disk_mb tier-2 disk (0=off)
        self.serve_kv_dir = ''         # serve.kv_dir tier-2 record dir
        self.serve_kv_share_dir = ''   # serve.kv_share_dir cross-replica
        self.serve_prefill_workers = 0  # serve.prefill_workers threads (0=inline)
        self.serve_max_queue = 64      # serve.max_queue admission bound
        self.serve_max_wait = 0.002    # serve.max_wait coalesce window (s)
        self.serve_deadline = 1.0      # serve.deadline per-request (s)
        self.serve_dtype = 'f32'       # serve.dtype: f32 | bf16 | int8
        self.serve_fold_bn = 0         # serve.fold_bn: 1 = fold conv+BN
        self.serve_reload = 0.0        # serve.reload poll period (s, 0=off)
        self.serve_models = ''         # serve.models fleet: id=dir;id=dir
        self.serve_mem_budget = 0      # serve.mem_budget bytes (0 = off)
        self.serve_replicas = 0        # serve.replicas (0/1 = one engine)
        # K staged batches per window (nnet/execution.py; 1 = per step)
        self.steps_per_dispatch = 1
        self.scan_strict = 0           # 1 = a demotion raises
        self.micro_batch = 1           # micro_batch / train.micro_batch
        # the training runtime (runtime/, doc/fault_tolerance.md)
        self.exact_ckpt = 0            # 1 = exact-resume sidecar a save
        self.fault_plan = ''           # train.fault_plan grammar
        self.supervise = 0             # train.supervise=1: TrainSupervisor
        self.watchdog_deadline = 60.0  # train.watchdog_deadline (s, 0=off)
        self.max_restarts = 3          # train.max_restarts per round
        self.nan_breaker = 3           # train.nan_breaker (consecutive NaNs)
        self.save_every = 0            # train.save_every (steps, 0=round)
        self.keep_last = 4             # train.keep_last steps kept (0=all)
        self.save_async = 0            # 1 = background checkpoint writer
        self.save_workers = 2          # leaf-write threads a save
        self._async_ckpt = None        # the lazy AsyncCheckpointer
        # train-while-serve (task=online)
        self.online_save_every = 8     # online.save_every steps a checkpoint
        self.online_freshness_slo = 0.0  # online.freshness_slo seconds
        self.online_freshness_strict = 0  # online.freshness_strict 1=raise
        self.online_reload = 0.05      # online.reload registry poll (s)
        self.online_qps = 50.0         # online.qps traffic driver rate
        self._sup_iter = None          # the supervised round's iterator
        # telemetry (obs/, JAX main.py:142-163)
        self.obs_port = -1             # obs.port: -1 off, 0 ephemeral
        self.obs_trace_export = ''     # obs.trace_export Chrome-trace path
        self.obs_ring_events = 4096    # obs.ring_events flight recorder
        self.obs_dump_dir = ''         # obs.dump_dir ('' = model_dir/flight)
        self.obs_sample_every = 0.0    # obs.sample_every s (0: 0.25 s when
                                       # a slo.* spec is given, else off)
        self.obs_recompile = 'warn'    # obs.recompile: warn | raise | off
        self.obs_profile = 1           # obs.profile: /profile?ms=N on
        self.obs_hbm = 1               # obs.hbm: hbm.* device gauges on
        self.slo_specs: List[ConfigEntry] = []   # slo.<name> grammar
        self._obs_server = None
        self._obs_sampler = None
        self._obs_slo = None
        self._train_stats = None       # train-mfu/steps_per_sec gauges
        self.cfg: List[ConfigEntry] = []
        self.net_trainer: Optional[NetTrainer] = None
        self.itr_train = None
        self.itr_evals = []
        self.eval_names = []
        self.itr_pred = None

    def set_param(self, name: str, val: str) -> None:
        if val == 'default':
            return
        _check_ported(name, val)
        simple = {
            'net_type': ('net_type', int),
            'reset_net_type': ('reset_net_type', int),
            'print_step': ('print_step', int),
            'continue': ('continue_training', int),
            'save_model': ('save_period', int),
            'start_counter': ('start_counter', int),
            'model_in': ('name_model_in', str),
            'model_dir': ('name_model_dir', str),
            'num_round': ('num_round', int), 'max_round': ('max_round', int),
            'silent': ('silent', int), 'task': ('task', str),
            'test_io': ('test_io', int),
            'extract_node_name': ('extract_node_name', str),
        }
        if name in simple:
            attr, typ = simple[name]
            setattr(self, attr, typ(val))
        for keys in (_SERVE_KEYS, _RUN_KEYS, _OBS_KEYS, _ONLINE_KEYS):
            if name in keys:
                attr, typ = keys[name]
                setattr(self, attr, typ(val))
        if name == 'obs.recompile' and val not in ('warn', 'raise', 'off'):
            # fails at config parse, like a malformed slo.* spec
            raise ValueError(
                f'obs.recompile must be warn|raise|off, got {val!r}')
        if name.startswith('slo.') and len(name) > 4:
            # validated here so a bad spec fails at parse; @0 is refused:
            # a per-sample spec is fed by in-process code
            # (SLOEngine.observe), and from the CLI it would read OK
            # forever
            from .obs.slo import SLOSpec
            spec = SLOSpec.parse(name[4:], val)
            if spec.window <= 0:
                raise ValueError(
                    f'{name}: @0 per-sample specs are engine-API-only '
                    f'(SLOEngine.observe); give a window > 0 seconds')
            self.slo_specs.append((name[4:], val))
        if name == 'dev':
            self.device = val
        if name == 'output_format':
            self.output_format = 1 if val == 'txt' else 0
        if name == 'task' and val in _UNPORTED_TASKS:
            raise NotPortedError(f'task={val}', _UNPORTED_TASKS[val])
        self.cfg.append((name, val))

    # --- setup ------------------------------------------------------------
    def _create_net(self) -> NetTrainer:
        if self.reset_net_type != -1:
            self.net_type = self.reset_net_type
        cfg = self.cfg
        if self.task == 'serve':
            # serving never trains: no optimizer state
            cfg = cfg + [('inference_only', '1')]
        return NetTrainer(cfg)

    def _model_path(self, counter: int) -> str:
        return os.path.join(self.name_model_dir, f'{counter:04d}.model')

    def _read_model(self, path: str) -> None:
        def read(f):
            self.net_type = int.from_bytes(f.read(4), 'little', signed=True)
            self.net_trainer = self._create_net()
            self.net_trainer.load_model(f)

        checkpoint.read_model_file(path, read)

    def _sync_latest_model(self) -> bool:
        """Adopt the newest ``<counter>.model`` at or past
        ``start_counter``.  Gap-tolerant, as the JAX CLI's scan: a
        ``task=online`` run names its files by STEP on the save cadence
        (0008, 0016, ...), so a walk of consecutive counters would stop
        at the first hole; the counter is compared by value and the file
        that matched is read (``00012.model`` resumes at round 13 as
        ``0012.model`` does) — the serving registry's own scan."""
        from .serve.registry import newest_model_file
        best = newest_model_file(self.name_model_dir)
        if best is None or best[0] < self.start_counter:
            return False
        counter = best[0]
        self._read_model(best[1])
        self.start_counter = counter + 1
        if self.exact_ckpt:
            from .nnet.sharded_ckpt import step_dir
            # exactly the loaded model's step: newer leftover sidecars
            # must not block restoring the matching one
            if os.path.isdir(step_dir(self._exact_dir(), counter)):
                self.net_trainer.load_training_state(self._exact_dir(),
                                                     counter)
                if not self.silent:
                    print(f'Init: exact optimizer state restored from '
                          f'{self._exact_dir()} step {counter}', flush=True)
            elif not self.silent:
                print(f'Init: no exact state for step {counter} — resuming '
                      f'with reset momentum (reference behavior)',
                      flush=True)
        return True

    def _load_model(self) -> None:
        stem = os.path.basename(self.name_model_in).split('.')[0]
        if stem.isdigit():
            self.start_counter = int(stem)
        self._read_model(self.name_model_in)
        self.start_counter += 1

    def _copy_model(self) -> None:
        """``task=finetune``: the conf's net, its named layers copied from
        ``model_in`` (``NetTrainer.copy_model_from``)."""
        self.net_trainer = self._create_net()

        def read(f):
            f.read(4)   # net_type prefix
            self.net_trainer.copy_model_from(f)

        checkpoint.read_model_file(self.name_model_in, read)

    def _exact_dir(self) -> str:
        return os.path.join(self.name_model_dir, 'exact_state')

    def _ckpt(self):
        """The CLI's background checkpoint writer (``save_async=1``)."""
        if self._async_ckpt is None:
            from .runtime.async_ckpt import AsyncCheckpointer
            self._async_ckpt = AsyncCheckpointer(workers=self.save_workers)
        return self._async_ckpt

    def _prune_exact(self, counter: int) -> None:
        """Only the sidecar of the newest model file is ever restored:
        drop the older ones (~3x a model's size each)."""
        import shutil

        from .nnet.sharded_ckpt import step_dir
        for old in range(counter):
            d = step_dir(self._exact_dir(), old)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    def _save_model(self) -> None:
        counter = self.start_counter
        path = self._model_path(counter)
        self.start_counter += 1
        if self.save_period == 0 or self.start_counter % self.save_period:
            return
        os.makedirs(self.name_model_dir, exist_ok=True)
        if self.save_async:
            self._save_model_async(counter, path)
            return

        def write(f):
            f.write(int(self.net_type).to_bytes(4, 'little', signed=True))
            self.net_trainer.save_model(f)

        # atomic and retried: a crash mid-save never leaves a truncated
        # file where continue=1 would load it
        checkpoint.save_model_file(path, write)
        checkpoint.write_model_digest(path)
        if self.exact_ckpt:
            self.net_trainer.save_training_state(self._exact_dir(), counter)
            self._prune_exact(counter)

    def _save_model_async(self, counter: int, path: str) -> None:
        """``save_async=1``: the round boundary only snapshots (device
        clones and the header's bytes); the blob, the model file, its
        digest and the exact sidecar are written on the background
        writer, the same bytes as the sync path.  ``task_train``
        barriers before it returns."""
        from .nnet import sharded_ckpt
        from .runtime import async_ckpt
        tr = self.net_trainer
        header = (int(self.net_type).to_bytes(4, 'little', signed=True)
                  + tr.model_header())
        net = tr.net
        # one snapshot a boundary: the exact tree carries a params copy,
        # copied to the host once for the blob and the sidecar both
        snap = (tr.snapshot_training_state() if self.exact_ckpt
                else async_ckpt.snapshot_tree(tr.params))
        exact_dir = self._exact_dir()
        ck = self._ckpt()

        def job():
            host = async_ckpt.host_tree(snap)
            params = host['params'] if self.exact_ckpt else host
            blob = checkpoint.params_to_blob(net, params)
            checkpoint.save_model_file(
                path, lambda f: NetTrainer.write_model_bytes(f, header,
                                                             blob))
            checkpoint.write_model_digest(path)
            if self.exact_ckpt:
                sharded_ckpt.save_tree_native(exact_dir, counter, host,
                                              pool=ck.io_pool)
                self._prune_exact(counter)

        ck.submit(job, step=counter, label=f'save_model:{counter:04d}')

    def _create_iterators(self) -> None:
        flag = 0
        evname = ''
        itcfg: List[ConfigEntry] = []
        defcfg: List[ConfigEntry] = []
        for name, val in self.cfg:
            if name == 'data':
                flag = 1
                continue
            if name == 'eval':
                evname = val
                flag = 2
                continue
            if name == 'pred':
                flag = 3
                self.name_pred = val
                continue
            if name == 'iter' and val == 'end':
                if flag == 0:
                    raise ValueError('wrong configuration file')
                if flag == 1 and self.task not in _PRED_ONLY:
                    if self.itr_train is not None:
                        raise ValueError('can only have one data')
                    self.itr_train = create_iterator(itcfg)
                if flag == 2 and self.task not in _PRED_ONLY:
                    self.itr_evals.append(create_iterator(itcfg))
                    self.eval_names.append(evname)
                if flag == 3 and self.task in _PRED_READERS:
                    if self.itr_pred is not None:
                        raise ValueError('only one pred section')
                    self.itr_pred = create_iterator(itcfg)
                flag = 0
                itcfg = []
                continue
            if flag == 0:
                defcfg.append((name, val))
            else:
                itcfg.append((name, val))
        for it in self._iterators():
            for name, val in defcfg:
                it.set_param(name, val)
            it.init()

    def _iterators(self):
        return ([self.itr_train] if self.itr_train else []) + \
            ([self.itr_pred] if self.itr_pred else []) + self.itr_evals

    def init(self) -> None:
        if self.task == 'serve' and self.serve_mode == 'decode':
            # the decode stack serves a TransformerLM from serve.lm, not a
            # netconfig model: no NetTrainer
            self._create_iterators()
            return
        if self.task == 'online' and self.continue_training:
            # resume a train-while-serve run: its model files are named by
            # STEP, so the newest is adopted and the publish counter
            # re-armed past it (no stale name is published again)
            if not self._sync_latest_model():
                raise RuntimeError(
                    'Init: cannot find models to continue the online run; '
                    'start fresh or specify model_in')
            self.net_trainer.sample_counter = self.start_counter - 1
            print(f'Init: continue online run from step '
                  f'{self.net_trainer.sample_counter}')
            self._create_iterators()
            return
        if self.task == 'train' and self.continue_training:
            if not self._sync_latest_model():
                raise RuntimeError(
                    'Init: cannot find models to continue training; '
                    'specify model_in instead')
            print(f'Init: Continue training from round {self.start_counter}')
            self._create_iterators()
            return
        self.continue_training = 0
        if self.name_model_in == 'NULL':
            if self.task not in ('train', 'online'):
                raise ValueError('must specify model_in if not training')
            self.net_trainer = self._create_net()
            self.net_trainer.init_model()
        elif self.task == 'finetune':
            self._copy_model()
        else:
            self._load_model()
        self._create_iterators()

    # --- tasks ------------------------------------------------------------
    def task_train(self) -> None:
        start = time.monotonic()
        if self.continue_training == 0 and self.name_model_in == 'NULL':
            self._save_model()
        else:
            for it, name in zip(self.itr_evals, self.eval_names):
                sys.stderr.write(self.net_trainer.evaluate(it, name))
            sys.stderr.write('\n')
            sys.stderr.flush()
        if self.itr_train is None:
            return
        if self.test_io:
            print('start I/O test')
        tracer = TraceWindow()
        tracer.configure(self.cfg)
        try:
            self._train_rounds(tracer, start)
        finally:
            tracer.stop()
            if self._async_ckpt is not None:
                # the final save always barriers: a deferred write error
                # surfaces here, and the newest model file is durable
                # before the CLI returns
                try:
                    self._async_ckpt.wait()
                finally:
                    self._async_ckpt.close(wait=False)
                    self._async_ckpt = None

    def _train_rounds(self, tracer, start: float) -> None:
        sup = None
        if self.supervise and self.test_io == 0:
            sup = self._make_supervisor()
        # one plan a run: profile_dir and test_io demote statically,
        # extra_data a round
        plan = ExecutionPlan.resolve(
            requested_k=self.steps_per_dispatch,
            profiling=tracer.enabled, test_io=bool(self.test_io),
            strict=bool(self.scan_strict), silent=bool(self.silent))
        batch_counter = 0
        try:
            cc = self.max_round
            while self.start_counter <= self.num_round and cc > 0:
                cc -= 1
                if not self.silent:
                    print(f'update round {self.start_counter - 1}',
                          flush=True)
                self.net_trainer.start_round(self.start_counter)
                t_round = time.monotonic()
                if sup is not None:
                    n = self._supervised_round(sup, plan, tracer,
                                               batch_counter, start)
                else:
                    n = self._round(plan, tracer, batch_counter, start)
                batch_counter += n
                dt_round = time.monotonic() - t_round
                self.net_trainer.flush_divergence_check()
                if self.test_io == 0:
                    sys.stderr.write(f'[{self.start_counter}]')
                    if not self.itr_evals:
                        sys.stderr.write(
                            self.net_trainer.evaluate(None, 'train'))
                    for it, name in zip(self.itr_evals, self.eval_names):
                        sys.stderr.write(self.net_trainer.evaluate(it, name))
                    self._write_io_stats()
                    sys.stderr.write('\n')
                    self._write_train_speed(n, dt_round)
                    sys.stderr.flush()
                self._save_model()
        finally:
            if sup is not None:
                sup.close()
        if not self.silent:
            print(f'\nupdating end, {int(time.monotonic() - start)} sec in all')

    def _progress(self, sample_counter: int, start: float) -> None:
        if sample_counter % self.print_step == 0 and not self.silent:
            print(f'round {self.start_counter - 1:8d}:'
                  f'[{sample_counter:8d}] '
                  f'{int(time.monotonic() - start)} sec elapsed', flush=True)

    def _round(self, plan, tracer, batch_counter: int, start: float) -> int:
        """One round's batches through the plan's ``WindowedStepper``
        (JAX ``_round``): at K=1 the next batch's copy is enqueued before
        the current step runs; at K>1 a window of K staged batches runs
        at once, and the round's tail runs per step.  The trace window
        sees each dispatch's run-wide update index.  Returns the updates
        run."""
        stepper = plan.round_stepper(
            self.net_trainer,
            before_dispatch=lambda u: tracer.before_update(batch_counter + u))
        sample_counter = 0
        for batch in self.itr_train:
            if self.test_io == 0:
                stepper.feed(batch)
            sample_counter += 1
            self._progress(sample_counter, start)
        stepper.finish()
        return stepper.updates

    def _make_supervisor(self):
        """The round supervisor (``train.supervise=1``).  It brings its own
        watchdog ``ThreadBuffer``, so a conf's ``iter = threadbuffer``
        stage is unwrapped (two producers would both count the 'batch'
        fault scope); a chain that reshuffles a pass is noted, since its
        replay is not bitwise."""
        from .io.data import ThreadBufferIterator
        from .runtime import faults
        from .runtime.supervisor import SupervisorConfig, TrainSupervisor
        self._sup_iter = self.itr_train
        if isinstance(self._sup_iter, ThreadBufferIterator):
            self._sup_iter = self._sup_iter.base
        if self._sup_iter is not None \
                and not self._sup_iter.is_replay_stable():
            msg = ('train iterator reshuffles per pass (shuffle=1): '
                   'recovery restores exact params, but the replayed '
                   'pass draws a fresh permutation — the run is NOT '
                   'bitwise-identical to an uninterrupted one')
            faults.global_failure_log().record('replay_unstable', msg)
            if not self.silent:
                print(f'TrainSupervisor: {msg}', flush=True)
        cfg = SupervisorConfig(
            batch_deadline=self.watchdog_deadline or None,
            max_restarts=self.max_restarts,
            nan_breaker=self.nan_breaker,
            save_every=self.save_every,
            keep_last=self.keep_last,
            save_async=self.save_async,
            save_workers=self.save_workers,
            pipeline_stats=(None if self._sup_iter is None
                            else self._sup_iter.pipeline_stats()))
        return TrainSupervisor(
            self.net_trainer,
            os.path.join(self.name_model_dir, 'supervised_state'), cfg)

    def _supervised_round(self, sup, plan, tracer, batch_counter: int,
                          start: float) -> int:
        """One round under the supervisor: ``batch_factory(k)`` re-winds a
        fresh pass to batch k (k counts dispatched steps, so recovery
        composes with the K-step window: a fault mid-window abandons the
        staged batches); the per-step path dispatches at once
        (``lookahead=0``)."""
        import itertools
        it = self._sup_iter

        def factory(k):
            return itertools.islice(iter(it), k, None)

        def before_step(i):
            # the unsupervised loop's progress and trace cadence
            tracer.before_update(batch_counter + i)
            self._progress(i + 1, start)

        return sup.run(
            factory, before_step=before_step,
            make_stepper=lambda: plan.round_stepper(self.net_trainer,
                                                    lookahead=0))

    def _write_io_stats(self) -> None:
        """An instrumented train chain's (``nworker``) per-stage stats join
        the round's eval line as ``\\tio-key:value``, then reset, so each
        round reports its own pass (one atomic drain)."""
        stats = None if self.itr_train is None \
            else self.itr_train.pipeline_stats()
        if stats is not None:
            sys.stderr.write(stats.print_and_clear('io'))

    def _write_train_speed(self, n: int, dt: float) -> None:
        """The round's ``train-steps_per_sec``, ``train-flops_per_step``
        (the ledger's products a step) and, where the card's peak is
        known, ``train-mfu``, on a stderr line of their own right under
        the eval line: eval lines are compared byte for byte across runs
        (the K-step and supervised CLI twins), and wall-clock numbers
        never ride them.  The same gauges serve on ``/metrics`` (the
        ``train`` StatSet), so an SLO can read them."""
        if n <= 0 or dt <= 0:
            return
        from .obs import get_hub
        from .obs.programs import mfu
        if self._train_stats is None:
            from .utils.metric import StatSet
            self._train_stats = StatSet()
            get_hub().register_stats('train', self._train_stats)
        st = self._train_stats
        sps = n / dt
        st.gauge('steps_per_sec', round(sps, 3))
        flops = self.net_trainer.train_step_flops()
        if flops > 0:
            st.gauge('flops_per_step', flops)
        m = mfu(flops, sps, self.net_trainer.device)
        if m is not None:
            st.gauge('mfu', round(m, 5))
        sys.stderr.write(st.print('train').lstrip('\t') + '\n')

    # --- telemetry (obs/) -------------------------------------------------
    def _obs_start(self) -> None:
        """Arm the telemetry hub for this run (JAX ``_obs_start``): the
        flight recorder's ring, its fault-triggered dumps and SIGUSR1 are
        always armed; the program ledger joins the hub, and the ``hbm.*``
        gauges with ``obs.hbm=1``; a ``slo.`` spec (or
        ``obs.sample_every``) starts the gauge sampler and the SLO engine;
        ``obs.port >= 0`` starts the endpoint thread."""
        from .obs import get_hub
        from .obs import programs as obs_programs
        hub = get_hub()
        if self.obs_ring_events > 0:
            hub.set_ring(self.obs_ring_events)
        dump_dir = self.obs_dump_dir or os.path.join(self.name_model_dir,
                                                     'flight')
        hub.arm_flight_recorder(dump_dir)
        hub.arm_signal_dump()
        ledger = obs_programs.get_ledger()
        ledger.set_recompile(self.obs_recompile)
        ledger.register_into(hub)
        if self.obs_hbm:
            obs_programs.register_hbm(hub)
        if self.slo_specs or self.obs_sample_every > 0:
            from .obs.history import GaugeSampler, hub_source
            # <= 0 means the 0.25 s default cadence, never a clamped
            # 100 Hz
            self._obs_sampler = GaugeSampler(
                hub_source(hub),
                period=(self.obs_sample_every
                        if self.obs_sample_every > 0 else 0.25))
            if self.slo_specs:
                from .obs.slo import SLOEngine, SLOSpec
                self._obs_slo = SLOEngine(self._obs_sampler.history)
                for spec_name, text in self.slo_specs:
                    self._obs_slo.add(SLOSpec.parse(spec_name, text))
                self._obs_slo.register_into(hub)
                self._obs_sampler.add_listener(self._obs_slo.on_tick)
            self._obs_sampler.start()
        if self.obs_port >= 0:
            from .obs.endpoints import ObsServer
            self._obs_server = ObsServer(
                hub, port=self.obs_port,
                port_file=os.environ.get('CXXNET_OBS_PORT_FILE'),
                profile_dir=(os.path.join(dump_dir, 'profile')
                             if self.obs_profile else None))
            routes = '/metrics /statusz /healthz /slos /programs'
            if self.obs_profile:
                routes += ' /profile'
            print(f'obs: telemetry on http://127.0.0.1:'
                  f'{self._obs_server.port} ({routes}), flight dumps in '
                  f'{dump_dir}', flush=True)

    def _obs_register_iterators(self) -> None:
        """An instrumented train chain's stats join the hub, so they serve
        on ``/metrics`` beside the eval line."""
        stats = None if self.itr_train is None \
            else self.itr_train.pipeline_stats()
        if stats is not None:
            from .obs import get_hub
            get_hub().register_stats('io', stats)

    def _obs_stop(self) -> None:
        from .obs import get_hub
        hub = get_hub()
        if self.obs_trace_export:
            path = hub.export_chrome_trace(self.obs_trace_export)
            if not self.silent:
                print(f'obs: Chrome trace exported to {path} (load it in '
                      'Perfetto)', flush=True)
        if self._obs_sampler is not None:
            self._obs_sampler.close(timeout=5.0)
            self._obs_sampler = None
        if self._obs_slo is not None:
            if not self.silent:
                from .obs.slo import summary_lines
                for line in summary_lines(self._obs_slo.status_view()):
                    print(f'obs: {line}', flush=True)
            self._obs_slo.close()
            self._obs_slo = None
        if self._obs_server is not None:
            self._obs_server.close(timeout=5.0)
            self._obs_server = None
        hub.disarm()

    def task_predict(self) -> None:
        if self.itr_pred is None:
            raise ValueError('must specify a pred iterator')
        print('start predicting...')
        with open(self.name_pred, 'w') as fo:
            for pred in self.net_trainer.predict_stream(self.itr_pred):
                for v in pred:
                    fo.write(f'{v:g}\n')
        print(f'finished prediction, write into {self.name_pred}')

    def task_predict_raw(self) -> None:
        """``task=pred_raw``: the last node's scores per instance, one
        space-separated ``%g`` line each (the format kaggle_bowl's
        ``make_submission.py`` reads)."""
        if self.itr_pred is None:
            raise ValueError('must specify a pred iterator')
        print('start predicting (raw scores)...')
        tr = self.net_trainer
        with open(self.name_pred, 'w') as fo:
            for out in tr.forward_stream(self.itr_pred,
                                         tr.net.node_index('top[-1]')):
                for row in out.reshape(out.shape[0], -1):
                    fo.write(' '.join(f'{v:g}' for v in row) + '\n')
        print(f'finished prediction, write into {self.name_pred}')

    def task_extract(self) -> None:
        """``task=extract``: node ``extract_node_name`` per instance, as
        ``%g`` text rows or raw little-endian float32."""
        import numpy as np
        if self.itr_pred is None:
            raise ValueError('must specify a pred iterator')
        node = self.extract_node_name or 'top[-1]'
        print(f'start extracting feature from {node}...')
        tr = self.net_trainer
        out = np.concatenate(list(tr.forward_stream(
            self.itr_pred, tr.net.node_index(node))), axis=0)
        if self.output_format == 1:
            np.savetxt(self.name_pred, out.reshape(out.shape[0], -1), '%g')
        else:
            out.astype('<f4').tofile(self.name_pred)
        print(f'finished extract, write into {self.name_pred}')

    def task_serve(self) -> None:
        """``task=serve`` in predict mode: the ``pred=`` section driven
        through the serving stack (``serve/``) as a fronting server would
        drive it: a bucketed ``PredictEngine`` (``serve.replicas`` >= 2:
        a ``ReplicatedPredictEngine``) warmed on every bucket and a
        ``DynamicBatcher``; ``serve.reload`` hot-reloads newer
        checkpoints of ``model_dir`` and ``serve.models`` stands a fleet
        up beside it.  Each batch's real rows go in as one request,
        normalized on the host (the serving wire contract: float rows),
        with up to half the admission queue in flight; the answers are
        drained in order, so the file matches ``task=pred``'s.  The
        batcher's (and the registry's and the fleet's) counters go to
        stderr."""
        import collections

        import numpy as np

        from .serve import (DynamicBatcher, ModelRegistry, PredictEngine,
                            ReplicatedPredictEngine)
        from .utils.bucketing import parse_buckets
        from .utils.metric import StatSet
        if self.itr_pred is None:
            raise ValueError('must specify a pred iterator')
        if self.serve_replicas >= 2:
            # replicas behind ONE batcher; completion is engine-owned, so
            # they count into the batcher's StatSet
            engine = ReplicatedPredictEngine(
                self.net_trainer, parse_buckets(self.serve_buckets),
                dtype=self.serve_dtype, replicas=self.serve_replicas,
                stats=StatSet(), fold_bn=self.serve_fold_bn)
        else:
            engine = PredictEngine(self.net_trainer,
                                   parse_buckets(self.serve_buckets),
                                   dtype=self.serve_dtype,
                                   fold_bn=self.serve_fold_bn)
        engine.warm()
        if not self.silent:
            nrep = getattr(engine, 'engines', None)
            print(f'serve: warmed {len(engine.buckets)} bucket programs '
                  f'{engine.buckets} (dtype={self.serve_dtype}, '
                  f'{engine.resident_bytes()} resident bytes'
                  + (f', {len(nrep)} replicas' if nrep else '') + ')',
                  flush=True)
            fv = getattr(engine, 'fold_view', lambda: None)()
            if fv:
                pairs = ','.join(f'{c}+{b}' for c, b in fv['pairs'])
                print(f'serve: folded {len(fv["pairs"])} conv+BN pair(s) '
                      f'[{pairs}] — proof max_abs_err '
                      f'{fv["max_abs_err"]:.3g} on the calibration batch',
                      flush=True)
        batcher = DynamicBatcher(engine, max_queue=self.serve_max_queue,
                                 max_wait=self.serve_max_wait,
                                 deadline=self.serve_deadline,
                                 stats=getattr(engine, 'stats', None))
        registry = None
        if self.serve_reload > 0:
            registry = ModelRegistry(
                engine, self.name_model_dir,
                poll_interval=self.serve_reload,
                current=self.start_counter - 1,
                on_swap=None if self.silent else (
                    lambda c, p: print(f'serve: hot-reloaded checkpoint '
                                       f'{c} from {p}', flush=True)))
            registry.start()
        # live telemetry: the batcher's gauges (the live queue depth
        # folded in per render) on /metrics, the registry's state machine
        # on /statusz, the fleet's budget ledger
        from .obs import get_hub
        hub = get_hub()
        batcher.register_into(hub)
        if registry is not None:
            registry.register_into(hub)
        fleet = self._serve_fleet()
        if fleet is not None:
            from .utils.metric import StatSet
            fleet_stats = StatSet()
            hub.register_stats(
                'fleet', fleet_stats,
                refresh=lambda: fleet.report(stats=fleet_stats))
            for mid in fleet.models():
                try:
                    fleet.get(mid)       # the budgeter decides who stays
                except Exception as e:  # noqa: BLE001 — printed; loads on demand
                    print(f'serve: fleet model {mid!r} not loaded: {e}',
                          flush=True)
            if not self.silent:
                print(f'serve: fleet of {len(fleet.models())} models, '
                      f'{len(fleet.loaded())} resident under '
                      f'{self.serve_mem_budget or "unbounded"} bytes',
                      flush=True)
        print('start serving...')
        served = 0
        try:
            with open(self.name_pred, 'w') as fo:
                pending = collections.deque()
                cap = max(1, self.serve_max_queue // 2)
                # a bulk request sits behind up to `cap` others by design:
                # the live per-request deadline would expire in this
                # drive's own queue, so the bound grows with the queue
                bulk_deadline = max(self.serve_deadline, 60.0 + 30.0 * cap)

                def drain_one():
                    for v in NetTrainer._pred_transform(
                            batcher.wait(pending.popleft())):
                        fo.write(f'{v:g}\n')

                for batch in self.itr_pred:
                    n = batch.batch_size - batch.num_batch_padd
                    if not n:
                        continue
                    data = batch.data
                    if batch.norm_spec is not None:
                        data = batch.norm_spec.apply(data)
                    rows = np.ascontiguousarray(
                        np.asarray(data, np.float32)[:n])
                    pending.append(batcher.submit_async(
                        rows, deadline=bulk_deadline))
                    served += n
                    while len(pending) >= cap:
                        drain_one()
                while pending:
                    drain_one()
        finally:
            if registry is not None:
                registry.close(timeout=5.0)
            batcher.close(timeout=30.0)
            if hasattr(engine, 'close'):        # the replicas' workers
                engine.close(timeout=10.0)
            sys.stderr.write(f'[serve]{batcher.report("serve")}\n')
            if registry is not None:
                # swap stamps: which checkpoint serves and how stale it is
                sys.stderr.write(f'[serve]{registry.report()}\n')
            if fleet is not None:
                sys.stderr.write(f'[serve]{fleet.report()}\n')
                fleet.close(timeout=5.0)
            sys.stderr.flush()
        print(f'finished serving {served} instances, predictions in '
              f'{self.name_pred} (compiled {engine.compile_count} programs '
              f'for {len(engine.buckets)} buckets)')

    def task_online(self) -> None:
        """``task=online``: the train-while-serve loop (``online/``) — a
        supervised trainer over the ``data=`` section (idiomatically
        ``iter = imgbin_stream``) publishing a serving checkpoint every
        ``online.save_every`` steps, while the colocated engine, batcher
        and registry hot-reload them under the ``pred=`` section's rows
        replayed at ``online.qps``.  Each round's eval line carries the
        freshness gauges; the serving counters and a one-line JSON
        summary print at the end."""
        import json

        import numpy as np

        from .online import OnlineConfig, OnlinePipeline
        from .utils.bucketing import parse_buckets
        if self.itr_train is None:
            raise ValueError('task=online needs a data section')
        request_source = None
        if self.itr_pred is not None:
            # the pred section's (normalized) rows replayed cyclically:
            # the CLI's stand-in for a fronting server's live traffic
            rows_pool = []
            for batch in self.itr_pred:
                n = batch.batch_size - batch.num_batch_padd
                if not n:
                    continue
                data = batch.data
                if batch.norm_spec is not None:
                    data = batch.norm_spec.apply(data)
                rows_pool.append(np.ascontiguousarray(
                    np.asarray(data, np.float32)[:n]))
            if rows_pool:
                state = {'i': 0}

                def request_source():
                    r = rows_pool[state['i'] % len(rows_pool)]
                    state['i'] += 1
                    return r
        # online runs publish asynchronously unless the conf says
        # otherwise: the step loop should never wait on storage
        save_async = self.save_async
        if not any(k == 'save_async' for k, _ in self.cfg):
            save_async = 1
        cfg = OnlineConfig(
            model_dir=self.name_model_dir,
            save_every=self.online_save_every,
            save_workers=self.save_workers,
            freshness_slo=self.online_freshness_slo,
            freshness_strict=bool(self.online_freshness_strict),
            reload_poll=self.online_reload,
            buckets=parse_buckets(self.serve_buckets),
            max_queue=self.serve_max_queue,
            max_wait=self.serve_max_wait,
            deadline=self.serve_deadline,
            dtype=self.serve_dtype,
            qps=self.online_qps,
            watchdog_deadline=self.watchdog_deadline or None,
            max_restarts=self.max_restarts,
            nan_breaker=self.nan_breaker,
            keep_last=self.keep_last,
            save_async=save_async,
            steps_per_dispatch=self.steps_per_dispatch,
            net_type=self.net_type,
            silent=bool(self.silent))
        pipe = OnlinePipeline(
            self.net_trainer, self.itr_train,
            lambda: NetTrainer(self.cfg + [('inference_only', '1')]), cfg,
            request_source=request_source)
        print('start online training-while-serving...')
        start = time.monotonic()
        try:
            summary = pipe.run(
                num_rounds=self.num_round,
                evals=list(zip(self.itr_evals, self.eval_names)),
                before_step=lambda i: self._progress(i + 1, start))
            sys.stderr.write(f'[online]{pipe.serve_report()}\n')
            sys.stderr.flush()
            print(f'online summary: {json.dumps(summary, sort_keys=True)}',
                  flush=True)
        finally:
            pipe.close(timeout=30.0)
        print(f'finished online run, '
              f'{int(time.monotonic() - start)} sec in all')

    def _serve_fleet(self):
        """``serve.models=id=dir;id=dir``: checkpoints of the conf's
        architecture in a ``MultiModelRegistry`` under
        ``serve.mem_budget`` bytes, each loaded by a factory that builds
        its own trainer (``serve.registry.fleet_factory``, which drops
        the trainer's f32 tree once the engine holds its placement); the
        fleet, or None."""
        if not self.serve_models:
            return None
        from .serve import MultiModelRegistry
        from .serve.registry import fleet_factory
        from .utils.bucketing import parse_buckets
        from .utils.config import parse_kv_list

        fleet = MultiModelRegistry(mem_budget=self.serve_mem_budget,
                                   poll_interval=self.serve_reload or 1.0)
        buckets = parse_buckets(self.serve_buckets)
        for mid, mdir in parse_kv_list(self.serve_models):
            fleet.add_model(mid, fleet_factory(self._create_net, mdir,
                                               buckets, self.serve_dtype),
                            model_dir=mdir)
        if self.serve_reload > 0:
            fleet.start()
        return fleet

    def _parse_lm_spec(self, spec: str, model_in: str = 'NULL',
                       seed: int = 0, default_vocab=None):
        """A TransformerLM ``(params, cfg)`` from a compact ``k=v[;k=v]``
        spec (vocab, d_model, heads, d_ff, stages, experts, seq, plus
        inline ``model_in=`` / ``seed=``); params from a ``%04d.lm`` file
        or a seeded init.  Shared by ``serve.lm`` and ``serve.draft``
        (whose vocab defaults to the target's)."""
        import numpy as np

        from .models import transformer as TT
        from .utils.config import parse_kv_list
        kw = {'attn': 'local'}
        if default_vocab is not None:
            kw['vocab_size'] = int(default_vocab)
        names = {'vocab': ('vocab_size', int), 'd_model': ('d_model', int),
                 'heads': ('num_heads', int), 'd_ff': ('d_ff', int),
                 'stages': ('num_stages', int), 'seq': ('seq_len', int),
                 'experts': ('num_experts', int)}
        for key, val in parse_kv_list(spec or ''):
            if key == 'model_in':
                model_in = val
            elif key == 'seed':
                seed = int(val)
            elif key in names:
                attr, typ = names[key]
                kw[attr] = typ(val)
            else:
                raise ValueError(f'unknown lm spec key: {key!r}')
        cfg = TT.TransformerConfig(**kw)
        TT.check_config(cfg)
        if model_in != 'NULL':
            from .serve.decode import load_lm_params
            params = load_lm_params(model_in)
        else:
            params = TT.init_params(np.random.RandomState(seed), cfg)
        return params, cfg

    def task_serve_decode(self) -> None:
        """``task=serve serve.mode=decode``: the continuous-batching decode
        stack driven over seeded synthetic prompts of mixed lengths.  The
        token streams land in ``pred=``'s file (one space-separated line
        per request, in arrival order); the first three are checked
        against offline ``transformer.generate`` twins and the stats go
        to stderr at shutdown."""
        import numpy as np

        from .models import transformer as TT
        from .serve.decode import DecodeService

        predict_only = [k for k, on in (
            ('serve.reload', self.serve_reload > 0),
            ('serve.models', bool(self.serve_models)),
            ('serve.mem_budget', self.serve_mem_budget != 0),
            ('serve.replicas', self.serve_replicas >= 2)) if on]
        if predict_only:
            # the JAX CLI reads these keys in decode mode and ignores
            # them; the port ignores nothing silently
            raise ValueError(f'{", ".join(predict_only)} apply to '
                             'serve.mode=predict only')
        params, cfg = self._parse_lm_spec(self.serve_lm,
                                          model_in=self.serve_lm_model_in,
                                          seed=self.serve_lm_seed)
        draft = None
        if self.serve_draft:
            draft = self._parse_lm_spec(self.serve_draft,
                                        default_vocab=cfg.vocab_size)
        eos = None if self.serve_eos < 0 else self.serve_eos
        svc = DecodeService(
            params, cfg, slots=self.serve_slots, pages=self.serve_pages,
            page_size=self.serve_page_size,
            max_prompt=self.serve_max_prompt,
            max_new_bound=self.serve_max_new, eos_id=eos,
            max_queue=self.serve_max_queue, max_wait=self.serve_max_wait,
            # bulk drive: throughput-bound, not latency-bound
            deadline=max(self.serve_deadline, 60.0),
            dtype=self.serve_dtype, flash_decode=self.serve_flash,
            prefix_share=self.serve_prefix_share,
            spec_k=self.serve_spec_k, draft=draft,
            kv_host_mb=self.serve_kv_host_mb,
            kv_disk_mb=self.serve_kv_disk_mb,
            kv_dir=self.serve_kv_dir or None,
            kv_share_dir=self.serve_kv_share_dir or None,
            prefill_workers=self.serve_prefill_workers, device=self.device)
        from .obs import get_hub
        svc.register_into(get_hub())
        eng = svc.engine
        if not self.silent:
            print(f'serve: decode engine up — {self.serve_slots} slots, '
                  f'{self.serve_pages}x{self.serve_page_size}-token KV '
                  f'pages (slot cache {eng.cache_len}, '
                  f'dtype={eng.serve_dtype}, device={eng.device}, '
                  f'attention={"flash" if eng.use_flash else "gather"}, '
                  f'prefix_share={self.serve_prefix_share}, '
                  f'spec_k={eng._spec_k}'
                  + (f', prefill_workers={self.serve_prefill_workers}'
                     if self.serve_prefill_workers else '')
                  + ')', flush=True)
        print('start serving (decode)...')
        rng = np.random.RandomState(self.serve_seed)
        n_req = max(1, self.serve_requests)
        prompts = [rng.randint(
            0, cfg.vocab_size,
            (1, int(rng.randint(1, max(2, self.serve_max_prompt)))))
            .astype(np.int32) for _ in range(n_req)]
        temp = float(self.serve_temperature)
        seeds = [None] * n_req
        if temp > 0:
            seeds = [self.serve_seed * 100003 + i for i in range(n_req)]
        served = 0
        try:
            reqs = [svc.submit_async(p, self.serve_max_new, temp, k)
                    for p, k in zip(prompts, seeds)]
            with open(self.name_pred, 'w') as fo:
                for r in reqs:
                    toks = svc.batcher.wait(r)
                    fo.write(' '.join(str(int(t)) for t in toks) + '\n')
                    served += 1
            # twin check: each stream equals its offline generate call
            # over the engine's own tree and attention leg
            checked = 0
            for i in range(min(3, n_req)):
                off = TT.generate(eng.params, prompts[i], self.serve_max_new,
                                  eng.cfg, temperature=temp, rng=seeds[i],
                                  eos_id=eos, flash=eng.use_flash)[0]
                got = reqs[i].result
                if not (np.asarray(got) == off[:len(got)]).all():
                    raise AssertionError(
                        f'decode stream {i} diverged from its offline '
                        f'generate twin: {got} vs {off}')
                checked += 1
            if not self.silent:
                print(f'decode twin check: {checked} streams equal their '
                      'offline generate calls', flush=True)
        finally:
            sys.stderr.write(f'[serve]{svc.report("decode")}\n')
            sys.stderr.flush()
            svc.close(30.0)
        print(f'finished serving {served} decode streams, token ids in '
              f'{self.name_pred}')

    def run(self, argv: List[str]) -> int:
        if not argv:
            print('Usage: <config> [k=v ...]')
            return 0
        cfg = apply_cli_overrides(parse_config_file(argv[0]), argv[1:])
        # a later pair of the same key wins (the reference replays CLI
        # pairs after the file); dev= resolves its device at once, so
        # only the last dev= of the run is replayed
        last_dev = max((i for i, (k, _) in enumerate(cfg) if k == 'dev'),
                       default=-1)
        for i, (name, val) in enumerate(cfg):
            if name == 'dev' and i != last_dev:
                continue
            self.set_param(name, val)
        _check_world_env(self.cfg)
        from .runtime import faults
        prev_plan = None
        if self.fault_plan:
            # deterministic fault injection: the plan drives the hooks
            # real faults take
            plan = faults.FaultPlan.parse(self.fault_plan)
            prev_plan = faults.install_plan(plan)
            if not self.silent:
                print(f'fault plan armed: {plan.describe()}', flush=True)
        self._obs_start()
        try:
            self.init()
            self._obs_register_iterators()
            if not self.silent:
                print('initializing end, start working')
            if self.task in ('train', 'finetune'):
                self.task_train()
            elif self.task == 'pred':
                self.task_predict()
            elif self.task == 'pred_raw':
                self.task_predict_raw()
            elif self.task == 'extract':
                self.task_extract()
            elif self.task == 'serve' and self.serve_mode == 'decode':
                self.task_serve_decode()
            elif self.task == 'serve':
                self.task_serve()
            elif self.task == 'online':
                self.task_online()
            else:
                raise ValueError(f'unknown task {self.task}')
        finally:
            for it in self._iterators():
                it.close(timeout=5.0)
            self._obs_stop()
            if self.fault_plan:
                faults.install_plan(prev_plan)
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    return LearnTask().run(argv if argv is not None else sys.argv[1:])


if __name__ == '__main__':
    sys.exit(main())
