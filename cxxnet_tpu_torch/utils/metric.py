"""Evaluation metrics and runtime counters.

The port's own copy of ``cxxnet_tpu/utils/metric.py`` (numpy only):

* ``Metric`` / ``MetricSet`` — the reference's model-quality metrics
  (``src/utils/metric.h:20-236``): ``error`` (argmax mismatch;
  threshold at 0 for a single score column), ``rmse`` (the mean squared
  sum, no square root, as the reference reports), ``logloss`` (clipped to
  [1e-15, 1-1e-15]) and ``rec@n``; ``MetricSet`` binds each to a label
  field (``metric[field] = name``) and prints
  ``\\tevname-metric[field]:value`` like the reference's ``Print``.
* ``StatSet`` — thread-safe runtime counters and distributions, in the
  same eval-line format, rendered by the telemetry hub's one formatter
  (``obs/hub.format_report``), so the eval line, ``/metrics`` and the
  gauge history spell every key alike.

Metrics are computed on the host: they are an observability surface,
not a device path.
"""

from __future__ import annotations

import threading

import numpy as np


class Metric:
    """Accumulating metric over (predscore, label) instance batches."""

    def __init__(self, name: str):
        self.name = name
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def clear(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def add_eval(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred: (n, k) score matrix; label: (n, m) label fields."""
        pred = np.asarray(pred, dtype=np.float64)
        label = np.asarray(label, dtype=np.float64)
        if pred.shape[0] == 0:
            return
        self.sum_metric += float(np.sum(self._calc(pred, label)))
        self.cnt_inst += pred.shape[0]

    def get(self) -> float:
        return self.sum_metric / max(self.cnt_inst, 1)

    def _calc(self, pred: np.ndarray, label: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class MetricRMSE(Metric):
    def __init__(self):
        super().__init__('rmse')

    def _calc(self, pred, label):
        if pred.shape[1] != label.shape[1]:
            raise ValueError('rmse: pred and label width must match')
        return np.sum((pred - label) ** 2, axis=1)


class MetricError(Metric):
    def __init__(self):
        super().__init__('error')

    def _calc(self, pred, label):
        if pred.shape[1] != 1:
            maxidx = np.argmax(pred, axis=1)
        else:
            maxidx = (pred[:, 0] > 0.0).astype(np.int64)
        return (maxidx != label[:, 0].astype(np.int64)).astype(np.float64)


class MetricLogloss(Metric):
    def __init__(self):
        super().__init__('logloss')

    def _calc(self, pred, label):
        eps = 1e-15
        if pred.shape[1] != 1:
            target = label[:, 0].astype(np.int64)
            p = np.clip(pred[np.arange(pred.shape[0]), target], eps,
                        1.0 - eps)
            return -np.log(p)
        py = np.clip(pred[:, 0], eps, 1.0 - eps)
        y = label[:, 0]
        res = -(y * np.log(py) + (1.0 - y) * np.log(1.0 - py))
        if np.any(np.isnan(res)):
            raise FloatingPointError('logloss: NaN detected!')
        return res


class MetricRecall(Metric):
    """rec@n: fraction of true labels present in the top-n scores."""

    def __init__(self, name: str):
        super().__init__(name)
        if not name.startswith('rec@'):
            raise ValueError('must specify n for rec@n')
        self.topn = int(name[4:])

    def _calc(self, pred, label):
        n = self.topn
        if pred.shape[1] < n:
            raise ValueError(
                f'rec@{n} meaningless for score list of length '
                f'{pred.shape[1]}')
        # top-n indices per row (ties broken arbitrarily, as the
        # reference's shuffle-then-sort randomizes tie order)
        topidx = np.argpartition(-pred, n - 1, axis=1)[:, :n]
        hits = np.zeros(pred.shape[0], dtype=np.float64)
        for j in range(label.shape[1]):
            hits += np.any(topidx == label[:, j:j + 1].astype(np.int64),
                           axis=1)
        return hits / label.shape[1]


def create_metric(name: str) -> Metric | None:
    if name == 'rmse':
        return MetricRMSE()
    if name == 'error':
        return MetricError()
    if name == 'logloss':
        return MetricLogloss()
    if name.startswith('rec@'):
        return MetricRecall(name)
    return None


class StatSet:
    """Thread-safe counters and sample distributions, keyed by name.

    * ``inc(name, v)`` — monotone counter,
    * ``gauge(name, v)`` / ``peak(name, v)`` — last-value / max-value,
    * ``observe(name, v)`` — sample a distribution; :meth:`print`
      expands it into ``name.p50 / name.p99 / name.mean / name.n``
      (exact quantiles over the newest ``max_samples`` samples).
    """

    def __init__(self, max_samples: int = 100_000):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}       # guarded-by: _lock
        self._samples: dict[str, list[float]] = {}  # guarded-by: _lock
        self._max_samples = int(max_samples)

    def inc(self, name: str, v: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + v

    def gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._counters[name] = float(v)

    def peak(self, name: str, v: float) -> None:
        with self._lock:
            if v > self._counters.get(name, float('-inf')):
                self._counters[name] = float(v)

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            s = self._samples.setdefault(name, [])
            s.append(float(v))
            if len(s) > self._max_samples:
                del s[:len(s) - self._max_samples]

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def clear(self) -> None:
        """Reset every counter and distribution.  A ``print()`` then
        ``clear()`` pair loses an update that lands between the two lock
        holds: per-round reporting from a live pipeline goes through
        :meth:`drain` / :meth:`print_and_clear`."""
        with self._lock:
            self._counters.clear()
            self._samples.clear()

    def snapshot(self) -> tuple:
        """Consistent ``(counters, samples)`` copies under one lock hold:
        the read every renderer (eval line, ``/metrics``, ``/statusz``,
        flight dumps) goes through."""
        with self._lock:
            return (dict(self._counters),
                    {k: list(v) for k, v in self._samples.items() if v})

    def tail_view(self, tail: int) -> tuple:
        """The bounded read of the gauge sampler: the counters and, per
        distribution, ``(newest tail samples, total retained count)``,
        under one lock hold, O(tail) a distribution."""
        with self._lock:
            return (dict(self._counters),
                    {k: (v[-tail:], len(v))
                     for k, v in self._samples.items() if v})

    def drain(self) -> tuple:
        """Atomic snapshot-and-reset: returns ``(counters, samples)`` and
        leaves the set empty, under ONE lock hold, so an update racing
        the drain lands in the returned epoch or the next, never
        nowhere."""
        with self._lock:
            counters, self._counters = self._counters, {}
            samples, self._samples = self._samples, {}
            return counters, {k: v for k, v in samples.items() if v}

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            s = list(self._samples.get(name, ()))
        if not s:
            return float('nan')
        return float(np.quantile(np.asarray(s), q))

    def print(self, prefix: str) -> str:
        from ..obs.hub import format_report
        return format_report(prefix, self)

    def print_and_clear(self, prefix: str) -> str:
        """Render one epoch's stats and reset atomically (see
        :meth:`drain`): the CLI's per-round ``io-`` line."""
        from ..obs.hub import format_report_parts
        return format_report_parts(prefix, *self.drain())


class MetricSet:
    """A list of metrics, each bound to a label field name."""

    def __init__(self):
        self.evals: list[Metric] = []
        self.label_fields: list[str] = []

    def add_metric(self, name: str, field: str = 'label') -> None:
        m = create_metric(name)
        if m is None:
            raise ValueError(f'Metric: unknown metric name: {name}')
        self.evals.append(m)
        self.label_fields.append(field)

    def clear(self) -> None:
        for m in self.evals:
            m.clear()

    def add_eval(self, predscores, label_info) -> None:
        """predscores: one (n, k) array per metric; label_info provides
        ``.field(name) -> (n, m)`` label arrays."""
        if len(predscores) != len(self.evals):
            raise ValueError('Metric: number of predict scores must equal '
                             'number of metrics')
        for m, field, pred in zip(self.evals, self.label_fields, predscores):
            m.add_eval(pred, label_info.field(field))

    def print(self, evname: str) -> str:
        out = []
        for m, field in zip(self.evals, self.label_fields):
            tag = f'{evname}-{m.name}'
            if field != 'label':
                tag += f'[{field}]'
            out.append(f'\t{tag}:{m.get():g}')
        return ''.join(out)

    def __len__(self) -> int:
        return len(self.evals)
