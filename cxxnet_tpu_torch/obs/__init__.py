"""Telemetry for the port: the hub, its endpoints, the gauge history and
SLO engine, and the program ledger.

The port's own copy of ``cxxnet_tpu/obs/`` (its ``fleet.py``, the
elastic launcher's merged scrape, comes with ROADMAP.md queue A item 9):

* :mod:`~cxxnet_tpu_torch.obs.hub` — the process-wide
  :class:`TelemetryHub` (StatSet registry, span flight recorder,
  Prometheus / statusz renderers, fault-triggered postmortem dumps,
  Chrome trace export) and the ``span()`` / ``record_event()``
  instrumentation every layer records through,
* :mod:`~cxxnet_tpu_torch.obs.endpoints` — the ``/metrics`` +
  ``/statusz`` + ``/healthz`` + ``/slos`` + ``/programs`` + ``/profile``
  http thread (``obs.port=`` in the CLI),
* :mod:`~cxxnet_tpu_torch.obs.history` (the ``obs.sample_every`` gauge
  sampler) and :mod:`~cxxnet_tpu_torch.obs.slo` (the ``slo.<name>=``
  burn-rate engine with typed OK / AT_RISK / BREACHED verdicts),
* :mod:`~cxxnet_tpu_torch.obs.programs` — the :class:`ProgramLedger`
  (one row per program and shape key: first-call ms, the product
  flops, parameter bytes; the recompile sentinel), the ``hbm.*``
  device-memory gauges, the MFU peak table and the on-demand
  ``/profile?ms=N`` session over ``torch.profiler``.
"""

from .hub import (TelemetryHub, format_report, get_hub, install_hub,
                  next_trace_id, record_event, span)

__all__ = ['TelemetryHub', 'format_report', 'get_hub', 'install_hub',
           'next_trace_id', 'record_event', 'span', 'ObsServer',
           'GaugeHistory', 'GaugeSampler', 'SLOEngine', 'SLOSpec',
           'ProgramLedger', 'get_ledger', 'install_ledger']


def __getattr__(name):
    # endpoints/history/slo/programs import lazily: embedders that never
    # serve telemetry or evaluate SLOs pay nothing for them
    if name == 'ObsServer':
        from .endpoints import ObsServer
        return ObsServer
    if name in ('GaugeHistory', 'GaugeSampler'):
        from . import history
        return getattr(history, name)
    if name in ('SLOEngine', 'SLOSpec'):
        from . import slo
        return getattr(slo, name)
    if name in ('ProgramLedger', 'get_ledger', 'install_ledger'):
        from . import programs
        return getattr(programs, name)
    raise AttributeError(name)
