"""Live telemetry endpoints: ``/metrics``, ``/statusz``, ``/healthz``,
``/slos``, ``/programs`` and ``/profile``.

The port's own copy of ``cxxnet_tpu/obs/endpoints.py``: a stdlib
``http.server`` thread serving the process-wide
:class:`~cxxnet_tpu_torch.obs.hub.TelemetryHub`:

* ``/metrics`` — Prometheus text exposition format rendered live from
  every registered ``StatSet``, including the SLO engine's
  ``cxxnet_slo_verdict{tag=...}`` / ratio rows when one is attached,
* ``/statusz`` — one JSON snapshot: registry state machines,
  page-pool/refcount/spec counters, execution-plan choice — whatever
  the subsystems registered,
* ``/programs`` — the program ledger's rows (``obs/programs.py``),
* ``/profile?ms=N`` — one on-demand ``torch.profiler`` window
  (``ProfilerSession``), when the server was given a profile dir,
* ``/slos`` — the attached SLO engines' typed verdicts (state, burn
  ratios, breach counts, window samples, verdict history) as one JSON
  object; ``{}`` when no engine is attached,
* ``/healthz`` — LIVENESS: always HTTP 200 while the process serves.
  The body is ``ok``, or ``degraded`` while any SLO is BREACHED — so a
  probe (or the future autoscaler) reads health without parsing
  ``/slos``, while restart-on-non-200 semantics stay untouched (a
  degraded process is alive and must keep serving).  A render that
  raises answers 500 for that request only.

One serving thread (named ``cxxnet-obs-*`` so the test suite's
thread-leak fixture holds the line on lifecycle); requests are handled
serially — metrics scrapes are small and rare, and a single thread
keeps shutdown deterministic.  A render never synchronizes the device:
the gauges read ``torch.cuda.memory_stats`` / ``mem_get_info``, which
ask the allocator and the driver only.  ``port=0`` binds an ephemeral
port (exposed as :attr:`ObsServer.port`, and announced into
``port_file`` when given); binding is loopback-only by default.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Dict, Optional, Tuple

__all__ = ['ObsServer', 'EndpointThread', 'PROM_CTYPE', 'TEXT_CTYPE',
           'JSON_CTYPE', 'json_body']

PROM_CTYPE = 'text/plain; version=0.0.4; charset=utf-8'
TEXT_CTYPE = 'text/plain; charset=utf-8'
JSON_CTYPE = 'application/json'

#: path -> (content type, zero-arg render returning the body bytes)
Routes = Dict[str, Tuple[str, Callable[[], bytes]]]


def json_body(obj) -> bytes:
    """One canonical JSON body spelling for every obs endpoint."""
    return (json.dumps(obj, sort_keys=True, default=str)
            + '\n').encode('utf-8')


class _RoutedHandler(BaseHTTPRequestHandler):
    # quiet: scrape access logs are noise on the CLI's stderr
    def log_message(self, fmt, *args):  # noqa: D102 — stdlib override
        pass

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib naming
        routes: Routes = self.server.routes
        path, _, query = self.path.partition('?')
        try:
            route = routes.get(path)
            if route is None:
                known = ' '.join(sorted(routes))
                self._reply(404, TEXT_CTYPE,
                            f'not found: {known}\n'.encode('utf-8'))
            else:
                ctype, render = route
                if getattr(render, 'wants_query', False):
                    from urllib.parse import parse_qs
                    body = render(parse_qs(query))
                else:
                    body = render()
                self._reply(200, ctype, body)
        # an endpoint render error must answer 500 to the scraper, never kill the serving thread
        except Exception as e:
            try:
                self._reply(500, TEXT_CTYPE,
                            f'error: {e!r}\n'.encode('utf-8'))
            except OSError:
                pass                 # client went away mid-error


class EndpointThread:
    """The shared endpoint scaffolding every obs server rides: one
    bound stdlib ``HTTPServer`` + a named daemon serving thread,
    route-table dispatch (404 lists the known paths, a render error
    answers 500), and an idempotent :meth:`close` that joins the
    thread.  Requests are handled serially — scrapes are small and
    rare, and a single thread keeps shutdown deterministic.  Thread
    names start ``cxxnet-obs-`` so the test suite's leak fixture holds
    the line on lifecycle."""

    def __init__(self, routes: Routes, port: int = 0,
                 host: str = '127.0.0.1',
                 thread_prefix: str = 'cxxnet-obs'):
        self._srv = HTTPServer((host, int(port)), _RoutedHandler)
        self._srv.routes = routes
        self.host = host
        self.port = int(self._srv.server_address[1])
        self._closed = False
        self._thread = threading.Thread(
            target=self._srv.serve_forever, kwargs={'poll_interval': 0.1},
            daemon=True, name=f'{thread_prefix}-{self.port}')
        self._thread.start()

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop serving and join the thread (idempotent); returns True
        once the thread exited."""
        if not self._closed:
            self._closed = True
            self._srv.shutdown()
            self._srv.server_close()
        if self._thread is threading.current_thread():
            return False
        self._thread.join(timeout)
        return not self._thread.is_alive()


def _programs_body() -> bytes:
    from .programs import get_ledger
    return json_body(get_ledger().view())


def _profile_render(out_dir: str):
    """``/profile?ms=N`` — start one single-flight on-demand
    ``torch.profiler`` window into ``out_dir`` (obs/programs.py
    ProfilerSession); answers ``busy`` while one (or a config-driven
    TraceWindow) is running."""
    def render(query: dict) -> bytes:
        from .programs import profile_session
        ms = float(query.get('ms', ['1000'])[0])
        return json_body(profile_session().start(out_dir, ms=ms))
    render.wants_query = True
    return render


class ObsServer(EndpointThread):
    """The per-process telemetry endpoint thread over a
    :class:`~cxxnet_tpu_torch.obs.hub.TelemetryHub`.  ``port=0`` = ephemeral
    (read :attr:`port` after construction); ``port_file=`` atomically
    writes the bound port for out-of-process discovery."""

    def __init__(self, hub, port: int = 0, host: str = '127.0.0.1',
                 port_file: Optional[str] = None, profile_dir:
                 Optional[str] = None):
        self.hub = hub
        routes = {
            '/healthz': (TEXT_CTYPE,
                         lambda: f'{hub.health()}\n'.encode('utf-8')),
            '/metrics': (PROM_CTYPE,
                         lambda: hub.metrics_text().encode('utf-8')),
            '/statusz': (JSON_CTYPE, lambda: json_body(hub.status())),
            '/slos': (JSON_CTYPE, lambda: json_body(hub.slos_view())),
            # the program ledger (obs/programs.py): every program's
            # shape-key rows, flops and first-call ms, live
            '/programs': (JSON_CTYPE, _programs_body),
        }
        if profile_dir:
            routes['/profile'] = (JSON_CTYPE, _profile_render(profile_dir))
        super().__init__(routes, port=port, host=host)
        if port_file:
            # temp+rename: a concurrent reader sees the whole port or
            # no file, never a partial write
            tmp = f'{port_file}.tmp.{os.getpid()}'
            with open(tmp, 'w', encoding='utf-8') as f:
                f.write(f'{self.port}\n')
            os.replace(tmp, port_file)
