"""Stdlib-only HTTP scrape surface for the monitor spine.

One background :class:`ThreadingHTTPServer` exposes the process's
telemetry to anything that can speak HTTP — a Prometheus scraper, a
browser, ``curl``, a future fleet router polling replica burn rates:

- ``/metrics`` — Prometheus text exposition of the registry;
- ``/traces``  — the tracer ring as Chrome trace-event JSON (save the
  body to a file and load it in Perfetto / ``chrome://tracing``);
  ``?kind=serving`` filters by trace kind;
- ``/slo``     — a fresh :meth:`~chainermn_torch.monitor.slo.SLOEngine.
  evaluate` pass as JSON (scraping IS the periodic evaluation driver);
- ``/events``  — the flight-recorder tail as JSON (``?last=N``, default
  64);
- ``/timeseries`` — the continuous-telemetry ring buffers
  (:class:`~chainermn_torch.monitor.timeseries.TimeSeriesStore`) as JSON
  when a store/collector was passed to :func:`serve`; ``?last=N``
  bounds points per series (default 128), ``?prefix=`` filters series
  by name;
- ``/health``  — per-replica :class:`~chainermn_torch.monitor.health.
  HealthMonitor` scores (``healthy``/``degraded``/``critical`` with
  contributing signals) when a monitor was passed to :func:`serve`;
- ``/fleet``   — the serving fleet's :meth:`~chainermn_torch.fleet.router.
  FleetRouter.fleet_report` as JSON (replica states, reroute/shed
  counters, affinity hit rate, fleet-pooled latency percentiles) when a
  router was passed to :func:`serve`; ``{}`` otherwise;
- ``/control`` — the fleet control plane's :meth:`~chainermn_torch.fleet.
  control.FleetController.report` (autoscaler state, canary phase,
  version history, decision ring) when a controller was passed to
  :func:`serve`;
- ``/costs``   — the cost ledger's :meth:`~chainermn_torch.monitor.costs.
  CostLedger.report` (per-tenant device/block/queue seconds, goodput
  breakdown, conservation check) when a ledger was passed to
  :func:`serve`;
- ``/``        — a plain-text index of the above.

Serving is read-only and allocation-light: every handler renders from
the live in-memory structures at request time (no background snapshot
thread). ``port=0`` binds an ephemeral port (tests); the bound port is
on :attr:`MonitorServer.port`. Handlers run on the server's worker
threads — the registry/event-log/tracer are all lock-protected, so a
scrape never blocks the serving or training hot path for more than a
dict copy.

The port's copy of ``chainermn_tpu/monitor/http.py``: stdlib only, over
the port's registry, event ring, tracer, SLO engine, time-series store,
health monitor, fleet router, fleet controller and cost ledger.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from chainermn_torch.monitor import get_event_log, get_registry


class MonitorServer:
    """Owns the background HTTP server; build via :func:`serve`."""

    def __init__(self, host: str, port: int, *, registry, events, tracer,
                 slo, fleet=None, timeseries=None, health=None,
                 controller=None, costs=None) -> None:
        self._registry = registry
        self._events = events
        self._tracer = tracer
        self._slo = slo
        self._fleet = fleet
        self._controller = controller
        self._costs = costs
        # a Collector is accepted where a TimeSeriesStore is expected —
        # the scrape serves the collector's store either way
        self._timeseries = getattr(timeseries, "store", timeseries)
        self._health = health
        owner = self

        class _Handler(BaseHTTPRequestHandler):
            # quiet: scrape traffic must not spam stderr
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    status, ctype, body = owner._render(self.path)
                except Exception as e:  # noqa: BLE001 — scrape must answer
                    status, ctype = 500, "text/plain; charset=utf-8"
                    body = f"{type(e).__name__}: {e}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"chainermn-monitor-http-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- rendering --------------------------------------------------------- #

    def _render(self, path: str) -> tuple[int, str, bytes]:
        parsed = urlparse(path)
        q = parse_qs(parsed.query)
        route = parsed.path.rstrip("/") or "/"
        if route == "/metrics":
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    self._registry.exposition().encode())
        if route == "/traces":
            kind = q.get("kind", [None])[0]
            traces = self._tracer.finished(kind=kind)
            body = json.dumps(self._tracer.export_chrome(traces=traces),
                              default=str).encode()
            return 200, "application/json", body
        if route == "/slo":
            payload = self._slo.evaluate() if self._slo is not None else {}
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/events":
            last = int(q.get("last", ["64"])[0])
            body = json.dumps({"events": self._events.tail(last)},
                              default=str).encode()
            return 200, "application/json", body
        if route == "/fleet":
            payload = (self._fleet.fleet_report()
                       if self._fleet is not None else {})
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/timeseries":
            last = int(q.get("last", ["128"])[0])
            prefix = q.get("prefix", [None])[0]
            payload = (self._timeseries.to_json(last=last, prefix=prefix)
                       if self._timeseries is not None else {})
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/health":
            payload = (self._health.report()
                       if self._health is not None else {})
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/control":
            payload = (self._controller.report()
                       if self._controller is not None else {})
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/costs":
            payload = (self._costs.report()
                       if self._costs is not None else {})
            return (200, "application/json",
                    json.dumps(payload, default=str).encode())
        if route == "/":
            index = ("chainermn_torch monitor\n"
                     "  /metrics     Prometheus text exposition\n"
                     "  /traces      Chrome trace-event JSON (?kind=)\n"
                     "  /slo         SLO burn-rate evaluation\n"
                     "  /events      flight-recorder tail (?last=N)\n"
                     "  /fleet       serving-fleet report (replica "
                     "states, pooled percentiles)\n"
                     "  /timeseries  telemetry ring buffers "
                     "(?last=N&prefix=)\n"
                     "  /health      per-replica health scores\n"
                     "  /control     fleet control-plane report "
                     "(autoscaler, canary, rebalance)\n"
                     "  /costs       per-tenant cost ledger "
                     "(device seconds, goodput, conservation)\n")
            return 200, "text/plain; charset=utf-8", index.encode()
        return 404, "text/plain; charset=utf-8", b"not found\n"

    # -- lifecycle --------------------------------------------------------- #

    def close(self) -> None:
        """Stop serving and join the server thread; idempotent."""
        srv, self._server = self._server, None
        if srv is None:
            return
        srv.shutdown()
        srv.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MonitorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(port: int = 0, host: str = "127.0.0.1", *, registry=None,
          events=None, tracer=None, slo=None, fleet=None,
          timeseries=None, health=None, controller=None,
          costs=None) -> MonitorServer:
    """Stand up the scrape endpoint on a background thread and return the
    running :class:`MonitorServer` (``.port`` carries the bound port when
    ``port=0``). Defaults wire the process-wide registry, flight
    recorder, tracer, and SLO engine; pass private instances for
    isolation (tests), and a :class:`~chainermn_torch.fleet.router.
    FleetRouter` as ``fleet=`` to light up ``/fleet`` (there is no
    process-wide default router — fleets are explicitly owned). Likewise
    ``timeseries=`` (a :class:`~chainermn_torch.monitor.timeseries.
    TimeSeriesStore` or :class:`~chainermn_torch.monitor.timeseries.
    Collector`) lights up ``/timeseries`` and ``health=`` (a
    :class:`~chainermn_torch.monitor.health.HealthMonitor`) lights up
    ``/health`` — continuous telemetry is explicitly owned too, as is
    ``controller=`` (a :class:`~chainermn_torch.fleet.control.
    FleetController`) for ``/control`` and ``costs=`` (a
    :class:`~chainermn_torch.monitor.costs.CostLedger`) for ``/costs``.
    Close with :meth:`MonitorServer.close` (also a context manager)."""
    if registry is None:
        registry = get_registry()
    if events is None:
        events = get_event_log()
    if tracer is None:
        from chainermn_torch.monitor.trace import get_tracer

        tracer = get_tracer()
    if slo is None:
        from chainermn_torch.monitor.slo import get_slo_engine

        slo = get_slo_engine()
    return MonitorServer(host, port, registry=registry, events=events,
                         tracer=tracer, slo=slo, fleet=fleet,
                         timeseries=timeseries, health=health,
                         controller=controller, costs=costs)


__all__ = ["MonitorServer", "serve"]
