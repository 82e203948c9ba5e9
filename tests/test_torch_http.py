"""The port's scrape server (``chainermn_torch.monitor.http``) held to the
JAX package's (mirrors ``tests/monitor_tests/test_http.py``, plus
``/costs`` and ``/control``).

Each test stands up one server of each package on an ephemeral port
over private telemetry objects, does the same thing to both stacks, and
scrapes both over a real socket (10 s timeout): the port's answer must
be the reference's wherever it does not depend on wall time or trace
ids, and pass the reference's own checks. Every server is closed in the
fixture's teardown.
"""

import json
from urllib.error import HTTPError
from urllib.request import urlopen

import pytest

import chainermn_torch.monitor as tmon
import chainermn_torch.monitor.costs as tcosts
import chainermn_torch.monitor.health as thealth
import chainermn_torch.monitor.slo as tslo
import chainermn_torch.monitor.timeseries as tts
import chainermn_torch.monitor.trace as ttrace
import chainermn_tpu.monitor as jmon
import chainermn_tpu.monitor.costs as jcosts
import chainermn_tpu.monitor.health as jhealth
import chainermn_tpu.monitor.slo as jslo
import chainermn_tpu.monitor.timeseries as jts
import chainermn_tpu.monitor.trace as jtrace
from chainermn_torch.monitor import http as thttp
from chainermn_tpu.monitor import http as jhttp

# (http, monitor, trace, slo, timeseries, health, costs) of each package
JAX = (jhttp, jmon, jtrace, jslo, jts, jhealth, jcosts)
TORCH = (thttp, tmon, ttrace, tslo, tts, thealth, tcosts)
TIMEOUT = 10


class Stack:
    """Private registry, event ring, tracer and SLO engine of one
    package, and a server over them (``extra`` goes to ``serve``)."""

    def __init__(self, pkg, servers, **extra):
        http, mon, trace, slo, *_ = pkg
        self.pkg = pkg
        self.reg = mon.MetricsRegistry()
        self.ev = mon.EventLog()
        self.tracer = trace.Tracer(sample=1, ring=16)
        self.slo = slo.SLOEngine(registry=self.reg, events=self.ev,
                                 tracer=self.tracer)
        self.srv = http.serve(port=0, registry=self.reg, events=self.ev,
                              tracer=self.tracer, slo=self.slo, **extra)
        servers.append(self.srv)

    def get(self, route) -> bytes:
        return urlopen(self.srv.url + route, timeout=TIMEOUT).read()

    def json(self, route):
        return json.loads(self.get(route))


@pytest.fixture()
def servers():
    live = []
    yield live
    for srv in live:
        srv.close()


@pytest.fixture()
def stacks(servers):
    return Stack(JAX, servers), Stack(TORCH, servers)


def test_metrics_endpoint_serves_prometheus_text(stacks):
    for s in stacks:
        s.reg.counter("served_total", {"inst": "0"}).inc(3)
        s.reg.histogram("ttft_seconds", unit="s").observe(0.5)
    theirs, ours = (s.get("/metrics").decode() for s in stacks)
    assert ours == theirs
    assert "# TYPE served_total counter" in ours
    assert 'served_total{inst="0"} 3' in ours


def test_traces_endpoint_serves_chrome_json(stacks):
    outs = []
    for s in stacks:
        t = s.tracer.trace("request", kind="serving", req=1)
        with t.span("queue"):
            pass
        t.finish()
        s.tracer.trace("train_step", kind="train").finish()
        full, only = s.json("/traces"), s.json("/traces?kind=train")
        outs.append(({e["name"] for e in full["traceEvents"]},
                     {e["name"] for e in only["traceEvents"]
                      if e["ph"] == "X"}))
    assert outs[1] == outs[0]
    names, only = outs[1]
    assert names >= {"request", "queue"}
    assert only == {"train_step"}


def test_slo_endpoint_evaluates_on_scrape(stacks):
    outs = []
    for s in stacks:
        slo_mod = s.pkg[3]
        s.slo.add(slo_mod.LatencyObjective(
            "ttft", "ttft_seconds", threshold_s=0.1, windows=(60.0,)))
        s.reg.histogram("ttft_seconds", unit="s").observe(0.5)
        outs.append(s.json("/slo"))
        assert s.reg.snapshot()["gauges"][
            'slo_burn_rate{slo="ttft",window="60s"}'] > 1.0
    assert outs[1] == outs[0]
    assert not outs[1]["ttft"]["compliant"]


def test_events_endpoint_tails_flight_recorder(stacks):
    outs = []
    for s in stacks:
        for i in range(5):
            s.ev.emit("step_start", n=i)
        outs.append([{k: v for k, v in e.items() if k not in ("i", "t")}
                     for e in s.json("/events?last=3")["events"]])
    assert outs[1] == outs[0]
    assert [e["n"] for e in outs[1]] == [2, 3, 4]


def test_timeseries_health_control_costs_default_empty(stacks):
    for s in stacks:
        for route in ("/timeseries", "/health", "/fleet", "/control",
                      "/costs"):
            assert s.json(route) == {}, route


def test_timeseries_and_health_endpoints_serve_live_json(servers):
    outs = []
    for pkg in (JAX, TORCH):
        mon, ts, health = pkg[1], pkg[4], pkg[5]
        reg, ev, store = mon.MetricsRegistry(), mon.EventLog(), \
            ts.TimeSeriesStore()
        hm = health.HealthMonitor(registry=reg, events=ev, store=store)
        hm.watch("0", detectors=[
            ts.ThresholdDetector("qd", "q", 10.0, severity="degraded")])
        for i in range(6):
            store.append("q", float(i), 50.0)
        hm.evaluate(now=6.0)
        col = ts.Collector(registry=reg, events=ev, store=store)
        srv = pkg[0].serve(port=0, registry=reg, events=ev, timeseries=col,
                           health=hm)
        servers.append(srv)

        def get(route, srv=srv):
            return json.loads(urlopen(srv.url + route,
                                      timeout=TIMEOUT).read())

        outs.append((get("/timeseries"), get("/timeseries?last=2"),
                     get("/timeseries?prefix=zzz"), get("/health")))
    assert outs[1][:3] == outs[0][:3]
    full, last2, none, health = outs[1]
    assert full["n_series"] == 1 and len(full["series"]["q"]["points"]) == 6
    assert last2["series"]["q"]["points"] == [[4.0, 50.0], [5.0, 50.0]]
    assert none["n_series"] == 0
    assert health["worst"] == outs[0][3]["worst"] == "degraded"
    assert health["replicas"]["0"]["contributing"] == ["qd"]


def test_costs_endpoint_serves_the_ledger_report(servers):
    outs = []
    for pkg in (JAX, TORCH):
        mon, costs = pkg[1], pkg[6]
        led = costs.CostLedger(instance="i0", registry=mon.MetricsRegistry(),
                               events=mon.EventLog())
        led.record_prefill(0.4, bucket=64, batch_rows=2,
                           members=[(1, "a", 32)])
        led.record_decode(0.2, n_rows=2, rows=[(1, "a", 3, 1),
                                               (2, "b", 1, 0)])
        led.record_queue_wait("b", 0.25)
        srv = pkg[0].serve(port=0, costs=led)
        servers.append(srv)
        outs.append((json.loads(urlopen(srv.url + "/costs",
                                        timeout=TIMEOUT).read()),
                     led.report()))
    (theirs, _), (ours, report) = outs
    assert ours == theirs == json.loads(json.dumps(report))
    assert set(ours["tenants"]) == {"a", "b", "-"}
    assert ours["device_time"]["conservation_error"] == 0.0
    assert ours["tenants"]["b"]["queue_wait_s"] == 0.25


def test_control_endpoint_serves_the_controller_report(servers):
    class Controller:             # all /control reads of a controller
        def report(self):
            return {"phase": "canary", "history": [[0, "init"]]}

    outs = []
    for pkg in (JAX, TORCH):
        srv = pkg[0].serve(port=0, controller=Controller())
        servers.append(srv)
        outs.append(json.loads(urlopen(srv.url + "/control",
                                       timeout=TIMEOUT).read()))
    assert outs[1] == outs[0] == Controller().report()


def test_index_and_404(stacks):
    jax_s, ours = stacks
    index = ours.get("/").decode()
    assert index.splitlines()[1:] == jax_s.get("/").decode().splitlines()[1:]
    assert index.startswith("chainermn_torch monitor")
    for route in ("/metrics", "/costs", "/control"):
        assert route in index
    for s in stacks:
        with pytest.raises(HTTPError) as ei:
            s.get("/nope")
        assert ei.value.code == 404


def test_close_is_idempotent(stacks):
    _, ours = stacks
    url = ours.srv.url
    ours.srv.close()
    ours.srv.close()
    with pytest.raises(OSError):
        urlopen(url + "/metrics", timeout=TIMEOUT)
