"""The port's continuous telemetry against the JAX package's: the
time-series store, the derived signals, the detectors, ``Collector.
tick``, ``HealthMonitor`` and ``SLOEngine`` (ports of
``tests/monitor_tests/test_timeseries.py``, ``test_health.py`` and
``test_slo.py``). Each scenario runs once against each package with the
same seeded numpy inputs and an injected clock, and must give the same
``to_json``, verdicts, scores, burn rates and events (exact equality:
both packages do the same float64 arithmetic in the same order). Host
logic only: no engine, no device."""

import threading

import numpy as np
import pytest
from _torch_isolation import fresh_telemetry

from chainermn_tpu.monitor import health as jhealth
from chainermn_tpu.monitor import slo as jslo
from chainermn_tpu.monitor import timeseries as jts
from chainermn_tpu.monitor.events import EventLog as JEventLog
from chainermn_tpu.monitor.registry import MetricsRegistry as JRegistry
from chainermn_tpu.monitor.trace import Tracer as JTracer
from chainermn_tpu.serving.metrics import ServingMetrics as JMetrics
from chainermn_torch.monitor import EventLog as TEventLog
from chainermn_torch.monitor import MetricsRegistry as TRegistry
from chainermn_torch.monitor import health as thealth
from chainermn_torch.monitor import slo as tslo
from chainermn_torch.monitor import timeseries as tts
from chainermn_torch.monitor.trace import Tracer as TTracer
from chainermn_torch.serving.metrics import ServingMetrics as TMetrics

SEEDS = range(3)


class _Pkg:
    def __init__(self, name, ts, health, slo, registry, events, tracer):
        self.name, self.ts, self.health, self.slo = name, ts, health, slo
        self.Registry, self.EventLog = registry, events
        self.tracer = tracer


TORCH = _Pkg("torch", tts, thealth, tslo, TRegistry, TEventLog,
             lambda: TTracer(sample=1, ring=32))
JAX = _Pkg("jax", jts, jhealth, jslo, JRegistry, JEventLog,
           lambda: JTracer(sample=1, ring=32))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _twin(scenario, *args):
    """Run ``scenario(pkg, *args)`` against both packages; their traces
    must be equal. Returns the port's."""
    got, want = scenario(TORCH, *args), scenario(JAX, *args)
    assert got == want
    return got


def _events(log):
    """An event ring's entries without their sequence number and wall
    time."""
    return [{k: v for k, v in e.items() if k not in ("i", "t")}
            for e in log.tail()]


# --------------------------------------------------------------------- #
# the store                                                              #
# --------------------------------------------------------------------- #


def _store_run(pkg, seed):
    rng = np.random.default_rng(seed)
    store = pkg.ts.TimeSeriesStore(maxlen=int(rng.integers(2, 9)))
    out = []
    t = 0.0
    for _ in range(120):
        t += float(rng.choice([0.0, 0.25, 1.0]))
        name = str(rng.choice(["a:x", "a:y", "b:z"]))
        store.append(name, t, float(rng.normal()),
                     kind=str(rng.choice(["gauge", "counter"])))
        out.append((store.last(name), store.values("missing"),
                    store.last("missing"), len(store)))
    return {"steps": out, "maxlen": store.maxlen, "names": store.names(),
            "points": {n: store.points(n) for n in store.names()},
            "json": store.to_json(), "last2": store.to_json(last=2),
            "prefix": store.to_json(prefix="a:")}


@pytest.mark.parametrize("seed", SEEDS)
def test_store_bounded_and_dumped_as_the_reference(seed):
    got = _twin(_store_run, seed)
    assert all(len(p) <= got["maxlen"] for p in got["points"].values())
    assert list(got["prefix"]["series"]) == [n for n in got["names"]
                                             if n.startswith("a:")]


def test_store_ring_is_bounded_and_rejects_degenerate_maxlen():
    for pkg in (TORCH, JAX):
        store = pkg.ts.TimeSeriesStore(maxlen=4)
        for i in range(100):
            store.append("s", float(i), float(i * 10))
        assert store.points("s") == [(96.0, 960.0), (97.0, 970.0),
                                     (98.0, 980.0), (99.0, 990.0)]
        with pytest.raises(ValueError):
            pkg.ts.TimeSeriesStore(maxlen=1)


# --------------------------------------------------------------------- #
# derived signals                                                        #
# --------------------------------------------------------------------- #


def _signals_run(pkg, seed):
    rng = np.random.default_rng(seed)
    ts = pkg.ts
    store = ts.TimeSeriesStore(maxlen=64)
    sigs = [ts.Rate("tok"), ts.EWMA("lat", alpha=0.3),
            ts.Ratio("acc", "prop", "accept"),
            ts.WindowPercentile("lat", q=90.0, window_s=3.0),
            ts.Rate("acc", name="acc_rate")]
    t, tok, acc = 0.0, 0.0, 0.0
    for _ in range(60):
        t += float(rng.choice([0.0, 0.5, 1.0]))
        if rng.random() > 0.3:
            tok += float(rng.integers(0, 20))
            store.append("tok", t, tok, kind="counter")
        if rng.random() > 0.3:
            store.append("lat", t, float(rng.exponential(0.1)))
        if rng.random() > 0.5:
            acc += float(rng.integers(0, 4))
            store.append("acc", t, acc)
            store.append("prop", t, float(rng.choice([0.0, 4.0, 8.0])))
        for sig in sigs:
            sig.evaluate(store, t)
    return store.to_json()


@pytest.mark.parametrize("seed", SEEDS)
def test_signals_derive_as_the_reference(seed):
    got = _twin(_signals_run, seed)
    assert {"tok:rate", "lat:ewma", "lat:w90"} <= set(got["series"])


def test_signal_values_of_the_reference_cases():
    store = tts.TimeSeriesStore()
    rate = tts.Rate("tok")
    store.append("tok", 1.0, 100.0, kind="counter")
    rate.evaluate(store, 1.0)
    store.append("tok", 3.0, 150.0, kind="counter")
    rate.evaluate(store, 3.0)
    rate.evaluate(store, 4.0)
    assert store.values("tok:rate") == [25.0]
    ewma = tts.EWMA("v", alpha=0.5)
    for i, x in enumerate([1.0, 3.0, 3.0]):
        store.append("v", float(i), x)
        ewma.evaluate(store, float(i))
    assert store.values("v:ewma") == [1.0, 2.0, 2.5]
    ratio = tts.Ratio("acc", "prop", "accept_ratio")
    store.append("acc", 1.0, 4.0)
    store.append("prop", 1.0, 0.0)
    ratio.evaluate(store, 1.0)
    assert store.values("accept_ratio") == []
    store.append("prop", 2.0, 8.0)
    ratio.evaluate(store, 2.0)
    assert store.values("accept_ratio") == [0.5]
    wp = tts.WindowPercentile("lat", q=50.0, window_s=5.0)
    store.append("lat", 0.0, 1000.0)
    for t, v in ((7.0, 1.0), (8.0, 3.0), (9.0, 5.0)):
        store.append("lat", t, v)
    wp.evaluate(store, 10.0)
    assert store.values("lat:w50") == [3.0]
    with pytest.raises(ValueError):
        tts.EWMA("v", alpha=0.0)


# --------------------------------------------------------------------- #
# detectors                                                              #
# --------------------------------------------------------------------- #


def _detectors_run(pkg, seed):
    rng = np.random.default_rng(seed)
    ts = pkg.ts
    store = ts.TimeSeriesStore(maxlen=128)
    reg, ev = pkg.Registry(), pkg.EventLog()
    active = [True]
    dets = [ts.ThresholdDetector("qd", "q", 10.0),
            ts.ThresholdDetector("kv", "free", 5.0, direction="below",
                                 severity="critical"),
            ts.ZScoreDetector("drift", "lat", z=2.0, min_points=6,
                              baseline=16),
            ts.ZScoreDetector("drop", "lat", z=2.0, direction="below",
                              min_points=6),
            ts.ZScoreDetector("both", "lat", z=1.5, direction="both",
                              min_points=4),
            ts.DeadmanDetector("stall", "tok", 2.0,
                               active_fn=lambda: active[0])]
    out = []
    t, tok = 0.0, 0.0
    for _ in range(80):
        t += float(rng.choice([0.25, 0.5, 1.5]))
        store.append("q", t, float(rng.integers(0, 16)))
        store.append("free", t, float(rng.integers(0, 10)))
        spike = rng.random() > 0.9
        store.append("lat", t, float(rng.normal(1.0, 0.1))
                     + (5.0 if spike else 0.0))
        if rng.random() > 0.4:
            tok += float(rng.integers(0, 3))
            store.append("tok", t, tok, kind="counter")
        active[0] = bool(rng.random() > 0.2)
        out.append([d.evaluate(store, t, registry=reg, events=ev)
                    for d in dets])
    return {"verdicts": out, "events": _events(ev),
            "gauges": reg.snapshot()["gauges"],
            "firing": [d.firing for d in dets]}


@pytest.mark.parametrize("seed", SEEDS)
def test_detectors_judge_as_the_reference(seed):
    got = _twin(_detectors_run, seed)
    kinds = {e["kind"] for e in got["events"]}
    assert kinds == {"detector_fired", "detector_cleared"}


def _edge_run(pkg):
    store = pkg.ts.TimeSeriesStore()
    reg, ev = pkg.Registry(), pkg.EventLog()
    det = pkg.ts.ThresholdDetector("qd", "q", 10.0, severity="critical")
    for t, v in ((1.0, 5.0), (2.0, 20.0), (3.0, None), (4.0, 5.0)):
        if v is not None:
            store.append("q", t, v)
        det.evaluate(store, t, registry=reg, events=ev)
    return _events(ev), reg.snapshot()["gauges"]


def test_detector_evaluate_is_edge_triggered_as_the_reference():
    events, gauges = _twin(_edge_run)
    assert [e["kind"] for e in events] == ["detector_fired",
                                           "detector_cleared"]
    assert events[0]["detector"] == "qd" and events[0]["value"] == 20.0
    assert gauges['detector_state{detector="qd"}'] == 0.0


def test_deadman_rearms_while_idle_as_the_reference():
    def run(pkg):
        store = pkg.ts.TimeSeriesStore()
        active = [True]
        det = pkg.ts.DeadmanDetector("stall", "tok", 2.0,
                                     active_fn=lambda: active[0])
        out = []
        store.append("tok", 0.0, 10.0, kind="counter")
        out.append(det.check(store, 0.0))
        store.append("tok", 1.0, 20.0, kind="counter")
        for now, act in ((1.0, True), (2.5, True), (4.0, True),
                         (10.0, False), (11.0, True), (14.0, True)):
            active[0] = act
            out.append(det.check(store, now))
        return out

    got = _twin(run)
    assert [v["firing"] for v in got] == [False, False, False, True, False,
                                          False, True]
    assert got[3]["stalled_s"] == 3.0


def test_detectors_reject_bad_config_as_the_reference():
    for pkg in (TORCH, JAX):
        ts = pkg.ts
        for bad in (lambda: ts.ThresholdDetector("x", "s", 1.0,
                                                 severity="panic"),
                    lambda: ts.ThresholdDetector("x", "s", 1.0,
                                                 direction="sideways"),
                    lambda: ts.ZScoreDetector("x", "s",
                                              direction="diagonal"),
                    lambda: ts.DeadmanDetector("x", "s", 0.0)):
            with pytest.raises(ValueError):
                bad()


# --------------------------------------------------------------------- #
# the collector                                                          #
# --------------------------------------------------------------------- #


def _collector_run(pkg, seed):
    rng = np.random.default_rng(seed)
    reg, ev = pkg.Registry(), pkg.EventLog()
    col = pkg.ts.Collector(registry=reg, events=ev, cadence_s=0.25,
                           clock=lambda: 0.0)
    key = 'serving_tokens_total{instance="7"}'
    col.add_signal(pkg.ts.EWMA(key + ":rate", alpha=0.5))
    col.add_detector(pkg.ts.ThresholdDetector(
        "rate_floor", key + ":rate", 1.0, direction="below"))
    insts = {
        "c": [reg.counter("serving_tokens_total", {"instance": i})
              for i in ("7", "8")],
        "g": [reg.gauge("serving_queue_depth_now", {"instance": i})
              for i in ("7", "8")],
        "h": [reg.histogram("serving_ttft_seconds", {"instance": i},
                            unit="s") for i in ("7", "8")],
    }
    out = []
    now = 0.0
    for _ in range(25):
        now += float(rng.choice([0.25, 0.5, 1.0]))
        for c in insts["c"]:
            if rng.random() > 0.3:
                c.inc(int(rng.integers(0, 50)))
        for g in insts["g"]:
            g.set(float(rng.integers(0, 8)))
        for h in insts["h"]:
            for _ in range(int(rng.integers(0, 4))):
                h.observe(float(rng.exponential(0.2)),
                          t=now - float(rng.random()))
        tick = col.tick(now=now)
        out.append({"now": tick["now"], "samples": tick["samples"],
                    "detectors": tick["detectors"]})
    snap = reg.snapshot()
    return {"ticks": out, "store": col.store.to_json(), "n": col.ticks,
            "events": _events(ev), "counters": snap["counters"],
            "gauges": snap["gauges"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_collector_tick_samples_as_the_reference(seed):
    got = _twin(_collector_run, seed)
    names = set(got["store"]["series"])
    key = 'serving_tokens_total{instance="7"}'
    assert {key, key + ":rate", key + ":rate:ewma",
            'serving_queue_depth_now{instance="8"}'} <= names
    assert any(n.endswith(":p99") for n in names)
    assert got["n"] == 25 and got["counters"]["ts_samples_total"] > 0


def test_collector_tick_values_of_the_reference_case():
    reg = TRegistry()
    col = tts.Collector(registry=reg, events=TEventLog(), cadence_s=0.25)
    c = reg.counter("serving_tokens_total", {"instance": "9"})
    g = reg.gauge("serving_queue_depth_now", {"instance": "9"})
    h = reg.histogram("serving_ttft_seconds", {"instance": "9"}, unit="s")
    c.inc(10)
    g.set(4)
    h.observe(0.5, t=0.9)
    col.tick(now=1.0)
    key = 'serving_tokens_total{instance="9"}'
    assert col.store.last(key) == (1.0, 10.0)
    assert col.store.last('serving_queue_depth_now{instance="9"}') == (
        1.0, 4.0)
    assert col.store.last(
        'serving_ttft_seconds{instance="9"}:p50') == (1.0, 0.5)
    c.inc(10)
    col.tick(now=2.0)
    assert col.store.last(key + ":rate") == (2.0, 10.0)


def test_histogram_recent_as_the_reference():
    def run(pkg):
        h = pkg.Registry().histogram("lat", unit="s")
        for i in range(12):
            h.observe(float(i), t=float(i))
        return [h.recent(w, now=11.0) for w in (0.0, 2.5, 100.0)]

    assert _twin(run) == [[11.0], [9.0, 10.0, 11.0],
                          [float(i) for i in range(12)]]


def test_collector_thread_smoke():
    reg = TRegistry()
    col = tts.Collector(registry=reg, events=TEventLog(), cadence_s=0.01)
    reg.gauge("serving_queue_depth_now").set(1.0)
    col.start()
    assert col.start() is col
    done = threading.Event()

    def waiter():
        while col.ticks < 3:
            pass
        done.set()

    threading.Thread(target=waiter, daemon=True).start()
    assert done.wait(10.0), "collector thread made no progress"
    col.stop()
    col.stop()
    assert col.ticks >= 3
    assert col.store.last("serving_queue_depth_now") is not None
    lag = reg.snapshot()["histograms"]["ts_collect_lag_seconds"]
    assert lag["count"] >= col.ticks - 1
    with pytest.raises(ValueError):
        tts.Collector(registry=reg, cadence_s=0.0)


# --------------------------------------------------------------------- #
# health                                                                 #
# --------------------------------------------------------------------- #


def _health_run(pkg, seed):
    rng = np.random.default_rng(seed)
    ts = pkg.ts
    reg, ev, store = pkg.Registry(), pkg.EventLog(), ts.TimeSeriesStore()
    mon = pkg.health.HealthMonitor(registry=reg, events=ev, store=store)
    state = {k: "healthy" for k in "abc"}
    restarts = {k: 0 for k in "abc"}
    for k in "abc":
        mon.watch(k, detectors=[
            ts.ThresholdDetector(f"qd@{k}", f"q{k}", 10.0),
            ts.DeadmanDetector(f"stall@{k}", f"tok{k}", 2.0,
                               severity="critical")],
            state_fn=lambda k=k: state[k],
            restarts_fn=lambda k=k: restarts[k])
    out = []
    now, tok = 0.0, dict.fromkeys("abc", 0.0)
    for step in range(40):
        now += float(rng.choice([0.5, 1.0, 2.5]))
        for k in "abc":
            store.append(f"q{k}", now, float(rng.integers(0, 14)))
            if rng.random() > 0.3:
                tok[k] += 1.0
                store.append(f"tok{k}", now, tok[k], kind="counter")
            state[k] = str(rng.choice(["healthy"] * 6 + [
                "starting", "draining", "retired", "restarting",
                "quarantined"]))
            if rng.random() > 0.85:
                restarts[k] += 1
        if step == 20:
            mon.unwatch("c")
        if step == 25:
            mon.add_detectors("a", ts.ThresholdDetector(
                "chaos@a", "chaos", 0.5, severity="degraded"))
            store.append("chaos", now, 1.0)
        scores = mon.evaluate(now=now)
        out.append({k: s.to_json() for k, s in scores.items()})
        out.append([mon.level(k) for k in "abcz"])
    return {"scores": out, "report": mon.report(), "keys": mon.keys,
            "events": [e for e in _events(ev)
                       if e["kind"] == "health_changed"],
            "gauges": reg.snapshot()["gauges"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_health_monitor_scores_as_the_reference(seed):
    got = _twin(_health_run, seed)
    assert got["keys"] == ["a", "b"]
    assert {e["state"] for e in got["events"]} >= {"healthy", "critical"}


def _health_cases(pkg):
    ts, health = pkg.ts, pkg.health
    out = []
    reg, ev, store = pkg.Registry(), pkg.EventLog(), ts.TimeSeriesStore()
    mon = health.HealthMonitor(registry=reg, events=ev, store=store)
    out.append((mon.level("nope"), mon.score_json("nope"), mon.report()))
    mon.watch("0", detectors=[
        ts.ThresholdDetector("qd", "q", 10.0, severity="degraded"),
        ts.DeadmanDetector("stall", "tok", 2.0, severity="critical")])
    for now, q, tok in ((1.0, 5.0, 1.0), (2.0, 50.0, 2.0),
                        (6.0, 50.0, None)):
        store.append("q", now, q)
        if tok is not None:
            store.append("tok", now, tok, kind="counter")
        out.append(mon.evaluate(now=now)["0"].to_json())
    state, restarts = ["healthy"], [0]
    mon.watch("r", state_fn=lambda: state[0],
              restarts_fn=lambda: restarts[0])
    for now, st, rs in ((7.0, "healthy", 0), (8.0, "starting", 1),
                        (9.0, "starting", 1), (10.0, "quarantined", 1)):
        state[0], restarts[0] = st, rs
        out.append(mon.evaluate(now=now)["r"].to_json())
    out.append(mon.report())
    out.append(health.HealthScore(state="degraded", level=1,
                                  contributing=["x"],
                                  detail={"x": {"firing": True}}).to_json())
    out.append(_events(ev))
    out.append(reg.snapshot()["gauges"])
    return out


def test_health_reference_cases_as_the_reference():
    got = _twin(_health_cases)
    assert got[0] == (0, None, {"replicas": {}, "worst": "healthy",
                                "n_watched": 0})
    assert [s["state"] for s in got[1:4]] == ["healthy", "degraded",
                                              "critical"]
    assert set(got[3]["contributing"]) == {"qd", "stall"}
    assert [s["state"] for s in got[4:8]] == ["healthy", "critical",
                                              "healthy", "critical"]
    assert got[5]["contributing"] == ["replica_restart"]
    assert got[7]["contributing"] == ["replica_state"]
    assert got[8]["worst"] == "critical"


def test_standard_replica_sensors_as_the_reference():
    def run(pkg):
        out = []
        for kw in (dict(tag="r3"), dict(min_kv_blocks_free=4.0, spec=True)):
            sigs, dets = pkg.health.standard_replica_sensors("3", **kw)
            out.append(([(type(s).__name__, s.name) for s in sigs],
                        [(type(d).__name__, d.name, d.series, d.severity)
                         for d in dets]))
        return out

    got = _twin(run)
    assert [d[1] for d in got[0][1]] == ["ttft_p99_drift@r3",
                                         "queue_depth@r3",
                                         "decode_stall@r3"]
    assert got[0][1][2][2] == 'serving_tokens_total{instance="3"}'
    assert "spec_accept_drift@3" in [d[1] for d in got[1][1]]


def test_metrics_report_carries_the_health_block_as_the_reference():
    def run(pkg_metrics):
        m = pkg_metrics(2)
        out = ["health" in m.report()]
        m.attach_health(lambda: {"state": "healthy", "level": 0})
        out.append(m.report()["health"])
        m.attach_health(lambda: 1 / 0)
        out.append(m.report()["health"])
        m.attach_health(None)
        out.append("health" in m.report())
        return out

    got, want = run(TMetrics), run(JMetrics)
    assert got == want == [False, {"state": "healthy", "level": 0},
                           {"error": "ZeroDivisionError: division by zero"},
                           False]


# --------------------------------------------------------------------- #
# SLOs                                                                   #
# --------------------------------------------------------------------- #


def _slo_latency_run(pkg, seed):
    rng = np.random.default_rng(seed)
    reg, ev = pkg.Registry(), pkg.EventLog()
    eng = pkg.slo.SLOEngine(registry=reg, events=ev, tracer=pkg.tracer())
    eng.add(pkg.slo.LatencyObjective(
        "ttft", "serving_ttft_seconds", threshold_s=0.1,
        target_quantile=0.9, windows=(5.0, 20.0), min_samples=2))
    eng.add(pkg.slo.LatencyObjective(
        "tpot", "serving_tpot_seconds", threshold_s=0.05,
        windows=(10.0,), burn_threshold=2.0))
    hists = [reg.histogram(name, {"instance": i}, unit="s")
             for name in ("serving_ttft_seconds", "serving_tpot_seconds")
             for i in ("0", "1")]
    out = []
    now = 0.0
    for _ in range(30):
        now += float(rng.choice([0.5, 1.0, 3.0]))
        slow = rng.random() > 0.6
        for h in hists:
            for _ in range(int(rng.integers(0, 5))):
                h.observe(float(rng.exponential(0.3 if slow else 0.02)),
                          t=now - float(rng.random()))
        out.append(eng.evaluate(now=now))
    snap = reg.snapshot()
    return {"reports": out, "last": eng.last, "events": _events(ev),
            "gauges": snap["gauges"], "counters": snap["counters"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_latency_burn_rates_as_the_reference(seed):
    got = _twin(_slo_latency_run, seed)
    assert any(not r["ttft"]["compliant"] for r in got["reports"])
    assert all(r["ttft"].get("offending_traces", []) == []
               for r in got["reports"])


def _slo_error_run(pkg, seed):
    rng = np.random.default_rng(seed)
    reg, ev = pkg.Registry(), pkg.EventLog()
    eng = pkg.slo.SLOEngine(registry=reg, events=ev, tracer=pkg.tracer())
    eng.add(pkg.slo.ErrorRateObjective(
        "errors", bad=("serving_requests_errored_total",
                       "serving_requests_shed_total"),
        total="serving_requests_submitted_total", target_rate=0.05,
        windows=(10.0, 40.0), min_events=2))
    bad = [reg.counter(n, {"instance": i})
           for n in ("serving_requests_errored_total",
                     "serving_requests_shed_total") for i in ("0", "1")]
    tot = [reg.counter("serving_requests_submitted_total", {"instance": i})
           for i in ("0", "1")]
    out = []
    now = 1000.0
    for _ in range(30):
        now += float(rng.choice([1.0, 2.0, 6.0]))
        for c in tot:
            c.inc(int(rng.integers(0, 10)))
        if rng.random() > 0.7:
            bad[int(rng.integers(0, 4))].inc(int(rng.integers(1, 4)))
        out.append(eng.evaluate(now=now))
    return {"reports": out, "events": _events(ev),
            "counters": reg.snapshot()["counters"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_error_rates_as_the_reference(seed):
    got = _twin(_slo_error_run, seed)
    assert any(r["errors"]["max_burn_rate"] > 0 for r in got["reports"])


def test_slo_reference_cases_on_the_port():
    reg, ev = TRegistry(), TEventLog()
    eng = tslo.SLOEngine(registry=reg, events=ev)
    eng.add(tslo.LatencyObjective("ttft", "serving_ttft_seconds",
                                  threshold_s=0.1, windows=(60.0, 300.0)))
    h = reg.histogram("serving_ttft_seconds", {"instance": "0"}, unit="s")
    for v in [0.01] * 8 + [0.5] * 2:
        h.observe(v)
    ent = eng.evaluate()["ttft"]
    assert ent["windows"]["60s"]["burn_rate"] == pytest.approx(20.0)
    assert not ent["compliant"] and ent["offending_traces"] == []
    eng.evaluate()
    assert reg.snapshot()["counters"]['slo_breaches_total{slo="ttft"}'] == 1
    assert len([e for e in ev.tail() if e["kind"] == "slo_breach"]) == 1
    obj = tslo.ErrorRateObjective("e", bad="bad_total", total="all_total")
    assert obj.bad == ("bad_total",) and obj.total == ("all_total",)


def test_slo_objective_validation_as_the_reference():
    for pkg in (TORCH, JAX):
        slo = pkg.slo
        eng = slo.SLOEngine(registry=pkg.Registry(), events=pkg.EventLog(),
                            tracer=pkg.tracer())
        for bad, exc in (
                (lambda: slo.LatencyObjective("x", "m", threshold_s=0.0),
                 ValueError),
                (lambda: slo.LatencyObjective("x", "m", threshold_s=1.0,
                                              target_quantile=1.5),
                 ValueError),
                (lambda: slo.ErrorRateObjective("x", bad=("b",),
                                                total=("t",),
                                                target_rate=2.0),
                 ValueError),
                (lambda: eng.add(object()), TypeError)):
            with pytest.raises(exc):
                bad()
        eng.add(slo.LatencyObjective("dup", "m", threshold_s=1.0))
        with pytest.raises(ValueError):
            eng.add(slo.LatencyObjective("dup", "m", threshold_s=1.0))


class _FakeComm:
    def __init__(self, payloads):
        self._payloads = payloads

    def allgather_obj(self, obj):
        return self._payloads


def test_slo_aggregate_pools_ranks_as_the_reference():
    def run(pkg):
        engines = []
        for slow in (0.0, 0.5, 0.2):
            eng = pkg.slo.SLOEngine(registry=pkg.Registry(),
                                    events=pkg.EventLog(),
                                    tracer=pkg.tracer())
            eng.add(pkg.slo.LatencyObjective(
                "ttft", "serving_ttft_seconds", threshold_s=0.1,
                windows=(60.0,)))
            h = eng._registry.histogram("serving_ttft_seconds", unit="s")
            for _ in range(10):
                h.observe(0.01, t=50.0)
            for _ in range(10 if slow else 0):
                h.observe(slow, t=50.0)
            eng.evaluate(now=60.0)
            engines.append(eng)
        payloads = [{n: {w: e["burn_rate"] for w, e in ent["windows"].items()}
                     for n, ent in eng.last.items()} for eng in engines]
        return engines[0].aggregate(_FakeComm(payloads))

    got = _twin(run)
    assert got["ranks"] == 3
    assert got["ttft"]["60s"]["max_burn_rate"] == pytest.approx(50.0)
