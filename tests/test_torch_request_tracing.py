"""Request-scoped tracing through the port's serving stack against the JAX
package's (the cases of ``tests/serving_tests/test_tracing.py``), each on
a tiny LM with the same requests on the JAX scheduler and the port's:
the same span names in the same order for each request, the Chrome
export and the critical path, streams identical with tracing on and off,
nothing recorded when off, a shed request's trace kept despite sampling,
the SLO breach naming the offending traces (``test_slo.py:90``), the
watchdog naming the in-flight requests and traces, and the
``RecompileGuard`` flagging the ambient trace."""

import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_isolation import fresh_telemetry

from chainermn_torch.extensions.profiling import Watchdog
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import (
    LatencyObjective,
    RecompileGuard,
    SLOEngine,
    get_event_log,
    get_registry,
    get_tracer,
)
from chainermn_torch.monitor.trace import Tracer
from chainermn_torch.resilience import FaultInjector
from chainermn_torch.serving import FCFSScheduler, ServingEngine, ServingMetrics
from chainermn_tpu.extensions import Watchdog as JaxWatchdog
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.monitor import RecompileGuard as JaxRecompileGuard
from chainermn_tpu.monitor import get_event_log as jax_event_log
from chainermn_tpu.monitor import get_tracer as jax_get_tracer
from chainermn_tpu.monitor.events import EventLog as JaxEventLog
from chainermn_tpu.monitor.registry import MetricsRegistry as JaxRegistry
from chainermn_tpu.monitor.slo import LatencyObjective as JaxObjective
from chainermn_tpu.monitor.slo import SLOEngine as JaxSLOEngine
from chainermn_tpu.monitor.trace import Tracer as JaxTracer
from chainermn_tpu.resilience import FaultInjector as JaxInjector
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving import ServingMetrics as JaxMetrics

torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=1, max_len=32)
ENGINE = dict(n_slots=2, prefill_len=6, cache_len=24)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


@pytest.fixture(scope="module")
def jax_lm():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


def _torch_engine(**kw):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                          seed=0)
    engine = ServingEngine(model, **dict(ENGINE, **kw), device="cpu")
    engine.warmup()
    return engine


def _jax_engine(jax_lm, **kw):
    engine = JaxEngine(*jax_lm, **dict(ENGINE, **kw))
    engine.warmup()
    return engine


@pytest.fixture(scope="module")
def engines(jax_lm):
    return {"torch": _torch_engine(), "jax": _jax_engine(jax_lm)}


def _workload(sched, pkg, n=4, max_new=4):
    """The same burst on either package: prompts and budgets from one
    seed; the JAX requests draw from keys, the port's from seeds."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n):
        prompt = rng.randint(1, 17, 1 + i % 4).astype(np.int32)
        kw = ({"rng": jax.random.PRNGKey(100 + i)} if pkg == "jax"
              else {"seed": 100 + i})
        reqs.append(sched.submit(prompt, max_new, **kw))
    sched.run_until_idle()
    return reqs


def _names(tracer) -> list:
    return [[s.name for s in t.spans]
            for t in sorted(tracer.finished(kind="serving"),
                            key=lambda t: t.root.labels["req"])]


def _sched(pkg, engine, tracer, **kw):
    cls = JaxScheduler if pkg == "jax" else FCFSScheduler
    return cls(engine, tracer=tracer, **kw)


# --------------------------------------------------------------------- #
# span trees and export                                                  #
# --------------------------------------------------------------------- #

def test_request_span_tree_matches_the_reference(engines):
    out = {}
    for pkg, tracer_cls in (("torch", Tracer), ("jax", JaxTracer)):
        tracer = tracer_cls(sample=1, ring=32)
        sched = _sched(pkg, engines[pkg], tracer)
        reqs = _workload(sched, pkg)
        out[pkg] = (_names(tracer), [
            {k: v for k, v in t.root.labels.items()}
            for t in sorted(tracer.finished(kind="serving"),
                            key=lambda t: t.root.labels["req"])],
            [s.labels.get("bucket") for t in tracer.finished()
             for s in t.spans if s.name == "prefill"])
        if pkg == "torch":
            traces = tracer.finished(kind="serving")
            assert len(traces) == len(reqs)
            for t, req in zip(sorted(traces,
                                     key=lambda t: t.root.labels["req"]),
                              reqs):
                assert t.error is None and not t.deadline_miss
                n_decode = sum(s.name == "decode_step" for s in t.spans)
                assert n_decode == len(req.tokens) - 1
            events = tracer.export_chrome()["traceEvents"]
            json.dumps(events)
            complete = [e for e in events if e["ph"] == "X"]
            assert complete and all(
                set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                           "args"} and e["dur"] >= 0 for e in complete)
            assert len({e["tid"] for e in events}) == len(traces)
            cp = sched.metrics.report()["critical_path"]
            assert cp["total_s"] > 0 and "queue" in cp["phases_s"]
            json.dumps(cp)
            hist = [k for k in get_registry().snapshot()["histograms"]
                    if k.startswith("trace_phase_seconds")]
            assert {k.split('phase="')[1].rstrip('"}') for k in hist} == {
                "queue", "admit", "prefill", "decode_step"}
    assert out["torch"] == out["jax"]
    names, roots, buckets = out["torch"]
    assert all(n[:4] == ["request", "queue", "admit", "prefill"]
               for n in names)
    assert all(r["reason"] == "length" for r in roots)
    assert buckets == [6] * 4


def test_tracing_on_vs_off_parity(engines):
    """Tracing changes no token and no engine call: the same warm engine
    serves the same burst with tracing off and on, per package, and the
    compile counts stay flat."""
    for pkg, tracer_cls in (("torch", Tracer), ("jax", JaxTracer)):
        engine = engines[pkg]
        counts = engine.compile_counts_detailed()
        runs = []
        for sample in (0, 1):
            sched = _sched(pkg, engine, tracer_cls(sample=sample, ring=32))
            reqs = _workload(sched, pkg)
            runs.append([tuple(r.tokens) for r in reqs])
        assert runs[0] == runs[1], pkg
        assert engine.compile_counts_detailed() == counts
        assert engine.recompiles == {}


def test_tracing_off_records_nothing(engines):
    out = {}
    for pkg, tracer_cls in (("torch", Tracer), ("jax", JaxTracer)):
        tracer = tracer_cls(sample=0)
        sched = _sched(pkg, engines[pkg], tracer)
        reqs = _workload(sched, pkg, n=2)
        out[pkg] = (tracer.finished(), [r.trace.enabled for r in reqs],
                    "critical_path" in sched.metrics.report())
        events = (get_event_log() if pkg == "torch"
                  else jax_event_log()).tail(256)
        assert not any("trace" in e or "traces" in e for e in events)
    assert out["torch"] == out["jax"] == ([], [False, False], False)


# --------------------------------------------------------------------- #
# forced retention and the SLO storm                                     #
# --------------------------------------------------------------------- #

def test_shed_request_trace_retained_despite_sampling(engines):
    out = {}
    for pkg, tracer_cls in (("torch", Tracer), ("jax", JaxTracer)):
        tracer = tracer_cls(sample=1000, ring=32)   # sampling drops all
        sched = _sched(pkg, engines[pkg], tracer)
        req = sched.submit(np.array([1, 2], np.int32), 2, deadline_s=0.001)
        time.sleep(0.01)
        sched.step()
        with pytest.raises(TimeoutError):
            req.wait(timeout=1)
        kept = [t for t in tracer.finished(kind="serving")
                if t.deadline_miss]
        assert len(kept) == 1 and kept[0].trace_id == req.trace.trace_id
        log = get_event_log() if pkg == "torch" else jax_event_log()
        shed = [e for e in log.tail(64)
                if e["kind"] == "shed" and e.get("req") == req.id]
        assert shed and shed[0]["trace"] == req.trace.trace_id
        out[pkg] = ([s.name for s in kept[0].spans],
                    kept[0].root.labels["reason"], shed[0]["where"])
    assert out["torch"] == out["jax"] == (["request", "queue"], "shed",
                                          "queue")


def test_slo_burn_flips_on_deadline_miss_storm(jax_lm):
    """A delay injected at every prefill makes each admission blow a
    tight deadline: queued requests shed, the TTFT objective burns past
    1 and the breach event names offending traces, shed ones among them,
    on both packages."""
    cases = (
        ("torch", _torch_engine(n_slots=1), Tracer, FaultInjector,
         "serving.prefill_batch"),
        ("jax", _jax_engine(jax_lm, n_slots=1), JaxTracer, JaxInjector,
         "serving.prefill"))
    for pkg, engine, tracer_cls, injector_cls, point in cases:
        tracer = tracer_cls(sample=1, ring=64)
        if pkg == "torch":
            metrics = ServingMetrics(1)          # the fresh default registry
            reg, events = get_registry(), get_event_log()
            slo = SLOEngine(tracer=tracer)
            objective = LatencyObjective
        else:
            reg, events = JaxRegistry(), JaxEventLog()
            metrics = JaxMetrics(1, registry=reg, events=events)
            slo = JaxSLOEngine(registry=reg, events=events, tracer=tracer)
            objective = JaxObjective
        sched = _sched(pkg, engine, tracer, metrics=metrics,
                       default_deadline_s=0.02)
        slo.add(objective("ttft_p99", "serving_ttft_seconds",
                          threshold_s=0.02, windows=(30.0, 60.0)))
        assert slo.evaluate()["ttft_p99"]["compliant"]
        inj = injector_cls(seed=0)
        inj.arm(point, kind="delay", delay_s=0.06, times=None)
        with inj:
            reqs = [sched.submit(np.array([1 + i], np.int32), 2)
                    for i in range(4)]
            sched.run_until_idle()
        assert sum(r.state.value == "errored" for r in reqs) >= 1, pkg
        ent = slo.evaluate()["ttft_p99"]
        assert not ent["compliant"] and ent["max_burn_rate"] > 1.0, pkg
        snap = reg.snapshot()
        assert snap["gauges"][
            'slo_burn_rate{slo="ttft_p99",window="30s"}'] > 1.0
        breach = [e for e in events.tail(128) if e["kind"] == "slo_breach"
                  and e["slo"] == "ttft_p99"][-1]
        shed_ids = {r.trace.trace_id for r in reqs
                    if r.state.value == "errored"}
        assert shed_ids & set(breach["traces"]), pkg
        assert set(ent["offending_traces"]) >= shed_ids & set(
            ent["offending_traces"])


def test_slo_engine_defaults_to_the_process_tracer():
    """``tracer=None`` reads the default tracer, as the reference's does:
    an errored trace finished there is named by the breach."""
    eng = SLOEngine()
    eng.add(LatencyObjective("ttft", "serving_ttft_seconds",
                             threshold_s=0.1, windows=(60.0, 300.0)))
    t = get_tracer().trace("request", kind="serving")
    t.mark_error("Boom")
    t.finish()
    h = get_registry().histogram("serving_ttft_seconds", {"instance": "x"},
                                 unit="s")
    for v in [0.01] * 8 + [0.5] * 2:
        h.observe(v)
    ent = eng.evaluate()["ttft"]
    assert not ent["compliant"]
    assert ent["offending_traces"] == [t.trace_id]


# --------------------------------------------------------------------- #
# watchdog identity and the recompile guard                              #
# --------------------------------------------------------------------- #

def test_watchdog_fire_names_requests_and_traces(jax_lm):
    """A hang mid-decode fires the watchdog; its banner and its
    ``watchdog_fire`` event carry the in-flight request and trace ids, on
    both packages."""
    out = {}
    for pkg in ("torch", "jax"):
        sink = io.StringIO()
        dog = (Watchdog if pkg == "torch" else JaxWatchdog)(
            timeout=0.05, on_timeout="warn", _sink=sink)
        if pkg == "torch":
            engine = _torch_engine(n_slots=1, watchdog=dog)
            tracer, injector = Tracer(sample=1, ring=8), FaultInjector(seed=0)
            log = get_event_log()
        else:
            engine = _jax_engine(jax_lm, n_slots=1, watchdog=dog)
            tracer, injector = JaxTracer(sample=1, ring=8), JaxInjector(seed=0)
            log = jax_event_log()
        sched = _sched(pkg, engine, tracer)
        req = sched.submit(np.array([1, 2], np.int32), 3)
        sched.step()                        # admit (the prefill is watched)
        injector.arm("serving.decode", kind="delay", delay_s=0.25, times=1)
        with injector:
            sched.step()                    # the decode hangs; the dog fires
        assert dog.fired
        banner = sink.getvalue()
        assert f"reqs=[{req.id}]" in banner
        assert req.trace.trace_id in banner
        fires = [e for e in log.tail(128) if e["kind"] == "watchdog_fire"]
        assert fires and fires[-1]["reqs"] == [req.id]
        assert fires[-1]["traces"] == [req.trace.trace_id]
        sched.run_until_idle()
        out[pkg] = (req.state.value, len(req.tokens))
    assert out["torch"] == out["jax"] == ("done", 3)


class _Program:
    """A stand-in with an executable count, as both guards watch."""

    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


def test_recompile_guard_flags_the_ambient_trace():
    out = {}
    for pkg, guard_cls, tracer in (
            ("torch", RecompileGuard, get_tracer()),
            ("jax", JaxRecompileGuard, jax_get_tracer())):
        guard, prog = guard_cls(), _Program()
        guard.watch("decode", prog)
        with tracer.trace("train_step", kind="train", step=0):
            prog.n = 1
            guard.check()                   # the first build: no flag
        with tracer.trace("train_step", kind="train", step=1):
            prog.n = 3
            guard.check()                   # a recompile: flagged
        prog.n = 4
        guard.check()                       # no ambient trace: nothing
        out[pkg] = ([(t.root.labels["step"], t.error)
                     for t in tracer.finished(kind="train")],
                    guard.recompiles)
    assert out["torch"] == out["jax"] == (
        [(0, None), (1, "recompile:decode")], {"decode": 3})
