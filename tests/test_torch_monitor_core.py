"""The rest of the port's ``monitor`` core held to the JAX package's
(mirrors ``tests/monitor_tests/test_monitor.py`` and the training part of
``test_wiring.py``): the Prometheus exposition (text equal to the
reference's for the same registry operations), ``aggregate`` over two
gloo ranks, ``merge_rank_payloads``, the event dump's device-memory
lines, the CUDA memory gauges, profiler annotations, ``instrument``,
the monitored train steps, the metric/event catalog, and the
``parallel``/``ops`` facades' mesh helpers.
"""

import ast
import inspect
import io
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from _torch_isolation import fresh_telemetry
from chainermn_torch import monitor
from chainermn_torch.monitor import catalog as tcatalog
from chainermn_torch.monitor import events as tevents
from chainermn_torch.monitor.instrument import record_memory_gauges
from chainermn_torch.monitor.registry import MetricsRegistry as TRegistry
from chainermn_torch.monitor.registry import merge_rank_payloads as tmerge
from chainermn_torch.testing import run_ranks
from chainermn_tpu.monitor import catalog as jcatalog
from chainermn_tpu.monitor.registry import MetricsRegistry as JRegistry
from chainermn_tpu.monitor.registry import merge_rank_payloads as jmerge

PKG = pathlib.Path(__file__).resolve().parents[1] / "chainermn_torch"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _populate(reg):
    """The same registry operations on either package's registry."""
    reg.counter("served_total", {"inst": "0"}).inc(7)
    reg.counter("served_total", {"inst": "1"}).inc(2)
    reg.counter("plain_total").inc()
    reg.gauge("occupancy").set(0.5)
    reg.gauge("kv_blocks_free", {"instance": "3"}).set(1234567.0)
    h = reg.histogram("ttft_seconds", {"inst": "0"}, unit="s")
    for v in (0.25, 0.5, 0.125, 2.0):
        h.observe(v)
    q = reg.histogram("queue_depth")
    for v in range(17):
        q.observe(float(v))
    reg.histogram("empty_seconds", unit="s")
    return reg


# --------------------------------------------------------------------- #
# exposition                                                            #
# --------------------------------------------------------------------- #

def test_exposition_text_equals_the_reference():
    ours = _populate(TRegistry()).exposition()
    theirs = _populate(JRegistry()).exposition()
    assert ours.splitlines() == theirs.splitlines()
    assert "# TYPE served_total counter" in ours
    assert 'served_total{inst="0"} 7' in ours
    assert 'ttft_seconds{inst="0",quantile="0.5"} 0.375' in ours
    assert 'ttft_seconds_count{inst="0"} 4' in ours
    assert ours.endswith("\n")
    assert TRegistry().exposition() == JRegistry().exposition() == ""


def test_facade_exposition_reads_the_default_registry():
    _populate(monitor.get_registry())
    assert monitor.exposition() == _populate(JRegistry()).exposition()


# --------------------------------------------------------------------- #
# cross-rank aggregation                                                #
# --------------------------------------------------------------------- #

class _FakeComm:
    def __init__(self, payloads):
        self._payloads = payloads

    def allgather_obj(self, obj):
        return self._payloads


def test_aggregate_merges_ranks_like_the_reference():
    def build(Registry):
        regs = [Registry() for _ in range(2)]
        for r, reg in enumerate(regs):
            reg.counter("steps_total").inc(10 * (r + 1))
            reg.gauge("occupancy").set(float(r))
            h = reg.histogram("ttft_seconds", unit="s")
            for v in ([0.01] * 9 if r == 0 else [0.01] * 4 + [1.0] * 5):
                h.observe(v)
        return regs

    tregs, jregs = build(TRegistry), build(JRegistry)
    ours = tregs[0].aggregate(_FakeComm([r._rank_payload() for r in tregs]))
    theirs = jregs[0].aggregate(_FakeComm([r._rank_payload()
                                           for r in jregs]))
    assert ours == theirs
    assert ours["ranks"] == 2 and ours["counters"]["steps_total"] == 30
    assert ours["gauges"]["occupancy"] == pytest.approx(0.5)
    assert ours["histograms"]["ttft_seconds"]["p99_s"] > 0.5


def test_merge_rank_payloads_handles_empty():
    assert tmerge([]) == jmerge([])
    assert tmerge([])["ranks"] == 0
    one = [{"counters": {}, "gauges": {}, "hist": {}}]
    assert tmerge(one) == jmerge(one)
    assert tmerge(one)["counters"] == {} and tmerge(one)["histograms"] == {}


_AGG = """
from chainermn_torch import create_communicator, monitor
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import train_step

comm = create_communicator("flat", device="cpu")
reg = monitor.get_registry()
reg.counter("requests_total", {"rank": str(RANK)}).inc(3 + RANK)
reg.counter("shared_total").inc(10 * (RANK + 1))
reg.gauge("occupancy").set(float(RANK))
h = reg.histogram("ttft_seconds", unit="s")
for v in ([0.01] * 9 if RANK == 0 else [0.01] * 4 + [1.0] * 5):
    h.observe(v)
model = MLP(8, 4, torch.float32, n_in=6, device="cpu", seed=0)
opt = create_multi_node_optimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), comm)
step = train_step(model, opt, comm)
gen = torch.Generator().manual_seed(RANK)
for _ in range(3):
    step(torch.randn(4, 6, generator=gen), torch.randint(0, 4, (4,)))
payload = reg._rank_payload()
save({"payload": payload, "aggregate": reg.aggregate(comm),
      "facade": monitor.aggregate(comm)})
comm.finalize()
"""


@pytest.fixture(scope="module")
def agg_ranks():
    return run_ranks(_AGG, 2, timeout=240)


@pytest.mark.parametrize("rank", [0, 1])
def test_aggregate_over_two_gloo_ranks(agg_ranks, rank):
    """Every rank returns the same merge, the reference's merge of the
    two ranks' payloads: counters summed (the monitored train step's
    ``steps_total`` is 2 x 3), gauges averaged, histograms pooled."""
    out = agg_ranks[rank]
    want = jmerge([r["payload"] for r in agg_ranks])
    assert out["aggregate"] == want
    assert out["facade"]["counters"] == want["counters"]
    c = want["counters"]
    assert c['requests_total{rank="0"}'] == 3
    assert c['requests_total{rank="1"}'] == 4
    assert c["shared_total"] == 30
    assert c['steps_total{step="train_step"}'] == 6
    assert want["gauges"]["occupancy"] == pytest.approx(0.5)
    assert want["histograms"]["ttft_seconds"]["count"] == 18
    assert want["histograms"]["ttft_seconds"]["p99_s"] > 0.5


# --------------------------------------------------------------------- #
# the event dump and the device-memory lines                            #
# --------------------------------------------------------------------- #

def test_event_dump_writes_memory_lines_after_the_events():
    log = tevents.EventLog()
    log.emit("step_start", step="s", n=1)
    buf = io.StringIO()
    assert log.dump(file=buf, memory=True) == 1
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("chainermn_torch flight recorder: last 1")
    assert '"kind": "step_start"' in lines[1]
    assert lines[2] == "device memory:"
    assert lines[3].startswith("  device memory unavailable")
    assert lines[-1] == "end flight recorder"
    bare = io.StringIO()
    log.dump(file=bare, memory=False)
    assert "device memory" not in bare.getvalue()
    # the once= guard still holds with memory lines on
    guarded = io.StringIO()
    assert log.dump(file=guarded, once="x") == 1
    assert log.dump(file=guarded, once="x") == 0
    assert guarded.getvalue().count("device memory:") == 1


def test_device_memory_lines_never_raise(monkeypatch):
    assert tevents.device_memory_lines() == [
        "device memory unavailable: no CUDA device"]

    def broken():
        raise RuntimeError("CUDA context is dead")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    (line,) = tevents.device_memory_lines()
    assert line.startswith("device memory unavailable: RuntimeError")
    buf = io.StringIO()
    log = tevents.EventLog()
    log.emit("x")
    assert log.dump(file=buf) == 1          # the events still dump


class _FakeCuda:
    """``torch.cuda``'s memory surface for one device, on the CPU."""

    def __init__(self, monkeypatch, current, peak, fail=False):
        def stats(i):
            if fail:
                raise RuntimeError("boom")
            return {"allocated_bytes.all.current": current,
                    "allocated_bytes.all.peak": peak}

        for name, fn in (("is_available", lambda: True),
                         ("is_initialized", lambda: True),
                         ("device_count", lambda: 1),
                         ("memory_stats", stats),
                         ("get_device_name", lambda i: "Fake H100"),
                         ("get_device_properties",
                          lambda i: type("P", (), {"total_memory": 8e10}))):
            monkeypatch.setattr(torch.cuda, name, fn)


def test_memory_lines_and_gauges_read_the_allocator(monkeypatch):
    reg = TRegistry()
    record_memory_gauges(reg)
    assert reg.snapshot()["gauges"] == {}      # the CPU records nothing
    _FakeCuda(monkeypatch, current=5e8, peak=7e8)
    record_memory_gauges(reg)
    assert reg.snapshot()["gauges"] == {
        'device_bytes_in_use{device="0"}': 5e8,
        'device_peak_bytes_in_use{device="0"}': 7e8}
    assert tevents.device_memory_lines() == [
        "device 0 (Fake H100): in_use=500.0MB peak=700.0MB "
        "limit=80000.0MB"]


def test_a_broken_device_records_nothing_and_reports_why(monkeypatch):
    _FakeCuda(monkeypatch, current=1, peak=1, fail=True)
    reg = TRegistry()
    record_memory_gauges(reg)
    assert reg.snapshot()["gauges"] == {}
    (line,) = tevents.device_memory_lines()
    assert line == "device 0: memory_stats unavailable: RuntimeError: boom"


def test_snapshot_refreshes_memory_gauges_unless_told_not_to(monkeypatch):
    _FakeCuda(monkeypatch, current=3.0, peak=4.0)
    assert monitor.snapshot(memory=False)["gauges"] == {}
    snap = monitor.snapshot()
    assert snap["gauges"]['device_bytes_in_use{device="0"}'] == 3.0
    assert set(snap) == {"counters", "gauges", "histograms"}


def test_emit_writes_the_default_ring():
    monitor.emit("checkpoint", path="/x")
    (ev,) = monitor.get_event_log().tail(1)
    assert ev["kind"] == "checkpoint" and ev["path"] == "/x"


# --------------------------------------------------------------------- #
# annotations                                                           #
# --------------------------------------------------------------------- #

def _profiled_names(fn) -> set:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_annotate_is_free_without_a_profiler_and_named_under_one():
    ann = monitor.annotate("chainermn.eval")
    with ann:
        assert ann._rf is None        # no profiler: no record_function

    def body():
        with monitor.annotate("chainermn.eval"):
            torch.ones(3).sum()

    assert "chainermn.eval" in _profiled_names(body)


def test_collectives_are_annotated():
    from chainermn_torch import create_communicator

    comm = create_communicator("flat", device="cpu")
    try:
        x = torch.arange(4.0)

        def body():
            comm.allreduce(x)
            comm.allreduce(x, "mean")
            comm.allgather(x)
            comm.bcast(x)
            comm.scatter(x[None])
            comm.alltoall(x[None])
            comm.ppermute(x, [(0, 0)])

        names = _profiled_names(body)
    finally:
        comm.finalize()
    assert {"chainermn.allreduce_sum", "chainermn.allreduce_mean",
            "chainermn.allgather", "chainermn.bcast", "chainermn.scatter",
            "chainermn.alltoall", "chainermn.ppermute"} <= names


def test_engine_calls_are_annotated():
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import FCFSScheduler, ServingEngine

    model = TransformerLM(17, d_model=16, n_heads=4, n_layers=1,
                          max_len=32, compute_dtype=torch.float32,
                          device="cpu", seed=0)
    engine = ServingEngine(model, n_slots=2, prefill_len=6, cache_len=24,
                           kv_block_size=2, device="cpu")
    engine.warmup()
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3]), 3)
    names = _profiled_names(sched.run_until_idle)
    assert {"chainermn.serving_admit", "chainermn.serving_prefill",
            "chainermn.prefill", "chainermn.serving_decode",
            "chainermn.decode"} <= names


# --------------------------------------------------------------------- #
# instrument and the monitored train steps                              #
# --------------------------------------------------------------------- #

def test_instrument_is_call_transparent():
    assert inspect.isfunction(monitor.instrument)
    from chainermn_torch.monitor.instrument import RecompileGuard

    assert RecompileGuard is monitor.RecompileGuard

    def f(a, b=2):
        return a * b

    f.tag = "mine"
    reg, log = TRegistry(), tevents.EventLog()
    wrapped = monitor.instrument(f, "f", registry=reg, events=log,
                                 memory_interval=2)
    assert wrapped(3) == 6 and wrapped(3, b=5) == 15
    assert wrapped.tag == "mine" and wrapped.inner is f
    assert repr(wrapped).startswith("<MonitoredFunction 'f'")
    assert reg.counter("steps_total", {"step": "f"}).value == 2
    assert reg.histogram("step_time_seconds", {"step": "f"},
                         unit="s").count == 2
    kinds = [(e["kind"], e["n"]) for e in log.tail()]
    assert kinds == [("step_start", 1), ("step_end", 1),
                     ("step_start", 2), ("step_end", 2)]
    again = monitor.instrument(wrapped, "g", registry=reg, events=log)
    assert again.inner is f          # re-instrumenting does not stack
    assert isinstance(again, monitor.MonitoredFunction)


def test_train_steps_are_monitored_by_default():
    from chainermn_torch import create_communicator
    from chainermn_torch.models import MLP, TransformerLM
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training import lm_train_step, train_step

    comm = create_communicator("flat", device="cpu")
    try:
        model = MLP(8, 4, torch.float32, n_in=6, device="cpu", seed=0)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), comm)
        step = train_step(model, opt, comm)
        assert isinstance(step, monitor.MonitoredFunction)
        bare = train_step(model, opt, comm, monitored=False)
        assert not isinstance(bare, monitor.MonitoredFunction)
        counter = monitor.get_registry().counter("steps_total",
                                                 {"step": "train_step"})
        x, y = torch.randn(4, 6), torch.randint(0, 4, (4,))
        for _ in range(3):
            step(x, y)
        bare(x, y)
        assert counter.value == 3
        kinds = [e["kind"] for e in monitor.get_event_log().tail(10)]
        assert "step_start" in kinds and "step_end" in kinds

        lm = TransformerLM(17, d_model=16, n_heads=2, n_layers=1,
                           max_len=8, compute_dtype=torch.float32,
                           device="cpu", seed=0)
        lstep = lm_train_step(lm, create_multi_node_optimizer(
            torch.optim.SGD(lm.parameters(), lr=0.1), comm), comm)
        tok = torch.randint(0, 17, (2, 8))
        names = _profiled_names(lambda: lstep(tok, tok))
        assert {"chainermn.step.lm_train_step",
                "chainermn.lm_train_step"} <= names
        assert monitor.get_registry().counter(
            "steps_total", {"step": "lm_train_step"}).value == 1
        names = _profiled_names(lambda: step(x, y))
        assert {"chainermn.step.train_step", "chainermn.train_step"} <= names
    finally:
        comm.finalize()


# --------------------------------------------------------------------- #
# the catalog                                                           #
# --------------------------------------------------------------------- #

def _emitted():
    """Every literal name the port's code passes to ``counter``/
    ``gauge``/``histogram`` (metrics) and ``emit`` (events)."""
    metrics, events = set(), set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            if node.func.attr in ("counter", "gauge", "histogram"):
                metrics.add(node.args[0].value)
            elif node.func.attr == "emit":
                events.add(node.args[0].value)
    return metrics, events


def test_catalog_names_every_metric_and_event_the_port_emits():
    metrics, events = _emitted()
    assert {"tenant_device_seconds_total", "goodput_fraction",
            "cost_conservation_error", "steps_total",
            "device_bytes_in_use"} <= metrics
    assert {"cost_flush", "noisy_neighbor", "step_start"} <= events
    assert metrics - tcatalog.METRIC_NAMES == set()
    assert events - tcatalog.EVENT_KINDS == set()
    # the reference's names, every one of them
    assert jcatalog.METRIC_NAMES <= tcatalog.METRIC_NAMES
    assert jcatalog.EVENT_KINDS <= tcatalog.EVENT_KINDS
    for name in tcatalog.METRIC_NAMES | tcatalog.EVENT_KINDS:
        assert re.fullmatch(r"[a-z][a-z0-9_]*", name), name


# --------------------------------------------------------------------- #
# the parallel facade's meshes                                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_meshes_pick_the_reference_grid(n, monkeypatch):
    from chainermn_torch import parallel
    from chainermn_tpu.parallel import mesh as jmesh

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    devs = jax.devices()[:n]
    ref = jmesh.make_hierarchical_mesh(devs)
    ours = parallel.make_hierarchical_mesh(n)
    assert ours.axis_names == ref.axis_names == ("inter", "intra")
    assert ours.ranks.shape == ref.devices.shape
    np.testing.assert_array_equal(ours.ranks.reshape(-1), np.arange(n))
    flat = parallel.make_mesh(n)
    assert flat.axis_names == jmesh.make_mesh(devs).axis_names == (
        parallel.DEFAULT_AXIS,)
    assert flat.ranks.shape == (n,)
    # several nodes: intra is a node's ranks, as the reference's
    # process-local devices
    if n in (4, 8):
        assert parallel.make_hierarchical_mesh(
            n, local_world_size=2).ranks.shape == (n // 2, 2)
