"""The port's cost ledger (``chainermn_torch.monitor.costs``) held to the
JAX package's (mirrors ``tests/monitor_tests/test_costs.py``).

Every ledger here is a :class:`Twin`: one ledger of each package, each
with its own registry and event ring, fed the same script of
``record_*``/``note_preempt``/``finalize``/``flush`` calls. Each call's
return value must agree, and at the end of the test both ledgers'
``payload()`` and ``report()`` must agree to 1e-12, both registries hold
the same instruments with the same values, their Prometheus expositions
are line for line identical, and both event rings carry the same events
(sequence numbers and wall times aside). The reference's own assertions
then run on the port's side. Pure host arithmetic: intervals are passed
in, never measured.
"""

import random

import pytest

from chainermn_torch.monitor import costs as tcosts
from chainermn_torch.monitor.events import EventLog as TEventLog
from chainermn_torch.monitor.registry import MetricsRegistry as TRegistry
from chainermn_torch.monitor.timeseries import TimeSeriesStore as TStore
from chainermn_tpu.monitor import costs as jcosts
from chainermn_tpu.monitor.events import EventLog as JEventLog
from chainermn_tpu.monitor.registry import MetricsRegistry as JRegistry
from chainermn_tpu.monitor.timeseries import TimeSeriesStore as JStore

KINDS = tcosts.KINDS
UNATTRIBUTED = tcosts.UNATTRIBUTED
TOL = 1e-12


def _same(a, b, where="value"):
    """``a`` (JAX side) equals ``b`` (port side): dicts by key, sequences
    item by item, floats within ``TOL``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where,
                                                                   a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def _instrument_values(reg) -> dict:
    counters, gauges, hists = reg._by_kind()
    return {i.key: (i.kind, float(i.value)) for i in counters + gauges}


def _events(log) -> list:
    return [{k: v for k, v in e.items() if k not in ("i", "t")}
            for e in log.tail()]


class Twin:
    """One ledger of each package driven by the same calls. Attribute
    reads and method calls go to both and must agree; the port's result
    is returned. ``reg``/``events`` are the port's."""

    def __init__(self, instance="i0", **kw):
        kw.setdefault("flush_event_every_s", 3600.0)
        self.jreg, self.jev = JRegistry(), JEventLog()
        self.reg, self.events = TRegistry(), TEventLog()
        self.j = jcosts.CostLedger(instance=instance, registry=self.jreg,
                                   events=self.jev, **kw)
        self.t = tcosts.CostLedger(instance=instance, registry=self.reg,
                                   events=self.events, **kw)
        _LIVE.append(self)

    def __getattr__(self, name):
        jm, tm = getattr(self.j, name), getattr(self.t, name)
        if not callable(jm):
            _same(jm, tm, name)
            return tm

        def call(*args, **kwargs):
            jr, tr = jm(*args, **kwargs), tm(*args, **kwargs)
            _same(jr, tr, name)
            return tr

        return call

    def check(self):
        _same(self.j.payload(), self.t.payload(), "payload")
        _same(self.j.report(), self.t.report(), "report")
        _same(_instrument_values(self.jreg), _instrument_values(self.reg),
              "registry")
        assert (self.jreg.exposition().splitlines()
                == self.reg.exposition().splitlines())
        assert _events(self.jev) == _events(self.events)


_LIVE: list = []


@pytest.fixture(autouse=True)
def _twins_agree():
    """Every twin a test built ends in the same state on both sides."""
    _LIVE.clear()
    yield
    for twin in _LIVE:
        twin.check()
    _LIVE.clear()


def _ledger(**kw):
    return Twin(**kw)


# ---------------------------------------------------------------------- #
# prefill: token-share split, padding rows                                #
# ---------------------------------------------------------------------- #


def test_prefill_splits_by_token_share_and_pads_empty_rows():
    led = _ledger()
    out = led.record_prefill(0.4, bucket=64, batch_rows=2,
                             members=[(1, "a", 32)])
    assert out[("a", "useful")] == pytest.approx(0.1)
    assert out[("a", "padding")] == pytest.approx(0.1)
    assert out[(UNATTRIBUTED, "padding")] == pytest.approx(0.2)
    assert sum(out.values()) == pytest.approx(0.4)
    assert led.conservation_error < 1e-9


def test_prefill_clamps_suffix_into_bucket():
    led = _ledger()
    out = led.record_prefill(0.2, bucket=8, batch_rows=2,
                             members=[(1, "a", 99), (2, "b", -3)])
    assert out[("a", "useful")] == pytest.approx(0.1)
    assert ("a", "padding") not in out
    assert out[("b", "padding")] == pytest.approx(0.1)
    assert ("b", "useful") not in out
    assert sum(out.values()) == pytest.approx(0.2)


def test_prefill_batch_rows_floor_is_member_count():
    led = _ledger()
    out = led.record_prefill(0.3, bucket=4, batch_rows=1,
                             members=[(1, "a", 4), (2, "a", 4), (3, "b", 4)])
    assert out[("a", "useful")] == pytest.approx(0.2)
    assert out[("b", "useful")] == pytest.approx(0.1)
    assert sum(out.values()) == pytest.approx(0.3)


# ---------------------------------------------------------------------- #
# decode: even row split, speculative accept/waste, idle rows            #
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("committed,rejected,useful_frac", [
    (1, 3, 0.25),
    (3, 1, 0.75),
    (4, 0, 1.0),
])
def test_decode_spec_split(committed, rejected, useful_frac):
    led = _ledger()
    out = led.record_decode(0.4, n_rows=4,
                            rows=[(1, "a", committed, rejected)])
    assert out.get(("a", "useful"), 0.0) == pytest.approx(0.1 * useful_frac)
    assert out.get(("a", "wasted"), 0.0) == pytest.approx(
        0.1 * (1.0 - useful_frac))
    assert out[(UNATTRIBUTED, "idle")] == pytest.approx(0.3)
    assert sum(out.values()) == pytest.approx(0.4)
    assert led.conservation_error < 1e-9


def test_decode_plain_rows_and_idle():
    led = _ledger()
    out = led.record_decode(0.2, n_rows=2, rows=[(1, "a", 1, 0),
                                                 (2, "b", 1, 0)])
    assert out[("a", "useful")] == pytest.approx(0.1)
    assert out[("b", "useful")] == pytest.approx(0.1)
    assert (UNATTRIBUTED, "idle") not in out
    assert sum(out.values()) == pytest.approx(0.2)


# ---------------------------------------------------------------------- #
# KV block-seconds: refcount split integral                              #
# ---------------------------------------------------------------------- #


def test_block_seconds_refcount_split_sums_to_pool_occupancy():
    led = _ledger()
    led.record_block_seconds(2.0, [("a", 2.5), ("b", 0.5)])
    led.record_block_seconds(0.0, [("a", 99.0)])      # dt <= 0 ignored
    led.record_block_seconds(1.0, [("a", 0.0)])       # share <= 0 ignored
    rep = led.report()
    assert rep["tenants"]["a"]["kv_block_s"] == pytest.approx(5.0)
    assert rep["tenants"]["b"]["kv_block_s"] == pytest.approx(1.0)


# ---------------------------------------------------------------------- #
# preempt-and-replay: the double-booking guard                           #
# ---------------------------------------------------------------------- #


def test_replay_prefill_books_once_then_reverts_to_useful():
    led = _ledger()
    led.note_preempt(1, "a", 0)
    out = led.record_prefill(0.1, bucket=4, batch_rows=1,
                             members=[(1, "a", 4)])
    assert out == {("a", "replay"): pytest.approx(0.1)}
    out2 = led.record_prefill(0.1, bucket=4, batch_rows=1,
                              members=[(1, "a", 4)])
    assert out2 == {("a", "useful"): pytest.approx(0.1)}


def test_replay_decode_debt_is_token_metered_and_drains_once():
    led = _ledger()
    led.note_preempt(1, "a", 3)
    out = led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
    assert out == {("a", "replay"): pytest.approx(0.1)}
    out = led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
    assert out[("a", "replay")] == pytest.approx(0.05)
    assert out[("a", "useful")] == pytest.approx(0.05)
    out = led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
    assert out == {("a", "useful"): pytest.approx(0.1)}
    assert led.conservation_error < 1e-9


def test_second_preempt_adds_only_newly_discarded_tokens():
    led = _ledger()
    led.note_preempt(1, "a", 4)
    led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
    led.note_preempt(1, "a", 2)
    drained = 0.0
    for _ in range(4):
        out = led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
        drained += out.get(("a", "replay"), 0.0)
    assert drained == pytest.approx(0.2)


def test_finalize_clears_replay_state_and_is_idempotent():
    led = _ledger()
    led.note_preempt(1, "a", 5)
    led.finalize(1)
    led.finalize(1)
    out = led.record_prefill(0.1, bucket=4, batch_rows=1,
                             members=[(1, "a", 4)])
    assert out == {("a", "useful"): pytest.approx(0.1)}
    out = led.record_decode(0.1, n_rows=1, rows=[(1, "a", 2, 0)])
    assert out == {("a", "useful"): pytest.approx(0.1)}


# ---------------------------------------------------------------------- #
# queue wait                                                              #
# ---------------------------------------------------------------------- #


def test_queue_wait_accumulates_and_ignores_nonpositive():
    led = _ledger()
    led.record_queue_wait("a", 0.25)
    led.record_queue_wait("a", 0.75)
    led.record_queue_wait("a", -1.0)
    led.record_queue_wait("b", 0.0)
    rep = led.report()
    assert rep["tenants"]["a"]["queue_wait_s"] == pytest.approx(1.0)
    assert "b" not in rep["tenants"]


# ---------------------------------------------------------------------- #
# flush: registry fold, goodput gauges, cost_flush event                 #
# ---------------------------------------------------------------------- #


def test_flush_folds_counters_gauges_and_emits_event_once():
    led = _ledger()
    reg, ev = led.reg, led.events
    led.record_prefill(0.4, bucket=64, batch_rows=2, members=[(1, "a", 32)])
    led.record_block_seconds(2.0, [("a", 1.0)])
    led.flush(force_event=True)
    assert reg.counter("tenant_device_seconds_total",
                       {"instance": "i0", "tenant": "a",
                        "kind": "useful"}).value == pytest.approx(0.1)
    assert reg.counter("tenant_kv_block_seconds_total",
                       {"instance": "i0",
                        "tenant": "a"}).value == pytest.approx(2.0)
    fracs = {k: reg.gauge("goodput_fraction",
                          {"instance": "i0", "kind": k}).value
             for k in KINDS}
    assert fracs["useful"] == pytest.approx(0.25)
    assert fracs["padding"] == pytest.approx(0.75)
    assert sum(fracs.values()) == pytest.approx(1.0)
    assert reg.gauge("cost_conservation_error",
                     {"instance": "i0"}).value == pytest.approx(0.0)
    assert [e["kind"] for e in ev.tail()].count("cost_flush") == 1
    led.flush()        # idle: no double increment, no second event
    assert reg.counter("tenant_device_seconds_total",
                       {"instance": "i0", "tenant": "a",
                        "kind": "useful"}).value == pytest.approx(0.1)
    assert [e["kind"] for e in ev.tail()].count("cost_flush") == 1


def test_series_key_helpers_match_registry_rendering():
    for mod, registry in ((tcosts, TRegistry()), (jcosts, JRegistry())):
        c = registry.counter("tenant_device_seconds_total",
                             {"tenant": "a", "kind": "useful",
                              "instance": "i0"})
        assert c.key == mod.tenant_device_key("i0", "a", "useful")
        b = registry.counter("tenant_kv_block_seconds_total",
                             {"tenant": "a", "instance": "i0"})
        assert b.key == mod.tenant_block_key("i0", "a")
    assert tcosts.KINDS == jcosts.KINDS
    assert tcosts.UNATTRIBUTED == jcosts.UNATTRIBUTED


# ---------------------------------------------------------------------- #
# report / merge / ranking                                               #
# ---------------------------------------------------------------------- #


def test_report_shape_and_goodput_partition():
    led = _ledger()
    led.record_prefill(0.4, bucket=64, batch_rows=2, members=[(1, "a", 32)])
    led.record_decode(0.4, n_rows=4, rows=[(1, "a", 3, 1), (2, "b", 1, 0)])
    rep = led.report()
    assert set(rep) == {"tenants", "goodput", "device_time"}
    assert set(rep["goodput"]) == set(KINDS)
    assert sum(rep["goodput"].values()) == pytest.approx(1.0, abs=1e-5)
    assert rep["device_time"]["dispatches"] == 2
    assert rep["device_time"]["conservation_error"] == pytest.approx(0.0)
    assert rep["device_time"]["max_dispatch_error"] == pytest.approx(0.0)
    assert rep["device_time"]["attributed_s"] == pytest.approx(
        rep["device_time"]["measured_s"])
    assert UNATTRIBUTED in rep["tenants"]


def test_merge_cost_payloads_pools_replicas():
    a, b = _ledger(), _ledger()
    a.record_prefill(0.4, bucket=4, batch_rows=1, members=[(1, "t0", 4)])
    b.record_prefill(0.6, bucket=4, batch_rows=1, members=[(2, "t0", 4)])
    b.record_decode(0.2, n_rows=2, rows=[(2, "t1", 1, 0)])
    b.record_queue_wait("t1", 0.5)
    merged = tcosts.merge_cost_payloads([a.t.payload(), b.t.payload()])
    _same(jcosts.merge_cost_payloads([a.j.payload(), b.j.payload()]),
          merged, "merged")
    assert merged["tenants"]["t0"]["device_s"]["useful"] == pytest.approx(1.0)
    assert merged["tenants"]["t1"]["device_s"]["useful"] == pytest.approx(0.1)
    assert merged["tenants"]["t1"]["queue_wait_s"] == pytest.approx(0.5)
    assert merged["device_time"]["dispatches"] == 3
    assert merged["device_time"]["conservation_error"] == pytest.approx(0.0)
    assert tcosts.merge_cost_payloads([]) == jcosts.merge_cost_payloads([])


def test_top_tenant_excludes_unattributed():
    led = _ledger()
    assert led.top_tenant() is None
    led.record_prefill(0.4, bucket=64, batch_rows=4, members=[(1, "a", 64)])
    led.record_decode(0.4, n_rows=2, rows=[(2, "b", 1, 0)])
    tenant, secs = led.top_tenant()
    assert tenant == "b"
    assert secs == pytest.approx(0.2)
    assert UNATTRIBUTED not in led.tenant_device_seconds()


# ---------------------------------------------------------------------- #
# conservation property: fuzzed schedule                                 #
# ---------------------------------------------------------------------- #


def _fuzz_conservation(seed):
    rng = random.Random(seed)
    led = _ledger()
    live = []
    for i in range(300):
        op = rng.random()
        if op < 0.35 or not live:
            live.append((i, rng.choice(["a", "b", "c"])))
            members = [(r, t, rng.randint(0, 80))
                       for r, t in rng.sample(live, min(len(live), 4))]
            led.record_prefill(rng.uniform(1e-6, 0.5),
                               bucket=rng.choice([16, 64]),
                               batch_rows=rng.randint(1, 4),
                               members=members)
        elif op < 0.75:
            rows = [(r, t, rng.randint(1, 5), rng.randint(0, 4))
                    for r, t in rng.sample(live, min(len(live), 4))]
            led.record_decode(rng.uniform(1e-6, 0.5),
                              n_rows=rng.randint(1, 4), rows=rows)
        elif op < 0.85:
            rid, t = rng.choice(live)
            led.note_preempt(rid, t, rng.randint(0, 12))
        elif op < 0.95:
            led.record_block_seconds(
                rng.uniform(0.0, 0.1),
                [(t, rng.uniform(0.0, 8.0)) for _, t in live[:3]])
        else:
            rid, _ = live.pop(rng.randrange(len(live)))
            led.finalize(rid)
        if rng.random() < 0.1:
            led.flush()
    led.flush(force_event=True)
    pay = led.t.payload()
    assert led.conservation_error < 1e-9
    assert pay["max_dispatch_error"] < 1e-9
    assert pay["dispatches"] > 0
    assert {k.split("\x00")[1] for k in pay["device"]} <= set(KINDS)


def test_conservation_fuzzed_schedule():
    _fuzz_conservation(1234)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 99, 2024])
def test_conservation_fuzzed_schedule_soak(seed):
    _fuzz_conservation(seed)


# ---------------------------------------------------------------------- #
# sensors: share signal + noisy-neighbor detector                        #
# ---------------------------------------------------------------------- #
# Each runs the same script on both packages' store, event ring and
# sensor classes, and the two stores and event rings must agree.

SIDES = ((jcosts, JStore, JEventLog), (tcosts, TStore, TEventLog))


def _both(script):
    """``script(costs_module, Store, EventLog)`` on both packages; its
    returned ``(store, events, extra)`` must agree. The port's result."""
    res = [script(*side) for side in SIDES]
    (js, je, jx), (ts, te, tx) = res
    _same(js.to_json(), ts.to_json(), "store")
    assert _events(je) == _events(te)
    _same(jx, tx, "result")
    return res[1]


def test_share_of_total_skips_until_total_positive():
    def script(mod, Store, Log):
        store = Store(maxlen=16)
        sig = mod.ShareOfTotal("r:a", ["r:a", "r:b"], name="share:a")
        seen = []
        sig.evaluate(store, 1.0)
        seen.append(store.last("share:a"))
        store.append("r:a", 2.0, 0.0)
        store.append("r:b", 2.0, 0.0)
        sig.evaluate(store, 2.0)
        seen.append(store.last("share:a"))
        store.append("r:a", 3.0, 3.0)
        store.append("r:b", 3.0, 1.0)
        sig.evaluate(store, 3.0)
        seen.append(store.last("share:a"))
        return store, Log(), seen

    _, _, seen = _both(script)
    assert seen[0] is None and seen[1] is None
    assert seen[2] == (3.0, pytest.approx(0.75))


def test_noisy_neighbor_threshold_mode_names_tenant_on_rising_edge():
    def script(mod, Store, Log):
        store, ev = Store(maxlen=16), Log()
        det = mod.NoisyNeighborDetector("nn", "share:a", tenant="bulk",
                                        threshold=0.6)
        verdicts = [det.evaluate(store, 1.0, events=ev)]
        store.append("share:a", 2.0, 0.9)
        verdicts.append(det.evaluate(store, 2.0, events=ev))
        store.append("share:a", 3.0, 0.95)
        verdicts.append(det.evaluate(store, 3.0, events=ev))
        return store, ev, verdicts

    _, ev, verdicts = _both(script)
    assert verdicts[0]["firing"] is False and verdicts[0]["tenant"] == "bulk"
    assert verdicts[1]["firing"] is True
    nn = [e for e in ev.tail() if e["kind"] == "noisy_neighbor"]
    assert len(nn) == 1
    assert (nn[0]["tenant"], nn[0]["detector"], nn[0]["series"]) == (
        "bulk", "nn", "share:a")
    assert any(e["kind"] == "detector_fired" for e in ev.tail())


def test_noisy_neighbor_z_mode_fires_on_rate_spike():
    def script(mod, Store, Log):
        store, ev = Store(maxlen=256), Log()
        det = mod.NoisyNeighborDetector("nn", "r:a", tenant="bulk", z=3.0,
                                        baseline=32, min_points=8)
        firing = []
        for i in range(32):
            store.append("r:a", float(i), 1.0 + 0.01 * (i % 3))
            firing.append(det.evaluate(store, float(i),
                                       events=ev)["firing"])
        store.append("r:a", 40.0, 50.0)
        return store, ev, [firing, det.evaluate(store, 40.0, events=ev)]

    _, ev, (firing, last) = _both(script)
    assert not any(firing)
    assert last["firing"] is True and last["tenant"] == "bulk"
    assert [e["tenant"] for e in ev.tail()
            if e["kind"] == "noisy_neighbor"] == ["bulk"]


def test_standard_tenant_sensors_wiring():
    def describe(signals, detectors):
        return ([(s.name, s.num, s.siblings) for s in signals],
                [(d.name, d.series, d.tenant, d.threshold)
                 for d in detectors])

    kits = []
    for mod in (jcosts, tcosts):
        kits.append([
            describe(*mod.standard_tenant_sensors(
                "bulk", "i0", tenants=["bulk", "quiet"],
                share_threshold=0.6, tag="t")),
            describe(*mod.standard_tenant_sensors("bulk", "i0",
                                                  rate_threshold=5.0)),
            describe(*mod.standard_tenant_sensors("bulk", "i0"))])
    _same(kits[0], kits[1], "kits")
    share, rate, zmode = kits[1]
    tenants = ["bulk", "quiet"]
    assert [s[0] for s in share[0]] == ["tenant_device_share:t",
                                        "tenant_block_share:t"]
    assert share[0][0][1] == tcosts.tenant_device_key(
        "i0", "bulk", "useful") + ":rate"
    assert share[0][0][2] == [tcosts.tenant_device_key(
        "i0", t, "useful") + ":rate" for t in tenants]
    assert share[1] == [("noisy_neighbor:t", "tenant_device_share:t",
                         "bulk", 0.6)]
    assert rate[1][0][1] == tcosts.tenant_device_key(
        "i0", "bulk", "useful") + ":rate"
    assert rate[1][0][3] == 5.0
    assert zmode[1][0][0] == "noisy_neighbor:bulk@i0"
    assert zmode[1][0][3] is None


# ---------------------------------------------------------------------- #
# the ledger on the scheduler: the port books what the reference books   #
# ---------------------------------------------------------------------- #

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from _torch_isolation import fresh_telemetry  # noqa: E402

from chainermn_torch.analysis import sanitizer  # noqa: E402
from chainermn_torch.interop import params_from_flax  # noqa: E402
from chainermn_torch.models import TransformerLM  # noqa: E402
from chainermn_torch.serving import (  # noqa: E402
    FCFSScheduler,
    RequestState,
    ServingEngine,
    SpeculativeConfig,
)
from chainermn_tpu.models import TransformerLM as JaxLM  # noqa: E402
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler  # noqa: E402
from chainermn_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from chainermn_tpu.serving import (  # noqa: E402
    SpeculativeConfig as JaxSpecConfig,
)

torch.set_float32_matmul_precision("highest")

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=1, max_len=64)
# the paged engine of the reference's conservation rig, and a speculative
# chunked twin with batched prefill over two buckets
RIGS = {
    "paged": dict(n_slots=2, prefill_len=6, paged=True, kv_blocks=64,
                  kv_block_size=2, decode_window=4, cache_len=48),
    "spec_chunked": dict(n_slots=3, prefill_buckets=(4, 8), prefill_batch=2,
                         paged=True, kv_blocks=96, kv_block_size=2,
                         cache_len=48),
    "dense": dict(n_slots=2, prefill_len=6, prefill_batch=2, paged=False,
                  cache_len=32),
}
RIGS["paged_peer"] = RIGS["paged"]      # a migration's destination


@pytest.fixture(scope="module")
def lms():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return lm, params, model


_ENGINES: dict = {}


def _engine(lms, pkg, rig):
    """One warm engine per (package, rig) for the module."""
    key = (pkg, rig)
    if key not in _ENGINES:
        kw = dict(RIGS[rig])
        if rig == "spec_chunked":
            kw["speculative"] = (JaxSpecConfig if pkg == "jax"
                                 else SpeculativeConfig)(k=3)
        lm, params, model = lms
        eng = (JaxEngine(lm, params, **kw) if pkg == "jax"
               else ServingEngine(model, device="cpu", **kw))
        eng.warmup()
        _ENGINES[key] = eng
    return _ENGINES[key]


class CallLog:
    """A ledger that logs each call without its measured interval (the
    timing-free part of the booking), then books it."""

    def __init__(self, ledger, log):
        self._ledger, self._log = ledger, log

    def __getattr__(self, name):
        fn = getattr(self._ledger, name)
        if not callable(fn):
            return fn

        def call(*args, **kw):
            self._log.append(_describe(name, args, kw))
            return fn(*args, **kw)

        return call


def _describe(name, args, kw) -> tuple:
    if name == "record_prefill":
        return (name, kw["bucket"], kw["batch_rows"],
                tuple(tuple(m) for m in kw["members"]))
    if name == "record_decode":
        return (name, kw["n_rows"], tuple(tuple(r) for r in kw["rows"]))
    if name == "record_migration":
        return (name, kw["req_id"], kw["tenant"])
    if name == "record_block_seconds":
        return (name, tuple((t, round(float(s), 9)) for t, s in args[1]))
    if name == "record_queue_wait":
        return (name, args[0])
    return (name,) + tuple(args)


def _submit(sched, pkg, prompt, n, i, **kw):
    seed = ({"rng": jax.random.PRNGKey(100 + i)} if pkg == "jax"
            else {"seed": 100 + i})
    return sched.submit(np.asarray(prompt, np.int32), n, **seed, **kw)


def _logged(sched, log):
    sched.costs = CallLog(sched.costs, log)
    return sched


# prompts with repeats for the n-gram drafter, of 3..8 tokens (cut to
# the 6 of prefill_len on the other rigs)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5], [6, 7, 8, 9, 6, 7, 8],
           [10, 11, 3], [12, 13, 12, 13, 12, 13], [14, 3, 14]]
TENANTS = ["bulk", "quiet", "bulk", "gold", "bulk", "quiet"]


def _scenario(lms, pkg, name):
    """One traffic scenario on ``pkg``'s scheduler; returns the ledger
    call log, the token streams and the schedulers."""
    log = []
    Sched = JaxScheduler if pkg == "jax" else FCFSScheduler
    if name == "migrate":
        sa = _logged(Sched(_engine(lms, pkg, "paged"),
                           chunk_tokens_per_step=2), log)
        sb = _logged(Sched(_engine(lms, pkg, "paged_peer")), log)
        sa.migrate_cb = lambda req, payload: bool(
            sb.enqueue_migrated(req, payload))
        reqs = [_submit(sa, pkg, PROMPTS[0][:6], 6, 0, tenant="bulk")]
        for _ in range(400):
            sa.step()
            sb.step()
            if reqs[0].finished:
                break
        return log, [r.tokens for r in reqs], [sa, sb], reqs
    if name == "preempt":
        eng = _engine(lms, pkg, "paged")
        sched = _logged(Sched(eng, fair=True), log)
        batch = _submit(sched, pkg, PROMPTS[1], 12, 0, priority="batch",
                        tenant="bulk")
        sched.step()
        inter = _submit(sched, pkg, PROMPTS[0][:3], 12, 1,
                        priority="interactive", tenant="quiet")
        sched.step()
        victim = max(dict(sched._by_slot).values(), key=sched._preempt_key)
        assert victim is batch
        sched._preempt(victim, reason="kv_pool_dry")
        sched.run_until_idle()
        reqs = [batch, inter]
        return log, [r.tokens for r in reqs], [sched], reqs
    rig = "spec_chunked" if name == "spec_chunked" else name
    kw = {"chunk_tokens_per_step": 4, "fair": True} \
        if name == "spec_chunked" else {}
    sched = _logged(Sched(_engine(lms, pkg, rig), **kw), log)
    cut = 8 if name == "spec_chunked" else 6
    reqs = [_submit(sched, pkg, p[:cut], 6, i, tenant=t)
            for i, (p, t) in enumerate(zip(PROMPTS, TENANTS))]
    sched.run_until_idle()
    return log, [r.tokens for r in reqs], [sched], reqs


@pytest.mark.parametrize("name", ["paged", "spec_chunked", "dense",
                                  "preempt", "migrate"])
def test_scheduler_books_the_reference_calls(lms, name, monkeypatch):
    """The same traffic on the JAX scheduler and the port's books the
    same sequence of ledger calls (method, request, tenant, rows or
    members, bucket, batch rows; the intervals aside) and streams the
    same tokens; every port ledger conserves."""
    fresh_telemetry(monkeypatch)
    jlog, jstreams, _, _ = _scenario(lms, "jax", name)
    tlog, tstreams, scheds, reqs = _scenario(lms, "torch", name)
    assert tstreams == jstreams
    assert all(r.state is RequestState.DONE for r in reqs)
    assert tlog == jlog
    methods = {entry[0] for entry in tlog}
    assert {"record_decode", "flush", "finalize"} <= methods
    want = {"spec_chunked": {"record_prefill", "record_block_seconds",
                             "tenant_device_seconds"},
            "preempt": {"note_preempt", "record_block_seconds"},
            "migrate": {"record_migration"}}.get(name, {"record_prefill"})
    assert want <= methods
    if name == "spec_chunked":
        assert any(r[3] > 0 for e in tlog if e[0] == "record_decode"
                   for r in e[2]), "no draft was rejected"
    if name == "migrate":
        # handed over to an engine of its own: solo generate()'s stream
        from chainermn_tpu.models import generate

        lm, params, _ = lms
        prompt = PROMPTS[0][:6]
        solo = np.asarray(generate(lm, params, jnp.asarray(
            prompt, jnp.int32)[None], 6)[0])[len(prompt):]
        assert tstreams == [[int(t) for t in solo]]
    for s in scheds:
        assert s.costs.conservation_error < 1e-6


# ---------------------------------------------------------------------- #
# conservation on a live scheduler (tests/serving_tests/                 #
# test_cost_conservation.py)                                             #
# ---------------------------------------------------------------------- #

C_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11], [12], [13, 14, 3]]
C_TENANTS = ["bulk", "bulk", "quiet", "bulk", "quiet", "bulk"]
C_MAX_NEW = 9


@pytest.fixture
def sanitized():
    """The port's sanitizer on (instrumented locks, the fuzzer's sync
    points) for schedulers built inside the test."""
    sanitizer.reset()
    sanitizer.enable()
    yield
    sanitizer.reset()
    sanitizer.disable()


def _assert_conserved(sched):
    pay = sched.costs.payload()
    assert pay["dispatches"] > 0
    assert sched.costs.conservation_error < 1e-6
    assert pay["max_dispatch_error"] < 1e-6
    assert {k.split("\x00")[1] for k in pay["device"]} <= set(KINDS)
    ranked = sched.costs.tenant_device_seconds()
    assert set(ranked) <= {"bulk", "quiet"}
    assert all(s > 0.0 for s in ranked.values())
    assert UNATTRIBUTED not in ranked


def _run_fuzzed(sched, seed):
    import threading

    stop = threading.Event()

    def drive():
        while not stop.is_set():
            sched.step()

    with sanitizer.fuzz(seed, p=0.3, sleep_s=0.0005,
                        points=("lock:", "guarded:", "mutate:")):
        t = threading.Thread(target=drive, daemon=True)
        t.start()
        try:
            reqs = [sched.submit(np.asarray(p, np.int32), C_MAX_NEW,
                                 tenant=tenant)
                    for p, tenant in zip(C_PROMPTS, C_TENANTS)]
            for r in reqs:
                assert r.wait(timeout=120)
        finally:
            stop.set()
            t.join(30)
    assert not t.is_alive()
    return reqs


def test_sequential_schedule_conserves_device_time(lms):
    sched = FCFSScheduler(_engine(lms, "torch", "paged"))
    assert isinstance(sched.costs, tcosts.CostLedger)
    assert sched.metrics.costs is sched.costs
    reqs = [sched.submit(np.asarray(p, np.int32), C_MAX_NEW, tenant=t)
            for p, t in zip(C_PROMPTS, C_TENANTS)]
    sched.run_until_idle()
    assert all(r.state is RequestState.DONE for r in reqs)
    _assert_conserved(sched)
    ranked = sched.costs.tenant_device_seconds()
    assert ranked["bulk"] > ranked["quiet"]
    assert sched.metrics.report()["costs"]["device_time"][
        "conservation_error"] < 1e-6
    off = FCFSScheduler(_engine(lms, "torch", "paged"),
                        cost_accounting=False)
    assert off.costs is None and off.metrics.costs is None
    req = off.submit(np.asarray(C_PROMPTS[0], np.int32), C_MAX_NEW)
    off.run_until_idle()
    assert req.tokens == reqs[0].tokens
    assert "costs" not in off.metrics.report()


def test_fuzzed_schedule_conserves_device_time(lms, sanitized):
    sched = FCFSScheduler(_engine(lms, "torch", "paged"))
    reqs = _run_fuzzed(sched, seed=1234)
    assert [r.state for r in reqs] == [RequestState.DONE] * len(C_PROMPTS)
    _assert_conserved(sched)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 99, 2024])
def test_fuzzed_conservation_soak(lms, sanitized, seed):
    sched = FCFSScheduler(_engine(lms, "torch", "paged"))
    reqs = _run_fuzzed(sched, seed)
    assert [r.state for r in reqs] == [RequestState.DONE] * len(C_PROMPTS)
    _assert_conserved(sched)


def test_chunked_schedule_conserves_device_time(lms, sanitized):
    sched = FCFSScheduler(_engine(lms, "torch", "paged"),
                          chunk_tokens_per_step=2)
    reqs = _run_fuzzed(sched, seed=77)
    assert [r.state for r in reqs] == [RequestState.DONE] * len(C_PROMPTS)
    _assert_conserved(sched)


def test_migrated_request_books_migrate_kind(lms):
    eng = _engine(lms, "torch", "paged")
    sa = FCFSScheduler(eng, chunk_tokens_per_step=2)
    sb = FCFSScheduler(eng)
    sa.migrate_cb = lambda req, payload: bool(
        sb.enqueue_migrated(req, payload))
    r = sa.submit(np.asarray([1, 2, 3, 4, 5, 6], np.int32), C_MAX_NEW,
                  tenant="bulk")
    for _ in range(400):
        sa.step()
        sb.step()
        if r.finished:
            break
    assert r.state is RequestState.DONE, (r.state, r.error)
    kinds = {k.split("\x00")[1] for k in sa.costs.payload()["device"]}
    assert "migrate" in kinds
    _assert_conserved(sa)
    _assert_conserved(sb)
    assert sa.costs.tenant_device_seconds()["bulk"] > 0.0
