"""Fault injection and retry (``chainermn_torch.resilience``) against the
JAX package's: a seeded fault plan fires at the same calls, and
``RetryPolicy`` gives the same delays and the same telemetry."""

import threading
import time

import pytest

from chainermn_tpu import resilience as jres
from chainermn_tpu.resilience import cutpoints as jcut
from chainermn_torch import monitor as tmon
from chainermn_torch import resilience as tres
from chainermn_torch.resilience import cutpoints as tcut


def _fired(mod, arms, calls, seed):
    """Which of ``calls`` (cut-point names, in order) fire under a
    FaultInjector of ``mod`` seeded with ``seed`` and armed with
    ``arms``: a list of (call index, kind, fraction)."""
    inj = mod.FaultInjector(seed=seed)
    for point, kind, kw in arms:
        inj.arm(point, kind=kind, **kw)
    out = []
    with inj:
        for i, point in enumerate(calls):
            frac = mod.torn_fraction(point)
            if frac is not None:
                out.append((i, "torn_write", frac))
            try:
                mod.inject(point)
            except mod.InjectedFault as e:
                assert e.point == point
                out.append((i, "raise", None))
    return out, inj.fired_log


PLANS = {
    "after_times": [("checkpoint.write", "raise", dict(after=3, times=2))],
    "probability": [("checkpoint.save", "raise", dict(p=0.3, times=None))],
    "torn_write": [("checkpoint.write", "torn_write",
                    dict(frac=0.25, after=1, times=2)),
                   ("checkpoint.load", "raise", dict(p=0.5, times=3))],
    "isolation": [("checkpoint.load", "raise", dict(times=None))],
}
CALLS = (["checkpoint.save", "checkpoint.write", "checkpoint.load"] * 20
         + ["checkpoint.write"] * 10)


def test_cutpoint_catalog_matches():
    assert tcut.ALL_CUTPOINTS == jcut.ALL_CUTPOINTS
    assert tcut.DYNAMIC_PREFIXES == jcut.DYNAMIC_PREFIXES
    assert tcut.comm_point("allreduce") == jcut.comm_point("allreduce")
    for name in ("CHECKPOINT_SAVE", "CHECKPOINT_WRITE", "CHECKPOINT_LOAD"):
        assert getattr(tcut, name) == getattr(jcut, name)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_seeded_plan_fires_at_the_same_calls(plan, seed):
    got = _fired(tres, PLANS[plan], CALLS, seed)
    want = _fired(jres, PLANS[plan], CALLS, seed)
    assert got == want
    assert got[0], "the plan fired nothing"


def test_noop_without_an_injector():
    assert tres.get_injector() is None
    tres.inject("checkpoint.save")
    assert tres.torn_fraction("checkpoint.write") is None


def test_delay_and_hang():
    inj = tres.FaultInjector()
    inj.arm("checkpoint.save", kind="delay", delay_s=0.05, times=1)
    inj.arm("checkpoint.load", kind="hang", hang_s=30.0, times=1)
    with inj:
        t0 = time.perf_counter()
        tres.inject("checkpoint.save")
        assert time.perf_counter() - t0 >= 0.04
        threading.Timer(0.1, inj.release).start()
        t0 = time.perf_counter()
        tres.inject("checkpoint.load")       # blocks until released
        assert 0.05 <= time.perf_counter() - t0 < 10.0
    assert tres.get_injector() is None


def test_fault_emits_event_and_counter():
    c = tmon.get_registry().counter(
        "faults_injected_total", {"point": "checkpoint.save", "kind": "raise"})
    before = c.value
    inj = tres.FaultInjector()
    inj.arm("checkpoint.save", kind="raise", times=1)
    with inj, pytest.raises(tres.InjectedFault):
        tres.inject("checkpoint.save", iteration=4)
    assert c.value == before + 1
    ev = [e for e in tmon.get_event_log().tail(20)
          if e["kind"] == "fault_injected"][-1]
    assert ev["point"] == "checkpoint.save" and ev["iteration"] == 4


@pytest.mark.parametrize("kw", [
    dict(base_delay_s=0.1, multiplier=2.0, max_delay_s=0.5, jitter=0),
    dict(base_delay_s=0.05, jitter=0.5, seed=3),
    dict(base_delay_s=0.2, multiplier=3.0, jitter=0.25, seed=11),
])
def test_retry_delays_match(kw):
    a = tres.RetryPolicy(max_attempts=9, **kw)
    b = jres.RetryPolicy(max_attempts=9, **kw)
    assert [a.delay_s(k) for k in range(1, 9)] == \
        [b.delay_s(k) for k in range(1, 9)]


def test_retry_absorbs_injected_transients_with_telemetry():
    reg = tmon.get_registry()
    retries = reg.counter("retries_total", {"op": "t.torch"})
    exhausted = reg.counter("retries_exhausted_total", {"op": "t.torch"})
    r0, e0 = retries.value, exhausted.value
    calls = []

    def write():
        calls.append(1)
        tres.inject("checkpoint.write")
        return "ok"

    policy = tres.RetryPolicy(max_attempts=3, base_delay_s=0.001, jitter=0)
    inj = tres.FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=2)
    with inj:
        assert policy.call(write, op="t.torch") == "ok"
    assert len(calls) == 3 and retries.value == r0 + 2
    inj = tres.FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=None)
    with inj, pytest.raises(tres.InjectedFault):
        policy.wrap(write, op="t.torch")()
    assert exhausted.value == e0 + 1
    with pytest.raises(ValueError):
        tres.RetryPolicy(max_attempts=0)
