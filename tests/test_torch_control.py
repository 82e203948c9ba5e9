"""The port's fleet control plane against the JAX package's: the same
scenario, driven by ``Collector.tick(now=)`` and ``FleetController.
tick(now=)`` with the same injected clock, runs on a fleet of each
package (ports of ``tests/fleet_tests/test_control.py``,
``test_control_chaos.py``, ``test_fleet_publish.py``'s rolling publish and
dead-replica skip, and ``test_fleet_health.py``). Each scenario returns a
trace (the controller's decisions and reports, the version log, which
weights each replica holds, health verdicts and every stream served) and
the two traces must be equal; every stream must also equal JAX
``generate()`` on the flax weights of the version it ran on (greedy,
float32, exact tokens). The port's weights are the JAX package's carried
across with ``interop.params_from_flax``; a bump of every tensor by a
constant commutes with that conversion exactly.

The port copies weights where the reference can keep a reference
(``swap_params`` writes in place): a rollback must bring back the
pre-canary weights, and the same test with the controller's copies
planted as references must fail."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_isolation import fresh_telemetry

import chainermn_tpu.fleet as jfleet
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.monitor import health as jhealth
from chainermn_tpu.monitor import timeseries as jts
from chainermn_tpu.resilience import FaultInjector as JFaultInjector
from chainermn_tpu.serving import ServingEngine as JEngine
import chainermn_torch.fleet as tfleet
from chainermn_torch.fleet import control as tcontrol
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import health as thealth
from chainermn_torch.monitor import timeseries as tts
from chainermn_torch.resilience import FaultInjector as TFaultInjector
from chainermn_torch.resilience.cutpoints import DEPLOY_PUBLISH
from chainermn_torch.serving import ServingEngine

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=1, max_len=48)
ENGINE = dict(n_slots=2, prefill_len=6, cache_len=32)
NEVER = 1e9           # a hysteresis window no test reaches
WAIT = 120
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8], [9, 10], [3, 1, 4]]
N_NEW = 5


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


class _Pkg:
    """One package's fleet, engines and weights behind one surface."""

    def __init__(self, name, fleet, health, ts, injector, v0, make_engine,
                 weights_of, bump):
        self.name, self.fleet, self.health, self.ts = name, fleet, health, ts
        self.FaultInjector = injector
        self.v0 = v0
        self._make_engine, self.weights_of, self.bump = (make_engine,
                                                         weights_of, bump)
        self.engines = 0

    def make_engine(self, params=None):
        self.engines += 1
        return self._make_engine(self.v0 if params is None else params)


def _jax_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _torch_equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def lm():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


def _torch_engine(state):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    return ServingEngine(model, paged=False, device="cpu", **ENGINE)


@pytest.fixture
def pkgs(lm):
    jlm, params = lm
    jax_pkg = _Pkg(
        "jax", jfleet, jhealth, jts, JFaultInjector, params,
        lambda p: JEngine(jlm, p, **ENGINE), lambda e: e.params,
        lambda p, d=0.01: jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(d, a.dtype), p))
    torch_pkg = _Pkg(
        "torch", tfleet, thealth, tts, TFaultInjector,
        params_from_flax(jax.device_get(params)), _torch_engine,
        lambda e: e.model.state_dict(),
        lambda s, d=0.01: {k: v + d for k, v in s.items()})
    return torch_pkg, jax_pkg


def _equal(pkg, a, b):
    return (_torch_equal if pkg.name == "torch" else _jax_equal)(a, b)


def _twin(pkgs, scenario, *args):
    """``scenario(pkg, *args)`` on both packages: equal traces."""
    got = scenario(pkgs[0], *args)
    want = scenario(pkgs[1], *args)
    assert got == want
    return got


_SOLO: dict = {}


def _solo(lm, jax_params, prompt, n=N_NEW):
    key = (id(jax_params), tuple(prompt), n)
    if key not in _SOLO:
        out = jax_generate(lm[0], jax_params,
                           jnp.asarray([prompt], jnp.int32), n)
        _SOLO[key] = [int(t) for t in np.asarray(out[0])[len(prompt):]]
    return _SOLO[key]


def _serve(router, prompts=PROMPTS, n=N_NEW):
    frs = [router.submit(np.asarray(p, np.int32), n) for p in prompts]
    for fr in frs:
        assert fr.wait(timeout=WAIT) and fr.state.name == "DONE"
    return [[int(t) for t in fr.tokens] for fr in frs]


def _held(pkg, router, versions):
    """Which of ``versions`` each replica's engine holds (None: none)."""
    out = []
    for r in router.replicas:
        w = pkg.weights_of(r.engine)
        out.append(next((i for i, v in enumerate(versions)
                         if _equal(pkg, w, v)), None))
    return out


def _acts(summary):
    return [a["action"] for a in summary["actions"]]


def _wait(pred, what):
    deadline = time.perf_counter() + 60
    while time.perf_counter() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# --------------------------------------------------------------------- #
# the reflex arc                                                         #
# --------------------------------------------------------------------- #


def _reflex_arc(pkg):
    f = pkg.fleet
    v1 = pkg.bump(pkg.v0)
    v2 = pkg.bump(v1)
    versions = [pkg.v0, v1, v2]
    tr = {}
    with f.FleetRouter([pkg.make_engine()], autostart=False) as router:
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        mon = col.health
        ctrl = f.FleetController(
            router, col, engine_factory=pkg.make_engine,
            autoscale=f.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                        queue_high=2.0, up_after_s=1.0,
                                        down_after_s=NEVER, cooldown_s=0.0),
            canary=f.CanaryPolicy(bake_s=2.0),
            sensor_kw=dict(stall_timeout_s=60.0))
        # replica 0 is not driving yet: the queue depth is real pressure
        frs = [router.submit(np.array([1 + i, 2], np.int32), 2)
               for i in range(6)]
        col.tick(now=1.0)
        s1 = ctrl.tick(now=1.0)
        tr["s1"] = (s1["signals"]["pressure"], s1["actions"],
                    router.capacity)
        col.tick(now=2.5)
        s2 = ctrl.tick(now=2.5)
        tr["s2"] = (s2["actions"], len(router.replicas), mon.keys,
                    ctrl.report()["autoscale"]["scale_ups"])
        router.start()
        assert router.wait_ready(300)
        for fr in frs:
            assert fr.wait(timeout=WAIT)
        tr["queued"] = [(fr.state.name, [int(t) for t in fr.tokens])
                        for fr in frs]
        tr["v0"] = (_held(pkg, router, versions), _serve(router))
        live = [router.submit(np.array([7 + i], np.int32), 2)
                for i in range(6)]
        for fr in live:
            assert fr.wait(timeout=WAIT)
        tr["spread"] = sorted({fr.replica_id for fr in live})
        ctrl.deploy(v1, step=1)
        tr["pending"] = ctrl.report()["phase"]
        col.tick(now=3.0)
        s3 = ctrl.tick(now=3.0)
        tr["s3"] = (s3["actions"], ctrl.report()["phase"],
                    sorted(_held(pkg, router, versions)))
        col.tick(now=4.0)
        tr["s4"] = ctrl.tick(now=4.0)["actions"]
        tr["bake_serves"] = _serve(router, [[5, 6]], 2)
        col.tick(now=5.1)
        s5 = ctrl.tick(now=5.1)
        tr["s5"] = (s5["actions"], _held(pkg, router, versions),
                    (ctrl.log.current.version, ctrl.log.current.source))
        tr["v1"] = _serve(router)
        ctrl.deploy(v2, step=2)
        col.tick(now=6.0)
        s6 = ctrl.tick(now=6.0)
        rid = s6["actions"][0]["replica"]
        # a regression on the canary only
        mon.add_detectors(str(rid), pkg.ts.ThresholdDetector(
            f"chaos@{rid}", "chaos_signal", threshold=0.5,
            severity="degraded"))
        col.store.append("chaos_signal", 6.5, 1.0)
        col.tick(now=6.5)
        tr["s6"] = (s6["actions"], mon.level(str(rid)),
                    _held(pkg, router, versions))
        s7 = ctrl.tick(now=6.5)
        tr["s7"] = (s7["actions"], _held(pkg, router, versions),
                    (ctrl.log.current.version, ctrl.log.current.source))
        tr["rolled_back"] = _serve(router)
        tr["recompiles"] = [r.engine.recompiles for r in router.replicas]
        rep = ctrl.report()
        tr["report"] = {k: rep[k] for k in ("phase", "target_replicas",
                                            "capacity", "versions",
                                            "decisions")}
        tr["report"]["canary"] = {k: rep["canary"][k] for k in (
            "deploys", "promotes", "rollbacks", "last_outcome")}
        fleet = router.fleet_report()
        tr["fleet"] = (fleet["control"]["phase"],
                       fleet["health"]["n_watched"],
                       [r["weight_version"]
                        for r in fleet["replicas"].values()])
    return tr


def test_reflex_arc_scale_up_canary_promote_rollback_as_the_reference(
        lm, pkgs):
    """A sustained queue breach scales up and the spawned replica serves;
    a canary bakes and promotes; a regressing canary rolls every replica
    back to the promoted weights, with nothing dropped and no program
    rebuilt."""
    tr = _twin(pkgs, _reflex_arc)
    v1 = pkgs[1].bump(pkgs[1].v0)
    assert tr["s1"] == (["queue_depth"], [], 1)
    assert [a["action"] for a in tr["s2"][0]] == ["scale_up"]
    assert tr["s2"][1:] == (2, ["0", "1"], 1)
    assert tr["v0"][0] == [0, 0] and tr["spread"] == [0, 1]
    assert tr["v0"][1] == [_solo(lm, pkgs[1].v0, p) for p in PROMPTS]
    assert tr["pending"] == "pending"
    assert tr["s3"][1:] == ("baking", [0, 1]) and tr["s4"] == []
    assert [a["action"] for a in tr["s5"][0]] == ["canary_promote"]
    assert tr["s5"][1:] == ([1, 1], (1, "publish"))
    assert tr["v1"] == [_solo(lm, v1, p) for p in PROMPTS]
    assert tr["s6"][1] == 1
    a = tr["s7"][0][0]
    assert (a["action"], a["reason"], a["rolled_back_to"]) == (
        "canary_rollback", "regression", 1)
    assert tr["s7"][1:] == ([1, 1], (1, "rollback"))
    assert tr["rolled_back"] == tr["v1"]
    assert tr["recompiles"] == [{}, {}]
    assert [e["source"] for e in tr["report"]["versions"]["history"]] == [
        "init", "canary", "publish", "canary", "rollback"]
    assert tr["report"]["canary"]["deploys"] == 2
    # engine-local versions: the canary swapped three times (v1, v2,
    # rollback), its peer twice (promote, rollback)
    assert tr["fleet"] == ("idle", 2, [3, 2])


def _rollback_run(pkg):
    """Promote v1, then a regressing canary of v2: the streams after the
    rollback against the streams before the canary."""
    f = pkg.fleet
    v1 = pkg.bump(pkg.v0)
    v2 = pkg.bump(v1, 0.05)
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        ctrl = f.FleetController(router, col,
                                 canary=f.CanaryPolicy(bake_s=1.0))
        ctrl.deploy(v1)
        col.tick(now=1.0)
        ctrl.tick(now=1.0)
        col.tick(now=2.5)
        assert _acts(ctrl.tick(now=2.5)) == ["canary_promote"]
        before = _serve(router)
        ctrl.deploy(v2)
        col.tick(now=3.0)
        rid = ctrl.tick(now=3.0)["actions"][0]["replica"]
        col.health.add_detectors(str(rid), pkg.ts.ThresholdDetector(
            f"chaos@{rid}", "chaos", threshold=0.5, severity="degraded"))
        col.store.append("chaos", 3.5, 1.0)
        col.tick(now=3.5)
        assert _acts(ctrl.tick(now=3.5)) == ["canary_rollback"]
        after = _serve(router)
        held = _held(pkg, router, [pkg.v0, v1, v2])
    return before, after, held


@pytest.mark.parametrize("variant", ["honest", "planted_alias"])
def test_rollback_stream_equals_the_pre_canary_stream(lm, pkgs, variant,
                                                       monkeypatch):
    """The rollback gate: every stream after a rollback equals the
    stream before the canary. ``planted_alias`` keeps the pre-canary
    weights as references to the engine's live tensors, as the
    reference may with immutable arrays: the swap overwrites them, the
    rollback republishes the canary's weights, and the gate must fail."""
    torch_pkg = pkgs[0]
    if variant == "planted_alias":
        monkeypatch.setattr(tcontrol, "_private_copy", dict)
    before, after, held = _rollback_run(torch_pkg)
    assert before == [_solo(lm, pkgs[1].bump(pkgs[1].v0), p)
                      for p in PROMPTS]
    if variant == "honest":
        assert after == before and held == [1, 1]
    else:
        assert after != before and held == [2, 2]


# --------------------------------------------------------------------- #
# autoscaler, retire, rebalance, guards                                  #
# --------------------------------------------------------------------- #


def _scale_down(pkg):
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        mon = col.health
        ctrl = f.FleetController(
            router, col, engine_factory=pkg.make_engine,
            autoscale=f.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                        queue_high=NEVER, idle_low=0.25,
                                        up_after_s=1.0, down_after_s=2.0,
                                        cooldown_s=0.0),
            sensor_kw=dict(stall_timeout_s=60.0))
        tr = {"served": _serve(router, [[1, 2, 3]], 2)}
        col.tick(now=1.0)
        tr["s1"] = ctrl.tick(now=1.0)["actions"]
        col.tick(now=3.5)
        tr["s2"] = ctrl.tick(now=3.5)["actions"]
        victim = tr["s2"][0]["replica"]
        tr["after"] = (router.capacity,
                       router.replicas[victim].state.value, mon.keys)
        later = []
        for now in (6.0, 9.0, 12.0):
            col.tick(now=now)
            later.append(ctrl.tick(now=now)["actions"])
        tr["later"] = (later, router.capacity)
        fr = router.submit(np.array([4, 5], np.int32), 2)
        assert fr.wait(timeout=WAIT)
        tr["survivor"] = (fr.replica_id, [int(t) for t in fr.tokens])
    return tr


def test_scale_down_retires_idle_replica_and_respects_min(pkgs):
    tr = _twin(pkgs, _scale_down)
    a = tr["s2"][0]
    assert tr["s1"] == [] and a["action"] == "scale_down"
    assert a["signals"] == ["idle"] and not a["forced"]
    assert tr["after"] == (1, "retired", [str(1 - a["replica"])])
    assert tr["later"] == ([[], [], []], 1)
    assert tr["survivor"][0] == 1 - a["replica"]


def _retire_during_warmup(pkg):
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        eng = pkg.make_engine()
        gate = threading.Event()
        eng.warmup = gate.wait
        spawned = router.spawn_replica(engine=eng, wait_ready=False)
        tr = [spawned.state.value, spawned.accepting]
        threading.Timer(0.2, gate.set).start()
        out = router.retire_replica(spawned.replica_id, timeout=5.0)
        spawned._thread.join(30)
        tr += [out["state"], out["forced"], spawned._thread.is_alive(),
               spawned.state.value, spawned.accepting, router.capacity]
    return tr


def test_retire_during_warmup_never_resurrects(pkgs):
    assert _twin(pkgs, _retire_during_warmup) == [
        "starting", True, "retired", False, False, "retired", False, 1]


def _rebalance(pkg):
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        mon = col.health
        ctrl = f.FleetController(router, col, rebalance=f.RebalancePolicy(
            degraded_weight=0.25))
        mon.add_detectors("0", pkg.ts.ThresholdDetector(
            "chaos@0", "chaos_signal", threshold=0.5, severity="degraded"))
        col.store.append("chaos_signal", 1.0, 1.0)
        col.tick(now=1.0)
        tr = [mon.level("0"), ctrl.tick(now=1.0)["actions"],
              router.admission_weight(0), router.admission_weight(1),
              ctrl.tick(now=1.5)["actions"],
              ctrl.report()["rebalance"]["weights"]]
        frep = router.fleet_report()
        tr += [frep["replicas"]["0"]["admission_weight"],
               frep["control"]["rebalance"]["weights"]["0"]]
        col.store.append("chaos_signal", 2.0, 0.0)
        col.tick(now=2.0)
        tr += [mon.level("0"), ctrl.tick(now=2.0)["actions"],
               router.admission_weight(0), ctrl.tick(now=2.5)["actions"]]
    return tr


def test_rebalance_sheds_degraded_weight_edge_triggered(pkgs):
    tr = _twin(pkgs, _rebalance)
    assert tr[:4] == [1, [{"action": "rebalance", "replica": 0,
                           "weight": 0.25, "level": 1}], 0.25, 1.0]
    assert tr[4:8] == [[], {"0": 0.25, "1": 1.0}, 0.25, 0.25]
    assert tr[8] == 0 and tr[9][0]["weight"] == 1.0
    assert tr[10:] == [1.0, []]


def test_controller_guards_as_the_reference(pkgs):
    for pkg in pkgs:
        f = pkg.fleet
        with f.FleetRouter([pkg.make_engine()], autostart=False) as router:
            col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
            with pytest.raises(ValueError, match="engine_factory"):
                f.FleetController(router, col,
                                  autoscale=f.AutoscalePolicy())
            with pytest.raises(ValueError, match="cadence_s"):
                f.FleetController(router, col, cadence_s=0.0)
            ctrl = f.FleetController(router, col, canary=f.CanaryPolicy())
            with pytest.raises(RuntimeError, match="canary policy"):
                f.FleetController(router, col).deploy(pkg.v0)
            ctrl.deploy(pkg.v0)
            with pytest.raises(RuntimeError, match="already in flight"):
                ctrl.deploy(pkg.v0)
            with pytest.raises(ValueError, match="mutually exclusive"):
                router.publish(pkg.v0, canary=0, exclude=(0,))
            rep = ctrl.report()
            assert (rep["phase"], rep["canary"]["policy"]["bake_s"],
                    rep["versions"]["current"]["source"]) == (
                        "pending", 5.0, "init")


def test_snapshot_spawn_falls_back_to_the_factory(pkgs):
    """The port's ``spawn_replica(checkpoint=)`` raises; a controller
    configured with a snapshot scales up from its factory instead,
    recorded as ``factory_fallback`` (the reference's path for a failed
    snapshot load)."""
    pkg = pkgs[0]
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine()], autostart=False) as router:
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        ctrl = f.FleetController(
            router, col, engine_factory=pkg.make_engine,
            snapshot=dict(checkpoint=object(),
                          engine_factory=lambda p: None,
                          params_template={}),
            autoscale=f.AutoscalePolicy(max_replicas=2, queue_high=0.5,
                                        up_after_s=0.0, cooldown_s=0.0))
        for i in range(3):
            router.submit(np.array([1 + i], np.int32), 2)
        col.tick(now=1.0)
        ctrl.tick(now=1.0)
        col.tick(now=1.5)
        s = ctrl.tick(now=1.5)
        assert [(a["action"], a["source"]) for a in s["actions"]] == [
            ("scale_up", "factory_fallback")]
        assert len(router.replicas) == 2


# --------------------------------------------------------------------- #
# control-plane chaos                                                    #
# --------------------------------------------------------------------- #


def _canary_killed(pkg):
    f = pkg.fleet
    v1 = pkg.bump(pkg.v0)
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        ctrl = f.FleetController(router, col,
                                 canary=f.CanaryPolicy(bake_s=5.0))
        ctrl.deploy(v1, step=1)
        col.tick(now=1.0)
        s1 = ctrl.tick(now=1.0)
        rid = s1["actions"][0]["replica"]
        survivor = router.replicas[1 - rid]
        router.replicas[rid].kill()
        _wait(lambda: router.replicas[rid].state.value == "quarantined",
              f"quarantine of canary {rid}")
        col.tick(now=2.0)
        s2 = ctrl.tick(now=2.0)
        tr = [s1["actions"], s2["actions"],
              (ctrl.log.current.version, ctrl.log.current.source),
              survivor.engine.weight_version,
              _held(pkg, router, [pkg.v0, v1])[1 - rid],
              survivor.engine.recompiles, ctrl.report()["phase"],
              ctrl.report()["canary"]["rollbacks"],
              ctrl.tick(now=7.0)["actions"]]
        fr = router.submit(np.array([1, 2, 3], np.int32), 2)
        assert fr.wait(timeout=WAIT)
        tr.append((fr.replica_id == 1 - rid, [int(t) for t in fr.tokens]))
    return tr


def test_canary_killed_mid_bake_aborts_cleanly(pkgs):
    tr = _twin(pkgs, _canary_killed)
    a = tr[1][0]
    assert (a["action"], a["reason"], a["rolled_back_to"]) == (
        "canary_rollback", "canary_lost", 0)
    assert a["signals"] == [f"replica_state@{tr[0][0]['replica']}"]
    assert tr[2:] [:6] == [(0, "rollback"), 0, 0, {}, "idle", 1]
    assert tr[8] == [] and tr[9][0]


def _promote_fault(pkg):
    f = pkg.fleet
    v1 = pkg.bump(pkg.v0)
    with f.FleetRouter([pkg.make_engine() for _ in range(3)]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        ctrl = f.FleetController(router, col,
                                 canary=f.CanaryPolicy(bake_s=2.0))
        inj = pkg.FaultInjector(seed=0)
        # hit 1 is the canary's own commit; hit 2, the promote's first
        # peer commit, fires
        inj.arm(DEPLOY_PUBLISH, kind="raise", after=1, times=1)
        with inj:
            ctrl.deploy(v1, step=1)
            col.tick(now=1.0)
            s1 = ctrl.tick(now=1.0)
            col.tick(now=3.5)
            s2 = ctrl.tick(now=3.5)
        tr = [[p for p, _ in inj.fired_log], s1["actions"], s2["actions"],
              (ctrl.log.current.version, ctrl.log.current.source),
              [r.accepting for r in router.replicas],
              _held(pkg, router, [pkg.v0, v1]),
              [r.engine.recompiles for r in router.replicas],
              ctrl.report()["canary"]["promotes"], _serve(router, [[4, 5]])]
    return tr


def test_promote_commit_fault_rolls_every_replica_back(lm, pkgs):
    tr = _twin(pkgs, _promote_fault)
    assert tr[0] == [DEPLOY_PUBLISH]
    a = tr[2][0]
    assert (a["action"], a["reason"], a["signals"], a["rolled_back_to"]) \
        == ("canary_rollback", "promote_failed", ["publish_error"], 0)
    assert tr[3:8] == [(0, "rollback"), [True] * 3, [0, 0, 0],
                       [{}, {}, {}], 0]
    assert tr[8] == [_solo(lm, pkgs[1].v0, [4, 5])]


def _soak(pkg, seed):
    rng = np.random.default_rng(seed)
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        mon = col.health
        ctrl = f.FleetController(router, col,
                                 canary=f.CanaryPolicy(bake_s=2.0))
        expected, now, tr = pkg.v0, 1.0, []
        for round_n in range(3):
            traffic = [list(rng.integers(1, 16, size=2))
                       for _ in range(int(rng.integers(1, 4)))]
            tr.append(_serve(router, traffic, 3))
            candidate = pkg.bump(expected, 0.01 * (round_n + 1))
            bad = bool(rng.integers(0, 2))
            ctrl.deploy(candidate, step=round_n)
            col.tick(now=now)
            s = ctrl.tick(now=now)
            rid = s["actions"][0]["replica"]
            tr.append(s["actions"])
            if bad:
                series = f"chaos_{seed}_{round_n}"
                mon.add_detectors(str(rid), pkg.ts.ThresholdDetector(
                    f"{series}@{rid}", series, threshold=0.5,
                    severity="degraded"))
                col.store.append(series, now + 0.5, 1.0)
                col.tick(now=now + 0.5)
                tr.append(ctrl.tick(now=now + 0.5)["actions"])
                col.store.append(series, now + 0.6, 0.0)
                col.tick(now=now + 0.6)
                tr.append(mon.level(str(rid)))
            else:
                col.tick(now=now + 2.5)
                tr.append(ctrl.tick(now=now + 2.5)["actions"])
                expected = candidate
            tr.append([_equal(pkg, pkg.weights_of(r.engine), expected)
                       for r in router.replicas])
            tr.append([r.engine.recompiles for r in router.replicas])
            now += 4.0
        tr.append(_serve(router, [[3, 1, 4]]))
    return tr


@pytest.mark.parametrize("seed", [
    0, pytest.param(1, marks=pytest.mark.slow),
    pytest.param(2, marks=pytest.mark.slow)])
def test_control_chaos_soak(pkgs, seed):
    """Random good and bad deploy rounds: bad canaries roll back, good
    ones promote, and after every round the whole fleet holds one
    version, with nothing rebuilt."""
    tr = _twin(pkgs, _soak, seed)
    held = [x for x in tr if isinstance(x, list) and x
            and all(isinstance(b, bool) for b in x)]
    assert len(held) == 3 and all(all(h) for h in held)


# --------------------------------------------------------------------- #
# the rolling publish                                                    #
# --------------------------------------------------------------------- #


def _rolling_publish(pkg, want_old, want_new):
    f = pkg.fleet
    v1 = pkg.bump(pkg.v0)
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()]) as router:
        assert router.wait_ready(300)
        frs = [router.submit(np.asarray(p, np.int32), N_NEW)
               for p in PROMPTS]
        out = router.publish(v1, step=42, timeout=120.0)
        for fr in frs:
            assert fr.wait(timeout=WAIT) and fr.state.name == "DONE"
            key = tuple(int(t) for t in fr.prompt)
            want = (want_old if fr.weight_version == 0 else want_new)[key]
            assert [int(t) for t in fr.tokens] == want
        post = _serve(router)
        tr = [out["ok"], sorted(out["replicas"]),
              [(r["ok"], r["version"]) for r in out["replicas"].values()],
              post, [r["weight_version"]
                     for r in router.fleet_report()["replicas"].values()],
              [r.engine.recompiles for r in router.replicas]]
    return tr


def test_rolling_publish_loses_no_request(lm, pkgs):
    """Traffic in flight on both replicas when the roll starts: every
    request finishes token-exactly on the weights its version says, and
    both replicas end on the new version with nothing rebuilt."""
    v1 = pkgs[1].bump(pkgs[1].v0)
    want_old = {tuple(p): _solo(lm, pkgs[1].v0, p) for p in PROMPTS}
    want_new = {tuple(p): _solo(lm, v1, p) for p in PROMPTS}
    tr = _twin(pkgs, _rolling_publish, want_old, want_new)
    assert tr[:3] == [True, ["0", "1"], [(True, 1), (True, 1)]]
    assert tr[3] == [want_new[tuple(p)] for p in PROMPTS]
    assert tr[4:] == [[1, 1], [{}, {}]]


def _publish_skips_dead(pkg):
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()],
                       max_restarts=0) as router:
        assert router.wait_ready(300)
        router.replicas[0].kill(RuntimeError("chaos"))
        _wait(lambda: not router.replicas[0].accepting, "replica 0 down")
        out = router.publish(pkg.bump(pkg.v0), timeout=120.0)
        return [out["ok"], sorted(out["replicas"]["0"]),
                out["replicas"]["1"]["ok"],
                router.replicas[1].engine.weight_version]


def test_publish_skips_dead_replica_and_reports(pkgs):
    assert _twin(pkgs, _publish_skips_dead) == [True, ["ok", "skipped"],
                                                True, 1]


# --------------------------------------------------------------------- #
# fleet health                                                           #
# --------------------------------------------------------------------- #


def _health_chaos(pkg):
    f = pkg.fleet
    with f.FleetRouter([pkg.make_engine(), pkg.make_engine()],
                       max_restarts=2) as router:
        assert router.wait_ready(300)
        col = pkg.health.fleet_health(router, stall_timeout_s=60.0)
        mon = col.health
        tr = [mon.keys, _serve(router, [[1, 2, 3], [4, 5]], 3)]
        col.tick(now=1.0)
        rep = router.fleet_report()
        tr += [[mon.level(k) for k in "01"], rep["health"]["worst"],
               rep["health"]["n_watched"],
               router.replicas[0].metrics.report()["health"]["state"]]
        victim = router.replicas[0]
        victim.kill(RuntimeError("chaos"))
        _wait(lambda: victim.restarts == 1
              and victim.state.value == "healthy", "warm restart")
        s = mon.evaluate(now=2.0)["0"]
        fr = router.submit(np.array([9, 8, 7], np.int32), 2)
        tr += [s.state, s.contributing, fr.replica_id,
               router.fleet_report()["health"]["worst"]]
        assert fr.wait(timeout=WAIT)
        col.tick(now=3.0)
        tr += [mon.level("0"), router.fleet_report()["health"]["worst"]]
        victim.kill()
        _wait(lambda: victim.state.value == "quarantined", "quarantine")
        for now in (4.0, 5.0):
            s = mon.evaluate(now=now)["0"]
            tr.append((s.state, s.contributing,
                       s.detail["replica_state"]))
        rep = router.fleet_report()["health"]["replicas"]
        tr += [rep["0"]["state"], rep["1"]["state"]]
        fr = router.submit(np.array([6, 7], np.int32), 3)
        assert fr.wait(timeout=WAIT)
        tr.append((fr.replica_id, [int(t) for t in fr.tokens]))
        col.tick(now=6.0)
        names = col.store.names()
        keys = [f'serving_tokens_total{{instance="{r.metrics.instance}"}}'
                for r in router.replicas]
        tr.append([(k in names, k + ":rate" in names) for k in keys])
        tr.append(col.ticks)
    return tr


def test_fleet_health_drives_routing_as_the_reference(pkgs):
    """A warm-killed replica scores critical once (the restart latch)
    while routing avoids it, then healthy; a hard kill keeps it critical;
    the collector samples every replica's series."""
    tr = _twin(pkgs, _health_chaos)
    assert tr[0] == ["0", "1"]
    assert tr[2:6] == [[0, 0], "healthy", 2, "healthy"]
    assert tr[6:10] == ["critical", ["replica_restart"], 1, "critical"]
    assert tr[10:12] == [0, "healthy"]
    assert tr[12] == tr[13] == ("critical", ["replica_state"],
                                "quarantined")
    assert tr[14:16] == ["critical", "healthy"] and tr[16][0] == 1
    assert tr[17] == [(True, True)] * 2 and tr[18] == 3
