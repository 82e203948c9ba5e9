"""The fleet control plane: sensors, policies and actuators in one loop
(the port's copy of ``chainermn_tpu/fleet/control.py``).

:class:`FleetController` reads the telemetry pipeline (a
:class:`~chainermn_torch.monitor.timeseries.Collector` with its
:class:`~chainermn_torch.monitor.health.HealthMonitor`, and optionally an
:class:`~chainermn_torch.monitor.slo.SLOEngine`) and drives three
policies, on a daemon thread or by ``tick(now=)``:

- **Autoscaling** (:class:`AutoscalePolicy`): sustained queue pressure or
  SLO burn spawns a replica (``spawn_replica``; it warms on its own
  thread and is synced to the fleet's promoted weights); sustained
  idleness retires one (``retire_replica``'s graceful drain). Hysteresis,
  a cooldown and ``min_replicas``/``max_replicas`` keep a noisy signal
  from flapping the fleet.
- **Canary deploys** (:class:`CanaryPolicy`): :meth:`FleetController.
  deploy` swaps exactly one replica, bakes it for ``bake_s`` against the
  fleet's health and SLO baseline, then promotes (the rest roll) or rolls
  back (every accepting replica republished onto the pre-canary
  weights). A canary that dies mid-bake aborts (its peers never saw the
  new weights); a publish fault during the promote rolls everyone back.
- **Rebalancing** (:class:`RebalancePolicy`): a DEGRADED replica's
  admission weight is shed until it scores healthy again, and
  ``migrate_decode`` moves one live decode a tick off the most pressured
  replica (``FleetRouter.rebalance_decode``).

Every decision is an event (``controller_scale_up``/``_scale_down``/
``_rebalance``, ``canary_start``/``_promote``/``_rollback``) naming its
signals, a counter, and an entry in :meth:`FleetController.report`, which
``FleetRouter.fleet_report`` embeds under ``"control"``.

**Weights are copied, not referenced.** ``swap_params`` writes an
engine's parameters in place, so the tensors of an engine's
``state_dict()`` *are* whatever it was last swapped to. The controller
therefore keeps private copies: of each deployed weight set when it is
queued, and of the canary's weights before its swap (the rollback
target; on the card a device clone of the whole weight set).
Keeping a reference instead would make a rollback republish the
canary's own weights.

The controller's lock is a leaf guarding only report-visible state;
policy work runs on the tick thread and every router call happens
outside it (the controller calls into the router, never the reverse).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from chainermn_torch.analysis import sanitizer
from chainermn_torch.deploy.versions import VersionLog
from chainermn_torch.monitor import get_event_log, get_registry


@dataclass
class AutoscalePolicy:
    """When and how far to scale. Pressure is queued work per accepting
    replica above ``queue_high`` or (``burn_gate``) a non-compliant SLO;
    sustained for ``up_after_s`` it spawns a replica. No pressure and
    fleet load at or below ``idle_low`` for ``down_after_s`` retires one.
    ``cooldown_s`` separates consecutive actions."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 4.0
    idle_low: float = 0.25
    up_after_s: float = 1.0
    down_after_s: float = 5.0
    cooldown_s: float = 2.0
    burn_gate: bool = True


@dataclass
class CanaryPolicy:
    """The bake: for ``bake_s`` the canary must not score worse than the
    fleet baseline (its peers' worst level now, or the baseline at canary
    start, whichever is higher), and (``slo_gate``) the SLO must not newly
    breach."""

    bake_s: float = 5.0
    slo_gate: bool = True


@dataclass
class RebalancePolicy:
    """The admission weight of DEGRADED (level 1) replicas, and the
    mid-stream decode migration: with ``migrate_decode`` one live decode
    a tick (``migrate_cooldown_s`` apart) moves off the most pressured
    replica (degraded first, then a normalized load gap of at least
    ``migrate_load_gap``) onto the least loaded healthy peer."""

    degraded_weight: float = 0.25
    migrate_decode: bool = False
    migrate_load_gap: float = 1.0
    migrate_cooldown_s: float = 2.0


def _private_copy(state) -> dict:
    """A copy of a ``state_dict`` mapping that nobody else writes: each
    tensor cloned where it lies (pinned host memory stays pinned, so a
    later commit from it stays asynchronous)."""
    import torch

    out = {}
    with torch.no_grad():
        for name, t in state.items():
            if t.device.type == "cpu" and t.is_pinned():
                out[name] = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True).copy_(t)
            else:
                out[name] = t.detach().clone()
    return out


class _Canary:
    """One in-flight canary deploy (tick-thread state, copied for
    reports)."""

    __slots__ = ("replica_id", "new_params", "old_params", "step",
                 "started_at", "version", "baseline_level",
                 "baseline_compliant")

    def __init__(self, replica_id, new_params, old_params, step,
                 started_at, version, baseline_level,
                 baseline_compliant) -> None:
        self.replica_id = replica_id
        self.new_params = new_params
        self.old_params = old_params
        self.step = step
        self.started_at = started_at
        self.version = version
        self.baseline_level = baseline_level
        self.baseline_compliant = baseline_compliant

    def to_json(self) -> dict:
        return {"replica": self.replica_id, "version": self.version,
                "started_at": self.started_at, "step": self.step,
                "baseline_level": self.baseline_level,
                "baseline_compliant": self.baseline_compliant}


_controller_ids = itertools.count()


class FleetController:
    """Closed-loop controller over one fleet (module docstring).

    Parameters
    ----------
    router : FleetRouter
        The fleet under control.
    collector : Collector
        The telemetry pipeline (normally :func:`~chainermn_torch.monitor.
        health.fleet_health`'s): its store feeds the queue sensor, its
        health monitor the canary and rebalance verdicts.
    slo : SLOEngine, optional
        Burn-rate gate for scale-up pressure and the canary bake.
    engine_factory : callable() -> ServingEngine, optional
        Builds each scale-up's engine, on weights of its own.
    snapshot : dict, optional
        ``spawn_replica`` keywords for a spawn from a checkpoint
        (``checkpoint=``, ``engine_factory=``, ``params_template=``, and
        ``model=``/``comm=`` for the degree): a scale-up restores its
        replica from the newest snapshot. When that load fails (no
        snapshot, a corrupt file, an injected fault) and ``engine_factory``
        is given, the scale-up falls back to it
        (``source="factory_fallback"``), as the reference does.
    brownout : BrownoutPolicy, optional
        Sustained pressure steps brownout up before it spends a replica;
        a spawned replica turning ready relieves it.
    autoscale / canary / rebalance : policy dataclasses or None
        ``None`` disables that policy.
    cadence_s / clock : ``start()`` ticks every ``cadence_s`` on a daemon
        thread; tests drive ``tick(now=)``.
    sensor_kw : dict, optional
        :func:`~chainermn_torch.monitor.health.wire_replica` keywords for
        spawned replicas (those ``fleet_health`` was given).
    """

    def __init__(self, router, collector, *, slo=None,
                 engine_factory: Optional[Callable] = None,
                 snapshot: Optional[dict] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 canary: Optional[CanaryPolicy] = None,
                 rebalance: Optional[RebalancePolicy] = None,
                 brownout=None,
                 cadence_s: float = 0.5, clock=None,
                 sensor_kw: Optional[dict] = None,
                 publish_timeout_s: float = 60.0,
                 retire_timeout_s: float = 60.0,
                 registry=None, events=None) -> None:
        if cadence_s <= 0:
            raise ValueError(f"cadence_s must be > 0, got {cadence_s}")
        if (autoscale is not None and engine_factory is None
                and snapshot is None):
            raise ValueError(
                "an autoscale policy needs engine_factory= or snapshot= "
                "to build scale-up replicas")
        self.router = router
        self.collector = collector
        self.slo = slo
        self.autoscale = autoscale
        self.canary = canary
        self.rebalance = rebalance
        self.brownout = brownout
        self.cadence_s = float(cadence_s)
        self.log = VersionLog()          # the fleet's deploy audit trail
        self._engine_factory = engine_factory
        self._snapshot = dict(snapshot) if snapshot is not None else None
        self._sensor_kw = dict(sensor_kw or {})
        self._publish_timeout_s = float(publish_timeout_s)
        self._retire_timeout_s = float(retire_timeout_s)
        self._clock = clock if clock is not None else time.monotonic
        self._events = events if events is not None else get_event_log()
        self._registry = registry if registry is not None else get_registry()
        labels = {"controller": str(next(_controller_ids))}
        self._labels = labels
        reg = self._registry
        self._c_ticks = reg.counter("controller_ticks_total", labels)
        self._c_ups = reg.counter("controller_scale_ups_total", labels)
        self._c_downs = reg.counter("controller_scale_downs_total", labels)
        self._c_deploys = reg.counter("canary_deploys_total", labels)
        self._c_promotes = reg.counter("canary_promotes_total", labels)
        self._c_rollbacks = reg.counter("canary_rollbacks_total", labels)
        self._g_target = reg.gauge("controller_target_replicas", labels)
        self._g_phase = reg.gauge("controller_canary_phase", labels)
        # leaf: guards only report-visible state
        self._lock = sanitizer.make_lock("FleetController._lock", leaf=True)
        self._canary: Optional[_Canary] = None
        self._pending_deploy: Optional[tuple] = None
        self._decisions: deque = deque(maxlen=32)
        self._last_outcome: Optional[dict] = None
        # tick-thread policy state (one ticker)
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale: Optional[float] = None
        self._last_decode_rebalance: Optional[float] = None
        self._target: Optional[int] = None
        self._fleet_version = 0
        self._params_current = None      # the last promoted weights
        self._pending_sync: list = []    # spawned replicas to sync
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        router.attach_controller(self)

    # ------------------------------------------------------------------ #
    # the deploy entry point (any thread)                                 #
    # ------------------------------------------------------------------ #

    def deploy(self, params, *, step: Optional[int] = None) -> None:
        """Queue ``params`` (a ``state_dict`` mapping, copied here) for a
        canary deploy; the next tick starts the bake. One deploy at a
        time: a second call while one is pending or baking raises."""
        if self.canary is None:
            raise RuntimeError(
                "controller has no canary policy (pass canary=)")
        params = _private_copy(params)
        with self._lock:
            if self._canary is not None or self._pending_deploy is not None:
                raise RuntimeError(
                    "a canary deploy is already in flight; wait for its "
                    "promote/rollback before deploying again")
            self._pending_deploy = (params, step)

    # ------------------------------------------------------------------ #
    # the control loop                                                    #
    # ------------------------------------------------------------------ #

    def tick(self, now: Optional[float] = None) -> dict:
        """One sense, decide, act pass at one timestamp. Returns the
        signals read and the actions taken (also kept for reports)."""
        now = self._clock() if now is None else float(now)
        summary = {"now": now, "actions": []}
        if getattr(self.router, "_closed", False):
            return summary
        sensors = self._read_sensors(now)
        summary["signals"] = sensors
        self._canary_tick(now, sensors, summary)
        self._autoscale_tick(now, sensors, summary)
        self._rebalance_tick(sensors, summary)
        self._sync_spawned(summary)
        self._c_ticks.inc()
        if self._target is not None:
            self._g_target.set(self._target)
        # graftlint: unguarded-ok — atomic reference read (writers lock)
        self._g_phase.set(0 if self._canary is None else 1)
        if summary["actions"]:
            with self._lock:
                self._decisions.extend(summary["actions"])
        return summary

    def start(self) -> "FleetController":
        """Run :meth:`tick` every ``cadence_s`` on a daemon thread
        (idempotent while running)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="chainermn-fleet-controller",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def __enter__(self) -> "FleetController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — controller must not die
                print(f"chainermn_torch.fleet: controller tick failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            self._stop.wait(self.cadence_s)

    # ------------------------------------------------------------------ #
    # sensors                                                             #
    # ------------------------------------------------------------------ #

    def _read_sensors(self, now: float) -> dict:
        """The controller's inputs: queue depth (the sampled gauge, or the
        live scheduler depth when larger: a stalled replica's gauge
        freezes while its queue grows), fleet load, the SLO verdict, and
        the pressure signals."""
        store = self.collector.store
        accepting = [r for r in self.router.replicas if r.accepting]
        queued = active = slots = 0.0
        for r in accepting:
            key = (f'serving_queue_depth_now'
                   f'{{instance="{r.metrics.instance}"}}')
            last = store.last(key)
            live = float(r.scheduler.queue_depth)
            queued += (max(float(last[1]), live) if last is not None
                       else live)
            snap = r.snapshot()
            active += snap.active_slots
            slots += snap.n_slots
        n = max(len(accepting), 1)
        compliant, max_burn = True, 0.0
        if self.slo is not None:
            for entry in self.slo.evaluate(now).values():
                compliant = compliant and bool(entry.get("compliant", True))
                max_burn = max(max_burn,
                               float(entry.get("max_burn_rate", 0.0)))
        sensors = {
            "accepting": len(accepting),
            "queue_total": queued,
            "queue_per_replica": queued / n,
            "load": (queued + active) / max(slots, 1.0),
            "slo_compliant": compliant,
            "max_burn_rate": max_burn,
            "pressure": [],
        }
        p = self.autoscale
        if p is not None:
            if sensors["queue_per_replica"] > p.queue_high:
                sensors["pressure"].append("queue_depth")
            if p.burn_gate and not compliant:
                sensors["pressure"].append("slo_burn")
        return sensors

    @property
    def health(self):
        return self.collector.health

    def _level(self, replica_id) -> int:
        hm = self.health
        return hm.level(str(replica_id)) if hm is not None else 0

    # ------------------------------------------------------------------ #
    # policy 1: autoscaling                                               #
    # ------------------------------------------------------------------ #

    def _autoscale_tick(self, now: float, s: dict, summary: dict) -> None:
        p = self.autoscale
        if p is None:
            return
        # graftlint: unguarded-ok — atomic reference read (writers lock)
        if self._canary is not None:
            # a bake compares against a stable baseline: no resizing
            self._pressure_since = self._idle_since = None
            return
        capacity = s["accepting"]
        if self._target is None:
            self._target = capacity
        in_cooldown = (self._last_scale is not None
                       and now - self._last_scale < p.cooldown_s)
        pressure = bool(s["pressure"]) and capacity < p.max_replicas
        idle = (not s["pressure"] and s["load"] <= p.idle_low
                and capacity > p.min_replicas)
        if pressure:
            self._idle_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            elif (now - self._pressure_since >= p.up_after_s
                  and not in_cooldown):
                if (self.brownout is not None
                        and not self.brownout.saturated):
                    self._brownout_up(now, s, summary)
                else:
                    self._scale_up(now, s, summary)
        elif idle:
            self._pressure_since = None
            if self._idle_since is None:
                self._idle_since = now
            elif (now - self._idle_since >= p.down_after_s
                  and not in_cooldown):
                self._scale_down(now, s, summary)
        else:
            self._pressure_since = self._idle_since = None

    def _top_tenant(self) -> Optional[str]:
        """The tenant using the most device time fleet-wide, summed over
        the replicas' cost ledgers (``FCFSScheduler(cost_accounting=
        True)``, the default), or None before any attributed work."""
        totals: dict = {}
        for r in self.router.replicas:
            led = getattr(r.metrics, "costs", None)
            if led is None:
                continue
            for tenant, secs in led.tenant_device_seconds().items():
                totals[tenant] = totals.get(tenant, 0.0) + secs
        if not totals:
            return None
        return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]

    def _brownout_up(self, now: float, s: dict, summary: dict) -> None:
        """Degrade before scaling: a brownout step is instant, a replica
        slow. It counts as a scale action for the cooldown."""
        prev = self.brownout.level
        self.brownout.step_up(
            "controller:" + "+".join(s["pressure"]), now=now)
        self._last_scale = now
        self._pressure_since = None
        summary["actions"].append(
            {"action": "brownout", "direction": "up", "t": now,
             "level": self.brownout.level, "prev": prev,
             "signals": list(s["pressure"]),
             "queue_per_replica": round(s["queue_per_replica"], 3)})

    def _spawn_scaled_replica(self) -> tuple:
        """Spawn from the snapshot when one is configured, falling back to
        the factory when that fails; returns ``(replica, source)``."""
        if self._snapshot is not None:
            try:
                return (self.router.spawn_replica(
                    wait_ready=False, **self._snapshot), "snapshot")
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                if self._engine_factory is None:
                    raise
                print("chainermn_torch.fleet: snapshot spawn failed "
                      f"({type(e).__name__}: {e}); falling back to "
                      "engine_factory", file=sys.stderr, flush=True)
                return (self.router.spawn_replica(
                    engine=self._engine_factory(), wait_ready=False),
                    "factory_fallback")
        return (self.router.spawn_replica(
            engine=self._engine_factory(), wait_ready=False), "factory")

    def _scale_up(self, now: float, s: dict, summary: dict) -> None:
        replica, source = self._spawn_scaled_replica()
        self._last_scale = now
        self._pressure_since = None
        self._target = min(s["accepting"] + 1, self.autoscale.max_replicas)
        hm = self.health
        if hm is not None:
            from chainermn_torch.monitor.health import wire_replica

            wire_replica(self.collector, hm, replica, **self._sensor_kw)
        self._pending_sync.append(replica)
        self._c_ups.inc()
        tt = self._top_tenant()
        tenant_kw = {} if tt is None else {"top_tenant": tt}
        summary["actions"].append(
            {"action": "scale_up", "t": now,
             "replica": replica.replica_id, "source": source,
             "signals": list(s["pressure"]),
             "queue_per_replica": round(s["queue_per_replica"], 3),
             "capacity": s["accepting"], **tenant_kw})
        self._events.emit("controller_scale_up",
                          replica=replica.replica_id, source=source,
                          signals=list(s["pressure"]),
                          queue_per_replica=round(s["queue_per_replica"], 3),
                          capacity=s["accepting"], **tenant_kw)

    def _scale_down(self, now: float, s: dict, summary: dict) -> None:
        candidates = [r for r in self.router.replicas if r.accepting]
        if len(candidates) <= self.autoscale.min_replicas:
            return
        # least-loaded victim; ties retire the youngest replica
        victim = min(candidates,
                     key=lambda r: (r.snapshot().load, -r.replica_id))
        rid = victim.replica_id
        out = self.router.retire_replica(rid,
                                         timeout=self._retire_timeout_s)
        self._last_scale = now
        self._idle_since = None
        self._target = max(s["accepting"] - 1, self.autoscale.min_replicas)
        self._pending_sync = [r for r in self._pending_sync
                              if r.replica_id != rid]
        hm = self.health
        if hm is not None:
            hm.unwatch(str(rid))
        self._c_downs.inc()
        summary["actions"].append(
            {"action": "scale_down", "t": now, "replica": rid,
             "signals": ["idle"], "load": round(s["load"], 3),
             "forced": out["forced"], "capacity": s["accepting"]})
        self._events.emit("controller_scale_down", replica=rid,
                          signals=["idle"], load=round(s["load"], 3),
                          forced=out["forced"], capacity=s["accepting"])

    def _sync_spawned(self, summary: dict) -> None:
        """Bring warm spawned replicas onto the fleet's promoted weights
        (their factory built them on its own; after a promote those are
        stale)."""
        for replica in list(self._pending_sync):
            if not replica.ready.is_set():
                continue
            self._pending_sync.remove(replica)
            if self.brownout is not None and self.brownout.level > 0:
                # the capacity the brownout stood in for has arrived
                prev = self.brownout.level
                self.brownout.relieve(now=summary["now"])
                summary["actions"].append(
                    {"action": "brownout", "direction": "relieve",
                     "t": summary["now"], "level": self.brownout.level,
                     "prev": prev, "replica": replica.replica_id})
            if not replica.accepting or self._params_current is None:
                continue
            self.router.publish(self._params_current,
                                canary=replica.replica_id,
                                timeout=self._publish_timeout_s)

    # ------------------------------------------------------------------ #
    # policy 2: SLO-guarded canary deploys                                #
    # ------------------------------------------------------------------ #

    def _canary_tick(self, now: float, s: dict, summary: dict) -> None:
        with self._lock:
            c = self._canary
            pending = None
            if c is None and self._pending_deploy is not None:
                pending, self._pending_deploy = self._pending_deploy, None
        if c is None:
            if pending is not None:
                self._start_canary(now, pending[0], pending[1], s, summary)
            return
        replica = self.router.replicas[c.replica_id]
        if not replica.accepting:
            # the canary died mid-bake: its weights died with it
            self._rollback(now, c, summary, reason="canary_lost",
                           signals=[f"replica_state@{c.replica_id}"],
                           dirty=False)
            return
        signals = self._regression_signals(c, s)
        if signals:
            self._rollback(now, c, summary, reason="regression",
                           signals=signals, dirty=True)
            return
        if now - c.started_at >= self.canary.bake_s:
            self._promote(now, c, summary)

    def _start_canary(self, now: float, params, step, s: dict,
                      summary: dict) -> None:
        candidates = [r for r in self.router.replicas if r.accepting]
        if not candidates:
            self._events.emit("canary_rollback", replica=None,
                              reason="no_accepting_replica", signals=[])
            self._c_rollbacks.inc()
            return
        replica = min(candidates,
                      key=lambda r: (r.snapshot().load, r.replica_id))
        rid = replica.replica_id
        # a copy, taken before the swap writes these tensors in place
        old_params = _private_copy(replica.engine.model.state_dict())
        out = self.router.publish(params, canary=rid, step=step,
                                  timeout=self._publish_timeout_s)
        if not out["ok"]:
            # the canary refused the new weights: the fleet never left
            # the old version
            self._c_rollbacks.inc()
            action = {"action": "canary_rollback", "t": now,
                      "replica": rid, "reason": "canary_publish_failed",
                      "signals": []}
            summary["actions"].append(action)
            self._events.emit("canary_rollback", replica=rid,
                              reason="canary_publish_failed", signals=[])
            with self._lock:
                self._last_outcome = action
            return
        peers = [self._level(r.replica_id) for r in candidates
                 if r.replica_id != rid]
        self._fleet_version += 1
        version = self._fleet_version
        self.log.record(version, source="canary", step=step)
        c = _Canary(rid, params, old_params, step, now, version,
                    baseline_level=max(peers, default=0),
                    baseline_compliant=bool(s["slo_compliant"]))
        with self._lock:
            self._canary = c
        self._c_deploys.inc()
        summary["actions"].append(
            {"action": "canary_start", "t": now, "replica": rid,
             "version": version, "bake_s": self.canary.bake_s})
        self._events.emit("canary_start", replica=rid, version=version,
                          bake_s=self.canary.bake_s, step=step)

    def _regression_signals(self, c: _Canary, s: dict) -> list:
        """What damns the canary: its level above both the live peer
        baseline and the start-of-bake one, or a new SLO breach."""
        signals = []
        level = self._level(c.replica_id)
        peers = [self._level(r.replica_id) for r in self.router.replicas
                 if r.accepting and r.replica_id != c.replica_id]
        baseline = max(max(peers, default=0), c.baseline_level)
        if level >= 1 and level > baseline:
            signals.append(f"health@{c.replica_id}")
        if (self.canary.slo_gate and c.baseline_compliant
                and not s["slo_compliant"]):
            signals.append("slo_burn")
        return signals

    def _promote(self, now: float, c: _Canary, summary: dict) -> None:
        peers = [r for r in self.router.replicas
                 if r.accepting and r.replica_id != c.replica_id]
        ok = True
        if peers:
            out = self.router.publish(c.new_params,
                                      exclude=(c.replica_id,),
                                      step=c.step,
                                      timeout=self._publish_timeout_s)
            ok = out["ok"]
        if not ok:
            self._rollback(now, c, summary, reason="promote_failed",
                           signals=["publish_error"], dirty=True)
            return
        self.log.record(c.version, source="publish", step=c.step)
        self._params_current = c.new_params
        self._c_promotes.inc()
        action = {"action": "canary_promote", "t": now,
                  "replica": c.replica_id, "version": c.version,
                  "baked_s": round(now - c.started_at, 3)}
        summary["actions"].append(action)
        with self._lock:
            self._canary = None
            self._last_outcome = action
        self._events.emit("canary_promote", replica=c.replica_id,
                          version=c.version,
                          baked_s=round(now - c.started_at, 3))

    def _rollback(self, now: float, c: _Canary, summary: dict, *,
                  reason: str, signals: list, dirty: bool) -> None:
        """Bring every accepting replica back onto the pre-canary weights
        (``dirty=False``, a lost canary: nobody else held the new ones).
        Replicas still on those weights take a same-content swap, which
        in the port copies every tensor and clears the prefix trie."""
        target = self.log.rollback_target()
        if dirty:
            self.router.publish(c.old_params,
                                timeout=self._publish_timeout_s)
        self._fleet_version = target.version if target is not None else 0
        self.log.record(self._fleet_version, source="rollback")
        self._c_rollbacks.inc()
        action = {"action": "canary_rollback", "t": now,
                  "replica": c.replica_id, "reason": reason,
                  "signals": list(signals), "version": c.version,
                  "rolled_back_to": self._fleet_version}
        summary["actions"].append(action)
        with self._lock:
            self._canary = None
            self._last_outcome = action
        self._events.emit("canary_rollback", replica=c.replica_id,
                          reason=reason, signals=list(signals),
                          version=c.version,
                          rolled_back_to=self._fleet_version)

    # ------------------------------------------------------------------ #
    # policy 3: rebalancing                                               #
    # ------------------------------------------------------------------ #

    def _rebalance_tick(self, s: dict, summary: dict) -> None:
        p = self.rebalance
        if p is None:
            return
        if self.health is None:
            # weight shedding keys on health; migration is load-based
            self._migrate_tick(summary)
            return
        for r in self.router.replicas:
            if not r.accepting:
                continue
            rid = r.replica_id
            level = self._level(rid)
            want = p.degraded_weight if level == 1 else 1.0
            if self.router.admission_weight(rid) == want:
                continue
            self.router.set_admission_weight(rid, want)
            self._registry.gauge(
                "fleet_admission_weight",
                dict(self._labels, replica=str(rid))).set(want)
            tt = self._top_tenant()
            tenant_kw = {} if tt is None else {"top_tenant": tt}
            summary["actions"].append(
                {"action": "rebalance", "replica": rid, "weight": want,
                 "level": level, **tenant_kw})
            self._events.emit("controller_rebalance", replica=rid,
                              weight=want, level=level, **tenant_kw)
        self._migrate_tick(summary)

    def _migrate_tick(self, summary: dict) -> None:
        """Move one live decode (cooldown-bounded) off the most pressured
        replica, degraded first, then by load, onto the least loaded
        healthy peer (fire and forget; a failure leaves it in place)."""
        p = self.rebalance
        if p is None or not p.migrate_decode:
            return
        now = summary["now"]
        if (self._last_decode_rebalance is not None
                and now - self._last_decode_rebalance
                < p.migrate_cooldown_s):
            return
        snaps = [r.snapshot() for r in self.router.replicas if r.accepting]
        for sn in snaps:
            sn.health = self._level(sn.replica_id)
        busy = [sn for sn in snaps if sn.active_slots > 0]
        if len(snaps) < 2 or not busy:
            return
        src = max(busy, key=lambda sn: (sn.health, sn.load, sn.replica_id))
        peers = [sn for sn in snaps
                 if sn.replica_id != src.replica_id and sn.health == 0]
        if not peers:
            return
        dest = min(peers, key=lambda sn: (sn.load, sn.replica_id))
        if src.health == 0 and src.load - dest.load < p.migrate_load_gap:
            return            # a healthy source must be lopsided to move
        ticket = self.router.rebalance_decode(src.replica_id,
                                              dest.replica_id)
        if ticket is None:
            return
        self._last_decode_rebalance = now
        summary["actions"].append(
            {"action": "rebalance_decode", "t": now,
             "src": src.replica_id, "dest": dest.replica_id,
             "level": src.health})

    # ------------------------------------------------------------------ #
    # observability                                                       #
    # ------------------------------------------------------------------ #

    def report(self) -> dict:
        """Policies, phase, canary state, version history, admission
        weights and the decision ring (``fleet_report``'s ``control``)."""
        with self._lock:
            canary = self._canary
            pending = self._pending_deploy is not None
            decisions = list(self._decisions)
            last_outcome = self._last_outcome
        weights = {
            str(r.replica_id): self.router.admission_weight(r.replica_id)
            for r in self.router.replicas if r.accepting}
        cur = self.log.current
        return {
            "ticks": int(self._c_ticks.value),
            "phase": ("baking" if canary is not None
                      else "pending" if pending else "idle"),
            "target_replicas": self._target,
            "capacity": self.router.capacity,
            "autoscale": (dict(asdict(self.autoscale),
                               scale_ups=int(self._c_ups.value),
                               scale_downs=int(self._c_downs.value))
                          if self.autoscale is not None else None),
            "canary": ({"policy": asdict(self.canary),
                        "active": (canary.to_json()
                                   if canary is not None else None),
                        "last_outcome": last_outcome,
                        "deploys": int(self._c_deploys.value),
                        "promotes": int(self._c_promotes.value),
                        "rollbacks": int(self._c_rollbacks.value)}
                       if self.canary is not None else None),
            "rebalance": (dict(asdict(self.rebalance), weights=weights)
                          if self.rebalance is not None else None),
            "brownout": (self.brownout.to_json()
                         if self.brownout is not None else None),
            "versions": {
                "current": {"version": cur.version, "source": cur.source,
                            "step": cur.step},
                "history": [{"version": e.version, "source": e.source,
                             "step": e.step}
                            for e in self.log.history()],
            },
            "decisions": decisions,
        }


__all__ = ["AutoscalePolicy", "CanaryPolicy", "FleetController",
           "RebalancePolicy"]
