"""Per-replica health scores over detector states and the replica
lifecycle (the port's copy of ``chainermn_tpu/monitor/health.py``).

:class:`HealthMonitor` watches keys (replica ids), each with its
detectors and two lifecycle probes, and folds them into a
:class:`HealthScore`:

- ``healthy`` (0): nothing firing;
- ``degraded`` (1): a ``severity="degraded"`` detector firing (TTFT
  drift, queue or KV pressure);
- ``critical`` (2): a ``severity="critical"`` detector firing (the
  decode-stall deadman), a lifecycle state other than starting, healthy,
  draining or retired, or a warm restart since the previous evaluation
  (the restart latch: a recovery faster than one cadence still gives one
  CRITICAL verdict).

Every score names its contributing signals, publishes a
``health_state{replica=}`` gauge and emits an edge-triggered
``health_changed`` event. :meth:`HealthMonitor.report` is the fleet's
``health`` block; ``FleetRouter.attach_health`` makes the levels the
leading routing key. The monitor's lock is a leaf guarding only its
maps, so routers read :meth:`HealthMonitor.level` under their own lock
without a lock-order edge. :func:`fleet_health` wires the whole pipeline
onto a router (duck-typed: this module imports nothing of the fleet).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.monitor.timeseries import (
    Collector,
    DeadmanDetector,
    Ratio,
    ThresholdDetector,
    TimeSeriesStore,
    ZScoreDetector,
)

HEALTHY, DEGRADED, CRITICAL = "healthy", "degraded", "critical"
_STATE_BY_LEVEL = {0: HEALTHY, 1: DEGRADED, 2: CRITICAL}
_LEVEL_BY_SEVERITY = {"degraded": 1, "critical": 2}
# lifecycle states that are not failures (a retiring replica must not
# drag the fleet's worst-of verdict down)
_BENIGN_LIFECYCLE = ("starting", "healthy", "draining", "retired")


@dataclass
class HealthScore:
    """One key's composed verdict and what drove it."""

    state: str
    level: int
    contributing: list = field(default_factory=list)
    detail: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"state": self.state, "level": self.level,
                "contributing": list(self.contributing),
                "detail": dict(self.detail)}


class _Watch:
    __slots__ = ("detectors", "state_fn", "restarts_fn", "seen_restarts")

    def __init__(self, detectors, state_fn, restarts_fn) -> None:
        self.detectors = list(detectors)
        self.state_fn = state_fn
        self.restarts_fn = restarts_fn
        self.seen_restarts: Optional[int] = None


class HealthMonitor:
    """Compose detector and lifecycle signals into per-key scores (module
    docstring). ``store`` is the series store the detectors read, usually
    the owning collector's."""

    def __init__(self, *, registry=None, events=None,
                 store: Optional[TimeSeriesStore] = None,
                 clock=None) -> None:
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self.store = store if store is not None else TimeSeriesStore()
        self._clock = clock if clock is not None else time.monotonic
        self._lock = sanitizer.make_lock("HealthMonitor._lock", leaf=True)
        self._watches: dict[str, _Watch] = sanitizer.guarded(
            {}, lock=self._lock, name="HealthMonitor._watches")
        self._scores: dict[str, HealthScore] = sanitizer.guarded(
            {}, lock=self._lock, name="HealthMonitor._scores")

    def watch(self, key, *, detectors=(),
              state_fn: Optional[Callable] = None,
              restarts_fn: Optional[Callable] = None) -> "HealthMonitor":
        """Score ``key`` from ``detectors`` and the optional probes
        ``state_fn() -> ReplicaState|str`` and ``restarts_fn() -> int``
        (a monotonic warm-restart count; a rise latches one CRITICAL)."""
        w = _Watch(detectors, state_fn, restarts_fn)
        with self._lock:
            self._watches[str(key)] = w
        return self

    def unwatch(self, key) -> "HealthMonitor":
        """Stop scoring ``key`` and forget its last score (a retired
        replica leaves the worst-of verdict)."""
        with self._lock:
            self._watches.pop(str(key), None)
            self._scores.pop(str(key), None)
        return self

    def add_detectors(self, key, *detectors) -> "HealthMonitor":
        """Extend a watch with more detectors (a canary's regression
        probes)."""
        with self._lock:
            self._watches[str(key)].detectors.extend(detectors)
        return self

    @property
    def keys(self) -> list:
        with self._lock:
            return sorted(self._watches)

    def _score_watch(self, key: str, w: _Watch, now: float) -> HealthScore:
        level = 0
        contributing: list = []
        detail: dict = {}
        if w.state_fn is not None:
            st = w.state_fn()
            name = str(getattr(st, "value", st))
            detail["replica_state"] = name
            if name not in _BENIGN_LIFECYCLE:
                level = 2
                contributing.append("replica_state")
        if w.restarts_fn is not None:
            restarts = int(w.restarts_fn())
            seen, w.seen_restarts = w.seen_restarts, restarts
            detail["restarts"] = restarts
            if seen is not None and restarts > seen:
                level = 2
                contributing.append("replica_restart")
        for det in w.detectors:
            verdict = det.evaluate(self.store, now, registry=self._registry,
                                   events=self._events)
            detail[det.name] = verdict
            if verdict.get("firing"):
                contributing.append(det.name)
                level = max(level, _LEVEL_BY_SEVERITY[det.severity])
        return HealthScore(state=_STATE_BY_LEVEL[level], level=level,
                           contributing=contributing, detail=detail)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One scoring pass over every watched key: updates the scores,
        publishes the ``health_state`` gauges, emits ``health_changed``
        on each transition. Returns ``{key: HealthScore}``."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            watches = list(self._watches.items())
            prev = {k: s.state for k, s in self._scores.items()}
        scores = {key: self._score_watch(key, w, now) for key, w in watches}
        with self._lock:
            self._scores.update(scores)
        for key, score in scores.items():
            self._registry.gauge("health_state",
                                 {"replica": key}).set(score.level)
            if prev.get(key) != score.state:
                self._events.emit("health_changed", replica=key,
                                  state=score.state, was=prev.get(key),
                                  contributing=list(score.contributing))
        return scores

    def level(self, key) -> int:
        """0 healthy / 1 degraded / 2 critical; a key nobody scored yet
        reads healthy."""
        with self._lock:
            score = self._scores.get(str(key))
        return 0 if score is None else score.level

    def score(self, key) -> Optional[HealthScore]:
        with self._lock:
            return self._scores.get(str(key))

    def score_json(self, key) -> Optional[dict]:
        score = self.score(key)
        return score.to_json() if score is not None else None

    def report(self) -> dict:
        """Per-key scores and the fleet's worst state."""
        with self._lock:
            scores = dict(self._scores)
        worst = max((s.level for s in scores.values()), default=0)
        return {"replicas": {k: s.to_json()
                             for k, s in sorted(scores.items())},
                "worst": _STATE_BY_LEVEL[worst],
                "n_watched": len(scores)}


# ---------------------------------------------------------------------- #
# standard sensor sets + fleet wiring                                     #
# ---------------------------------------------------------------------- #


def _instrument_key(name: str, instance: str) -> str:
    return f'{name}{{instance="{instance}"}}'


def standard_replica_sensors(instance: str, *,
                             stall_timeout_s: float = 10.0,
                             max_queue_depth: float = 64.0,
                             min_kv_blocks_free: Optional[float] = None,
                             spec: bool = False, z: float = 3.0,
                             active_fn: Optional[Callable] = None,
                             tag: Optional[str] = None) -> tuple:
    """The default ``(signals, detectors)`` of one serving instance (its
    :class:`~chainermn_torch.serving.metrics.ServingMetrics` label):
    TTFT-p99 z-score drift (``serving_ttft_seconds``), the queue-depth
    threshold (``serving_queue_depth_now``), the decode-progress deadman
    (``serving_tokens_total``); optionally a free-KV-blocks floor
    (``kv_blocks_free``) and, with ``spec=True``, the speculative accept
    rate (``spec_tokens_accepted_total`` over ``spec_tokens_proposed_
    total``) with a downward z-score. ``tag`` names the detectors
    (default: the instance)."""
    tag = instance if tag is None else str(tag)
    signals: list = []
    detectors: list = [
        ZScoreDetector(
            f"ttft_p99_drift@{tag}",
            _instrument_key("serving_ttft_seconds", instance) + ":p99",
            z=z, direction="above", severity="degraded"),
        ThresholdDetector(
            f"queue_depth@{tag}",
            _instrument_key("serving_queue_depth_now", instance),
            threshold=max_queue_depth, direction="above",
            severity="degraded"),
        DeadmanDetector(
            f"decode_stall@{tag}",
            _instrument_key("serving_tokens_total", instance),
            timeout_s=stall_timeout_s, active_fn=active_fn,
            severity="critical"),
    ]
    if min_kv_blocks_free is not None:
        detectors.append(ThresholdDetector(
            f"kv_blocks_free@{tag}",
            _instrument_key("kv_blocks_free", instance),
            threshold=min_kv_blocks_free, direction="below",
            severity="degraded"))
    if spec:
        accept = f"spec_accept_rate@{tag}"
        signals.append(Ratio(
            _instrument_key("spec_tokens_accepted_total", instance)
            + ":rate",
            _instrument_key("spec_tokens_proposed_total", instance)
            + ":rate",
            name=accept))
        detectors.append(ZScoreDetector(
            f"spec_accept_drift@{tag}", accept, z=z, direction="below",
            severity="degraded"))
    return signals, detectors


def wire_replica(collector: Collector, monitor: HealthMonitor, replica, *,
                 stall_timeout_s: float = 10.0, spec: bool = False,
                 **sensor_kw) -> None:
    """Wire one fleet replica into a collector and monitor: the standard
    sensors (keyed by its metrics instance, tagged by its id), the
    lifecycle and restart-latch probes, and its metrics report's
    ``health`` block. :func:`fleet_health` calls it for the fleet it is
    given; the controller calls it for every replica it spawns."""
    signals, detectors = standard_replica_sensors(
        replica.metrics.instance, stall_timeout_s=stall_timeout_s,
        spec=spec, tag=str(replica.replica_id),
        active_fn=(lambda r=replica: r.busy), **sensor_kw)
    for sig in signals:
        collector.add_signal(sig)
    monitor.watch(str(replica.replica_id), detectors=detectors,
                  state_fn=(lambda r=replica: r.state),
                  restarts_fn=(lambda r=replica: r.restarts))
    replica.metrics.attach_health(
        lambda m=monitor, k=str(replica.replica_id): m.score_json(k))


def fleet_health(router, *, cadence_s: float = 0.25, registry=None,
                 events=None, clock=None, maxlen: int = 512,
                 stall_timeout_s: float = 10.0, spec: bool = False,
                 **sensor_kw) -> Collector:
    """Wire the pipeline onto a :class:`~chainermn_torch.fleet.router.
    FleetRouter`: one store and collector, every replica through
    :func:`wire_replica`, and the router's routing penalty
    (``router.attach_health``). Returns the collector: ``start()`` it for
    the background cadence, or drive ``tick(now=)``."""
    store = TimeSeriesStore(maxlen=maxlen)
    monitor = HealthMonitor(registry=registry, events=events, store=store,
                            clock=clock)
    collector = Collector(registry=registry, events=events, store=store,
                          cadence_s=cadence_s, clock=clock)
    for replica in router.replicas:
        wire_replica(collector, monitor, replica,
                     stall_timeout_s=stall_timeout_s, spec=spec,
                     **sensor_kw)
    collector.attach_health(monitor)
    router.attach_health(monitor)
    return collector


__all__ = ["CRITICAL", "DEGRADED", "HEALTHY", "HealthMonitor",
           "HealthScore", "fleet_health", "standard_replica_sensors",
           "wire_replica"]
