"""Continuous telemetry: a time-series store and a fixed-cadence collector
over the metrics registry, with derived signals and anomaly detectors
(the port's copy of ``chainermn_tpu/monitor/timeseries.py``).

- :class:`TimeSeriesStore`: named bounded rings of ``(t, value)`` points
  behind one leaf lock (readers copy out; nothing is acquired while it is
  held).
- :class:`Collector`: samples every registry instrument each tick.
  Counters give a cumulative series and a ``:rate`` series (the delta
  over the tick), gauges sample directly, histograms give ``:p50`` and
  ``:p99`` over the samples observed since the previous tick. The clock
  is injectable (``time.monotonic`` scale), so tests drive
  :meth:`Collector.tick` with ``now=`` and never sleep; :meth:`Collector.
  start` runs the ticks on a daemon thread. The collector counts itself
  (``ts_samples_total``, ``ts_collect_lag_seconds``).
- Derived signals (:class:`Rate`, :class:`EWMA`, :class:`Ratio`,
  :class:`WindowPercentile`), evaluated in declaration order each tick,
  write new series back into the store.
- Detectors (:class:`ThresholdDetector`, :class:`ZScoreDetector`,
  :class:`DeadmanDetector`) judge store series, edge-triggered: a
  ``detector_fired``/``detector_cleared`` event on a transition only,
  and a live ``detector_state{detector=}`` gauge (0 clear, 1 degraded,
  2 critical). :mod:`~chainermn_torch.monitor.health` composes their
  states into per-replica verdicts.

One thread ticks a collector (its own, or a test's); signals and
detectors keep private state and run only inside that tick, so the
store is the only shared structure. Host logic only: numpy does the
percentile math.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.monitor.registry import Counter, Gauge, Histogram

_SEVERITY_CODE = {"degraded": 1, "critical": 2}


class Series:
    """One named ring of ``(t, value)`` points (a plain container: every
    access goes through the owning store's lock)."""

    __slots__ = ("name", "kind", "_points")

    def __init__(self, name: str, kind: str = "gauge",
                 maxlen: int = 512) -> None:
        self.name = name
        self.kind = kind
        self._points: deque = deque(maxlen=maxlen)


class TimeSeriesStore:
    """Named bounded series, get-or-create, behind one leaf lock.
    ``maxlen`` bounds every ring (512 points at a 0.25 s cadence is about
    two minutes of history)."""

    def __init__(self, maxlen: int = 512) -> None:
        if maxlen < 2:
            raise ValueError(f"maxlen must be >= 2, got {maxlen}")
        self.maxlen = int(maxlen)
        self._lock = sanitizer.make_lock("TimeSeriesStore._lock", leaf=True)
        self._series: dict[str, Series] = sanitizer.guarded(
            {}, lock=self._lock, name="TimeSeriesStore._series")

    def append(self, name: str, t: float, v: float,
               kind: str = "gauge") -> None:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = Series(name, kind, self.maxlen)
                self._series[name] = s
            s._points.append((float(t), float(v)))

    def points(self, name: str) -> list:
        """``[(t, v), ...]`` oldest first; ``[]`` for an unknown series."""
        with self._lock:
            s = self._series.get(name)
            return list(s._points) if s is not None else []

    def last(self, name: str) -> Optional[tuple]:
        with self._lock:
            s = self._series.get(name)
            return s._points[-1] if s is not None and s._points else None

    def values(self, name: str) -> list:
        return [v for _t, v in self.points(name)]

    def names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def to_json(self, last: Optional[int] = None,
                prefix: Optional[str] = None) -> dict:
        """``{"n_series": n, "series": {name: {"kind": k, "points":
        [[t, v], ...]}}}``: the newest ``last`` points of each series,
        optionally only the names starting with ``prefix``."""
        with self._lock:
            items = [(n, s.kind, list(s._points))
                     for n, s in sorted(self._series.items())
                     if prefix is None or n.startswith(prefix)]
        out = {}
        for name, kind, pts in items:
            if last is not None:
                pts = pts[-int(last):]
            out[name] = {"kind": kind,
                         "points": [[round(t, 6), v] for t, v in pts]}
        return {"n_series": len(out), "series": out}


# ---------------------------------------------------------------------- #
# derived signals                                                         #
# ---------------------------------------------------------------------- #


class Rate:
    """d(source)/dt between the source's previous and newest points."""

    def __init__(self, source: str, name: Optional[str] = None) -> None:
        self.source = source
        self.name = name if name is not None else f"{source}:rate"
        self._prev: Optional[tuple] = None

    def evaluate(self, store: TimeSeriesStore, now: float) -> None:
        latest = store.last(self.source)
        if latest is None:
            return
        prev, self._prev = self._prev, latest
        if prev is None or latest[0] <= prev[0]:
            return
        store.append(self.name, latest[0],
                     (latest[1] - prev[1]) / (latest[0] - prev[0]),
                     kind="derived")


class EWMA:
    """Exponentially weighted moving average of the source's newest value
    (updated only when the source advances)."""

    def __init__(self, source: str, alpha: float = 0.2,
                 name: Optional[str] = None) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.source = source
        self.alpha = float(alpha)
        self.name = name if name is not None else f"{source}:ewma"
        self._last_t: Optional[float] = None
        self._ewma: Optional[float] = None

    def evaluate(self, store: TimeSeriesStore, now: float) -> None:
        latest = store.last(self.source)
        if latest is None or latest[0] == self._last_t:
            return
        self._last_t = latest[0]
        self._ewma = (latest[1] if self._ewma is None
                      else (1 - self.alpha) * self._ewma
                      + self.alpha * latest[1])
        store.append(self.name, latest[0], self._ewma, kind="derived")


class Ratio:
    """num / den of two series' newest values (a zero denominator skips
    the tick instead of writing inf)."""

    def __init__(self, num: str, den: str, name: str) -> None:
        self.num = num
        self.den = den
        self.name = name

    def evaluate(self, store: TimeSeriesStore, now: float) -> None:
        n, d = store.last(self.num), store.last(self.den)
        if n is None or d is None or d[1] == 0.0:
            return
        store.append(self.name, max(n[0], d[0]), n[1] / d[1],
                     kind="derived")


class WindowPercentile:
    """q-th percentile of the source's points inside the trailing window:
    a percentile over series history (the collector's ``:p50``/``:p99``
    are over one tick's histogram samples)."""

    def __init__(self, source: str, q: float = 99.0,
                 window_s: float = 10.0,
                 name: Optional[str] = None) -> None:
        self.source = source
        self.q = float(q)
        self.window_s = float(window_s)
        self.name = name if name is not None else f"{source}:w{q:g}"

    def evaluate(self, store: TimeSeriesStore, now: float) -> None:
        cutoff = now - self.window_s
        vals = [v for t, v in store.points(self.source) if t >= cutoff]
        if not vals:
            return
        store.append(self.name, now,
                     float(np.percentile(np.asarray(vals, np.float64),
                                         self.q)),
                     kind="derived")


# ---------------------------------------------------------------------- #
# detectors                                                               #
# ---------------------------------------------------------------------- #


class Detector:
    """Base detector: a subclass implements the pure :meth:`check`;
    :meth:`evaluate` adds the edge trigger (the ``detector_state`` gauge,
    and ``detector_fired``/``detector_cleared`` events on a transition
    only)."""

    def __init__(self, name: str, series: str,
                 severity: str = "degraded") -> None:
        if severity not in _SEVERITY_CODE:
            raise ValueError(
                f"severity must be degraded|critical, got {severity!r}")
        self.name = name
        self.series = series
        self.severity = severity
        self.firing = False
        self.last: dict = {}

    def check(self, store: TimeSeriesStore, now: float) -> dict:
        raise NotImplementedError

    def evaluate(self, store: TimeSeriesStore, now: float, *,
                 registry=None, events=None) -> dict:
        verdict = self.check(store, now)
        verdict["severity"] = self.severity
        firing, was = bool(verdict.get("firing")), self.firing
        self.firing = firing
        self.last = verdict
        if registry is not None:
            registry.gauge("detector_state", {"detector": self.name}).set(
                float(_SEVERITY_CODE[self.severity]) if firing else 0.0)
        if events is not None and firing != was:
            fields = {k: v for k, v in verdict.items()
                      if isinstance(v, (int, float, str, bool))}
            events.emit("detector_fired" if firing else "detector_cleared",
                        detector=self.name, series=self.series, **fields)
        return verdict


class ThresholdDetector(Detector):
    """Newest value beyond a fixed bound (queue too deep, too few free KV
    blocks)."""

    def __init__(self, name: str, series: str, threshold: float, *,
                 direction: str = "above",
                 severity: str = "degraded") -> None:
        super().__init__(name, series, severity)
        if direction not in ("above", "below"):
            raise ValueError(
                f"direction must be above|below, got {direction!r}")
        self.threshold = float(threshold)
        self.direction = direction

    def check(self, store: TimeSeriesStore, now: float) -> dict:
        latest = store.last(self.series)
        if latest is None:
            return {"firing": False, "value": None,
                    "threshold": self.threshold}
        v = latest[1]
        firing = (v > self.threshold if self.direction == "above"
                  else v < self.threshold)
        return {"firing": firing, "value": v, "threshold": self.threshold,
                "direction": self.direction}


class ZScoreDetector(Detector):
    """Newest value ``z`` standard deviations from the rolling baseline
    (the ``baseline`` points before it). It needs ``min_points`` baseline
    points, and a flat baseline (std below ``eps``) never fires."""

    def __init__(self, name: str, series: str, *, z: float = 3.0,
                 direction: str = "above", baseline: int = 64,
                 min_points: int = 8, eps: float = 1e-9,
                 severity: str = "degraded") -> None:
        super().__init__(name, series, severity)
        if direction not in ("above", "below", "both"):
            raise ValueError(
                f"direction must be above|below|both, got {direction!r}")
        self.z = float(z)
        self.direction = direction
        self.baseline = int(baseline)
        self.min_points = int(min_points)
        self.eps = float(eps)

    def check(self, store: TimeSeriesStore, now: float) -> dict:
        vals = store.values(self.series)[-(self.baseline + 1):]
        if len(vals) < self.min_points + 1:
            return {"firing": False, "points": len(vals)}
        base = np.asarray(vals[:-1], np.float64)
        mean, std = float(base.mean()), float(base.std())
        if std < self.eps:
            return {"firing": False, "value": vals[-1], "mean": mean,
                    "zscore": 0.0}
        zscore = (vals[-1] - mean) / std
        firing = {"above": zscore > self.z,
                  "below": zscore < -self.z,
                  "both": abs(zscore) > self.z}[self.direction]
        return {"firing": firing, "value": vals[-1],
                "mean": round(mean, 6), "zscore": round(zscore, 4),
                "z": self.z, "direction": self.direction}


class DeadmanDetector(Detector):
    """No progress on a cumulative series for longer than ``timeout_s``
    while the subject has work (``active_fn``): the decode-stall alarm.
    While ``active_fn`` reports idle the stall clock rearms: an empty
    queue is not a stall."""

    def __init__(self, name: str, series: str, timeout_s: float, *,
                 active_fn: Optional[Callable[[], bool]] = None,
                 severity: str = "critical") -> None:
        super().__init__(name, series, severity)
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.active_fn = active_fn
        self._last_value: Optional[float] = None
        self._last_advance_t: Optional[float] = None

    def check(self, store: TimeSeriesStore, now: float) -> dict:
        latest = store.last(self.series)
        value = latest[1] if latest is not None else None
        if (value is not None
                and (self._last_value is None or value > self._last_value)):
            self._last_value = value
            self._last_advance_t = now
        active = (bool(self.active_fn()) if self.active_fn is not None
                  else True)
        if not active or self._last_advance_t is None:
            self._last_advance_t = now
            return {"firing": False, "value": value, "active": active,
                    "stalled_s": 0.0}
        stalled = now - self._last_advance_t
        return {"firing": stalled > self.timeout_s, "value": value,
                "active": active, "stalled_s": round(stalled, 3),
                "timeout_s": self.timeout_s}


# ---------------------------------------------------------------------- #
# the collector                                                           #
# ---------------------------------------------------------------------- #


class Collector:
    """Fixed-cadence sampler: registry -> store -> signals -> detectors
    (-> health, once a :class:`~chainermn_torch.monitor.health.
    HealthMonitor` is attached). One :meth:`tick` is the whole pipeline at
    one timestamp; :meth:`start` runs it every ``cadence_s`` on a daemon
    thread, which observes its own scheduling lag into
    ``ts_collect_lag_seconds``. One thread ticks it (single writer)."""

    def __init__(self, *, registry=None,
                 store: Optional[TimeSeriesStore] = None,
                 cadence_s: float = 0.25, clock=None,
                 signals=(), detectors=(), events=None,
                 maxlen: int = 512) -> None:
        if cadence_s <= 0:
            raise ValueError(f"cadence_s must be > 0, got {cadence_s}")
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self.store = store if store is not None else TimeSeriesStore(
            maxlen=maxlen)
        self.cadence_s = float(cadence_s)
        self._clock = clock if clock is not None else time.monotonic
        self._signals = list(signals)
        self._detectors = list(detectors)
        self._health = None
        self._prev_counters: dict[str, tuple] = {}
        self._last_tick: Optional[float] = None
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_samples = self._registry.counter("ts_samples_total")
        self._h_lag = self._registry.histogram("ts_collect_lag_seconds",
                                               unit="s")

    def add_signal(self, signal) -> "Collector":
        self._signals.append(signal)
        return self

    def add_detector(self, detector: Detector) -> "Collector":
        self._detectors.append(detector)
        return self

    def attach_health(self, monitor) -> "Collector":
        """Evaluate ``monitor`` at the end of every tick, over this
        collector's store and clock."""
        self._health = monitor
        return self

    @property
    def detectors(self) -> list:
        return list(self._detectors)

    @property
    def health(self):
        """The attached health monitor (``None`` until
        :meth:`attach_health`)."""
        return self._health

    def tick(self, now: Optional[float] = None) -> dict:
        """Sample every instrument, run the signals, then the detectors,
        then health, all at one timestamp; returns ``{"now", "samples",
        "detectors", "health"}``."""
        now = self._clock() if now is None else float(now)
        window = (self.cadence_s if self._last_tick is None
                  else max(now - self._last_tick, 1e-9))
        n = 0
        for inst in self._registry.instruments():
            key = inst.key
            if isinstance(inst, Counter):
                v = float(inst.value)
                prev = self._prev_counters.get(key)
                self._prev_counters[key] = (now, v)
                self.store.append(key, now, v, kind="counter")
                n += 1
                if prev is not None and now > prev[0]:
                    self.store.append(key + ":rate", now,
                                      (v - prev[1]) / (now - prev[0]),
                                      kind="rate")
                    n += 1
            elif isinstance(inst, Gauge):
                self.store.append(key, now, float(inst.value), kind="gauge")
                n += 1
            elif isinstance(inst, Histogram):
                samples = inst.recent(window, now=now)
                if samples:
                    t = np.asarray(samples, np.float64)
                    self.store.append(key + ":p50", now,
                                      float(np.percentile(t, 50)),
                                      kind="percentile")
                    self.store.append(key + ":p99", now,
                                      float(np.percentile(t, 99)),
                                      kind="percentile")
                    n += 2
        for sig in self._signals:
            sig.evaluate(self.store, now)
        verdicts = {det.name: det.evaluate(self.store, now,
                                           registry=self._registry,
                                           events=self._events)
                    for det in self._detectors}
        health = (self._health.evaluate(now) if self._health is not None
                  else None)
        self._last_tick = now
        self.ticks += 1
        self._c_samples.inc(n)
        return {"now": now, "samples": n, "detectors": verdicts,
                "health": health}

    def start(self) -> "Collector":
        """Run :meth:`tick` every ``cadence_s`` on a daemon thread
        (idempotent while running)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="chainermn-ts-collector", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop and join the collector thread; idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def __enter__(self) -> "Collector":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        target = self._clock()
        while not self._stop.is_set():
            t0 = self._clock()
            self._h_lag.observe(max(0.0, t0 - target))
            try:
                self.tick(t0)
            except Exception as e:  # noqa: BLE001 — the observer must not die
                print(f"chainermn_torch.monitor: collector tick failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            target = t0 + self.cadence_s
            self._stop.wait(self.cadence_s)


__all__ = ["Collector", "DeadmanDetector", "Detector", "EWMA", "Rate",
           "Ratio", "Series", "ThresholdDetector", "TimeSeriesStore",
           "WindowPercentile", "ZScoreDetector"]
