"""Declarative SLOs with multi-window burn rates (the port's copy of
``chainermn_tpu/monitor/slo.py``).

A ``q``-quantile latency objective allows a ``1 - q`` fraction of
requests over its threshold; the burn rate is how fast live traffic
spends that allowance (observed bad fraction over allowed bad fraction:
1.0 is on budget). An objective breaches only when every one of its
windows burns past ``burn_threshold``, so one slow request does not
alarm while a sustained regression does.

Latency objectives read a histogram's timestamped reservoir
(:meth:`~chainermn_torch.monitor.registry.Histogram.recent`, every label
set of the name pooled); error-rate objectives difference counters
between :meth:`SLOEngine.evaluate` calls. Each evaluation publishes
``slo_burn_rate{slo=,window=}`` and ``slo_compliant{slo=}`` gauges; a
new breach counts ``slo_breaches_total{slo=}`` and emits one
``slo_breach`` event naming the offending trace ids: the tracer's
retained traces in the longest window that were slow past the
objective's threshold, errored or missed their deadline. ``tracer=None``
means the process-wide :func:`~chainermn_torch.monitor.trace.get_tracer`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.monitor.registry import Counter, Histogram
from chainermn_torch.monitor.trace import get_tracer


@dataclass
class LatencyObjective:
    """``quantile(metric) < threshold_s``, e.g. TTFT p99 under 200 ms.
    ``metric`` names a seconds-valued histogram (all its label sets
    pool); the allowed bad fraction is ``1 - target_quantile``; below
    ``min_samples`` a window reports burn 0."""

    name: str
    metric: str
    threshold_s: float
    target_quantile: float = 0.99
    windows: tuple = (60.0, 300.0)
    burn_threshold: float = 1.0
    min_samples: int = 1

    def __post_init__(self) -> None:
        if not 0.0 < self.target_quantile < 1.0:
            raise ValueError(
                f"target_quantile must be in (0, 1), got "
                f"{self.target_quantile}")
        if self.threshold_s <= 0:
            raise ValueError(f"threshold_s must be > 0, got "
                             f"{self.threshold_s}")


@dataclass
class ErrorRateObjective:
    """``bad / total < target_rate`` over each window. ``bad`` and
    ``total`` name counters (a tuple pools several; all label sets of a
    name sum). Rates come from counter deltas between evaluations, so
    the engine must be evaluated periodically."""

    name: str
    bad: tuple
    total: tuple
    target_rate: float = 0.01
    windows: tuple = (60.0, 300.0)
    burn_threshold: float = 1.0
    min_events: int = 1
    _history: deque = field(default_factory=lambda: deque(maxlen=4096),
                            repr=False)

    def __post_init__(self) -> None:
        if isinstance(self.bad, str):
            self.bad = (self.bad,)
        if isinstance(self.total, str):
            self.total = (self.total,)
        if not 0.0 < self.target_rate < 1.0:
            raise ValueError(
                f"target_rate must be in (0, 1), got {self.target_rate}")


class SLOEngine:
    """Evaluate declared objectives against the live registry."""

    def __init__(self, *, registry=None, events=None, tracer=None) -> None:
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self._tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()
        self._objectives: list = []
        self._breached: dict[str, bool] = {}
        self._last: dict = {}

    def add(self, objective) -> "SLOEngine":
        if not isinstance(objective, (LatencyObjective, ErrorRateObjective)):
            raise TypeError(
                f"expected LatencyObjective or ErrorRateObjective, got "
                f"{type(objective).__name__}")
        with self._lock:
            if any(o.name == objective.name for o in self._objectives):
                raise ValueError(f"objective {objective.name!r} already "
                                 "declared")
            self._objectives.append(objective)
        return self

    @property
    def objectives(self) -> list:
        with self._lock:
            return list(self._objectives)

    def _histograms_named(self, name: str) -> list:
        return [i for i in self._registry.instruments()
                if isinstance(i, Histogram) and i.name == name]

    def _counter_sum(self, names: tuple) -> int:
        return sum(int(i.value) for i in self._registry.instruments()
                   if isinstance(i, Counter) and i.name in names)

    def _eval_latency(self, obj: LatencyObjective, now: float) -> dict:
        hists = self._histograms_named(obj.metric)
        allowed = 1.0 - obj.target_quantile
        per_window = {}
        for w in obj.windows:
            samples: list = []
            for h in hists:
                samples.extend(h.recent(w, now=now))
            if len(samples) < obj.min_samples:
                per_window[w] = {"samples": len(samples), "bad_frac": 0.0,
                                 "burn_rate": 0.0}
                continue
            bad = sum(1 for s in samples if s > obj.threshold_s)
            frac = bad / len(samples)
            per_window[w] = {"samples": len(samples),
                             "bad_frac": round(frac, 6),
                             "burn_rate": round(frac / allowed, 4)}
        return per_window

    def _eval_error_rate(self, obj: ErrorRateObjective, now: float) -> dict:
        bad = self._counter_sum(obj.bad)
        total = self._counter_sum(obj.total)
        obj._history.append((now, bad, total))
        per_window = {}
        for w in obj.windows:
            cutoff = now - w
            # the oldest snapshot inside the window anchors the delta
            anchor = next(((b, n) for t, b, n in obj._history
                           if t >= cutoff), (bad, total))
            d_bad = bad - anchor[0]
            d_total = total - anchor[1]
            if d_total < obj.min_events:
                per_window[w] = {"events": d_total, "bad": d_bad,
                                 "rate": 0.0, "burn_rate": 0.0}
                continue
            rate = d_bad / d_total
            per_window[w] = {"events": d_total, "bad": d_bad,
                             "rate": round(rate, 6),
                             "burn_rate": round(rate / obj.target_rate, 4)}
        return per_window

    def _offending_traces(self, obj, window_s: float,
                          limit: int = 16) -> list[str]:
        """Retained traces inside the window that were slow past the
        threshold, errored or missed a deadline."""
        since = time.perf_counter() - float(window_s)
        threshold = getattr(obj, "threshold_s", None)
        ids = [t.trace_id for t in self._tracer.finished(since=since)
               if (threshold is not None and t.duration_s > threshold)
               or t.error is not None or t.deadline_miss]
        return ids[-limit:]

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass: per-objective, per-window burn rates, ``compliant``
        verdicts, the gauges, and an edge-triggered ``slo_breach`` event
        when an objective newly burns past its threshold in every
        window. ``now`` is on the ``time.monotonic()`` scale."""
        now = time.monotonic() if now is None else float(now)
        report: dict = {}
        for obj in self.objectives:
            latency = isinstance(obj, LatencyObjective)
            per_window = (self._eval_latency(obj, now) if latency
                          else self._eval_error_rate(obj, now))
            burns = [per_window[w]["burn_rate"] for w in obj.windows]
            breached = bool(burns) and all(
                b > obj.burn_threshold for b in burns)
            for w in obj.windows:
                self._registry.gauge(
                    "slo_burn_rate", {"slo": obj.name, "window": f"{w:g}s"},
                ).set(per_window[w]["burn_rate"])
            self._registry.gauge("slo_compliant", {"slo": obj.name}).set(
                0.0 if breached else 1.0)
            entry = {
                "kind": "latency" if latency else "error_rate",
                "windows": {f"{w:g}s": per_window[w] for w in obj.windows},
                "max_burn_rate": round(max(burns, default=0.0), 4),
                "burn_threshold": obj.burn_threshold,
                "compliant": not breached,
            }
            if latency:
                entry["threshold_s"] = obj.threshold_s
                entry["target_quantile"] = obj.target_quantile
            else:
                entry["target_rate"] = obj.target_rate
            was = self._breached.get(obj.name, False)
            if breached:
                traces = self._offending_traces(obj, max(obj.windows))
                entry["offending_traces"] = traces
                if not was:
                    self._registry.counter(
                        "slo_breaches_total", {"slo": obj.name}).inc()
                    self._events.emit(
                        "slo_breach", slo=obj.name,
                        max_burn_rate=entry["max_burn_rate"],
                        windows={f"{w:g}s": per_window[w]["burn_rate"]
                                 for w in obj.windows},
                        traces=traces)
            self._breached[obj.name] = breached
            report[obj.name] = entry
        with self._lock:
            self._last = report
        return report

    @property
    def last(self) -> dict:
        """The most recent :meth:`evaluate` result."""
        with self._lock:
            return dict(self._last)

    def aggregate(self, comm) -> dict:
        """Pool burn rates across ranks over the communicator's
        ``allgather_obj``: per objective and window the mean (what a
        router budgets against) and the max (the worst rank). Every rank
        returns the same dict."""
        local = {name: {w: ent["burn_rate"]
                        for w, ent in entry["windows"].items()}
                 for name, entry in self.last.items()}
        gathered = comm.allgather_obj(local)
        out: dict = {"ranks": len(gathered)}
        for name in sorted({n for g in gathered for n in g}):
            windows: dict = {}
            for g in gathered:
                for w, b in g.get(name, {}).items():
                    windows.setdefault(w, []).append(float(b))
            out[name] = {
                w: {"mean_burn_rate": round(sum(v) / len(v), 4),
                    "max_burn_rate": round(max(v), 4)}
                for w, v in windows.items()}
        return out


_ENGINE: Optional[SLOEngine] = None
_ENGINE_LOCK = threading.Lock()


def get_slo_engine() -> SLOEngine:
    """The process-wide default :class:`SLOEngine`, built at first use."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = SLOEngine()
        return _ENGINE


__all__ = ["ErrorRateObjective", "LatencyObjective", "SLOEngine",
           "get_slo_engine"]
