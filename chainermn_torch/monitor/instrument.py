"""Recompile and memory tracking, and the per-step instrumentation
wrapper (the port's copy of ``chainermn_tpu/monitor/instrument.py``).

:class:`RecompileGuard` watches anything that exposes ``_cache_size()``,
the number of executables it has built: a jitted function in the
reference, a fixed step program (:mod:`chainermn_torch.serving._programs`,
one captured CUDA graph) in the port. Growth past the first build is a
*recompile*: counted, event-logged, and optionally warned or raised on.

:class:`MonitoredFunction` (through :func:`instrument`) wraps a
step-shaped callable with the telemetry spine: ``step_start``/
``step_end`` events, the ``steps_total`` counter and
``step_time_seconds`` histogram, recompile detection, a profiler
annotation, and every ``memory_interval`` calls the device-memory
gauges (:func:`record_memory_gauges`). Unknown attributes delegate to
the wrapped function, so callers of its own surface see no difference.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

from chainermn_torch.monitor.annotations import annotate
from chainermn_torch.monitor.events import EventLog
from chainermn_torch.monitor.registry import MetricsRegistry
from chainermn_torch.monitor.trace import get_tracer


def _cache_size(fn) -> Optional[int]:
    """Executable count of a watched object, or None when it has none."""
    try:
        return int(fn._cache_size())
    except Exception:
        return None


def record_memory_gauges(registry: MetricsRegistry) -> None:
    """Per-device gauges ``device_bytes_in_use`` and
    ``device_peak_bytes_in_use`` (label ``device``) from
    ``torch.cuda.memory_stats`` (allocated bytes, now and at the peak).
    Records nothing without a CUDA context (the CPU); never raises
    (called from step loops and reporting paths)."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:  # noqa: BLE001 — skip a broken device
                continue
            if not stats:
                continue
            labels = {"device": str(i)}
            if "allocated_bytes.all.current" in stats:
                registry.gauge("device_bytes_in_use", labels).set(
                    stats["allocated_bytes.all.current"])
            if "allocated_bytes.all.peak" in stats:
                registry.gauge("device_peak_bytes_in_use", labels).set(
                    stats["allocated_bytes.all.peak"])
    except Exception:  # noqa: BLE001 — telemetry never raises
        pass


class RecompileGuard:
    """Watch programs for executable-cache growth.

    ``watch(name, fn)`` registers a program (baseline = its current
    ``_cache_size()``); ``check()`` re-reads every watched count and
    returns ``{name: new_executables}`` for those that grew *past their
    first build*. Growth 0 -> 1 is the expected warmup build (a
    ``compile`` event, not a recompile); any later growth increments
    ``recompiles_total{fn=name}`` and emits a ``recompile`` event, and,
    per ``on_recompile``, stays silent (``'count'``), prints to stderr
    (``'warn'``), or raises (``'raise'``).
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None,
                 on_recompile: str = "count") -> None:
        from chainermn_torch.monitor import get_event_log, get_registry

        if on_recompile not in ("count", "warn", "raise"):
            raise ValueError(
                f"on_recompile must be count|warn|raise, got {on_recompile!r}")
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self._mode = on_recompile
        self._watched: dict[str, tuple] = {}   # name -> (fn, last_count)
        self._recompiles: dict[str, int] = {}

    def watch(self, name: str, fn) -> None:
        self._watched[name] = (fn, _cache_size(fn) or 0)

    def check(self) -> dict[str, int]:
        grown: dict[str, int] = {}
        for name, (fn, last) in list(self._watched.items()):
            cur = _cache_size(fn)
            if cur is None or cur <= last:
                continue
            self._watched[name] = (fn, cur)
            if last == 0 and cur == 1:
                self._events.emit("compile", fn=name, executables=cur)
                continue
            delta = cur - max(last, 1)
            if delta <= 0:            # 0 -> n>1 in one step: n-1 recompiles
                continue
            grown[name] = delta
            self._recompiles[name] = self._recompiles.get(name, 0) + delta
            self._registry.counter(
                "recompiles_total", {"fn": name}).inc(delta)
            self._events.emit("recompile", fn=name, executables=cur)
            # a step that recompiled is always worth its trace: flag the
            # ambient trace (if any) for forced retention
            get_tracer().mark_current_error(f"recompile:{name}")
            msg = (f"chainermn_torch.monitor.RecompileGuard: {name!r} "
                   f"recompiled ({cur} executables) — a shape or a static "
                   "argument changed on a hot path")
            if self._mode == "warn":
                print(msg, file=sys.stderr, flush=True)
            elif self._mode == "raise":
                raise RuntimeError(msg)
        return grown

    @property
    def recompiles(self) -> dict[str, int]:
        """Total recompiles observed per watched name (beyond warmup)."""
        return dict(self._recompiles)

    def counts(self) -> dict[str, int]:
        """Current executable count per watched program."""
        return {name: _cache_size(fn) or 0
                for name, (fn, _) in self._watched.items()}

    def assert_no_recompiles(self) -> None:
        self.check()
        if self._recompiles:
            raise AssertionError(
                f"recompiles detected: {self._recompiles} (expected every "
                "watched program to keep its warmup executable)")


class MonitoredFunction:
    """Telemetry wrapper around a step-shaped callable (built by
    :func:`instrument`). Call-transparent: same signature, same result;
    unknown attributes delegate to the wrapped function."""

    def __init__(self, fn: Callable, name: str, *,
                 registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None,
                 memory_interval: int = 64) -> None:
        from chainermn_torch.monitor import get_event_log, get_registry

        self._fn = fn
        self._name = name
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self._memory_interval = int(memory_interval)
        labels = {"step": name}
        self._c_steps = self._registry.counter("steps_total", labels)
        self._h_time = self._registry.histogram(
            "step_time_seconds", labels, unit="s")
        self._guard = RecompileGuard(
            registry=self._registry, events=self._events)
        self._guard.watch(name, fn)
        self._n = 0

    @property
    def inner(self) -> Callable:
        return self._fn

    def __call__(self, *args, **kwargs):
        self._n += 1
        n = self._n
        ev = self._events
        ev.emit("step_start", step=self._name, n=n)
        t0 = time.perf_counter()
        with annotate(f"chainermn.step.{self._name}"):
            out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        self._c_steps.inc()
        self._h_time.observe(dt)
        ev.emit("step_end", step=self._name, n=n, dur_s=round(dt, 6))
        self._guard.check()
        if self._memory_interval and n % self._memory_interval == 0:
            record_memory_gauges(self._registry)
        return out

    def __getattr__(self, name: str):
        return getattr(self._fn, name)

    def __repr__(self) -> str:
        return f"<MonitoredFunction {self._name!r} of {self._fn!r}>"


def instrument(fn: Callable, name: str, **kwargs) -> MonitoredFunction:
    """Wrap ``fn`` with step events, metrics and recompile/memory
    tracking. Instrumenting a :class:`MonitoredFunction` wraps the
    original function under the new name instead of stacking wrappers."""
    if isinstance(fn, MonitoredFunction):
        fn = fn.inner
    return MonitoredFunction(fn, name, **kwargs)


__all__ = ["MonitoredFunction", "RecompileGuard", "instrument",
           "record_memory_gauges"]
