"""Host-side telemetry the serving path writes: the metrics registry and
the event ring, each with one process-wide default instance, and the
recompile guard over the serving engine's fixed step programs."""

from __future__ import annotations

from chainermn_torch.monitor.events import EventLog
from chainermn_torch.monitor.instrument import RecompileGuard
from chainermn_torch.monitor.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_report,
)

_REGISTRY = MetricsRegistry()
_EVENTS = EventLog()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _REGISTRY


def get_event_log() -> EventLog:
    """The process-wide default event ring."""
    return _EVENTS


__all__ = ["Counter", "EventLog", "Gauge", "Histogram", "MetricsRegistry",
           "RecompileGuard", "get_event_log", "get_registry",
           "latency_report"]
