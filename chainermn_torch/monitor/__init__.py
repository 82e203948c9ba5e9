"""Host-side telemetry: the metrics registry and the event ring, each with
one process-wide default instance; the recompile guard over the serving
engine's fixed step programs; continuous telemetry (the time-series
store, collector, derived signals and detectors); per-replica health
scores; SLO burn rates; and request-scoped tracing (span trees with
Chrome export)."""

from __future__ import annotations

from chainermn_torch.monitor.events import EventLog
from chainermn_torch.monitor.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_report,
    merge_rank_payloads,
)

_REGISTRY = MetricsRegistry()
_EVENTS = EventLog()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _REGISTRY


def get_event_log() -> EventLog:
    """The process-wide default event ring."""
    return _EVENTS


# after the defaults: these modules import get_registry/get_event_log
from chainermn_torch.monitor.health import (  # noqa: E402
    HealthMonitor,
    HealthScore,
    fleet_health,
    standard_replica_sensors,
    wire_replica,
)
from chainermn_torch.monitor.instrument import RecompileGuard  # noqa: E402
from chainermn_torch.monitor.slo import (  # noqa: E402
    ErrorRateObjective,
    LatencyObjective,
    SLOEngine,
    get_slo_engine,
)
from chainermn_torch.monitor.trace import (  # noqa: E402
    NULL_TRACE,
    Span,
    Trace,
    Tracer,
    get_tracer,
    span,
)
from chainermn_torch.monitor.timeseries import (  # noqa: E402
    EWMA,
    Collector,
    DeadmanDetector,
    Detector,
    Rate,
    Ratio,
    ThresholdDetector,
    TimeSeriesStore,
    WindowPercentile,
    ZScoreDetector,
)

__all__ = ["NULL_TRACE", "Collector", "Counter", "DeadmanDetector",
           "Detector", "EWMA", "ErrorRateObjective", "EventLog", "Gauge",
           "HealthMonitor", "HealthScore", "Histogram", "LatencyObjective",
           "MetricsRegistry", "Rate", "Ratio", "RecompileGuard", "SLOEngine",
           "Span", "ThresholdDetector", "TimeSeriesStore", "Trace", "Tracer",
           "WindowPercentile", "ZScoreDetector", "fleet_health",
           "get_event_log", "get_registry", "get_slo_engine", "get_tracer",
           "latency_report", "merge_rank_payloads", "span",
           "standard_replica_sensors", "wire_replica"]
