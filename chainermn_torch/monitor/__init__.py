"""Host-side telemetry (the port's ``chainermn_tpu.monitor``): the metrics
registry and the event ring, each with one process-wide default
instance, with Prometheus :func:`exposition`, a JSON :func:`snapshot`
and the cross-rank :func:`aggregate`; the recompile guard and the
per-step wrapper :func:`instrument` with the CUDA memory gauges;
profiler regions (:func:`annotate`); continuous telemetry (the
time-series store, collector, derived signals and detectors);
per-replica health scores; SLO burn rates; request-scoped tracing (span
trees with Chrome export); the per-tenant cost ledger
(:class:`CostLedger`); and the scrape server (:mod:`.http`).

Usage::

    from chainermn_torch import monitor

    step = monitor.instrument(step, "train")      # events+metrics+recompiles
    with monitor.annotate("chainermn.eval"):      # profiler region
        ...
    monitor.emit("checkpoint", path=p)            # structured event
    print(monitor.exposition())                   # Prometheus text
    record["monitor"] = monitor.snapshot()        # JSON block
    fleet = monitor.aggregate(comm)               # every rank: the merge
"""

from __future__ import annotations

from chainermn_torch.monitor.annotations import annotate
from chainermn_torch.monitor.events import EventLog, device_memory_lines
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
from chainermn_torch.monitor.instrument import (  # noqa: E402
    MonitoredFunction,
    RecompileGuard,
    instrument,
    record_memory_gauges,
)
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

from chainermn_torch.monitor.costs import (  # noqa: E402
    CostLedger,
    NoisyNeighborDetector,
    merge_cost_payloads,
    standard_tenant_sensors,
)
from chainermn_torch.monitor import http  # noqa: E402,F401


def emit(kind: str, **fields) -> None:
    """Emit a structured event into the default event ring."""
    get_event_log().emit(kind, **fields)


def snapshot(memory: bool = True) -> dict:
    """JSON-able snapshot of the default registry, refreshing the CUDA
    memory gauges first unless ``memory=False``."""
    if memory:
        record_memory_gauges(get_registry())
    return get_registry().snapshot()


def exposition() -> str:
    """Prometheus text exposition of the default registry."""
    return get_registry().exposition()


def aggregate(comm) -> dict:
    """The default registry merged across ``comm``'s ranks (counters
    summed, gauges averaged, histogram percentiles over the pooled
    samples); every rank returns the same dict."""
    return get_registry().aggregate(comm)


__all__ = ["NULL_TRACE", "Collector", "CostLedger", "Counter",
           "DeadmanDetector", "Detector", "EWMA", "ErrorRateObjective",
           "EventLog", "Gauge", "HealthMonitor", "HealthScore", "Histogram",
           "LatencyObjective", "MetricsRegistry", "MonitoredFunction",
           "NoisyNeighborDetector", "Rate", "Ratio", "RecompileGuard",
           "SLOEngine", "Span", "ThresholdDetector", "TimeSeriesStore",
           "Trace", "Tracer", "WindowPercentile", "ZScoreDetector",
           "aggregate", "annotate", "device_memory_lines", "emit",
           "exposition", "fleet_health", "get_event_log", "get_registry",
           "get_slo_engine", "get_tracer", "http", "instrument",
           "latency_report", "merge_cost_payloads", "merge_rank_payloads",
           "record_memory_gauges", "snapshot", "span",
           "standard_replica_sensors", "standard_tenant_sensors",
           "wire_replica"]
