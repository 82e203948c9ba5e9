"""Per-test telemetry isolation for the port's tests that drive objects of
both packages.

Each package keeps one process-wide metrics registry, event ring and
tracer, and
several of its objects count into them (the JAX package's
``SharePayloadCache`` and ``TenantBreaker`` report hits, evictions and
states from it). Test files that share a worker process would otherwise
see each other's counts and traces. :func:`fresh_telemetry` gives both
packages a new registry, event ring and default tracer for one test;
``monkeypatch`` puts the old ones back afterwards. Both packages'
``get_registry()`` and ``get_tracer()`` (and the module-level ``span``)
read their module global at each call, so the patched global takes
effect at once.

Use it from an autouse fixture::

    @pytest.fixture(autouse=True)
    def _isolated(monkeypatch):
        fresh_telemetry(monkeypatch)

Objects built before the patch (a module-scoped engine) keep counting
into the registry they were built against; compare their counts as
deltas.
"""

from chainermn_torch import monitor as torch_monitor
from chainermn_torch.monitor import trace as torch_trace
from chainermn_tpu.monitor import _state as jax_state
from chainermn_tpu.monitor import trace as jax_trace
from chainermn_tpu.monitor.events import EventLog as JaxEventLog
from chainermn_tpu.monitor.registry import MetricsRegistry as JaxRegistry


def fresh_telemetry(monkeypatch) -> tuple:
    """Give both packages a fresh registry, event ring and default tracer
    (sampling every trace) for this test; returns ``(jax_registry,
    torch_registry)``."""
    jax_reg, torch_reg = JaxRegistry(), torch_monitor.MetricsRegistry()
    monkeypatch.setattr(jax_state, "_REGISTRY", jax_reg)
    monkeypatch.setattr(jax_state, "_EVENTS", JaxEventLog())
    monkeypatch.setattr(torch_monitor, "_REGISTRY", torch_reg)
    monkeypatch.setattr(torch_monitor, "_EVENTS", torch_monitor.EventLog())
    monkeypatch.setattr(jax_trace, "_TRACER", jax_trace.Tracer())
    monkeypatch.setattr(torch_trace, "_TRACER", torch_trace.Tracer())
    return jax_reg, torch_reg
