"""Multi-replica serving: N engines behind one service (the port's copy of
``chainermn_tpu/fleet``).

- :mod:`~chainermn_torch.fleet.routing`: host policy,
  :class:`RoutingPolicy` (prefix affinity against occupancy-aware
  least-loaded) and :class:`FleetTrie` (which replica caches which
  prefix);
- :mod:`~chainermn_torch.fleet.replica`: :class:`EngineReplica`, one
  engine and scheduler on a thread under a supervisor that drains,
  warm-restarts or quarantines it;
- :mod:`~chainermn_torch.fleet.router`: :class:`FleetRouter`, the
  ``submit``/``wait``/``stream`` front with affinity routing, edge
  shedding, failover by replay, disaggregated prefill/decode tiers with
  KV migration, cross-replica prefix sharing and mid-decode rebalancing;
- :mod:`~chainermn_torch.fleet.overload`: :class:`RetryBudget` and
  :class:`TenantBreaker` at the fleet edge;
- :mod:`~chainermn_torch.fleet.share`: :class:`SharePayloadCache`, the
  exported prefix payloads.

A fleet's streams equal solo ``generate()`` token for token, a killed
replica loses no accepted request (its work replays on a survivor), and
no surviving replica rebuilds a step program after its warmup. The
fleet controller (``control.py``) is not ported yet (ROADMAP.md).
"""

from chainermn_torch.fleet.overload import RetryBudget, TenantBreaker
from chainermn_torch.fleet.replica import (
    EngineReplica,
    ReplicaHang,
    ReplicaKilled,
    ReplicaState,
)
from chainermn_torch.fleet.router import FleetRequest, FleetRouter
from chainermn_torch.fleet.routing import (
    FleetTrie,
    ReplicaSnapshot,
    RouteDecision,
    RoutingPolicy,
)
from chainermn_torch.fleet.share import SharePayloadCache

__all__ = [
    "EngineReplica",
    "FleetRequest",
    "FleetRouter",
    "FleetTrie",
    "ReplicaHang",
    "ReplicaKilled",
    "ReplicaSnapshot",
    "ReplicaState",
    "RetryBudget",
    "RouteDecision",
    "RoutingPolicy",
    "SharePayloadCache",
    "TenantBreaker",
]
