"""Host routing policy of the serving fleet (the port's copy of
``chainermn_tpu/fleet/routing.py``).

A placement decision has two signals:

- **prefix affinity**: a fleet-level trie (:class:`FleetTrie`) maps
  token-block prefixes to the replica whose engine caches them; a
  request sharing a cached prefix goes there, where its admission
  prefills only the uncached suffix;
- **occupancy-aware least-loaded**: each replica's queue depth, slot
  occupancy and EWMA TTFT (:class:`ReplicaSnapshot`) rank the healthy
  replicas; affinity wins only while the holder's load stays within
  ``max_imbalance`` of the least-loaded candidate.

Deterministic, lock-free, engine-free: snapshots in, a
:class:`RouteDecision` out, ties broken by replica id.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class ReplicaSnapshot:
    """One replica's occupancy at routing time (host counters only).

    ``load`` is the admission-relevant pressure: requests queued or
    decoding, normalized by the slot pool so differently-sized replicas
    compare fairly. ``ttft_ewma_s`` breaks load ties toward the replica
    that has recently been fast; ``kv_free_frac`` lets a paged replica
    running low on blocks shed affinity traffic before it starts
    preempting. ``health`` is the telemetry verdict (0 healthy /
    1 degraded / 2 critical, from a health monitor when the router has
    one attached; the monitor is not ported yet): it outranks load,
    so a degraded replica is deprioritized while it can still serve —
    the step *before* the supervisor would quarantine it.
    ``admission_weight`` (0 < w <= 1) is the control plane's rebalance
    knob: shedding a replica's weight inflates its apparent load, so the
    policy sends it proportionally less traffic without ever making it
    unroutable — the step before even the health penalty."""

    replica_id: int
    healthy: bool = True
    queue_depth: int = 0
    active_slots: int = 0
    n_slots: int = 1
    ttft_ewma_s: float = 0.0
    kv_free_frac: float = 1.0
    health: int = 0
    admission_weight: float = 1.0

    @property
    def load(self) -> float:
        # the epsilon keeps the weight effective at zero occupancy (an
        # idle shed replica still loses ties to an idle full-weight
        # peer); at weight 1.0 it is a constant offset and cancels out
        # of every comparison the policy makes
        raw = (self.queue_depth + self.active_slots) / max(self.n_slots, 1)
        return (raw + 1e-3) / max(self.admission_weight, 1e-6)


@dataclass
class RouteDecision:
    """Where one request goes and why (the ``route`` span's labels)."""

    replica_id: int
    affinity_hit: bool = False
    affinity_blocks: int = 0
    reason: str = "least_loaded"


class RoutingPolicy:
    """Two-signal placement over healthy-replica snapshots.

    Parameters
    ----------
    affinity : bool
        Consult the fleet trie at all. Off = pure least-loaded.
    max_imbalance : float
        How much MORE normalized load the affinity holder may carry than
        the least-loaded healthy replica before the cached prefix stops
        being worth it (in ``load`` units: queued+active per slot).
    min_affinity_blocks : int
        Minimum resident prefix blocks for affinity to outrank load —
        a one-block match rarely pays for imbalance.
    min_kv_free_frac : float
        A paged replica below this free-block fraction is skipped by
        affinity (admission there would likely defer or preempt).
    """

    def __init__(self, *, affinity: bool = True, max_imbalance: float = 1.0,
                 min_affinity_blocks: int = 1,
                 min_kv_free_frac: float = 0.05) -> None:
        self.affinity = bool(affinity)
        self.max_imbalance = float(max_imbalance)
        self.min_affinity_blocks = int(min_affinity_blocks)
        self.min_kv_free_frac = float(min_kv_free_frac)

    @staticmethod
    def _key(snap: ReplicaSnapshot) -> tuple:
        # deterministic total order: health verdict first (a degraded
        # replica loses to ANY healthy one regardless of load), then
        # load, then recent speed, then id — equal replicas always
        # resolve to the lowest id
        return (snap.health, snap.load, snap.ttft_ewma_s, snap.replica_id)

    def least_loaded(self, snapshots: Sequence[ReplicaSnapshot]
                     ) -> Optional[ReplicaSnapshot]:
        healthy = [s for s in snapshots if s.healthy]
        if not healthy:
            return None
        return min(healthy, key=self._key)

    def route(self, snapshots: Sequence[ReplicaSnapshot],
              affinity_replica: Optional[int] = None,
              affinity_blocks: int = 0) -> Optional[RouteDecision]:
        """Pick a replica; ``None`` when no healthy replica exists.
        ``affinity_replica``/``affinity_blocks`` come from the fleet
        trie's longest-holder lookup (``None``/0 on a miss)."""
        base = self.least_loaded(snapshots)
        if base is None:
            return None
        if (self.affinity and affinity_replica is not None
                and affinity_blocks >= self.min_affinity_blocks):
            holder = next((s for s in snapshots
                           if s.replica_id == affinity_replica and s.healthy),
                          None)
            if (holder is not None
                    and holder.health <= base.health
                    and holder.kv_free_frac >= self.min_kv_free_frac
                    and holder.load - base.load <= self.max_imbalance):
                return RouteDecision(holder.replica_id, affinity_hit=True,
                                     affinity_blocks=affinity_blocks,
                                     reason="affinity")
        return RouteDecision(base.replica_id, affinity_hit=False,
                             reason="least_loaded")

    def migration_targets(self, snapshots: Sequence[ReplicaSnapshot]
                          ) -> list[ReplicaSnapshot]:
        """Rank decode-tier candidates for a KV handover: healthy
        replicas with block headroom, best (least-loaded) first. The
        caller walks the list until one accepts the payload — a ranking,
        not a single pick, because import capacity (free slots, exact
        block budget) is only known engine-side at handover time.
        Affinity plays no part: the migrated request's prefix KV travels
        WITH it, so there is nothing cached to seek out."""
        fit = [s for s in snapshots
               if s.healthy and s.kv_free_frac >= self.min_kv_free_frac]
        return sorted(fit, key=self._key)

    @staticmethod
    def overloaded(snapshots: Sequence[ReplicaSnapshot],
                   max_queue: Optional[int]) -> bool:
        """Fleet-edge admission gate: total work queued across healthy
        replicas has reached the global bound — shed at the edge (reject
        at submit rather than bury the request in a queue it will expire
        in)."""
        if max_queue is None:
            return False
        depth = sum(s.queue_depth for s in snapshots if s.healthy)
        return depth >= max_queue


class _TrieNode:
    __slots__ = ("key", "parent", "children", "replicas", "last_use")

    def __init__(self, key, parent):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.replicas: dict[int, int] = {}   # replica_id -> last_use clock
        self.last_use = 0


class FleetTrie:
    """The router's belief of which replica caches which prompt prefix.

    A host-only trie over ``block_size``-token keys (the same granularity
    as the engines' :class:`~chainermn_torch.serving.prefix_cache.
    PrefixCacheIndex`, so a fleet hit corresponds to a real engine-side
    block match). Each node records the replicas believed to hold that
    block; :meth:`note` is called at routing time (the chosen replica
    will cache the prompt on admission), :meth:`drop_replica` when a
    replica restarts or quarantines (its engine trie was cleared with its
    store — believing otherwise would route traffic at KV that no longer
    exists). It is a belief, not ground truth: an engine-side LRU
    eviction the router missed just downgrades a would-be hit to a plain
    suffix prefill — correctness never depends on this index.

    ``max_nodes`` bounds memory: inserts past the cap evict the
    least-recently-used leaves first (same stance as the engine trie).
    Single-threaded by design — the router serializes all calls under its
    own lock.
    """

    def __init__(self, block_size: int, max_nodes: int = 8192) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self.max_nodes = int(max_nodes)
        self._root = _TrieNode(None, None)
        self._n_nodes = 0
        self._clock = itertools.count(1)

    def _key(self, tokens, i: int) -> tuple:
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def note(self, tokens, replica_id: int) -> int:
        """Record that ``replica_id`` (now) holds every full block of
        ``tokens``; returns blocks noted. Walks/extends the path,
        stamping the replica on each node."""
        tokens = list(tokens)
        total = len(tokens) // self.block_size
        t = next(self._clock)
        node = self._root
        for i in range(total):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                self._evict_to_fit(protect=node)
                child = _TrieNode(key, node)
                node.children[key] = child
                self._n_nodes += 1
            child.replicas[int(replica_id)] = t
            child.last_use = t
            node = child
        return total

    def lookup(self, tokens) -> tuple[Optional[int], int]:
        """``(replica_id, blocks)`` of the longest believed-resident
        prefix — the replica covering the DEEPEST consecutive path from
        the root (ties: most recently stamped, then lowest id). ``(None,
        0)`` on a miss."""
        tokens = list(tokens)
        total = len(tokens) // self.block_size
        depth_by: dict[int, int] = {}
        stamp_by: dict[int, int] = {}
        alive: Optional[set] = None
        node = self._root
        t = next(self._clock)
        for i in range(total):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            present = set(child.replicas)
            alive = present if alive is None else (alive & present)
            if not alive:
                break
            child.last_use = t
            for rid in alive:
                depth_by[rid] = i + 1
                stamp_by[rid] = child.replicas[rid]
            node = child
        if not depth_by:
            return None, 0
        best = max(depth_by,
                   key=lambda r: (depth_by[r], stamp_by[r], -r))
        return best, depth_by[best]

    def forget(self, tokens, replica_id: int) -> int:
        """Drop ``replica_id``'s stamps along the full-block path of
        ``tokens`` — the surgical inverse of :meth:`note`, for when ONE
        prompt's blocks left a replica (KV migration / decode rebalance
        handed them to a peer) while the rest of its cache stayed put.
        Without this the trie keeps routing affinity traffic at the
        exporter for KV that now lives elsewhere (the disaggregation
        staleness bug). Prunes holder-less childless tail nodes; returns
        blocks forgotten."""
        rid = int(replica_id)
        tokens = list(tokens)
        total = len(tokens) // self.block_size
        path = []
        node = self._root
        for i in range(total):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            path.append(child)
            node = child
        forgotten = 0
        for node in reversed(path):
            if node.replicas.pop(rid, None) is not None:
                forgotten += 1
            if not node.replicas and not node.children:
                del node.parent.children[node.key]
                self._n_nodes -= 1
        return forgotten

    def drop_replica(self, replica_id: int) -> int:
        """Forget everything attributed to ``replica_id`` (its engine's
        trie/store was just rebuilt); prunes nodes left holder-less.
        Returns nodes pruned."""
        rid = int(replica_id)
        pruned = 0
        stack = [self._root]
        order = []
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        # leaves first, so emptied chains unzip bottom-up
        for node in reversed(order):
            if node is self._root:
                continue
            node.replicas.pop(rid, None)
            if not node.replicas and not node.children:
                del node.parent.children[node.key]
                self._n_nodes -= 1
                pruned += 1
        return pruned

    def _evict_to_fit(self, protect=None) -> None:
        while self._n_nodes >= self.max_nodes:
            leaves = []
            stack = [self._root]
            while stack:
                node = stack.pop()
                if (node is not self._root and not node.children
                        and node is not protect):  # never unzip the path
                    leaves.append(node)            # being extended
                stack.extend(node.children.values())
            if not leaves:
                return
            victim = min(leaves, key=lambda nd: nd.last_use)
            del victim.parent.children[victim.key]
            self._n_nodes -= 1

    @property
    def n_nodes(self) -> int:
        return self._n_nodes


__all__ = [
    "FleetTrie",
    "ReplicaSnapshot",
    "RouteDecision",
    "RoutingPolicy",
]
