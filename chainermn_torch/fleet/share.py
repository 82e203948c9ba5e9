"""Host-side cache of exported prefix-KV payloads (the port's copy of
``chainermn_tpu/fleet/share.py``).

With cross-replica prefix sharing on, the router exports a hot prefix's
KV blocks from the replica that holds them and imports them where the
load balancer sent the request. The export (a gather and a host copy on
the holder's driving thread) is the expensive half; this cache keeps one
export's payload, pinned by a reference count while a submission imports
from it, and serves it to every later request sharing the prefix.

Entries are keyed by the covered prefix's tokens; :meth:`SharePayloadCache.
match` returns the longest entry whose tokens are a prefix of the query.
Eviction is LRU over unpinned entries, bounded by ``max_entries`` (the
payloads are the largest host objects the fleet holds).
"""

from __future__ import annotations

import itertools
from typing import Optional

from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_registry


class ShareEntry:
    """One cached export: the payload plus its pin count. Pinned entries
    (a submission is mid-import from them) never evict."""

    __slots__ = ("payload", "pins", "last_use", "imports")

    def __init__(self, payload: dict) -> None:
        self.payload = payload
        self.pins = 0
        self.last_use = 0
        self.imports = 0

    @property
    def tokens(self) -> tuple:
        return tuple(int(t) for t in self.payload["tokens"])

    @property
    def n_blocks(self) -> int:
        return int(self.payload["n_blocks"])


class SharePayloadCache:
    """Ref-counted LRU over exported prefix payloads (module docstring).

    Thread-safe under its own leaf lock — callers hold NO router lock
    across these calls (the share handshake runs outside it)."""

    def __init__(self, max_entries: int = 8,
                 labels: Optional[dict] = None) -> None:
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = sanitizer.make_lock(
            "SharePayloadCache._lock", leaf=True)
        self._entries: dict[tuple, ShareEntry] = sanitizer.guarded(
            {}, lock=self._lock, name="SharePayloadCache._entries")
        self._clock = itertools.count(1)
        reg = get_registry()
        labels = dict(labels or {})
        self._c_hits = reg.counter(
            "share_payload_cache_hits_total", labels)
        self._c_evict = reg.counter(
            "share_payload_cache_evictions_total", labels)

    def put(self, payload: dict) -> ShareEntry:
        """Cache one exported payload (idempotent per covered prefix —
        a racing second export just refreshes recency) and return its
        entry PINNED; the caller imports from it then :meth:`release`\\s.
        """
        entry = ShareEntry(payload)
        key = entry.tokens
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                entry = existing
                evicted = 0
            else:
                evicted = self._evict_to_fit_locked()
                self._entries[key] = entry
            entry.pins += 1
            entry.last_use = next(self._clock)
        # counter locks are never taken under the cache's leaf lock
        for _ in range(evicted):
            self._c_evict.inc()
        return entry

    def match(self, tokens) -> Optional[ShareEntry]:
        """Longest cached entry whose covered prefix is a prefix of
        ``tokens``, PINNED (counted as a cache hit), or None."""
        query = tuple(int(t) for t in tokens)
        with self._lock:
            best = None
            for key, entry in self._entries.items():
                if len(key) <= len(query) and query[:len(key)] == key:
                    if best is None or len(key) > len(best.tokens):
                        best = entry
            if best is None:
                return None
            best.pins += 1
            best.last_use = next(self._clock)
        self._c_hits.inc()
        return best

    def release(self, entry: ShareEntry, *, imported: bool = False) -> None:
        """Unpin one :meth:`put`/:meth:`match` reference; ``imported``
        marks a completed adoption (reported per entry)."""
        with self._lock:
            entry.pins = max(0, entry.pins - 1)
            if imported:
                entry.imports += 1

    def _evict_to_fit_locked(self) -> int:
        evicted = 0
        while len(self._entries) >= self.max_entries:
            victims = [(e.last_use, k) for k, e in self._entries.items()
                       if e.pins == 0]
            if not victims:
                break           # everything pinned: grow past the bound
            _, key = min(victims)
            del self._entries[key]
            evicted += 1
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def to_json(self) -> dict:
        with self._lock:
            out = {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "pinned": sum(1 for e in self._entries.values()
                              if e.pins > 0),
                "blocks_cached": sum(e.n_blocks
                                     for e in self._entries.values()),
                "imports": sum(e.imports
                               for e in self._entries.values()),
            }
        out["hits"] = int(self._c_hits.value)
        out["evictions"] = int(self._c_evict.value)
        return out


__all__ = ["ShareEntry", "SharePayloadCache"]
