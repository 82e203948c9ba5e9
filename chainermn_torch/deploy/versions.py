"""Versioned-weights bookkeeping (the port's copy of
``chainermn_tpu/deploy/versions.py``).

A weight version is an integer scoped to one ``ServingEngine``: 0 is what
the engine was built with, and every successful publish bumps it by one.
It is engine-local on purpose: a fleet rolling through a publish has
replicas briefly on different versions, and the fleet report shows that
skew. :class:`VersionLog` is the host-side audit trail of who published
which version, from where and at which train step.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class WeightVersion:
    """One committed weight set, as seen by one engine (or, in the fleet
    controller's log, by the fleet)."""

    version: int
    # "init" | "publish" | "restore" | "canary" | "rollback"
    source: str = "init"
    step: Optional[int] = None    # the producer's train step, when known
    wall_time: float = field(default_factory=time.time)


class VersionLog:
    """Thread-safe append-only log of :class:`WeightVersion` records:
    written from the thread that runs a swap, read from publisher and
    router threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: List[WeightVersion] = [WeightVersion(0, "init")]

    def record(self, version: int, *, source: str,
               step: Optional[int] = None) -> WeightVersion:
        entry = WeightVersion(version, source, step)
        with self._lock:
            self._entries.append(entry)
        return entry

    @property
    def current(self) -> WeightVersion:
        with self._lock:
            return self._entries[-1]

    def rollback_target(self) -> Optional[WeightVersion]:
        """The newest entry whose version differs from the current one
        (what an automatic rollback lands on; a re-recorded version never
        targets itself). ``None`` while the log has seen one version."""
        with self._lock:
            cur = self._entries[-1]
            for entry in reversed(self._entries[:-1]):
                if entry.version != cur.version:
                    return entry
        return None

    def history(self) -> List[WeightVersion]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


__all__ = ["VersionLog", "WeightVersion"]
