"""Structured event log (flight recorder): a bounded in-memory ring of
timestamped event dicts — the port's copy of
``chainermn_tpu/monitor/events.py``. :meth:`EventLog.emit` is one deque
append under a lock, cheap enough for the decode loop; :meth:`EventLog.dump`
writes the tail as JSONL when something goes wrong."""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from collections import deque
from typing import Optional


class EventLog:
    """Bounded structured event ring."""

    def __init__(self, capacity: int = 1024) -> None:
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._dumped: set = set()       # once-keys already dumped

    def emit(self, kind: str, **fields) -> None:
        ev = {"i": next(self._seq), "t": round(time.time(), 6), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def tail(self, n: Optional[int] = None) -> list[dict]:
        with self._lock:
            evs = list(self._ring)
        return evs if n is None else evs[-n:]

    def dump(self, file=None, last: int = 64,
             once: Optional[str] = None) -> int:
        """Write the last ``last`` events, one JSON object per line (oldest
        first), to ``file`` (stderr by default); returns the count.
        ``once`` names a failure episode: a second dump with the same key
        prints one line instead, until :meth:`reset_dump_guard`."""
        sink = file or sys.stderr
        if once is not None:
            with self._lock:
                seen = once in self._dumped
                self._dumped.add(once)
            if seen:
                print(f"chainermn_torch flight recorder: already dumped for "
                      f"{once!r}", file=sink)
                return 0
        evs = self.tail(last)
        print(f"chainermn_torch flight recorder: last {len(evs)} event(s)",
              file=sink)
        for ev in evs:
            print(json.dumps(ev, default=str), file=sink)
        print("end flight recorder", file=sink)
        return len(evs)

    def reset_dump_guard(self) -> None:
        """Forget every once-key: the episode ended (recovery succeeded),
        so the next failure dumps again."""
        with self._lock:
            self._dumped.clear()


__all__ = ["EventLog"]
