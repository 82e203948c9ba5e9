"""Structured event log (flight recorder): a bounded in-memory ring of
timestamped event dicts — the port's copy of
``chainermn_tpu/monitor/events.py``. :meth:`EventLog.emit` is one deque
append under a lock, cheap enough for the decode loop; :meth:`EventLog.dump`
writes the tail as JSONL, then each CUDA device's allocator memory
(:func:`device_memory_lines`), when something goes wrong."""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from collections import deque
from typing import Optional


def device_memory_lines() -> list[str]:
    """One human line per CUDA device: bytes allocated now, the peak and
    the device's total memory, from ``torch.cuda.memory_stats`` (the
    caching allocator's host-side counters: no device sync). With no CUDA
    device, or none initialised in this process, one line says so. Never
    raises: this runs inside crash paths, where a dead CUDA context must
    still let the events dump."""
    lines: list[str] = []
    try:
        import torch

        if not torch.cuda.is_available():
            return ["device memory unavailable: no CUDA device"]
        if not torch.cuda.is_initialized():
            # reading the stats would create a context just to print 0
            return ["device memory: no CUDA context in this process"]
        for i in range(torch.cuda.device_count()):
            try:
                name = torch.cuda.get_device_name(i)
                stats = torch.cuda.memory_stats(i)
                limit = torch.cuda.get_device_properties(i).total_memory
            except Exception as e:  # noqa: BLE001 — a broken context
                lines.append(f"device {i}: memory_stats unavailable: "
                             f"{type(e).__name__}: {e}")
                continue
            used = stats.get("allocated_bytes.all.current", 0)
            peak = stats.get("allocated_bytes.all.peak", 0)
            lines.append(f"device {i} ({name}): in_use={used / 1e6:.1f}MB "
                         f"peak={peak / 1e6:.1f}MB "
                         f"limit={limit / 1e6:.1f}MB")
    except Exception as e:  # noqa: BLE001 — torch broken mid-crash
        lines.append(f"device memory unavailable: {type(e).__name__}: {e}")
    return lines


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

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def tail(self, n: Optional[int] = None) -> list[dict]:
        with self._lock:
            evs = list(self._ring)
        return evs if n is None else evs[-n:]

    def dump(self, file=None, last: int = 64, memory: bool = True,
             once: Optional[str] = None) -> int:
        """Write the last ``last`` events, one JSON object per line (oldest
        first), to ``file`` (stderr by default), then with ``memory`` the
        :func:`device_memory_lines`; returns the event count. ``once``
        names a failure episode: a second dump with the same key prints
        one line instead, until :meth:`reset_dump_guard`."""
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
        if memory:
            print("device memory:", file=sink)
            for line in device_memory_lines():
                print(f"  {line}", file=sink)
        print("end flight recorder", file=sink)
        return len(evs)

    def reset_dump_guard(self) -> None:
        """Forget every once-key: the episode ended (recovery succeeded),
        so the next failure dumps again."""
        with self._lock:
            self._dumped.clear()


__all__ = ["EventLog", "device_memory_lines"]
