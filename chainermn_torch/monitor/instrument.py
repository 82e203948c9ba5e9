"""Recompile tracking (the port's copy of ``RecompileGuard`` from
``chainermn_tpu/monitor/instrument.py``).

:class:`RecompileGuard` watches anything that exposes ``_cache_size()``,
the number of executables it has built: a jitted function in the
reference, a fixed step program (:mod:`chainermn_torch.serving._programs`,
one captured CUDA graph) in the port. Growth past the first build is a
*recompile*: counted, event-logged, and optionally warned or raised on.
The rest of the reference module (``instrument``, the memory gauges)
waits for its own slice (ROADMAP.md, Queue A item 13).
"""

from __future__ import annotations

import sys
from typing import Optional

from chainermn_torch.monitor.events import EventLog
from chainermn_torch.monitor.registry import MetricsRegistry


def _cache_size(fn) -> Optional[int]:
    """Executable count of a watched object, or None when it has none."""
    try:
        return int(fn._cache_size())
    except Exception:
        return None


class RecompileGuard:
    """Watch programs for executable-cache growth.

    ``watch(name, fn)`` registers a program (baseline = its current
    ``_cache_size()``); ``check()`` re-reads every watched count and
    returns ``{name: new_executables}`` for those that grew *past their
    first build*. Growth 0 -> 1 is the expected warmup build (a
    ``compile`` event, not a recompile); any later growth increments
    ``recompiles_total{fn=name}`` and emits a ``recompile`` event, and,
    per ``on_recompile``, stays silent (``'count'``), prints to stderr
    (``'warn'``), or raises (``'raise'``).
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None,
                 on_recompile: str = "count") -> None:
        from chainermn_torch.monitor import get_event_log, get_registry

        if on_recompile not in ("count", "warn", "raise"):
            raise ValueError(
                f"on_recompile must be count|warn|raise, got {on_recompile!r}")
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self._mode = on_recompile
        self._watched: dict[str, tuple] = {}   # name -> (fn, last_count)
        self._recompiles: dict[str, int] = {}

    def watch(self, name: str, fn) -> None:
        self._watched[name] = (fn, _cache_size(fn) or 0)

    def check(self) -> dict[str, int]:
        grown: dict[str, int] = {}
        for name, (fn, last) in list(self._watched.items()):
            cur = _cache_size(fn)
            if cur is None or cur <= last:
                continue
            self._watched[name] = (fn, cur)
            if last == 0 and cur == 1:
                self._events.emit("compile", fn=name, executables=cur)
                continue
            delta = cur - max(last, 1)
            if delta <= 0:            # 0 -> n>1 in one step: n-1 recompiles
                continue
            grown[name] = delta
            self._recompiles[name] = self._recompiles.get(name, 0) + delta
            self._registry.counter(
                "recompiles_total", {"fn": name}).inc(delta)
            self._events.emit("recompile", fn=name, executables=cur)
            # the reference also flags the ambient request trace for
            # retention here; the port has no tracer yet (ROADMAP.md,
            # Queue A item 13)
            msg = (f"chainermn_torch.monitor.RecompileGuard: {name!r} "
                   f"recompiled ({cur} executables) — a shape or a static "
                   "argument changed on a hot path")
            if self._mode == "warn":
                print(msg, file=sys.stderr, flush=True)
            elif self._mode == "raise":
                raise RuntimeError(msg)
        return grown

    @property
    def recompiles(self) -> dict[str, int]:
        """Total recompiles observed per watched name (beyond warmup)."""
        return dict(self._recompiles)

    def counts(self) -> dict[str, int]:
        """Current executable count per watched program."""
        return {name: _cache_size(fn) or 0
                for name, (fn, _) in self._watched.items()}

    def assert_no_recompiles(self) -> None:
        self.check()
        if self._recompiles:
            raise AssertionError(
                f"recompiles detected: {self._recompiles} (expected every "
                "watched program to keep its warmup executable)")


__all__ = ["RecompileGuard"]
