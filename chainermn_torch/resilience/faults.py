"""Deterministic, seedable fault injection with named cut-points (the
port's copy of ``chainermn_tpu/resilience/faults.py``).

Host-side boundaries carry named cut-points (``inject(CHECKPOINT_SAVE)``,
``torn_fraction(CHECKPOINT_WRITE)``, ...) that are free no-ops until a
:class:`FaultInjector` is installed; then armed faults fire
deterministically (``after``/``times``) or with a seeded probability
(``p``), each emitting a ``fault_injected`` event into the flight
recorder and incrementing ``faults_injected_total{point,kind}`` in the
process registry.

Fault kinds: ``raise`` (:class:`InjectedFault` or a given exception),
``delay`` (sleep ``delay_s``), ``hang`` (block for ``hang_s``, cut short
by :meth:`FaultInjector.release`) and ``torn_write`` (a write-shaped
cut-point keeps only ``frac`` of its bytes, see :func:`torn_fraction`).

The port's cut-points so far are the checkpointer's
(``checkpoint.save`` before any I/O, ``checkpoint.write`` mid-write,
``checkpoint.load`` in ``maybe_load``).

Usage::

    inj = FaultInjector(seed=0)
    inj.arm(CHECKPOINT_WRITE, kind="raise", after=3, times=1)
    with inj:                      # installs process-globally
        ... the 4th snapshot write raises InjectedFault ...
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from chainermn_torch.monitor import get_event_log, get_registry


class InjectedFault(RuntimeError):
    """The exception an armed ``kind='raise'`` fault throws at its
    cut-point (tests and retry policies match on this type)."""

    def __init__(self, point: str, message: Optional[str] = None) -> None:
        super().__init__(message or f"injected fault at {point!r}")
        self.point = point


_KINDS = ("raise", "delay", "hang", "torn_write")


@dataclass
class _Fault:
    point: str
    kind: str
    after: int = 0            # hits to let pass before becoming eligible
    times: Optional[int] = 1  # max firings (None: every eligible hit)
    p: float = 1.0            # per-hit firing probability once eligible
    delay_s: float = 0.05
    hang_s: float = 3600.0
    frac: float = 0.5         # torn_write: fraction of bytes kept
    exc: Optional[BaseException] = None
    hits: int = 0
    fired: int = 0


class FaultInjector:
    """Armable set of faults over the framework's named cut-points.

    Deterministic by construction: eligibility is hit-counted per fault
    (``after``/``times``) and the probabilistic path (``p < 1``) draws
    from one seeded ``RandomState``, so a chaos run replays exactly under
    the same seed and call sequence. Install process-globally with
    :meth:`install`/:meth:`uninstall` or as a context manager; when no
    injector is installed every cut-point is a cheap no-op.
    """

    def __init__(self, seed: Optional[int] = 0) -> None:
        self._rng = np.random.RandomState(seed)
        self._faults: list[_Fault] = []
        self._lock = threading.Lock()
        self._released = threading.Event()
        self.fired_log: list[tuple[str, str]] = []   # (point, kind) history

    # -- configuration --------------------------------------------------- #

    def arm(self, point: str, kind: str = "raise", **kw) -> _Fault:
        """Arm one fault at ``point``. Keywords per kind: ``after``,
        ``times``, ``p`` (all), ``delay_s`` (delay), ``hang_s`` (hang),
        ``frac`` (torn_write), ``exc`` (raise)."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        fault = _Fault(point=point, kind=kind, **kw)
        with self._lock:
            self._faults.append(fault)
        return fault

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            self._faults = [
                f for f in self._faults
                if point is not None and f.point != point
            ]

    # -- installation ---------------------------------------------------- #

    def install(self) -> "FaultInjector":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.release()
        self.uninstall()

    def release(self) -> None:
        """Unblock any in-flight ``hang`` fault (tests; emergency stop)."""
        self._released.set()

    # -- firing ---------------------------------------------------------- #

    def _match(self, point: str, kinds) -> Optional[_Fault]:
        with self._lock:
            for f in self._faults:
                if f.point != point or f.kind not in kinds:
                    continue
                f.hits += 1
                if f.hits <= f.after:
                    continue
                if f.times is not None and f.fired >= f.times:
                    continue
                if f.p < 1.0 and self._rng.rand() >= f.p:
                    continue
                f.fired += 1
                self.fired_log.append((point, f.kind))
                return f
        return None

    def _record(self, f: _Fault, ctx: dict) -> None:
        get_registry().counter(
            "faults_injected_total", {"point": f.point, "kind": f.kind}
        ).inc()
        get_event_log().emit("fault_injected", point=f.point, fault=f.kind,
                             **ctx)

    def fire(self, point: str, **ctx) -> None:
        """Consult the armed faults for ``point`` and act (the body of
        :func:`inject`). ``torn_write`` faults never fire here — they are
        consulted by write-shaped cut-points via :func:`torn_fraction`."""
        f = self._match(point, ("raise", "delay", "hang"))
        if f is None:
            return
        self._record(f, ctx)
        if f.kind == "raise":
            raise f.exc if f.exc is not None else InjectedFault(point)
        if f.kind == "delay":
            time.sleep(f.delay_s)
            return
        # hang: block in short interruptible slices so tests (and the
        # emergency release()) can cut it short; a Watchdog sees one
        # continuous stall either way
        deadline = time.monotonic() + f.hang_s
        while time.monotonic() < deadline:
            if self._released.wait(min(0.05, max(0.0,
                                                 deadline - time.monotonic()))):
                return

    def torn_fraction(self, point: str, **ctx) -> Optional[float]:
        """Fraction of bytes a write at ``point`` should keep, or ``None``
        when no ``torn_write`` fault fires."""
        f = self._match(point, ("torn_write",))
        if f is None:
            return None
        self._record(f, ctx)
        return f.frac


_ACTIVE: Optional[FaultInjector] = None


def get_injector() -> Optional[FaultInjector]:
    """The process-globally installed injector, or None."""
    return _ACTIVE


def inject(point: str, **ctx) -> None:
    """The cut-point call sprinkled through the framework: a no-op unless
    an injector is installed AND has an eligible fault armed at ``point``.
    ``ctx`` fields ride into the ``fault_injected`` event."""
    inj = _ACTIVE
    if inj is None:
        return
    inj.fire(point, **ctx)


def torn_fraction(point: str, **ctx) -> Optional[float]:
    """Write-shaped cut-points ask how much of their payload to actually
    write; None (the overwhelmingly common answer) means all of it."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.torn_fraction(point, **ctx)


__all__ = [
    "FaultInjector",
    "InjectedFault",
    "get_injector",
    "inject",
    "torn_fraction",
]
