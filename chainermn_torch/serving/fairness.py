"""Overload policies: weighted-fair admission and brownout (the port of
``chainermn_tpu/serving/fairness.py``).

Two policy objects the scheduler consults; they pick and gate, the
scheduler acts:

- :class:`FairAdmission` — class order plus weighted deficit round robin
  over tenants. ``batch`` requests are eligible only once every
  ``interactive`` one is drained; within a class, tenants take turns by
  DRR over token budgets (cost = prompt tokens + requested new tokens),
  each tenant's quantum scaled by an effective weight: its base weight
  shrunk by its measured device-second share (:meth:`FairAdmission.
  set_shares`). Selection only reorders admission; a request's tokens
  depend on its prompt and seed alone.
- :class:`BrownoutPolicy` — a reversible ladder of degradation levels,
  entered and left one step at a time under hysteresis, each step a
  ``brownout_step`` event and the ``brownout_level`` gauge:

  == =======================  ==========================================
  L1 ``pause_batch``          stop admitting the batch class
  L2 ``single_token_decode``  run the single-token decode step instead
                              of decode windows or verify windows
  L3 ``max_new_cap``          cap max_new_tokens of in-flight and
                              future requests
  L4 ``shed_lowest_tenant``   shed the lowest-effective-weight tenant's
                              queued work with a Retry-After hint
  == =======================  ==========================================

  It drives itself from queue depth (:meth:`BrownoutPolicy.auto_observe`)
  or is stepped by a controller (``queue_high=None``).

Both guard their state with a plain ``threading.Lock``. Stdlib and the
monitor spine only.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Mapping, Optional, Sequence

from chainermn_torch.monitor import get_event_log, get_registry

#: The two admission classes. Anything else is rejected at submit().
PRIORITY_CLASSES = ("interactive", "batch")

#: Ladder actions by level (index 0 = healthy). Cataloged here so tests,
#: docs, and the controller name levels consistently.
BROWNOUT_LEVELS = (
    "healthy",
    "pause_batch",
    "single_token_decode",
    "max_new_cap",
    "shed_lowest_tenant",
)


def request_cost(req) -> float:
    """DRR cost of admitting ``req``: prompt tokens + requested budget.

    Charged up front — admission is what reserves slot + KV capacity,
    and the reservation is sized by max_new_tokens, not by what the
    request eventually uses."""
    return float(len(req.prompt) + int(req.max_new_tokens))


class FairAdmission:
    """Weighted deficit-round-robin head selection over a FIFO queue.

    Stateless with respect to the queue itself (the scheduler keeps its
    one guarded deque; this object only *picks* an element), stateful
    in the DRR sense: per-tenant deficit counters and the round-robin
    ring persist across calls so short requests from a light tenant
    interleave fairly with long requests from a heavy one.
    """

    def __init__(self, *, tenant_weights: Optional[Mapping] = None,
                 quantum_tokens: float = 32.0,
                 share_floor: float = 0.05) -> None:
        self._lock = threading.Lock()
        self._quantum = float(quantum_tokens)
        self._floor = float(share_floor)
        with self._lock:
            self._weights = dict(tenant_weights or {})
            self._shares: dict = {}      # tenant -> device-second fraction
            self._deficit: dict = {}     # tenant -> accumulated tokens
            self._ring: list = []        # tenants in first-seen order
            self._last_served: Optional[str] = None

    # -- weight / share feeds ------------------------------------------
    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[str(tenant)] = float(weight)

    def set_shares(self, device_seconds: Mapping) -> None:
        """Feed measured per-tenant device-seconds; normalized to
        fractions here."""
        total = float(sum(device_seconds.values()))
        with self._lock:
            if total <= 0.0:
                self._shares = {}
            else:
                self._shares = {str(t): float(v) / total
                                for t, v in device_seconds.items()}

    def base_weight(self, tenant: str) -> float:
        with self._lock:
            return float(self._weights.get(tenant, 1.0))

    def tenant_share(self, tenant: str) -> float:
        with self._lock:
            return float(self._shares.get(tenant, 0.0))

    def effective_weight(self, tenant: str) -> float:
        """Base weight shrunk by measured consumption, floored so a
        dominant tenant is throttled, never starved."""
        with self._lock:
            return self._effective_locked(tenant)

    def _effective_locked(self, tenant: str) -> float:
        base = float(self._weights.get(tenant, 1.0))
        share = float(self._shares.get(tenant, 0.0))
        return base * max(self._floor, 1.0 - share)

    def lowest_weight_tenant(self, tenants: Iterable) -> Optional[str]:
        """The brownout L4 shed victim: lowest effective weight, ties
        broken by name for determinism."""
        with self._lock:
            pool = sorted(set(str(t) for t in tenants))
            if not pool:
                return None
            return min(pool, key=lambda t: (self._effective_locked(t), t))

    # -- selection ------------------------------------------------------
    def select(self, queue: Sequence, *, allow_batch: bool = True):
        """Pick the next request to admit from ``queue`` (not removed).

        Strict class order first — ``interactive`` before ``batch``,
        and ``batch`` only when ``allow_batch`` (brownout L1 clears it).
        Within the class, weighted DRR over the tenants with queued
        work: each pass tops every active tenant's deficit up by
        ``quantum * effective_weight`` and serves the first whose
        deficit covers its head-of-line cost. Returns ``None`` when
        nothing is eligible."""
        with self._lock:
            return self._select_locked(list(queue), allow_batch)

    def _select_locked(self, queue: list, allow_batch: bool):
        heads: dict = {}
        have_interactive = any(
            getattr(r, "priority", "interactive") != "batch"
            for r in queue)
        if not have_interactive and not allow_batch:
            return None
        want_batch = not have_interactive
        for req in queue:
            is_batch = getattr(req, "priority", "interactive") == "batch"
            if is_batch != want_batch:
                continue
            heads.setdefault(str(req.tenant), req)
        if not heads:
            return None

        # ring maintenance: first-seen order, idle tenants lose credit
        for t in heads:
            if t not in self._ring:
                self._ring.append(t)
        for t in list(self._deficit):
            if t not in heads:
                del self._deficit[t]

        active = [t for t in self._ring if t in heads]
        if self._last_served in active:
            i = active.index(self._last_served) + 1
            active = active[i:] + active[:i]
        if len(active) == 1:
            self._last_served = active[0]
            return heads[active[0]]

        rates = {t: self._quantum * self._effective_locked(t)
                 for t in active}
        max_cost = max(request_cost(heads[t]) for t in active)
        min_rate = max(1e-6, min(rates.values()))
        bound = int(max_cost / min_rate) + 2
        for _ in range(bound):
            for t in active:
                self._deficit[t] = self._deficit.get(t, 0.0) + rates[t]
                head = heads[t]
                if self._deficit[t] >= request_cost(head):
                    self._deficit[t] -= request_cost(head)
                    self._last_served = t
                    return head
        # unreachable by construction; fall back to arrival order
        oldest = min(heads.values(), key=lambda r: r.id)
        self._last_served = str(oldest.tenant)
        return oldest

    def to_json(self) -> dict:
        with self._lock:
            return {
                "weights": dict(self._weights),
                "shares": {t: round(v, 6) for t, v in self._shares.items()},
                "deficit": {t: round(v, 3)
                            for t, v in self._deficit.items()},
                "quantum_tokens": self._quantum,
                "share_floor": self._floor,
            }


class BrownoutPolicy:
    """The degradation ladder (see module docstring for the levels).

    Drives itself from queue depth when ``queue_high`` is set
    (scheduler-owned), or is stepped explicitly via ``step_up`` /
    ``step_down`` / ``relieve`` when ``queue_high`` is ``None``
    (controller-owned — the controller brings its own hysteresis).
    Every transition is edge-triggered: one ``brownout_step`` event per
    level change, gauge updated, never re-emitted while holding."""

    def __init__(self, *, max_level: int = 4,
                 queue_high: Optional[float] = 8.0,
                 up_after_s: float = 0.5, down_after_s: float = 2.0,
                 cooldown_s: float = 0.5,
                 max_new_cap: Optional[int] = 32,
                 labels: Optional[Mapping] = None) -> None:
        if not 1 <= int(max_level) <= len(BROWNOUT_LEVELS) - 1:
            raise ValueError(f"max_level must be 1..4, got {max_level}")
        self._lock = threading.Lock()
        self.max_level = int(max_level)
        self.queue_high = None if queue_high is None else float(queue_high)
        self.up_after_s = float(up_after_s)
        self.down_after_s = float(down_after_s)
        self.cooldown_s = float(cooldown_s)
        self.max_new_cap = None if max_new_cap is None else int(max_new_cap)
        self._events = get_event_log()
        self._g_level = get_registry().gauge("brownout_level",
                                             dict(labels or {}))
        self._g_level.set(0)
        with self._lock:
            self._level = 0
            self._pressure_since: Optional[float] = None
            self._calm_since: Optional[float] = None
            self._last_change: Optional[float] = None
            self._steps = 0
            self._last_reason = ""

    # -- state reads (torn reads fine: single int) ---------------------
    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def pause_batch(self) -> bool:
        return self.level >= 1

    @property
    def force_single_token(self) -> bool:
        return self.level >= 2

    @property
    def effective_max_new_cap(self) -> Optional[int]:
        if self.level >= 3:
            return self.max_new_cap
        return None

    @property
    def shed_lowest(self) -> bool:
        return self.level >= 4 and self.max_level >= 4

    @property
    def saturated(self) -> bool:
        return self.level >= self.max_level

    # -- transitions ----------------------------------------------------
    def step_up(self, reason: str, now: Optional[float] = None) -> bool:
        """One level deeper into brownout; False when already saturated."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self._level >= self.max_level:
                return False
            prev = self._level
            self._level += 1
            self._note_change_locked(now, reason)
            level = self._level
        self._emit_step(level, prev, "up", reason)
        return True

    def step_down(self, reason: str, now: Optional[float] = None) -> bool:
        """One level back toward healthy; False when already at 0."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self._level <= 0:
                return False
            prev = self._level
            self._level -= 1
            self._note_change_locked(now, reason)
            level = self._level
        self._emit_step(level, prev, "down", reason)
        return True

    def relieve(self, reason: str = "capacity_arrived",
                now: Optional[float] = None) -> int:
        """Unwind the whole ladder (capacity arrived); returns the
        number of levels exited, one cataloged event each."""
        steps = 0
        while self.step_down(reason, now=now):
            steps += 1
        return steps

    def _note_change_locked(self, now: float, reason: str) -> None:
        self._last_change = now
        self._pressure_since = None
        self._calm_since = None
        self._steps += 1
        self._last_reason = str(reason)

    def _emit_step(self, level: int, prev: int, direction: str,
                   reason: str) -> None:
        self._g_level.set(level)
        self._events.emit("brownout_step", level=level, prev=prev,
                          direction=direction,
                          action=BROWNOUT_LEVELS[max(level, prev)],
                          reason=str(reason))

    # -- self-driving hysteresis ---------------------------------------
    def auto_observe(self, queue_depth: float,
                     now: Optional[float] = None) -> None:
        """Scheduler-side drive: sustained queue pressure steps up,
        sustained calm steps down, one level per cooldown window. No-op
        for controller-owned policies (``queue_high is None``)."""
        if self.queue_high is None:
            return
        now = time.monotonic() if now is None else float(now)
        pressure = float(queue_depth) >= self.queue_high
        with self._lock:
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                sustained = now - self._pressure_since >= self.up_after_s
                cooled = (self._last_change is None
                          or now - self._last_change >= self.cooldown_s)
                go_up = sustained and cooled and self._level < self.max_level
            else:
                self._pressure_since = None
                if self._calm_since is None:
                    self._calm_since = now
                sustained = now - self._calm_since >= self.down_after_s
                go_up = False
                go_down = sustained and self._level > 0
        if pressure:
            if go_up:
                self.step_up(f"queue_depth>={self.queue_high:g}", now=now)
        elif go_down:
            self.step_down("queue_drained", now=now)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "action": BROWNOUT_LEVELS[self._level],
                "max_level": self.max_level,
                "pause_batch": self._level >= 1,
                "force_single_token": self._level >= 2,
                "max_new_cap": (self.max_new_cap
                                if self._level >= 3 else None),
                "steps": self._steps,
                "last_reason": self._last_reason,
            }


__all__ = [
    "BROWNOUT_LEVELS",
    "BrownoutPolicy",
    "FairAdmission",
    "PRIORITY_CLASSES",
    "request_cost",
]
