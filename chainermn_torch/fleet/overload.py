"""Fleet-edge overload protection (the port's copy of
``chainermn_tpu/fleet/overload.py``): per-tenant retry budgets and a
per-tenant circuit breaker.

- :class:`RetryBudget`: a token bucket per tenant. Every retry (never a
  first submission) spends one token; the bucket refills at
  ``rate_per_s`` up to ``burst``, so transient sheds retry freely while a
  sustained retry storm runs its tenant's budget dry and is denied at the
  edge (``fleet_retry_denied_total``).
- :class:`TenantBreaker`: a shed-rate circuit breaker per tenant over a
  sliding ``window_s`` of submit outcomes. Above its threshold the
  breaker opens for that tenant only (``breaker_open`` event,
  ``fleet_breaker_state`` gauge 1) and its submissions are refused at
  once with a ``retry_after_s`` hint; after ``open_s`` it half-opens and
  the next outcome decides. :meth:`TenantBreaker.note_noisy` tightens a
  flagged tenant's threshold by ``noisy_factor``.
"""

from __future__ import annotations

import time
from typing import Optional

from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_event_log, get_registry


class RetryBudget:
    """Per-tenant token bucket over *retries*.

    ``allow(tenant)`` consumes one token when available (True) or
    denies the retry (False, ``fleet_retry_denied_total{tenant=}``
    incremented). First submissions never consult the budget — only
    explicitly-marked retries spend tokens, so the budget bounds
    amplification, not admission."""

    def __init__(self, *, rate_per_s: float = 1.0,
                 burst: float = 5.0) -> None:
        if burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._lock = sanitizer.make_lock("RetryBudget._lock", leaf=True)
        self._registry = get_registry()
        with self._lock:
            self._tokens: dict = {}    # tenant -> (tokens, t_refill)
            self._denied: dict = {}    # tenant -> count (report mirror)

    def allow(self, tenant: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else float(now)
        tenant = str(tenant)
        with self._lock:
            tokens, t_last = self._tokens.get(tenant, (self.burst, now))
            tokens = min(self.burst,
                         tokens + (now - t_last) * self.rate_per_s)
            if tokens >= 1.0:
                self._tokens[tenant] = (tokens - 1.0, now)
                return True
            self._tokens[tenant] = (tokens, now)
            self._denied[tenant] = self._denied.get(tenant, 0) + 1
        self._registry.counter("fleet_retry_denied_total",
                               {"tenant": tenant}).inc()
        return False

    def to_json(self) -> dict:
        with self._lock:
            return {
                "rate_per_s": self.rate_per_s,
                "burst": self.burst,
                "tokens": {t: round(v[0], 3)
                           for t, v in self._tokens.items()},
                "denied": dict(self._denied),
            }


class TenantBreaker:
    """Per-tenant shed-rate circuit breaker (see module docstring)."""

    def __init__(self, *, window_s: float = 5.0,
                 shed_threshold: float = 0.5, min_samples: int = 4,
                 open_s: float = 2.0, noisy_factor: float = 0.5) -> None:
        if not 0.0 < shed_threshold <= 1.0:
            raise ValueError(
                f"shed_threshold must be in (0, 1], got {shed_threshold}")
        self.window_s = float(window_s)
        self.shed_threshold = float(shed_threshold)
        self.min_samples = int(min_samples)
        self.open_s = float(open_s)
        self.noisy_factor = float(noisy_factor)
        self._lock = sanitizer.make_lock("TenantBreaker._lock", leaf=True)
        self._events = get_event_log()
        self._registry = get_registry()
        with self._lock:
            self._outcomes: dict = {}   # tenant -> [(t, shed_bool), ...]
            self._open_until: dict = {}  # tenant -> monotonic deadline
            self._noisy: set = set()
            self._trips: dict = {}

    # -- outcome feed ---------------------------------------------------
    def record_shed(self, tenant: str,
                    now: Optional[float] = None) -> None:
        self._record(tenant, True, now)

    def record_ok(self, tenant: str, now: Optional[float] = None) -> None:
        self._record(tenant, False, now)

    def _record(self, tenant: str, shed: bool,
                now: Optional[float]) -> None:
        now = time.monotonic() if now is None else float(now)
        tenant = str(tenant)
        opened = False
        with self._lock:
            window = self._outcomes.setdefault(tenant, [])
            window.append((now, shed))
            self._prune_locked(tenant, now)
            if tenant not in self._open_until:
                window = self._outcomes[tenant]
                if len(window) >= self.min_samples:
                    rate = (sum(1 for _, s in window if s)
                            / len(window))
                    if rate >= self._threshold_locked(tenant):
                        self._open_until[tenant] = now + self.open_s
                        self._trips[tenant] = (
                            self._trips.get(tenant, 0) + 1)
                        opened = True
                        shed_rate = rate
        if opened:
            self._emit_open(tenant, shed_rate, reason="shed_rate")

    def _prune_locked(self, tenant: str, now: float) -> None:
        cutoff = now - self.window_s
        self._outcomes[tenant] = [
            (t, s) for t, s in self._outcomes[tenant] if t >= cutoff]

    def _threshold_locked(self, tenant: str) -> float:
        thr = self.shed_threshold
        if tenant in self._noisy:
            thr *= self.noisy_factor
        return thr

    # -- state reads ----------------------------------------------------
    def is_open(self, tenant: str, now: Optional[float] = None) -> bool:
        """True while ``tenant``'s breaker is open; an expired open
        window closes here (half-open: the caller's next real outcome
        re-arms or re-trips it)."""
        now = time.monotonic() if now is None else float(now)
        tenant = str(tenant)
        closed = False
        with self._lock:
            deadline = self._open_until.get(tenant)
            if deadline is None:
                return False
            if now < deadline:
                return True
            # half-open: clear the window so stale sheds can't re-trip
            # the breaker before fresh outcomes arrive
            del self._open_until[tenant]
            self._outcomes[tenant] = []
            closed = True
        if closed:
            self._emit_close(tenant)
        return False

    def retry_after(self, tenant: str,
                    now: Optional[float] = None) -> float:
        """Remaining open time — the structured hint a refused
        submission carries."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            deadline = self._open_until.get(str(tenant))
        if deadline is None:
            return 0.0
        return max(0.0, round(deadline - now, 3))

    # -- external controls ----------------------------------------------
    def force_open(self, tenant: str, open_s: Optional[float] = None,
                   now: Optional[float] = None) -> None:
        """Operator/chaos control: open ``tenant``'s breaker now."""
        now = time.monotonic() if now is None else float(now)
        tenant = str(tenant)
        with self._lock:
            self._open_until[tenant] = now + (
                self.open_s if open_s is None else float(open_s))
            self._trips[tenant] = self._trips.get(tenant, 0) + 1
        self._emit_open(tenant, 1.0, reason="forced")

    def note_noisy(self, tenant: str) -> None:
        """NoisyNeighborDetector feed: a flagged tenant's shed-rate
        threshold tightens by ``noisy_factor`` — measured
        overconsumption trips its breaker sooner."""
        with self._lock:
            self._noisy.add(str(tenant))

    def _emit_open(self, tenant: str, shed_rate: float,
                   reason: str) -> None:
        self._registry.gauge("fleet_breaker_state",
                             {"tenant": tenant}).set(1)
        self._events.emit("breaker_open", tenant=tenant,
                          shed_rate=round(shed_rate, 4), reason=reason,
                          open_s=self.open_s)

    def _emit_close(self, tenant: str) -> None:
        self._registry.gauge("fleet_breaker_state",
                             {"tenant": tenant}).set(0)
        self._events.emit("breaker_close", tenant=tenant)

    def to_json(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "window_s": self.window_s,
                "shed_threshold": self.shed_threshold,
                "open": {t: round(d - now, 3)
                         for t, d in self._open_until.items()},
                "noisy": sorted(self._noisy),
                "trips": dict(self._trips),
            }


__all__ = ["RetryBudget", "TenantBreaker"]
