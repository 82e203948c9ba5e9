"""Bounded retry with exponential backoff for host-side transient ops
(the port's copy of ``chainermn_tpu/resilience/retry.py``).

Bounded attempts, exponential backoff with an optional deterministic
(seeded) jitter, a ``retry_on`` exception filter, and registry/event
telemetry for every retry and every exhaustion
(``retries_total{op}`` / ``retries_exhausted_total{op}``).

Usage::

    policy = RetryPolicy(max_attempts=3, base_delay_s=0.05)
    result = policy.call(ckpt_write, blob, op="checkpoint.save")
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from chainermn_torch.monitor import get_event_log, get_registry


class RetryPolicy:
    """Retry a callable up to ``max_attempts`` times.

    Backoff for attempt ``k`` (1-based; the delay slept *after* attempt
    ``k`` fails) is ``min(max_delay_s, base_delay_s * multiplier**(k-1))``
    scaled by ``1 + jitter * u`` with ``u ~ U[0, 1)`` from a seeded RNG —
    ``jitter=0`` disables it; ``seed=None`` makes it nondeterministic
    (production de-synchronization; keep the default seed in tests).
    Exceptions outside ``retry_on`` propagate immediately: a shape error
    is not a transient.
    """

    def __init__(self, max_attempts: int = 3, *, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5, seed: Optional[int] = 0,
                 retry_on: tuple = (Exception,)) -> None:
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = retry_on
        self._rng = np.random.RandomState(seed)

    def delay_s(self, attempt: int) -> float:
        """Backoff after failed attempt ``attempt`` (1-based). Draws from
        the policy's RNG when jitter is on (one draw per call)."""
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * float(self._rng.rand())
        return d

    def call(self, fn: Callable, *args, op: str = "op", **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying per the policy. The final
        failure re-raises the last exception unchanged (callers keep their
        except clauses); every sleep and give-up is event-logged under
        ``op``."""
        events = get_event_log()
        registry = get_registry()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    registry.counter(
                        "retries_exhausted_total", {"op": op}).inc()
                    events.emit("retry_exhausted", op=op, attempts=attempt,
                                error=type(e).__name__)
                    raise
                d = self.delay_s(attempt)
                registry.counter("retries_total", {"op": op}).inc()
                events.emit("retry", op=op, attempt=attempt,
                            delay_s=round(d, 6), error=type(e).__name__)
                time.sleep(d)

    def wrap(self, fn: Callable, op: str = "op") -> Callable:
        """``fn`` with the policy baked in (drop-in replacement)."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, op=op, **kwargs)

        return wrapped


__all__ = ["RetryPolicy"]
