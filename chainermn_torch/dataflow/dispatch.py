"""Dispatch-ahead stepping: keep losses on the device, fetch them batched
every K steps (the port's copy of ``chainermn_tpu/dataflow/dispatch.py``).

A per-step ``float(loss)`` is a device-to-host round trip on the critical
path: the host waits for the step to finish before it may enqueue the
next one, and the card idles while the host does its share of the next
step. CUDA launches are asynchronous, so the host is free to run several
steps ahead. :class:`LossWindow` is the loop-side half of that bargain:
``push`` keeps the on-device loss of each step and returns at once; once
``window`` losses are pending they are stacked on the device and fetched
in ONE copy to the host, which doubles as the bounded in-flight window
(that copy cannot finish before those steps have, so dispatch never runs
more than ``window`` steps past completion).

:func:`device_fetch` is the other half: a device-to-host value copy,
which waits for the device to produce the bytes, so it is a trustworthy
completion barrier for a timing window or a step.

Telemetry (the process registry of :mod:`chainermn_torch.monitor`):
``loss_fetch_total{loop=}`` (fetch events: ``ceil(steps/window)``, not
``steps``), ``loss_fetch_seconds`` histogram, ``dispatch_lag_steps``
histogram (steps in flight when a fetch closed), ``dispatch_inflight``
gauge.
"""

from __future__ import annotations

from collections import deque
from time import perf_counter
from typing import Callable, Optional

import numpy as np
import torch

from chainermn_torch.monitor import get_registry
from chainermn_torch.monitor.trace import span as _trace_span


def device_fetch(values):
    """Copy tensor(s) to host numpy arrays. ``.cpu()`` waits for the
    device to produce the bytes, so this is also the step's completion
    barrier. Accepts a tensor or a tuple/list of tensors."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    if isinstance(values, (tuple, list)):
        return type(values)(device_fetch(v) for v in values)
    return np.asarray(values)


def _fetch_losses(vals: list) -> list:
    """The pending losses as host floats, in one device-to-host copy when
    they are 0-d tensors of one dtype on one device (stacked there first:
    a ``.item()`` each would be one sync per loss)."""
    if (all(isinstance(v, torch.Tensor) and v.numel() == 1 for v in vals)
            and len({(v.device, v.dtype) for v in vals}) == 1):
        stacked = torch.stack([v.detach().reshape(()) for v in vals])
        return [float(x) for x in stacked.cpu().tolist()]
    # mixed kinds: one copy a value (host values copy nothing)
    return [float(v.detach().float().cpu()) if isinstance(v, torch.Tensor)
            else float(np.asarray(v)) for v in vals]


class LossWindow:
    """Bounded in-flight window of on-device per-step losses.

    ``push(i, loss)`` is O(1) host work until the window fills; then all
    pending losses are fetched in one device-to-host copy (amortized
    ``1/window`` syncs per step). ``drain()`` fetches the remainder and
    returns every loss, in step order, as floats.

    ``on_fetch(step_index, value)`` (optional) is called for each loss as
    its fetch completes: logging callbacks see values up to ``window-1``
    steps late, which is the price of keeping the loop unblocked.
    """

    def __init__(self, window: int = 8, *, name: str = "train",
                 on_fetch: Optional[Callable[[int, float], None]] = None
                 ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._window = int(window)
        self._on_fetch = on_fetch
        self._pending: deque = deque()
        self._losses: list[float] = []
        reg = get_registry()
        labels = {"loop": name}
        self._c_fetches = reg.counter("loss_fetch_total", labels)
        self._h_fetch = reg.histogram("loss_fetch_seconds", labels, unit="s")
        self._h_lag = reg.histogram("dispatch_lag_steps", labels)
        self._g_inflight = reg.gauge("dispatch_inflight", labels)

    def push(self, step: int, loss) -> bool:
        """Keep step ``step``'s on-device loss; fetches (blocking once per
        ``window`` pushes) when the in-flight bound is reached. Returns
        True when this push closed a fetch."""
        self._pending.append((step, loss))
        self._g_inflight.set(len(self._pending))
        if len(self._pending) >= self._window:
            self._fetch_pending()
            return True
        return False

    def _fetch_pending(self) -> None:
        if not self._pending:
            return
        steps = [s for s, _ in self._pending]
        vals = [v for _, v in self._pending]
        self._pending.clear()
        self._h_lag.observe(len(vals))
        t0 = perf_counter()
        # ONE copy closes `len(vals)` steps; the ambient span puts the
        # blocking fetch on the current train-step trace (no-op when no
        # trace is ambient)
        with _trace_span("loss_fetch", n=len(vals)):
            host = _fetch_losses(vals)
        self._h_fetch.observe(perf_counter() - t0)
        self._c_fetches.inc()
        self._g_inflight.set(0)
        for s, v in zip(steps, host):
            self._losses.append(v)
            if self._on_fetch is not None:
                self._on_fetch(s, v)

    def drain(self) -> list[float]:
        """Fetch whatever is still in flight; returns ALL losses in step
        order. The loop's closing barrier: after ``drain`` every pushed
        step has completed on the device."""
        self._fetch_pending()
        return list(self._losses)

    @property
    def losses(self) -> list[float]:
        """Losses fetched so far (excludes in-flight steps)."""
        return list(self._losses)

    @property
    def inflight(self) -> int:
        return len(self._pending)


__all__ = ["LossWindow", "device_fetch"]
