"""Online weight hot-swap into a live serving engine (the port's copy of
``chainermn_tpu/deploy/publish.py``).

:class:`WeightPublisher` puts a new weight set, a mapping with exactly
``model.state_dict()``'s keys (what :meth:`~chainermn_torch.serving.
engine.ServingEngine.swap_params` takes), into a running engine with no
program rebuilt. The expensive part happens outside the fence:

1. **Commit** (the publisher's thread): every tensor is copied to the
   engine's device in the dtype the engine stores (bf16 matmul weights
   after ``cast_weights_()``), on the device's commit stream, from pinned
   host memory with ``non_blocking``; the stream is synchronised before
   the fence is requested, so fence time is drain time only. The commit
   is a snapshot: later writes to the caller's tensors do not reach the
   engine. Every publisher of a device shares one commit stream, which
   no engine holds: copies on an engine's stream would wait behind its
   replays, and a fresh stream for each publish would keep the caching
   allocator from reusing the previous commit's buffers.
2. **Fence** (the scheduler's driving thread):
   :meth:`~chainermn_torch.serving.scheduler.FCFSScheduler.request_swap`
   stops admissions, in-flight requests drain on the weights they
   started with, and between two device calls the drained scheduler
   runs the swap on the thread (and under the engine's CUDA stream) that
   drives the engine. ``swap_params`` checks every key, shape and dtype
   before it writes one, so a failed swap leaves the prior version.

``publish`` blocks for the whole cycle and must not be called from the
thread that drives ``scheduler.step()`` (that thread would wait on the
fence it is supposed to drain): a ``ServingClient`` or a fleet replica
owns such a thread; a caller that steps by hand uses
:meth:`WeightPublisher.publish_async` and keeps stepping until the
handle completes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Mapping, Optional

import torch

from chainermn_torch.deploy.versions import VersionLog
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.resilience.cutpoints import DEPLOY_PUBLISH
from chainermn_torch.resilience.faults import inject


_COMMIT_STREAMS: dict = {}
_COMMIT_LOCK = threading.Lock()


def _commit_stream(device: torch.device):
    """The device's commit stream (module docstring), taken from the pool
    at the first publish and held for the process."""
    from chainermn_torch.serving._programs import _own_stream

    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _COMMIT_LOCK:
        if index not in _COMMIT_STREAMS:
            _COMMIT_STREAMS[index] = _own_stream(device)[0]
        return _COMMIT_STREAMS[index]


class PublishError(RuntimeError):
    """A weight publish failed; the engine kept its prior weights."""


class SwapHandle:
    """Progress and result of one publish cycle."""

    def __init__(self, ticket, t_start: float, commit_s: float) -> None:
        self._ticket = ticket
        self._t_start = t_start
        self.commit_s = commit_s          # the copy to the device, synced
        self.version: Optional[int] = None

    @property
    def done(self) -> bool:
        return self._ticket.done

    @property
    def error(self) -> Optional[BaseException]:
        return self._ticket.error

    @property
    def fence_s(self) -> Optional[float]:
        return self._ticket.fence_s

    @property
    def total_s(self) -> Optional[float]:
        if self._ticket.t_executed is None:
            return None
        return self._ticket.t_executed - self._t_start

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until the swap ran; returns the new weight version.
        Raises :class:`PublishError` when the swap failed (the engine is
        on its prior weights) or the wait timed out."""
        try:
            ok = self._ticket.wait(timeout)
        except BaseException as e:
            raise PublishError(f"weight publish failed: {e}") from e
        if not ok:
            raise PublishError(
                f"weight publish still fenced after {timeout}s — is the "
                "scheduler being stepped? (publish from a non-driving "
                "thread, or use publish_async with a manual step loop)")
        self.version = self._ticket.result
        return self.version


class WeightPublisher:
    """Publishes versioned weight sets into one live engine.

    ``scheduler=None`` is the offline mode: the swap applies at once on
    the calling thread and needs an idle engine (no slot decoding)."""

    def __init__(self, engine, scheduler=None, *,
                 log: Optional[VersionLog] = None) -> None:
        self.engine = engine
        self.scheduler = scheduler
        self.log = log if log is not None else VersionLog()
        reg = get_registry()
        labels = {"engine": "serving"}
        self._c_swaps = reg.counter("deploy_swaps_total", labels)
        self._c_failed = reg.counter("deploy_swap_failures_total", labels)
        self._h_swap = reg.histogram("deploy_swap_seconds", labels, unit="s")
        self._events = get_event_log()

    def _commit(self, params) -> dict:
        """Copy ``params`` onto the engine's device in its stored dtypes
        and wait until the copies landed (module docstring, step 1)."""
        inject(DEPLOY_PUBLISH, version=self.engine.weight_version + 1)
        cur = self.engine.model.state_dict()
        if not isinstance(params, Mapping):
            raise PublishError(f"publish: expected a mapping of tensors, "
                               f"got {type(params).__name__}")
        if set(params) != set(cur):
            # swap_params checks shapes and dtypes; this keeps the copy
            # below from walking a different key set
            missing = sorted(set(cur) - set(params))[:3]
            extra = sorted(set(params) - set(cur))[:3]
            raise PublishError(f"publish: keys differ from the engine's "
                               f"state_dict (missing {missing}, "
                               f"unexpected {extra})")
        device = self.engine.device
        ctx, stream = contextlib.nullcontext(), None
        if device.type == "cuda":
            stream = _commit_stream(device)
            # order after what the caller queued for these tensors
            stream.wait_stream(torch.cuda.current_stream(device))
            ctx = torch.cuda.stream(stream)
        committed = {}
        with ctx, torch.no_grad():
            for name, old in cur.items():
                new = params[name]
                if not isinstance(new, torch.Tensor):
                    raise PublishError(f"publish: {name!r} is "
                                       f"{type(new).__name__}, not a tensor")
                committed[name] = new.to(
                    device=old.device, dtype=old.dtype, copy=True,
                    non_blocking=new.device.type == "cpu" and new.is_pinned())
        if stream is not None:
            stream.synchronize()
        return committed

    def _swap_fn(self, committed: dict, step: Optional[int]):
        engine = self.engine
        # the closure lets go of the committed tensors once the swap ran:
        # a handle the caller keeps must not hold a whole weight set, or
        # the next commit allocates afresh instead of reusing its buffers
        box = [committed]

        def run():
            committed = box.pop()
            stream = engine.stream
            ctx = contextlib.nullcontext()
            if stream is not None:
                # a fleet replica's thread already runs on it; another
                # caller (a client's thread, the offline path) enters it
                stream.wait_stream(torch.cuda.current_stream(engine.device))
                ctx = torch.cuda.stream(stream)
            with ctx:
                version = engine.swap_params(committed)
                if stream is not None:
                    # the copies read ``committed``, freed after this
                    stream.synchronize()
            self.log.record(version, source="publish", step=step)
            return version
        return run

    def publish_async(self, params, *, step: Optional[int] = None
                      ) -> SwapHandle:
        """Commit ``params`` to the device, then fence the swap through
        the scheduler; returns a :class:`SwapHandle` at once. Something
        must keep stepping the scheduler for the handle to complete."""
        t0 = time.perf_counter()
        try:
            committed = self._commit(params)
        except Exception as e:
            self._c_failed.inc()
            self._events.emit("publish_failed", phase="commit",
                              error=type(e).__name__)
            if isinstance(e, PublishError):
                raise
            raise PublishError(
                f"weight publish failed during commit: {e}") from e
        commit_s = time.perf_counter() - t0
        if self.scheduler is not None:
            ticket = self.scheduler.request_swap(
                self._swap_fn(committed, step))
        else:
            from chainermn_torch.serving.scheduler import SwapTicket

            ticket = SwapTicket(self._swap_fn(committed, step))
            if self.engine.active_slots:
                ticket.error = PublishError(
                    "publish without a scheduler requires an idle engine")
            else:
                try:
                    ticket.result = ticket.fn()
                except Exception as e:  # noqa: BLE001 — on the ticket
                    ticket.error = e
            ticket.t_executed = time.perf_counter()
            ticket._done.set()
        handle = SwapHandle(ticket, t0, commit_s)
        self._watch(handle)
        return handle

    def publish(self, params, *, step: Optional[int] = None,
                timeout: Optional[float] = 60.0) -> int:
        """The blocking publish cycle; returns the new weight version.
        Not from the thread that drives ``scheduler.step()``."""
        return self.publish_async(params, step=step).wait(timeout)

    def _watch(self, handle: SwapHandle) -> None:
        """Record the outcome when the handle resolves: at once when it
        already has (offline), else from a small daemon thread (an async
        caller may never wait)."""
        if handle.done:
            self._record(handle)
            return

        def run():
            handle._ticket._done.wait()
            self._record(handle)

        threading.Thread(target=run, daemon=True,
                         name="deploy-swap-watch").start()

    def _record(self, handle: SwapHandle) -> None:
        if handle.error is None:
            self._c_swaps.inc()
            if handle.total_s is not None:
                self._h_swap.observe(handle.total_s)
            self._events.emit(
                "publish", version=handle._ticket.result,
                commit_s=round(handle.commit_s, 6),
                fence_s=round(handle.fence_s or 0.0, 6))
        else:
            self._c_failed.inc()
            self._events.emit("publish_failed", phase="swap",
                              error=type(handle.error).__name__)


__all__ = ["PublishError", "SwapHandle", "WeightPublisher"]
