"""In-process serving client: a background thread drives the scheduler;
callers get blocking and streaming APIs (the port of
``chainermn_tpu/serving/client.py``).

Usage::

    engine = ServingEngine(model, n_slots=4, prefill_len=16)
    with ServingClient(engine, eos_id=0) as client:
        out = client.generate(prompt, max_new_tokens=32)      # blocking
        req = client.submit(prompt, 32, stream_cb=print)       # streaming
        req.wait()

The thread wakes on submission and sleeps when idle; an engine exception
fails every in-flight request loudly instead of hanging its caller.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from chainermn_torch.serving.scheduler import (
    FCFSScheduler,
    Request,
    SwapTicket,
)

_IDLE_WAIT_S = 0.05    # idle poll: bounds how long close() waits on a sleeper


class ServingClient:
    """Background-threaded continuous-batching server, in process. The
    engine is built by the caller; every other keyword (``eos_id``,
    ``max_queue``, ``default_deadline_s``, ``fair``, ``tenant_weights``,
    ``brownout``, ``chunk_tokens_per_step``, ``retry``,
    ``restart_on_error``, ``max_restarts``, ...) goes to the
    :class:`FCFSScheduler`. :meth:`request_swap` queues a weight swap
    behind the scheduler's fence. The thread starts in the constructor and stops
    in :meth:`close` (or on leaving the ``with`` block)."""

    def __init__(self, engine, **scheduler_kw) -> None:
        self.engine = engine
        self.scheduler = FCFSScheduler(engine, **scheduler_kw)
        self.metrics = self.scheduler.metrics
        self._work = threading.Event()
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="chainermn-torch-serving", daemon=True)
        self._thread.start()

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               stream_cb: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None, tenant: str = "default",
               priority: str = "interactive") -> Request:
        """Enqueue a request and return at once; ``stream_cb`` runs on the
        engine thread once per generated token."""
        if self._failure is not None:
            raise RuntimeError("serving engine failed") from self._failure
        if self._stop.is_set():
            raise RuntimeError("client is closed")
        req = self.scheduler.submit(prompt, max_new_tokens, seed=seed,
                                    stream_cb=stream_cb,
                                    deadline_s=deadline_s, tenant=tenant,
                                    priority=priority)
        self._work.set()
        return req

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None, tenant: str = "default",
                 priority: str = "interactive") -> np.ndarray:
        """Blocking single request: ``prompt + generated`` tokens. An
        ERRORED request (shed past its deadline included) re-raises here;
        a timeout cancels it."""
        req = self.submit(prompt, max_new_tokens, seed=seed,
                          deadline_s=deadline_s, tenant=tenant,
                          priority=priority)
        if not req.wait(timeout):
            self.cancel(req)
            raise TimeoutError(
                f"request {req.id} did not finish within {timeout}s")
        return req.output

    def cancel(self, req: Request) -> bool:
        return self.scheduler.cancel(req)

    def request_swap(self, fn) -> SwapTicket:
        """:meth:`FCFSScheduler.request_swap` on the engine thread's
        scheduler (wakes the thread so the fence is served)."""
        ticket = self.scheduler.request_swap(fn)
        self._work.set()
        return ticket

    def close(self, timeout: float = 10.0) -> None:
        """Stop the engine thread; pending requests are cancelled so no
        waiter hangs."""
        self._stop.set()
        self._work.set()
        self._thread.join(timeout)
        for req in self._pending():
            self.scheduler.cancel(req)

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _pending(self) -> list:
        with self.scheduler._lock:
            return (list(self.scheduler._queue)
                    + list(self.scheduler._by_slot.values())
                    + list(self.scheduler._prefilling.values()))

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self.scheduler.has_work:
                    self.scheduler.step()
                else:
                    # clear first so a submit during step() re-wakes us
                    self._work.clear()
                    if self.scheduler.has_work:
                        continue
                    self._work.wait(_IDLE_WAIT_S)
        except BaseException as e:  # noqa: BLE001 — fail every waiter
            self._failure = e
            for req in self._pending():
                req.error = e
                req._done.set()


__all__ = ["ServingClient"]
