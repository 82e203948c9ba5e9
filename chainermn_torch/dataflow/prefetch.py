"""Background device prefetch: the host-to-device copy overlapped with the
step (the port of ``chainermn_tpu/dataflow/prefetch.py``).

:class:`DevicePrefetcher` moves batch assembly and the H2D copy off the
training loop's critical path: a producer thread draws batches from any
iterator, optionally collates them (``transform``), copies every array
of the batch onto the card and parks the result, already on the device,
in a bounded queue. In steady state the loop's input cost is a queue
pop.

On the card the producer thread sets the device, stages each array in
pinned host memory, issues the copy on a side stream of its own, records
an event and waits for it (the copy's time is measured there, off the
critical path, as the reference's ``block_until_ready`` is). The
consumer makes its current stream wait on that event and calls
``record_stream`` on the tensors, so the caching allocator never hands a
batch's memory to another tensor while the step still reads it. With
``device="cpu"`` the arrays become CPU tensors (no copy) and only the
host-side prefetch runs.

Contracts (the reference's):

- **drains cleanly**: :meth:`close` (also the context-manager exit) stops
  the producer, unblocks it if it waits on a full queue, and joins the
  thread;
- **propagates producer exceptions**: an error raised while drawing,
  collating or copying a batch re-raises in the consumer's ``next()``;
- **resume stays exact**: :meth:`state_dict` is the wrapped iterator's
  state positioned to draw the first batch the consumer has not yet
  received, in the wrapped iterator's own format;
- ``epoch``/``is_new_epoch`` are those of the delivered batches.

Telemetry (the process registry of :mod:`chainermn_torch.monitor`):
``prefetch_queue_depth{name=}`` gauge, ``prefetch_h2d_seconds``
histogram (staging plus copy per batch, on the producer thread),
``prefetch_stall_total`` counter and ``prefetch_stall_seconds`` histogram
(the consumer found the queue empty: the input pipeline is the
bottleneck), ``prefetch_batches_total`` counter. A stall is also a
``prefetch_stall`` span on the consumer thread's ambient trace (the
training loop's ``train_step``; the producer thread has no ambient
trace), and the producer's put and the consumer's empty check are
interleaving points of :mod:`chainermn_torch.analysis.sanitizer`
(``prefetch:offer``, ``prefetch:next``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from chainermn_torch._device import resolve_device
from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_registry
from chainermn_torch.monitor.trace import span as _trace_span

_DONE = "done"
_ERROR = "error"
_BATCH = "batch"


def _map_arrays(fn, batch):
    """``fn`` applied to every numpy array and tensor of a batch (tuples,
    lists and dicts are walked; anything else is kept)."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_arrays(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_arrays(fn, v) for k, v in batch.items()}
    return batch


def _tensors(batch) -> list:
    out = []
    _map_arrays(lambda t: out.append(t), batch)
    return out


class DevicePrefetcher:
    """Wrap a batch iterator with a copy-ahead producer thread.

    - ``iterator``: yields batches (``SerialIterator``, the multi-node
      iterators, a ``NativeBatchLoader``, any generator). With
      ``state_dict``/``load_state_dict`` (and being its own iterator),
      resume is supported.
    - ``depth``: batches kept ready (the queue bound).
    - ``device``: where batches go (the current CUDA card when ``None``;
      raises when there is none — pass ``device="cpu"`` to prefetch on
      the host only).
    - ``transform``: ``transform(batch) -> batch`` on the producer thread
      before the copy (collation).
    - ``snapshot``: capture ``iterator.state_dict()`` after every draw so
      :meth:`state_dict` is exact mid-epoch (default: on when the wrapped
      iterator supports it).
    """

    def __init__(self, iterator, *, depth: int = 2, device=None,
                 transform: Optional[Callable] = None,
                 snapshot: Optional[bool] = None,
                 name: str = "prefetch") -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._device = resolve_device(device)
        # epoch metadata may live on the iterABLE (NativeBatchLoader sets
        # epoch/is_new_epoch on itself while its generator yields)
        self._src = iterator
        self._it = iterator if hasattr(iterator, "__next__") else iter(iterator)
        self._depth = int(depth)
        self._transform = transform
        self._name = name
        self._stateful = (hasattr(self._it, "state_dict")
                          and hasattr(self._it, "load_state_dict"))
        self._snapshot = self._stateful if snapshot is None else bool(snapshot)
        if self._snapshot and not self._stateful:
            raise TypeError(
                "snapshot=True needs the wrapped iterator to expose "
                "state_dict()/load_state_dict()")
        # state positioned to draw the next UNDELIVERED batch
        self._resume_state = self._it.state_dict() if self._snapshot else None
        self.epoch = getattr(self._src, "epoch", 0)
        self.is_new_epoch = getattr(self._src, "is_new_epoch", False)

        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._finished = False

        reg = get_registry()
        labels = {"name": name}
        self._g_depth = reg.gauge("prefetch_queue_depth", labels)
        self._h_h2d = reg.histogram("prefetch_h2d_seconds", labels,
                                     unit="s")
        self._c_stall = reg.counter("prefetch_stall_total", labels)
        self._h_stall = reg.histogram("prefetch_stall_seconds", labels,
                                       unit="s")
        self._c_batches = reg.counter("prefetch_batches_total", labels)

    # -- producer -------------------------------------------------------- #

    def _offer(self, item) -> bool:
        """Blocking put that stays interruptible by :meth:`close`."""
        while not self._stop.is_set():
            # interleaving point: the fuzzer stretches the gap between
            # the stop check and the put (the close()/producer race)
            sanitizer.sync_point("prefetch:offer")
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch, stream):
        """The batch on the card, its copies done: ``(batch, event)``."""
        t0 = time.perf_counter()

        def copy(x):
            host = torch.as_tensor(x)
            pinned = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            pinned.copy_(host)
            with torch.cuda.stream(stream):
                return pinned.to(self._device, non_blocking=True)

        batch = _map_arrays(copy, batch)
        event = torch.cuda.Event()
        event.record(stream)
        event.synchronize()   # the pinned buffers are free after this
        self._h_h2d.observe(time.perf_counter() - t0)
        return batch, event

    def _produce(self) -> None:
        try:
            stream = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._offer((_DONE, None, None, None, None))
                    return
                state = self._it.state_dict() if self._snapshot else None
                meta = (getattr(self._src, "epoch", 0),
                        getattr(self._src, "is_new_epoch", False))
                if self._transform is not None:
                    batch = self._transform(batch)
                event = None
                if stream is not None:
                    batch, event = self._to_device(batch, stream)
                else:
                    batch = _map_arrays(torch.as_tensor, batch)
                if not self._offer((_BATCH, batch, state, meta, event)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._offer((_ERROR, e, None, None, None))

    def _ensure_started(self) -> None:
        if self._thread is None and not self._finished:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._produce, name=f"prefetch-{self._name}",
                daemon=True)
            self._thread.start()

    # -- consumer protocol ----------------------------------------------- #

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        self._ensure_started()
        # interleaving point: the empty check against the producer's put
        sanitizer.sync_point("prefetch:next")
        if self._q.empty():
            # the producer is behind: the input pipeline, not the step,
            # is the bottleneck right now — count it, time the wait, and
            # put the stall on the ambient train-step trace (if one is open)
            self._c_stall.inc()
            t0 = time.perf_counter()
            with _trace_span("prefetch_stall"):
                item = self._q.get()
            self._h_stall.observe(time.perf_counter() - t0)
        else:
            item = self._q.get()
        self._g_depth.set(self._q.qsize())
        kind, payload, state, meta, event = item
        if kind == _DONE:
            self._finished = True
            self._join()
            raise StopIteration
        if kind == _ERROR:
            self._finished = True
            self._join()
            raise payload
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in _tensors(payload):
                t.record_stream(current)
        if self._snapshot:
            self._resume_state = state
        self.epoch, self.is_new_epoch = meta
        self._c_batches.inc()
        return payload

    next = __next__

    # -- lifecycle ------------------------------------------------------- #

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def _join(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            # unblock a producer waiting on a full queue...
            self._drain()
            t.join(timeout=5.0)
            self._thread = None
        # ...and drain AGAIN: the freed slot can admit the producer's
        # in-flight put before it re-checks the stop flag
        self._drain()
        self._g_depth.set(0)

    def close(self) -> None:
        """Stop and join the producer; safe to call repeatedly. Prefetched
        batches are discarded, so the prefetcher stays stopped until
        :meth:`load_state_dict` repositions it."""
        self._join()
        self._finished = True

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best effort; close() is the real contract
        try:
            self._stop.set()
        except Exception:
            pass

    # -- checkpointing ---------------------------------------------------- #

    def state_dict(self) -> dict:
        """The wrapped iterator's state, positioned to draw the first batch
        the consumer has not yet received (prefetched batches are not
        consumed); the wrapped iterator's own format."""
        if not self._snapshot:
            raise TypeError(
                "state_dict() needs snapshot=True and a wrapped iterator "
                "with state_dict()/load_state_dict()")
        return self._resume_state

    def load_state_dict(self, state: dict) -> None:
        """Reposition the wrapped iterator; discards every prefetched
        batch (they were drawn past the restore point)."""
        if not self._stateful:
            raise TypeError(
                "load_state_dict() needs a wrapped iterator with "
                "state_dict()/load_state_dict()")
        self._join()
        self._q = queue.Queue(maxsize=self._depth)
        self._it.load_state_dict(state)
        self._resume_state = self._it.state_dict() if self._snapshot else None
        self.epoch = getattr(self._src, "epoch", 0)
        self.is_new_epoch = getattr(self._src, "is_new_epoch", False)
        self._finished = False


__all__ = ["DevicePrefetcher"]
