"""The serving engine's fixed step programs.

The reference engine runs a fixed set of compiled programs (one per
prefill bucket, the decode step, the decode and verify windows, the
prefix insert, the drafter's two), each watched by a ``RecompileGuard``.
The port's counterpart of one compiled program is a :class:`StepProgram`:

- static input tensors, made once (under ``torch.inference_mode``, as the
  engine's steps run) and refilled in place by every call;
- a body that reads and writes only those tensors and the engine's
  persistent state (block stores, dense caches, parameters) and returns
  its outputs;
- ``_cache_size()``: how many times it was built (0 before its first
  call, 1 after), which the engine's guard watches.

On a CUDA device with ``capture`` on, the first call warms the body on a
side stream, then captures it into one ``torch.cuda.CUDAGraph`` in the
memory pool every program of a :class:`ProgramSet` shares; every call is
then copy-in, ``replay()``, and the static outputs. The outputs are
overwritten by the next call, so a caller consumes them first. Otherwise
the same body runs eagerly over the same static buffers, which is what
the CPU tests exercise. A capture or a replay that fails raises; nothing
falls back to eager.

A graph launches its kernels without calling their Python wrappers, so
a wrapper's launch counter (``paged_attend.launches``) would stop at the
capture. Each program records how many launches its capture made, takes
them back (a capture launches nothing), and adds them on every replay.

Engines of a fleet run on threads of one process. One capture runs at a
time in the process (``_CAPTURE_LOCK``, held across a program's warm
runs and its capture), in ``thread_local`` capture mode, so another
thread's replays, copies and syncs on its own stream go on meanwhile.
Each :class:`ProgramSet` owns a CUDA stream no other set holds
(:attr:`ProgramSet.stream`): its programs are warmed and captured on it,
and a fleet replica drives its engine on it. A captured matrix product
keeps the cuBLAS workspace of the (thread, stream) it was captured on,
so two engines captured on one stream would replay side by side over one
workspace (split-K products there spin on its semaphores: the card
hangs); on streams of their own they cannot.
The replay's launch count is added under the same lock, so a capture
counts its own thread's launches only; each :class:`ProgramSet` also
tallies its own replays' launches (``kernel_launches``), which splits
the process-wide count by engine.

A tensor-parallel engine's set has a role (:mod:`._tp`): the leader's
set announces every run (name and operands) before it runs it, and a
follower's runs a program only when the leader's announcement is
replayed (``replaying``), never on its own.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Callable, Optional

import torch

from chainermn_torch.parallel import paged_kernel

_WARM_RUNS = 2          # eager runs on a side stream before a capture
# process-wide: stream capture is a device-wide state, whichever engine
# (thread) starts it
_CAPTURE_LOCK = threading.RLock()
# (device, stream) pairs some live ProgramSet holds as its own
_OWNED_STREAMS: set = set()


def _own_stream(device: torch.device):
    """A stream of the device's pool that no live set holds (the pool has
    a fixed number a priority; both priorities are searched)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with _CAPTURE_LOCK:
        for _ in range(64):
            for prio in (0, -1):
                stream = torch.cuda.Stream(dev, priority=prio)
                key = (index, stream.cuda_stream)
                if key not in _OWNED_STREAMS:
                    _OWNED_STREAMS.add(key)
                    return stream, key
    raise RuntimeError("every pooled CUDA stream is held by a live engine")


class ProgramSet:
    """One engine's step programs and the CUDA-graph memory pool they
    share. ``capture`` says whether they are captured (CUDA only)."""

    def __init__(self, device: torch.device, capture: bool) -> None:
        if capture and device.type != "cuda":
            raise ValueError("capture=True needs a CUDA device")
        self.device = device
        self.capture = bool(capture)
        self.capture_s = 0.0        # wall seconds spent warming + capturing
        self.kernel_launches = 0    # paged_attend launches of its replays
        self._pool = None
        self._stream = None
        self.programs: dict = {}     # name -> StepProgram
        self.announce = None         # a TP leader's announce(name, values)
        self.follower = False        # a TP follower: runs only replays
        self.replaying = False

    @property
    def stream(self):
        """This set's own CUDA stream (taken at the first use, given back
        when the set is collected)."""
        if self._stream is None:
            self._stream, key = _own_stream(self.device)
            weakref.finalize(self, _OWNED_STREAMS.discard, key)
        return self._stream

    @property
    def pool(self):
        """The graph pool handle (made at the first capture)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def program(self, name: str, body: Callable, inputs: dict
                ) -> "StepProgram":
        """A program over static inputs ``{name: (shape, dtype)}``; the
        body takes the dict of static tensors."""
        prog = StepProgram(name, body, inputs, self)
        self.programs[name] = prog
        return prog


class StepProgram:
    """One fixed step program (module docstring)."""

    def __init__(self, name: str, body: Callable, inputs: dict,
                 owner: ProgramSet) -> None:
        self.name = name
        self._body = body
        self._specs = {k: (tuple(shape), dtype)
                       for k, (shape, dtype) in inputs.items()}
        self._owner = owner
        self._inputs: Optional[dict] = None
        self._graph = None
        self._outputs = None
        self._builds = 0
        self._launches = 0          # paged_attend launches of one replay
        self._counter = None

    def _cache_size(self) -> int:
        return self._builds

    @property
    def inputs(self) -> dict:
        """The static input tensors (made at the first access)."""
        if self._inputs is None:
            dev = self._owner.device
            with torch.inference_mode():
                self._inputs = {k: torch.zeros(shape, dtype=dt, device=dev)
                                for k, (shape, dt) in self._specs.items()}
        return self._inputs

    def run(self, **values):
        """Copy ``values`` (numpy arrays or tensors) into the static
        inputs and run the program; returns its outputs."""
        owner = self._owner
        if owner.follower and not owner.replaying:
            raise RuntimeError(
                f"step program {self.name!r}: this rank follows the "
                "tensor-parallel leader's programs (ServingEngine.follow); "
                "drive the engine on the leader")
        if owner.announce is not None:
            owner.announce(self.name, values)
        with torch.inference_mode():
            ins = self.inputs
            for k, v in values.items():
                ins[k].copy_(torch.as_tensor(v))
            if not self._owner.capture:
                if not self._builds:
                    self._builds = 1
                return self._body(ins)
            if self._graph is None:
                self._capture()
            try:
                self._graph.replay()
            except Exception as e:
                raise RuntimeError(f"step program {self.name!r}: CUDA graph "
                                   f"replay failed: {e}") from e
            if self._launches:
                with _CAPTURE_LOCK:
                    self._counter.launches += self._launches
                    self._owner.kernel_launches += self._launches
            return self._outputs

    def _capture(self) -> None:
        with _CAPTURE_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        """Warm the body on the set's own stream, then capture it there.
        The static inputs hold the first call's operands: every body is
        idempotent on the same inputs (its writes land where its reads
        look, with the values it would write anyway), so the warm runs
        change nothing the replay does not."""
        t0 = time.perf_counter()
        dev = self._owner.device
        main = torch.cuda.current_stream(dev)
        own = self._owner.stream
        own.wait_stream(main)
        with torch.cuda.stream(own):
            for _ in range(_WARM_RUNS):
                self._body(self._inputs)
        main.wait_stream(own)
        counter = paged_kernel.paged_attend
        n0 = counter.launches
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector, run inside the capture, would destroy the
        # graphs of engines already unreachable there, which a capturing
        # stream does not permit (the capture fails): it waits until after
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._owner.pool, stream=own,
                                  capture_error_mode="thread_local"):
                outputs = self._body(self._inputs)
        except Exception as e:
            counter.launches = n0
            raise RuntimeError(f"step program {self.name!r}: CUDA graph "
                               f"capture failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self._launches = counter.launches - n0
        counter.launches = n0            # a capture launches nothing
        self._counter = counter
        self._graph, self._outputs = graph, outputs
        self._builds += 1
        self._owner.capture_s += time.perf_counter() - t0


__all__ = ["ProgramSet", "StepProgram"]
