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
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from chainermn_torch.parallel import paged_kernel

_WARM_RUNS = 2          # eager runs on a side stream before a capture


class ProgramSet:
    """One engine's step programs and the CUDA-graph memory pool they
    share. ``capture`` says whether they are captured (CUDA only)."""

    def __init__(self, device: torch.device, capture: bool) -> None:
        if capture and device.type != "cuda":
            raise ValueError("capture=True needs a CUDA device")
        self.device = device
        self.capture = bool(capture)
        self.capture_s = 0.0        # wall seconds spent warming + capturing
        self._pool = None

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
        return StepProgram(name, body, inputs, self)


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
            self._counter.launches += self._launches
            return self._outputs

    def _capture(self) -> None:
        """Warm the body on a side stream, then capture it. The static
        inputs hold the first call's operands: every body is idempotent on
        the same inputs (its writes land where its reads look, with the
        values it would write anyway), so the warm runs change nothing
        the replay does not."""
        t0 = time.perf_counter()
        dev = self._owner.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(_WARM_RUNS):
                self._body(self._inputs)
        main.wait_stream(side)
        counter = paged_kernel.paged_attend
        n0 = counter.launches
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._owner.pool):
                outputs = self._body(self._inputs)
        except Exception as e:
            counter.launches = n0
            raise RuntimeError(f"step program {self.name!r}: CUDA graph "
                               f"capture failed: {e}") from e
        self._launches = counter.launches - n0
        counter.launches = n0            # a capture launches nothing
        self._counter = counter
        self._graph, self._outputs = graph, outputs
        self._builds += 1
        self._owner.capture_s += time.perf_counter() - t0


__all__ = ["ProgramSet", "StepProgram"]
