"""A step program's CUDA-graph capture runs with the cyclic garbage
collector off.

A collection inside a capture would destroy the graphs of engines that
are already unreachable (``cudaGraphExecDestroy``), which a capturing
stream does not permit: the capture then fails with
``cudaErrorStreamCaptureInvalidated``. This box has no card, so the
capture's CUDA calls are stand-ins that record what the body saw.
"""

import contextlib
import gc

import pytest
import torch

from chainermn_torch.serving import _programs
from chainermn_torch.serving._programs import StepProgram


class _Stream:
    def wait_stream(self, other):
        pass


class _Owner:
    device = torch.device("cpu")
    stream = _Stream()
    pool = None
    capture_s = 0.0


@pytest.fixture
def fake_capture(monkeypatch):
    """torch.cuda's stream and graph calls as no-ops; ``state`` says
    whether a capture is open."""
    state = {"capturing": False}

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, stream=None, capture_error_mode=None):
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return state


def _program(body):
    prog = StepProgram("p", body, {"x": ((2,), torch.float32)}, _Owner())
    prog._inputs = {"x": torch.zeros(2)}
    return prog


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_is_off_inside_the_capture_only(fake_capture, enabled):
    seen = []

    def body(ins):
        seen.append((fake_capture["capturing"], gc.isenabled()))
        return ins["x"] + 1

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        _program(body)._capture()
        after = gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    # the warm runs on the side stream, then the captured run
    assert seen == [(False, enabled)] * _programs._WARM_RUNS + [(True, False)]
    assert after is enabled


def test_a_failed_capture_turns_the_collector_back_on(fake_capture):
    def body(ins):
        if fake_capture["capturing"]:
            raise ValueError("invalidated")
        return ins["x"]

    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
        _program(body)._capture()
    assert gc.isenabled()
