"""The traced part of a ``--trace 1`` run and its reduction.

A run traces the last ``trace_seconds`` of its window with
``torch.profiler`` (host and device activity), so the trace is read
after the window closes. The harness marks the traced stretch with a
``bench.traced`` region and its own calls into each layer with
``bench.*`` regions; the program adds its ``chainermn.*`` annotations.

The reduction keeps, from the device timeline inside ``bench.traced``:
each operation's name, device seconds and count; the busy seconds (the
union of the intervals in which any operation ran: kernels, copies and
sets, without the GPU user annotations, which span kernels already
counted); and each idle gap, named by the innermost ``bench.*`` or
``chainermn.*`` host region open when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

TRACED = "bench.traced"


@dataclass
class TraceSummary:
    window_s: float                       # length of bench.traced
    busy_s: float                         # union of device activity
    ops: dict = field(default_factory=dict)   # name -> [seconds, count]
    gaps: dict = field(default_factory=dict)  # host region -> [seconds, n]
    steps: dict = field(default_factory=dict)  # what the driver counted

    def op_seconds(self, parts) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts`` (kernel names come demangled, ``void name<...>(...)``)."""
        return sum(s for name, (s, _) in self.ops.items()
                   if any(p in name for p in parts))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:n]
        return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
                "idle_gaps": [[f"{name} ({k} gaps)", s]
                              for name, (s, k) in gaps]}


def region(name: str):
    """A profiler region of the harness's own, entered only while a
    profiler runs (a ``record_function`` costs microseconds otherwise)."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Tracer:
    """Starts and stops the profiler around the traced stretch; call
    :meth:`warm` during set-up so that the start inside the window does
    not pay the profiler's first initialisation."""

    def __init__(self) -> None:
        self._prof = None
        self._region = None
        self.t0 = self.t1 = None

    @staticmethod
    def warm(device) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._region = record_function(TRACED)
        self._region.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, sync) -> None:
        """Close the traced stretch after ``sync()`` waited for the
        device."""
        sync()
        self.t1 = time.perf_counter()
        self._region.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    @property
    def started(self) -> bool:
        return self._prof is not None

    @property
    def active(self) -> bool:
        return self._prof is not None and self.t1 is None

    def summary(self) -> TraceSummary:
        return reduce_events(self._prof.events())


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _label(name: str) -> bool:
    return name.startswith(("bench.", "chainermn.")) and name != TRACED


def reduce_events(events) -> TraceSummary:
    """Reduce a profiler's events (``prof.events()``) to a
    :class:`TraceSummary`. Times are the events' own microseconds; the
    window is the host's ``bench.traced`` region (its GPU annotation
    spans only the device work it launched)."""
    from torch.autograd import DeviceType

    window = None
    host, dev = [], []
    for e in events:
        tr = e.time_range
        if e.name == TRACED and e.device_type == DeviceType.CPU:
            window = (tr.start, tr.end)
        elif _is_device(e):
            dev.append((tr.start, tr.end, e.name))
        elif _label(e.name) and e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {TRACED} region")
    w0, w1 = window
    ops: dict = defaultdict(lambda: [0.0, 0])
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        ops[name][0] += (t - s) / 1e6
        ops[name][1] += 1
        spans.append((s, t))
    spans.sort()
    busy = 0.0
    gaps = []
    cur_s = cur_t = None
    edge = w0
    for s, t in spans:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            gaps.append((edge if cur_t is None else cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
        gaps.append((cur_t, w1))
    else:
        gaps.append((w0, w1))
    named: dict = defaultdict(lambda: [0.0, 0])
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        named[_open_region(host, starts, g0)][0] += (g1 - g0) / 1e6
        named[_open_region(host, starts, g0)][1] += 1
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                        ops={k: list(v) for k, v in ops.items()},
                        gaps={k: list(v) for k, v in named.items()})


def _open_region(host, starts, t) -> str:
    """The innermost (latest started) labelled host region open at
    ``t``; ``host`` is sorted by start."""
    i = bisect.bisect_right(starts, t)
    best = None
    # regions are short and nest, so look back over a bounded stretch
    for j in range(i - 1, max(-1, i - 4096), -1):
        s, e, name = host[j]
        if e >= t and (best is None or s > best[0]):
            best = (s, name)
            break
    return best[1] if best else "host outside any region"
