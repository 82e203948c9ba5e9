"""Observability: step timing, a profiler trace helper and a hang
watchdog (the port of ``chainermn_tpu/extensions/profiling.py``).

:func:`latency_report` is the one percentile convention every latency
surface reports in (the monitor registry's). :class:`StepTimer` and
:class:`Watchdog` are the JAX package's, host code as it is; the
watchdog's flight-recorder dump is the port's event ring.
:func:`trace` runs ``torch.profiler`` where the reference runs
``jax.profiler``. The HLO collective parsing (``parse_hlo_collectives``,
``collective_stats``) reads XLA programs and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Optional

from chainermn_torch.monitor import get_event_log
from chainermn_torch.monitor.registry import latency_report


class StepTimer:
    """Wall-clock step statistics with warmup exclusion.

    Use as a context manager around each step (or call ``tick()`` once per
    step); ``report()`` returns mean/p50/p99 step time and items/sec.
    Time a device step only around work that ends in a device sync (a
    loss fetched to the host, ``torch.cuda.synchronize()``).
    """

    def __init__(self, warmup: int = 2, items_per_step: int = 0) -> None:
        self._warmup = warmup
        self._items = items_per_step
        self._times: list[float] = []
        self._seen = 0
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._record(time.perf_counter() - self._t0)

    def tick(self) -> None:
        """Alternative to the context manager: call once per completed step
        (the first call only arms the clock)."""
        now = time.perf_counter()
        if self._last is not None:
            self._record(now - self._last)
        self._last = now

    def _record(self, dt: float) -> None:
        self._seen += 1
        if self._seen > self._warmup:
            self._times.append(dt)

    @property
    def steps(self) -> int:
        return len(self._times)

    def report(self) -> dict[str, float]:
        if not self._times:
            return {"steps": 0}
        out = {"steps": len(self._times)}
        out.update(latency_report(self._times, "step_time"))
        if self._items:
            out["items_per_sec"] = self._items / out["step_time_mean_s"]
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over a code block (the CPU, and the card when
    there is one); writes a Chrome trace to ``log_dir/trace.json``
    (Perfetto loads it) and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Watchdog:
    """Deadlock watchdog: a hung step (lost collective peer, a peer that
    died before its send) dumps every thread's stack and — by default —
    aborts the process so the launcher can restart it, instead of hanging
    silently forever.

    Use around each step::

        dog = Watchdog(timeout=300)
        with dog.step():
            train_step(...)

    ``on_timeout='warn'`` only reports — re-armed each period, so a
    multi-period hang keeps reporting instead of going quiet after one.
    """

    def __init__(self, timeout: float, on_timeout: str = "abort",
                 _sink=None) -> None:
        if on_timeout not in ("abort", "warn"):
            raise ValueError(f"on_timeout must be abort|warn, got {on_timeout!r}")
        self._timeout = timeout
        self._mode = on_timeout
        self._sink = _sink or sys.stderr
        self._fired = threading.Event()
        self._timer: Optional[threading.Timer] = None
        # each step entry/exit bumps the generation; a timer carrying a
        # stale one stands down instead of re-arming a finished step
        self._lock = threading.Lock()
        self._gen = 0
        self._armed = False
        self._ctx: dict = {}

    def _fire(self, where: str, gen: int) -> None:
        with self._lock:
            if gen != self._gen or not self._armed:
                return  # the watched step finished; stale timer, stand down
            ctx = dict(self._ctx)
        self._fired.set()
        import faulthandler

        who = (" " + " ".join(f"{k}={v}" for k, v in ctx.items())
               if ctx else "")
        print(
            f"chainermn_torch.Watchdog: step exceeded {self._timeout}s "
            f"({where}{who}) — a peer likely died inside a collective. "
            "Thread stacks follow.",
            file=self._sink, flush=True,
        )
        try:
            # faulthandler needs a real fd; test sinks (StringIO) don't have
            # one, so fall back to a pure-Python dump in its format
            self._sink.fileno()
            faulthandler.dump_traceback(file=self._sink)
        except Exception:
            try:
                import traceback

                current = threading.get_ident()
                for tid, frame in sys._current_frames().items():
                    tag = "Current thread" if tid == current else "Thread"
                    print(f"{tag} {tid:#x} (most recent call first):",
                          file=self._sink)
                    for line in reversed(traceback.format_stack(frame)):
                        self._sink.write(line)
                self._sink.flush()
            except Exception:
                pass
        # flight recorder: what the process was doing when it wedged
        events = get_event_log()
        events.emit("watchdog_fire", where=where, timeout_s=self._timeout,
                    mode=self._mode, **ctx)
        events.dump(file=self._sink)
        if self._mode == "abort":
            os._exit(43)  # as the global except hook: die loudly, not hang
        with self._lock:  # warn mode: re-arm so long hangs keep reporting
            if self._armed and gen == self._gen:
                self._start_timer_locked(where)

    def _start_timer_locked(self, label: str) -> None:
        self._timer = threading.Timer(
            self._timeout, self._fire, args=(label, self._gen)
        )
        self._timer.daemon = True
        self._timer.start()

    @property
    def fired(self) -> bool:
        """Whether any watched step has ever timed out."""
        return self._fired.is_set()

    @contextlib.contextmanager
    def step(self, label: str = "train step", **context):
        """Watch one step. ``context`` (whatever identifies the work) rides
        into the ``watchdog_arm``/``watchdog_fire`` events and the fire
        banner."""
        with self._lock:
            self._gen += 1
            self._armed = True
            self._ctx = context
            self._start_timer_locked(label)
        get_event_log().emit("watchdog_arm", label=label,
                             timeout_s=self._timeout, **context)
        try:
            yield
        finally:
            with self._lock:
                self._gen += 1
                self._armed = False
                self._ctx = {}
                if self._timer is not None:
                    self._timer.cancel()


__all__ = ["StepTimer", "Watchdog", "latency_report", "trace"]
