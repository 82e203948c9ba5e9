"""Request-scoped tracing: span trees, context propagation, Chrome export
(the port's copy of ``chainermn_tpu/monitor/trace.py``).

The monitor's metrics are aggregates: when one request's TTFT lands in
the p99 or one training step stalls, they do not say where the time
went. This module is the causal layer under them:

- :class:`Span`: one named wall-clock interval (``trace_id`` /
  ``span_id`` / ``parent_id``, monotonic start and end, labels);
- :class:`Trace`: one request's (or one training step's) span tree, a
  context that rides the work across threads: the serving scheduler
  attaches spans to a request's trace from its driving thread while the
  submitter holds the handle;
- :class:`Tracer`: the process-wide collector: head sampling
  (``sample=N`` keeps every Nth started trace) with forced retention on
  error and deadline miss, a bounded ring of finished traces, and export
  as Chrome trace-event JSON (``chrome://tracing`` or Perfetto).

What a span measures on the card: host wall time, ``time.perf_counter``
around the host's calls. CUDA launches are asynchronous, so a
``dispatch`` span is the time to enqueue a step's kernels, not the
device's time to run them, and a serving ``decode_step`` span is the
host's time around a graph replay and its token fetch. Only a span that
waits for the device (the loss window's ``loss_fetch``, which copies the
losses to the host) includes device time, and then all the device work
queued before it.

Cost model: recording a span is a handful of host dict and list
operations under a per-trace lock; no device work, no I/O, no
serialization (export pays those). ``sample=0`` disables tracing:
:meth:`Tracer.trace` then returns the singleton :data:`NULL_TRACE`,
whose every method is a no-op, so instrumented code never branches.

Ambient spans: ``with tracer.trace("train_step", step=i):`` installs the
trace as the calling thread's current context, and the module-level
:func:`span` helper attaches a child to whatever context is current (a
no-op otherwise), so deep callees (the loss-window fetch, a checkpoint
enqueue, a prefetch stall) annotate themselves without a handle in every
signature. The ambient stack is thread-local: work on another thread
(serving) passes the :class:`Trace` handle explicitly.

Stdlib only.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional


class Span:
    """One named interval in a trace. ``t0``/``t1`` are
    ``time.perf_counter()`` values (monotonic); ``t1 is None`` while the
    span is open. Treat as read-only outside the owning :class:`Trace`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "labels")

    def __init__(self, name: str, trace_id: str, span_id: int,
                 parent_id: Optional[int], t0: float,
                 labels: Optional[dict] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.labels = labels or {}

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    def __repr__(self) -> str:
        return (f"<Span {self.name!r} {self.duration_s * 1e3:.3f}ms "
                f"trace={self.trace_id}>")


class _SpanCtx:
    """Context-manager handle for one open span: closes it on exit and
    (when the span was opened ambiently) pops it from the thread's
    current-span stack."""

    __slots__ = ("_trace", "_span", "_ambient")

    def __init__(self, trace: "Trace", span: Span, ambient: bool) -> None:
        self._trace = trace
        self._span = span
        self._ambient = ambient

    @property
    def span(self) -> Span:
        return self._span

    def label(self, **labels) -> None:
        self._span.labels.update(labels)

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            self._span.labels.setdefault("error", exc_type.__name__)
            self._trace.mark_error(exc_type.__name__)
        self._trace.end_span(self._span)
        if self._ambient:
            self._trace._tracer._pop_ambient(self._span)


class Trace:
    """One trace: a bounded span tree plus the flags that drive retention.

    Spans may be attached from any thread (per-trace lock); the tree is
    append-only until :meth:`finish`. ``max_spans`` bounds memory per
    trace — spans past the cap are counted (``dropped_spans``), not
    stored, so a pathological request can't grow without limit.
    """

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 kind: str, seq: int, labels: dict,
                 max_spans: int) -> None:
        self._tracer = tracer
        self.trace_id = trace_id
        self.kind = kind
        self.seq = seq
        self.max_spans = max_spans
        self.dropped_spans = 0
        self.error: Optional[str] = None
        self.deadline_miss = False
        self.forced = False
        self.finished = False
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.root = Span(name, trace_id, 0, None, time.perf_counter(),
                         dict(labels))
        self.spans: list[Span] = [self.root]

    enabled = True

    # -- span construction ------------------------------------------------ #

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **labels) -> Span:
        """Open a child span (of ``parent``, default the root). Close it
        with :meth:`end_span` — use :meth:`span` for the common
        context-managed form."""
        parent = parent if parent is not None else self.root
        sp = Span(name, self.trace_id, next(self._ids), parent.span_id,
                  time.perf_counter(), labels)
        with self._lock:
            if self.finished or len(self.spans) >= self.max_spans:
                self.dropped_spans += 1
            else:
                self.spans.append(sp)
        return sp

    def end_span(self, sp: Span, **labels) -> None:
        if sp.t1 is None:
            sp.t1 = time.perf_counter()
        if labels:
            sp.labels.update(labels)

    def span(self, name: str, parent: Optional[Span] = None,
             **labels) -> _SpanCtx:
        """``with trace.span("prefill", bucket=64): ...``"""
        return _SpanCtx(self, self.start_span(name, parent, **labels),
                        ambient=False)

    def add_span(self, name: str, t0: float, t1: float,
                 parent: Optional[Span] = None, **labels) -> None:
        """Attach an already-measured interval (``perf_counter`` values) —
        the form the serving scheduler uses when one device call covers a
        whole admission group and each member gets its own span."""
        sp = self.start_span(name, parent, **labels)
        sp.t0, sp.t1 = t0, t1

    # -- flags ------------------------------------------------------------ #

    def mark_error(self, error: str = "error") -> None:
        """Force retention: errored traces are kept regardless of the
        sampling decision (they are the ones worth reading)."""
        self.error = self.error or str(error)

    def mark_deadline_miss(self) -> None:
        self.deadline_miss = True

    def force(self) -> None:
        self.forced = True

    # -- lifecycle --------------------------------------------------------- #

    def finish(self, **labels) -> None:
        """Close the root (and any still-open span), then hand the trace
        to the tracer for the keep/drop decision. Idempotent."""
        with self._lock:
            if self.finished:
                return
            self.finished = True
            now = time.perf_counter()
            for sp in self.spans:
                if sp.t1 is None:
                    sp.t1 = now
        if labels:
            self.root.labels.update(labels)
        self._tracer._finish(self)

    def __enter__(self) -> "Trace":
        self._tracer._push_ambient(self.root, self)
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self._tracer._pop_ambient(self.root)
        if exc_type is not None:
            self.mark_error(exc_type.__name__)
        self.finish()

    # -- reporting --------------------------------------------------------- #

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def breakdown(self) -> dict:
        """Critical-path attribution: total root time, per-name summed
        durations of the root's DIRECT children (``decode_step`` spans
        collapse into one ``decode_step`` bucket with a count), and the
        ``untracked`` remainder — where the time went, as one dict."""
        with self._lock:
            spans = list(self.spans)
        phases: dict[str, float] = {}
        counts: dict[str, int] = {}
        child_total = 0.0
        for sp in spans:
            if sp.parent_id != 0:
                continue
            d = sp.duration_s
            phases[sp.name] = phases.get(sp.name, 0.0) + d
            counts[sp.name] = counts.get(sp.name, 0) + 1
            child_total += d
        total = self.duration_s
        out = {
            "trace_id": self.trace_id,
            "total_s": round(total, 6),
            "phases_s": {k: round(v, 6) for k, v in phases.items()},
            "phase_counts": counts,
            "untracked_s": round(max(0.0, total - child_total), 6),
        }
        if self.error:
            out["error"] = self.error
        if self.deadline_miss:
            out["deadline_miss"] = True
        return out


class _NullTrace:
    """The disabled-tracing singleton: every method is a no-op, every
    context manager is empty, so call sites never branch."""

    enabled = False
    trace_id = ""
    error = None
    deadline_miss = False
    spans: list = []
    root = None

    def start_span(self, name, parent=None, **labels):
        return None

    def end_span(self, sp, **labels):
        pass

    def span(self, name, parent=None, **labels):
        return self

    def add_span(self, name, t0, t1, parent=None, **labels):
        pass

    def label(self, **labels):
        pass

    def mark_error(self, error="error"):
        pass

    def mark_deadline_miss(self):
        pass

    def force(self):
        pass

    def finish(self, **labels):
        pass

    def breakdown(self):
        return {}

    @property
    def duration_s(self):
        return 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL_TRACE = _NullTrace()


class Tracer:
    """Process-wide trace collector.

    Parameters
    ----------
    sample : int
        Head-sampling rate: keep every ``sample``-th started trace
        (``1`` = all, the default — the ring bounds memory either way).
        ``0`` disables tracing: :meth:`trace` returns :data:`NULL_TRACE`
        and nothing records. Error / deadline-miss / forced traces are
        retained regardless of the sampling decision.
    ring : int
        Finished traces retained (newest win).
    max_spans : int
        Per-trace span cap (see :class:`Trace`).
    """

    def __init__(self, *, sample: int = 1, ring: int = 256,
                 max_spans: int = 512) -> None:
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._tls = threading.local()
        self.configure(sample=sample, ring=ring, max_spans=max_spans)

    def configure(self, *, sample: Optional[int] = None,
                  ring: Optional[int] = None,
                  max_spans: Optional[int] = None) -> None:
        """Reconfigure in place (the default tracer is process-global, so
        examples/benches tune it rather than replace it). Changing
        ``ring`` keeps the newest already-finished traces."""
        with self._lock:
            if sample is not None:
                self.sample = int(sample)
            if max_spans is not None:
                self.max_spans = int(max_spans)
            if ring is not None:
                old = list(getattr(self, "_ring", ()))
                self._ring: deque = deque(old, maxlen=int(ring))

    @property
    def enabled(self) -> bool:
        return self.sample > 0

    # -- trace creation ---------------------------------------------------- #

    def trace(self, name: str, *, kind: str = "request", **labels):
        """Start a trace (or return :data:`NULL_TRACE` when disabled).
        Usable as a context manager (ambient form — training loops) or
        held and finished explicitly (serving requests)."""
        if self.sample <= 0:
            return NULL_TRACE
        seq = next(self._seq)
        trace_id = f"{os.getpid():x}-{seq:x}"
        return Trace(self, trace_id, name, kind, seq, labels,
                     self.max_spans)

    def _finish(self, trace: Trace) -> None:
        keep = (trace.forced or trace.error is not None
                or trace.deadline_miss
                or (self.sample > 0 and trace.seq % self.sample == 0))
        if not keep:
            return
        with self._lock:
            self._ring.append(trace)

    # -- ambient (thread-local) context ------------------------------------ #

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push_ambient(self, span: Span, trace: Trace) -> None:
        self._stack().append((span, trace))

    def _pop_ambient(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1][0] is span:
            st.pop()

    def current(self) -> Optional[Trace]:
        """The calling thread's innermost ambient trace, or None."""
        st = self._stack()
        return st[-1][1] if st else None

    def span(self, name: str, **labels):
        """Child span of the calling thread's current ambient span — a
        no-op context manager when no trace is ambient. The deep-callee
        annotation hook (loss-window fetch, checkpoint enqueue)."""
        st = self._stack()
        if not st:
            return NULL_TRACE
        parent, trace = st[-1]
        sp = trace.start_span(name, parent, **labels)
        self._push_ambient(sp, trace)
        return _SpanCtx(trace, sp, ambient=True)

    def mark_current_error(self, error: str) -> None:
        """Flag the ambient trace (if any) for forced retention — the
        RecompileGuard hook: a step that recompiled is always worth its
        trace."""
        cur = self.current()
        if cur is not None:
            cur.mark_error(error)

    # -- retrieval / export ------------------------------------------------ #

    def finished(self, kind: Optional[str] = None,
                 since: Optional[float] = None) -> list[Trace]:
        """Retained traces, oldest first; filter by ``kind`` and/or root
        end time (``perf_counter`` value)."""
        with self._lock:
            traces = list(self._ring)
        if kind is not None:
            traces = [t for t in traces if t.kind == kind]
        if since is not None:
            traces = [t for t in traces
                      if t.root.t1 is not None and t.root.t1 >= since]
        return traces

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_events(self, traces: Optional[list] = None) -> list[dict]:
        """Chrome trace-event list: one ``ph="X"`` (complete) event per
        closed span, ``ts``/``dur`` in microseconds, one pid per process
        and one tid per trace, plus ``M`` metadata events naming each
        trace row — the layout Perfetto renders as one lane per
        request/step."""
        if traces is None:
            traces = self.finished()
        events: list[dict] = []
        pid = os.getpid()
        for t in traces:
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": t.seq,
                "args": {"name": f"{t.kind} {t.trace_id}"},
            })
            for sp in t.spans:
                if sp.t1 is None:
                    continue
                args = {"trace_id": t.trace_id, "span_id": sp.span_id,
                        "parent_id": sp.parent_id}
                args.update(sp.labels)
                events.append({
                    "name": sp.name,
                    "cat": t.kind,
                    "ph": "X",
                    "ts": round(sp.t0 * 1e6, 3),
                    "dur": round((sp.t1 - sp.t0) * 1e6, 3),
                    "pid": pid,
                    "tid": t.seq,
                    "args": args,
                })
        return events

    def export_chrome(self, file: Optional[str] = None,
                      traces: Optional[list] = None) -> dict:
        """The full Chrome trace object (``{"traceEvents": [...]}``);
        written as JSON to ``file`` when given. Load the file in
        ``chrome://tracing`` or https://ui.perfetto.dev."""
        out = {
            "traceEvents": self.chrome_events(traces),
            "displayTimeUnit": "ms",
        }
        if file:
            with open(file, "w") as f:
                # default=str: labels are caller-supplied and may carry
                # numpy scalars etc. — a trace dump must never raise
                json.dump(out, f, default=str)
        return out

    def stats(self) -> dict:
        with self._lock:
            n = len(self._ring)
            errs = sum(1 for t in self._ring if t.error is not None)
            misses = sum(1 for t in self._ring if t.deadline_miss)
        return {"retained": n, "errored": errs, "deadline_missed": misses,
                "sample": self.sample}


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide default :class:`Tracer` (serving and training
    share it)."""
    return _TRACER


def span(name: str, **labels):
    """Module-level ambient-span helper on the default tracer:
    ``with trace.span("checkpoint_enqueue"): ...`` annotates the current
    trace if one is ambient on this thread, else does nothing."""
    return _TRACER.span(name, **labels)


__all__ = ["NULL_TRACE", "Span", "Trace", "Tracer", "get_tracer", "span"]
