"""Admission and request lifecycle over the serving engine (the port's
subset of ``chainermn_tpu/serving/scheduler.py``).

Requests move through ``QUEUED -> PREFILL -> DECODE -> DONE`` (or
``CANCELLED`` / ``ERRORED``); a chunked admission passes through
``PREFILLING``. One :meth:`FCFSScheduler.step` is one engine round: shed
requests past their deadline, let the brownout policy observe the queue,
admit from the queue (a group of same-bucket requests in one prefill
call, at most ``max_prefills_per_step`` calls), advance the oldest
chunked prefill by one chunk, make sure every decoding slot has the
blocks its next round writes, run one decode round (one token, a decode
window, or a verify window), deliver tokens, and retire slots that hit
EOS or their budget — mid-window, dropping the window's tail.

- **Admission order**: FIFO by default. ``fair=True`` (or
  ``tenant_weights``) picks the head by class order and weighted DRR
  (:class:`~chainermn_torch.serving.fairness.FairAdmission`); brownout L1
  holds the ``batch`` class back either way.
- **Block-budget admission** (paged): a request admits only if its
  worst-case block growth fits ``free + evictable - reserved``; an
  unaffordable head goes back to the queue head. When the pool still runs
  dry before a decode round, the request that sorts last by
  :meth:`FCFSScheduler._preempt_key` (batch first, then the tenant most
  over its share, then the newest) goes back to the queue; its
  re-admission replays the same prompt and seed, so its token stream
  comes out the same.
- **Chunked prefill** (paged, ``chunk_tokens_per_step=N``): a prompt
  whose suffix exceeds ``N`` tokens is staged on a slot and prefilled one
  chunk a step, interleaved with decode rounds.
- **Deadlines**: a request past ``deadline_s`` (or the scheduler's
  ``default_deadline_s``) is shed at a step boundary — queued, decoding
  or mid-chunk — with :class:`DeadlineExceededError` stored.
- **Brownout** (:class:`~chainermn_torch.serving.fairness.
  BrownoutPolicy`): L2 runs the single-token decode step instead of a
  window, L3 caps the tokens a request gets (a prefix of its stream), L4
  sheds the lowest-weight tenant's queued work.
- **Engine failure** (the reference's degradation boundary): a decode
  round that raises fails every in-flight, chunking and admitting request
  with :class:`EngineFailed`, dumps the event log once, and warm-restarts
  the engine (:meth:`ServingEngine.restart`, the same programs) within
  ``max_restarts``; ``restart_on_error=False`` or a spent budget
  re-raises. A failed admission or chunk errors only its own requests
  (the stores are written in place, so nothing else is lost) unless it
  raised :class:`~chainermn_torch.serving.engine.EngineStateError`;
  ``retry=`` (a :class:`~chainermn_torch.resilience.retry.RetryPolicy`)
  retries an admission's prefill first.
- **Weight swap fence** (:meth:`FCFSScheduler.request_swap`): while a swap
  is pending nothing is admitted; once the slots drain, the swap runs
  between device calls, and every request records the
  ``weight_version`` it was admitted on.

``submit``/``cancel`` are safe from any thread; ``step`` is driven from
one thread (the engine is not concurrent).
"""

from __future__ import annotations

import enum
import itertools
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np

from chainermn_torch.monitor import get_event_log
from chainermn_torch.resilience.cutpoints import SERVING_ADMIT_FAIR
from chainermn_torch.resilience.faults import inject
from chainermn_torch.resilience.retry import RetryPolicy
from chainermn_torch.serving.engine import EngineStateError
from chainermn_torch.serving.fairness import (
    PRIORITY_CLASSES,
    BrownoutPolicy,
    FairAdmission,
)
from chainermn_torch.serving.metrics import ServingMetrics


class QueueFullError(RuntimeError):
    """Submission rejected: the bounded admission queue is full (or the
    request was shed by brownout L4). ``retry_after_s`` is the
    backpressure hint a client should wait before retrying."""

    def __init__(self, msg: str = "", *,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """The request passed its deadline (queued, decoding or mid-chunk)
    and was shed; carries the same ``retry_after_s`` hint."""

    def __init__(self, msg: str = "", *,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    PREFILLING = "prefilling"   # chunked prefill in progress (owns a slot)
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    ERRORED = "errored"


class EngineFailed(RuntimeError):
    """Stored on requests that were in flight when the engine raised (the
    engine's exception is the ``__cause__``)."""


class SwapTicket:
    """One pending weight swap (:meth:`FCFSScheduler.request_swap`).
    ``wait()`` blocks until the driving thread ran (or failed) it;
    ``result`` holds the swap function's return value, ``error`` its
    exception: a rejected swap leaves the engine on its prior weights
    (:meth:`ServingEngine.swap_params` checks before writing), so the
    ticket is where the failure shows."""

    def __init__(self, fn: Callable[[], object]) -> None:
        self.fn = fn
        self.result: object = None
        self.error: Optional[BaseException] = None
        self.t_request = time.perf_counter()
        self.t_executed: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the swap ran; re-raises its exception. True when it
        ran within ``timeout``."""
        ok = self._done.wait(timeout)
        if self.error is not None:
            raise self.error
        return ok

    @property
    def fence_s(self) -> Optional[float]:
        """Seconds from the request to the swap's execution."""
        if self.t_executed is None:
            return None
        return self.t_executed - self.t_request


@dataclass(eq=False)
class Request:
    """One inference request and its lifecycle state, created by
    :meth:`FCFSScheduler.submit`. ``seed`` seeds the request's sampler
    generator at (every) admission; ``tenant`` keys fair admission and
    brownout sheds; ``priority`` is its class (``interactive`` admits
    first and is preempted last, ``batch`` waits). Compares by identity
    (fair admission removes requests from the middle of the queue)."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: int = 0
    stream_cb: Optional[Callable[[int], None]] = None
    tenant: str = "default"
    priority: str = "interactive"
    id: int = -1
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    tokens: list = field(default_factory=list)
    error: Optional[BaseException] = None
    deadline_s: Optional[float] = None
    t_submit: float = 0.0
    t_deadline: Optional[float] = None
    t_last_token: float = 0.0
    weight_version: Optional[int] = None    # stamped at admission
    _done: threading.Event = field(default_factory=threading.Event)

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.ERRORED)

    @property
    def output(self) -> np.ndarray:
        """``prompt + generated`` tokens; an ERRORED request re-raises."""
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until finished; True if it finished. Re-raises the stored
        exception of an ERRORED request."""
        ok = self._done.wait(timeout)
        if self.error is not None:
            raise self.error
        return ok

    def stream(self, poll_s: float = 0.01) -> Iterator[int]:
        """Yield generated tokens as they arrive; re-raises at the end for
        an ERRORED request."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self._done.is_set():
                while i < len(self.tokens):
                    yield self.tokens[i]
                    i += 1
                if self.error is not None:
                    raise self.error
                return
            self._done.wait(poll_s)


class FCFSScheduler:
    """Continuous-batching scheduler (FIFO by default).

    ``eos_id``: a request retires as soon as it samples this token (kept
    as its last token). ``max_queue`` bounds the queue (submit raises
    :class:`QueueFullError` beyond it). ``max_prefills_per_step`` bounds
    the prefill calls before each decode round: 1 when the engine batches
    prefills, has several buckets or a prefix cache, unbounded otherwise.
    ``default_deadline_s`` applies to requests submitted without one.
    ``fair``/``tenant_weights``, ``brownout`` and
    ``chunk_tokens_per_step`` are the policies of the module docstring
    (``fair`` may also be a :class:`FairAdmission` to share or inspect).
    ``retry``, ``restart_on_error`` and ``max_restarts`` are its failure
    handling.
    """

    def __init__(self, engine, *, eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 max_prefills_per_step: Optional[int] = None,
                 fair=None, tenant_weights=None,
                 brownout: Optional[BrownoutPolicy] = None,
                 chunk_tokens_per_step: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 restart_on_error: bool = True,
                 max_restarts: int = 8) -> None:
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_prefills_per_step is not None and max_prefills_per_step < 1:
            raise ValueError(f"max_prefills_per_step must be >= 1, got "
                             f"{max_prefills_per_step}")
        if chunk_tokens_per_step is not None and chunk_tokens_per_step < 1:
            raise ValueError(f"chunk_tokens_per_step must be >= 1, got "
                             f"{chunk_tokens_per_step}")
        self.engine = engine
        self.eos_id = eos_id
        self.metrics = metrics or ServingMetrics(engine.n_slots)
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self._retry = retry
        self._restart_on_error = bool(restart_on_error)
        self._max_restarts = int(max_restarts)
        self._restarts = 0
        self._pending_swap: Optional[SwapTicket] = None
        if max_prefills_per_step is None and (
                engine.prefill_batch > 1 or len(engine.prefill_buckets) > 1
                or engine.prefix_enabled):
            max_prefills_per_step = 1
        self._max_prefills = max_prefills_per_step
        if fair is None:
            fair = tenant_weights is not None
        if isinstance(fair, FairAdmission):
            self._fair: Optional[FairAdmission] = fair
        elif fair:
            self._fair = FairAdmission(tenant_weights=tenant_weights)
        else:
            self._fair = None
        self._brownout = brownout
        self._chunk_tokens = (int(chunk_tokens_per_step)
                              if chunk_tokens_per_step is not None else None)
        self._events = get_event_log()
        self._lock = threading.Lock()
        self._queue: deque[Request] = deque()
        self._by_slot: dict[int, Request] = {}
        # slot -> request mid-chunked-prefill (disjoint from _by_slot: it
        # takes no decode token and appends no block)
        self._prefilling: dict[int, Request] = {}
        self._ids = itertools.count()

    # ------------------------------------------------------------------ #
    # submission surface (any thread)                                     #
    # ------------------------------------------------------------------ #

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               stream_cb: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None, tenant: str = "default",
               priority: str = "interactive") -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.validate_request(len(prompt), max_new_tokens)
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority must be one of {PRIORITY_CLASSES}, "
                             f"got {priority!r}")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      seed=int(seed), stream_cb=stream_cb,
                      tenant=str(tenant), priority=str(priority),
                      deadline_s=deadline_s)
        req.t_submit = time.perf_counter()
        if deadline_s is not None:
            req.t_deadline = req.t_submit + float(deadline_s)
        with self._lock:
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self.metrics.record_rejected()
                self._events.emit("reject", prompt_len=len(prompt),
                                  queue_depth=len(self._queue))
                raise QueueFullError(
                    f"admission queue full ({self.max_queue} queued)",
                    retry_after_s=self._retry_after_locked())
            req.id = next(self._ids)
            self._queue.append(req)
            self.metrics.record_submit()
        self._events.emit("submit", req=req.id, prompt_len=len(prompt),
                          max_new=int(max_new_tokens), tenant=req.tenant,
                          priority=req.priority)
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel: dequeued if QUEUED, slot freed if decoding; a chunked
        prefill's slot is released by the driving thread at its next
        chunk. False if it already finished."""
        with self._lock:
            if req.finished:
                return False
            if req.state is RequestState.QUEUED:
                try:
                    self._queue.remove(req)
                except ValueError:
                    return False
            elif req.state is RequestState.PREFILLING:
                pass   # the driving thread owns the staged chunk state
            elif req.slot >= 0:
                self.engine.release(req.slot)
                self._by_slot.pop(req.slot, None)
            # else: prefill in flight — the admission path releases the slot
            req.state = RequestState.CANCELLED
            self.metrics.record_done(cancelled=True)
        self._events.emit("slot_retire", req=req.id, slot=req.slot,
                          reason="cancelled")
        req._done.set()
        return True

    @property
    def has_work(self) -> bool:
        with self._lock:
            return (bool(self._queue) or bool(self._by_slot)
                    or bool(self._prefilling)
                    or self._pending_swap is not None)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def engine_restarts(self) -> int:
        """Warm restarts this scheduler has driven."""
        return self._restarts

    # ------------------------------------------------------------------ #
    # supervisor surface                                                  #
    # ------------------------------------------------------------------ #

    def drain_queued(self) -> list:
        """Remove and return every QUEUED request (they stay QUEUED; the
        caller owns them now), for a supervisor that re-routes work away
        from a failed engine. The reference's KV-import queue and traces
        are not ported (ROADMAP.md items 11.5 and 13)."""
        with self._lock:
            drained = list(self._queue)
            self._queue.clear()
        return drained

    def fail_inflight(self, e: BaseException) -> None:
        """Fail every in-flight request loudly (ERRORED, ``wait()``
        re-raises) without restarting the engine: the caller owns that
        decision. A pending swap ticket fails too, so its waiter hears of
        the death. Requests already errored are left as they are."""
        with self._lock:
            has_inflight = bool(self._by_slot) or bool(self._prefilling)
            ticket, self._pending_swap = self._pending_swap, None
        if ticket is not None:
            ticket.error = EngineFailed(
                "engine failed while a weight swap was fenced")
            ticket.error.__cause__ = e
            ticket.t_executed = time.perf_counter()
            ticket._done.set()
        if has_inflight:
            restart, self._restart_on_error = self._restart_on_error, False
            try:
                self._engine_failure(e)
            finally:
                self._restart_on_error = restart

    def request_swap(self, fn: Callable[[], object]) -> SwapTicket:
        """Queue a weight swap (``fn``, typically ``lambda:
        engine.swap_params(state)``) for the driving thread's next safe
        point; thread-safe. While it is pending nothing is admitted, so
        every in-flight request finishes on the weights it started with;
        once the slots drain, ``fn`` runs between device calls and the
        queue admits on the new weights. One swap may be pending at a
        time."""
        ticket = SwapTicket(fn)
        with self._lock:
            if self._pending_swap is not None:
                raise RuntimeError(
                    "a weight swap is already pending on this scheduler")
            self._pending_swap = ticket
        self._events.emit("swap_fence", queue_depth=self.queue_depth)
        return ticket

    # ------------------------------------------------------------------ #
    # the scheduling loop (one driving thread)                            #
    # ------------------------------------------------------------------ #

    def step(self) -> int:
        """One continuous-batching round; returns tokens emitted. Freed
        slots refill before the decode round."""
        emitted = 0
        self._shed_expired()
        self._policy_tick()
        # the version fence: no admission while a swap is pending; once
        # the slots drain it runs here, between device calls
        with self._lock:
            swapping = self._pending_swap is not None
            ticket = None
            if swapping and not self._by_slot and not self._prefilling:
                ticket, self._pending_swap = self._pending_swap, None
                swapping = False
        if ticket is not None:
            self._execute_swap(ticket)
        calls = 0
        while not swapping and self.engine.free_slots and (
                self._max_prefills is None or calls < self._max_prefills):
            group = self._next_group()
            if not group:
                break
            calls += 1
            emitted += self._admit_group(group)
        emitted += self._advance_chunks()
        if self.engine.paged:
            self._ensure_decode_blocks()
        # brownout L2: the single-token step instead of a window
        force_single = (self._brownout is not None
                        and self._brownout.force_single_token)
        ctx = {"reqs": [r.id for r in list(self._by_slot.values())]}
        try:
            if force_single:
                decoded = {slot: [tok] for slot, tok in
                           self.engine.decode_step(ctx=ctx).items()}
            else:
                decoded = self.engine.decode_round(ctx=ctx)
        except Exception as e:  # noqa: BLE001 — the degradation boundary
            if not self._engine_failure(e):
                raise
            decoded = {}
        for slot, toks in decoded.items():
            for tok in toks:
                # re-read per token: EOS or budget can retire the slot
                # mid-window, and the rest of the window is dropped
                req = self._by_slot.get(slot)
                if req is None or req.finished:
                    break
                now = time.perf_counter()
                self.metrics.record_token(req.t_last_token, now)
                self._deliver(req, tok, now)
                emitted += 1
        if self.engine.spec_enabled and not force_single:
            window = self.engine.pop_spec_window()
            if window is not None:
                self.metrics.record_spec_window(*window)
        # dense prefix inserts: after the tokens are out, before a donor
        # slot can be reused
        self.engine.flush_inserts()
        with self._lock:
            depth = len(self._queue)
            batch_depth = sum(1 for r in self._queue
                              if r.priority == "batch")
        self.metrics.record_step(depth, self.engine.active_slots,
                                 batch_depth=batch_depth)
        if self.engine.paged:
            self.metrics.record_kv_pool(*self.engine.kv_pool_stats())
        return emitted

    def run_until_idle(self, max_steps: Optional[int] = None) -> int:
        """Drive :meth:`step` until queue and slots drain; returns tokens
        emitted."""
        total = steps = 0
        while self.has_work:
            total += self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return total

    # ------------------------------------------------------------------ #
    # admission internals                                                 #
    # ------------------------------------------------------------------ #

    def _pop_head_locked(self) -> Optional[Request]:
        """Pick and remove the next admission candidate (lock held): FIFO,
        or the fair policy's pick; brownout L1 holds ``batch`` back."""
        if not self._queue:
            return None
        allow_batch = not (self._brownout is not None
                           and self._brownout.pause_batch)
        if self._fair is not None:
            head = self._fair.select(self._queue, allow_batch=allow_batch)
            if head is None:
                return None
            self._queue.remove(head)
        elif allow_batch:
            head = self._queue.popleft()
        else:
            head = next((r for r in self._queue if r.priority != "batch"),
                        None)
            if head is None:
                return None
            self._queue.remove(head)
        head.state = RequestState.PREFILL
        return head

    def _next_group(self) -> list:
        """Pop the next admission group: the picked head anchors it, then
        queued companions of the same class whose padded suffix lands in
        the same bucket join (those sharing the head's cached prefix
        first) while the block budget, ``prefill_batch`` and the free
        slots allow. A long head may instead begin a chunked prefill.
        Returns ``[(req, plan), ...]``; unselected candidates' plans are
        cancelled."""
        eng = self.engine
        paged = eng.paged
        cap = min(eng.prefill_batch, len(eng.free_slots))
        with self._lock:
            head = self._pop_head_locked()
        if head is None:
            return []
        try:
            inject(SERVING_ADMIT_FAIR, req=head.id, tenant=head.tenant,
                   priority=head.priority)
        except Exception as e:  # noqa: BLE001 — fail only the picked one
            self._fail([head], e, "admission")
            return []
        plan = eng.plan_admission(head.prompt, head.seed,
                                  max_new=head.max_new_tokens)
        budget = None
        if paged:
            budget = eng.kv_blocks_admittable()
            need = eng.blocks_needed(len(head.prompt), head.max_new_tokens,
                                     plan.start)
            if need > budget:
                self._defer_admission(head, plan, need, budget)
                return []
            budget -= need
        if (self._chunk_tokens is not None
                and len(head.prompt) - plan.start > self._chunk_tokens):
            chunks = eng.plan_chunks(plan, self._chunk_tokens)
            if chunks is not None:
                self._begin_chunked(head, plan, chunks)
                return []
        group = [(head, plan)]
        if cap <= 1:
            return group
        with self._lock:
            candidates = list(self._queue)
        scored = []
        for idx, req in enumerate(candidates):
            if req.priority != head.priority:
                continue   # a batch request must not ride an interactive group
            p = eng.plan_admission(req.prompt, req.seed,
                                   max_new=req.max_new_tokens)
            if p.bucket != plan.bucket:
                eng.cancel_plan(p)
                continue
            shares = (plan.match is not None and p.match is not None
                      and p.match.nodes[0] is plan.match.nodes[0])
            scored.append((0 if shares else 1, idx, req, p))
        scored.sort(key=lambda t: (t[0], t[1]))
        for rank, (_, _, req, p) in enumerate(scored):
            need = (eng.blocks_needed(len(req.prompt), req.max_new_tokens,
                                      p.start) if paged else 0)
            if rank < cap - 1 and (budget is None or need <= budget):
                with self._lock:
                    try:
                        self._queue.remove(req)   # lost a cancel() race?
                    except ValueError:
                        eng.cancel_plan(p)
                        continue
                    req.state = RequestState.PREFILL
                group.append((req, p))
                if budget is not None:
                    budget -= need
            else:
                eng.cancel_plan(p)
        return group

    def _requeue_head(self, req: Request) -> None:
        with self._lock:
            req.state = RequestState.QUEUED
            self._queue.appendleft(req)

    def _defer_admission(self, req: Request, plan, need: int,
                         available: int) -> None:
        """The block budget cannot cover the head: put it back at the
        queue head until retirements return blocks."""
        self.engine.cancel_plan(plan)
        self._requeue_head(req)
        self._events.emit("kv_admit_defer", req=req.id, need=need,
                          available=available)

    def _admit_group(self, group: list) -> int:
        """One prefill call for the group, then commit each member.
        Returns first tokens emitted. A failed admission errors only the
        group's requests."""
        reqs = [r for r, _ in group]
        plans = [p for _, p in group]
        ctx = {"reqs": [r.id for r in reqs]}
        try:
            if self._retry is not None:
                results = self._retry.call(self.engine.admit_batch, plans,
                                           op="serving.prefill_batch",
                                           ctx=ctx)
            else:
                results = self.engine.admit_batch(plans, ctx=ctx)
        except Exception as e:  # noqa: BLE001 — contain to this group
            if isinstance(e, EngineStateError):
                if not self._engine_failure(e, admitting=reqs):
                    raise
            else:
                self._fail(reqs, e, "admission")
            return 0
        self.metrics.record_admission(len(group))
        emitted = 0
        for (req, plan), (slot, first) in zip(group, results):
            now = time.perf_counter()
            with self._lock:
                if req.state is RequestState.CANCELLED:
                    self.engine.release(slot)
                    continue
                req.slot = slot
                self._by_slot[slot] = req
                req.state = RequestState.DECODE
                # the fence keeps this version until the request retires
                req.weight_version = self.engine.weight_version
            self._events.emit("slot_admit", req=req.id, slot=slot,
                              prompt_len=len(req.prompt), bucket=plan.bucket,
                              cached=plan.start, tenant=req.tenant,
                              priority=req.priority)
            self.metrics.record_first_token(req.t_submit, now, req_id=req.id,
                                            cached_frac=plan.cached_frac)
            self._deliver(req, first, now)
            emitted += 1
        return emitted

    # ------------------------------------------------------------------ #
    # chunked prefill                                                     #
    # ------------------------------------------------------------------ #

    def _begin_chunked(self, req: Request, plan, chunks: list) -> None:
        """Stage ``req`` as a chunked admission (the engine claims a slot
        and its blocks); :meth:`_advance_chunks` runs one chunk a step. A
        staging failure puts the request back at the queue head."""
        eng = self.engine
        try:
            slot = eng.begin_chunked(plan, chunks)
        except Exception as e:  # noqa: BLE001 — retry next step
            self._requeue_head(req)
            self._events.emit("kv_admit_defer", req=req.id,
                              error=type(e).__name__)
            return
        with self._lock:
            if req.state is RequestState.CANCELLED:
                eng.release(slot)
                return
            req.state = RequestState.PREFILLING
            req.slot = slot
            self._prefilling[slot] = req
        self._events.emit("slot_admit", req=req.id, slot=slot,
                          prompt_len=len(req.prompt), bucket=chunks[0][2],
                          cached=plan.start, chunks=len(chunks),
                          tenant=req.tenant, priority=req.priority)

    def _advance_chunks(self) -> int:
        """Advance the oldest PREFILLING request by one chunk. The final
        chunk commits the slot, records TTFT and delivers the first token.
        A failed chunk errors that request alone: the engine's stores are
        written in place, so nothing else is lost. Returns first tokens
        emitted (0 or 1)."""
        with self._lock:
            if not self._prefilling:
                return 0
            slot, req = min(self._prefilling.items(),
                            key=lambda kv: kv[1].id)
        if req.finished:
            # cancelled mid-chunk: cancel() left the release to this thread
            with self._lock:
                self._prefilling.pop(slot, None)
            self.engine.release(slot)
            return 0
        st = self.engine.chunk_state(slot)
        try:
            first = self.engine.prefill_chunk(slot, ctx={"reqs": [req.id]})
        except Exception as e:  # noqa: BLE001 — contain to this request
            if isinstance(e, EngineStateError):
                if not self._engine_failure(e):
                    raise
                return 0
            with self._lock:
                self._prefilling.pop(slot, None)
            self._fail([req], e, "chunk_prefill")
            return 0
        if first is None:
            return 0
        with self._lock:
            self._prefilling.pop(slot, None)
            if req.state is RequestState.CANCELLED:
                self.engine.release(slot)
                return 0
            req.state = RequestState.DECODE
            req.weight_version = self.engine.weight_version
            self._by_slot[slot] = req
        now = time.perf_counter()
        self.metrics.record_first_token(
            req.t_submit, now, req_id=req.id,
            cached_frac=st.start / len(st.prompt))
        self._deliver(req, first, now)
        return 1

    # ------------------------------------------------------------------ #
    # failures                                                            #
    # ------------------------------------------------------------------ #

    def _fail(self, reqs: list, e: BaseException, where: str) -> None:
        """Error ``reqs`` terminally with :class:`EngineFailed` (``wait()``
        re-raises), freeing any slot they hold."""
        with self._lock:
            for req in reqs:
                if req.finished:
                    continue
                if req.slot >= 0:
                    self._by_slot.pop(req.slot, None)
                    self._prefilling.pop(req.slot, None)
                    self.engine.release(req.slot)
                failure = EngineFailed(
                    f"{where} failed for request {req.id}: "
                    f"{type(e).__name__}: {e}")
                failure.__cause__ = e
                req.error = failure
                req.state = RequestState.ERRORED
                self.metrics.record_errored()
        self._events.emit("engine_error", where=where,
                          error=type(e).__name__, detail=str(e)[:200],
                          reqs=[r.id for r in reqs])
        for req in reqs:
            req._done.set()

    def _engine_failure(self, e: BaseException, admitting=()) -> bool:
        """The engine raised mid-round: every decoding, chunking and
        ``admitting`` request errors loudly with :class:`EngineFailed`
        (no waiter hangs on a dead engine), the event log is dumped once
        for the episode, and within the restart budget the engine warm-
        restarts (fresh stores, tables, trie and mirrors; the same
        programs) so the queue keeps being served. Returns True after a
        restart; False tells the caller to re-raise."""
        with self._lock:
            victims = (list(self._by_slot.values())
                       + list(self._prefilling.values()) + list(admitting))
            self._by_slot.clear()
            self._prefilling.clear()
            for req in victims:
                if req.slot >= 0:       # the stores are intact: free it
                    self.engine.release(req.slot)
                if req.finished:
                    continue
                if req.error is None:
                    failure = EngineFailed(
                        f"engine failed while request {req.id} was in "
                        f"flight: {type(e).__name__}: {e}")
                    failure.__cause__ = e
                    req.error = failure
                req.state = RequestState.ERRORED
                self.metrics.record_errored()
        self._events.emit("engine_error", where="decode",
                          error=type(e).__name__, detail=str(e)[:200],
                          reqs=[r.id for r in victims])
        self._events.dump(file=sys.stderr, last=32, once="engine_failure")
        for req in victims:
            req._done.set()
        if not self._restart_on_error or \
                self._restarts >= self._max_restarts:
            return False
        self.engine.restart()
        self._restarts += 1
        self.metrics.record_restart()
        self._events.emit("engine_restart", restarts=self._restarts)
        self._events.reset_dump_guard()    # recovered: the next one dumps
        return True

    def _execute_swap(self, ticket: SwapTicket) -> None:
        """Run a fenced swap on the driving thread (the slots drained). A
        raising swap shows only on the ticket: the engine keeps its prior
        weights and the queue keeps being served."""
        t0 = time.perf_counter()
        try:
            ticket.result = ticket.fn()
        except Exception as e:  # noqa: BLE001 — surfaced on the ticket
            ticket.error = e
        ticket.t_executed = time.perf_counter()
        self._events.emit(
            "swap_exec", ok=ticket.error is None,
            seconds=round(ticket.t_executed - t0, 6),
            fence_s=round(ticket.t_executed - ticket.t_request, 6),
            queue_depth=self.queue_depth,
            **({"error": type(ticket.error).__name__}
               if ticket.error is not None else {}))
        ticket._done.set()

    # ------------------------------------------------------------------ #
    # paged-KV block management                                           #
    # ------------------------------------------------------------------ #

    def _ensure_decode_blocks(self) -> None:
        """Before a paged decode round, append blocks for every slot whose
        round writes past its allocated span (a verify or decode window
        may need more than one). When the pool is dry even after trie
        eviction, preempt the request :meth:`_preempt_key` sorts last and
        retry; an injected ``serving.kv_append`` fault preempts only that
        slot's request."""
        eng = self.engine
        for slot in sorted(self._by_slot):
            req = self._by_slot.get(slot)
            if req is None:
                continue
            while eng.slot_needs_block(slot):
                try:
                    appended = eng.append_block(slot)
                except Exception as e:  # noqa: BLE001 — contain to slot
                    self._preempt(req, reason=f"kv_append_"
                                              f"{type(e).__name__}")
                    break
                if appended:
                    continue
                victim = max(self._by_slot.values(), key=self._preempt_key)
                self._preempt(victim, reason="kv_pool_dry")
                if victim is req:
                    break

    def _preempt_key(self, req: Request) -> tuple:
        """Victim order when blocks run dry (max is evicted first):
        ``batch`` before ``interactive``, then the tenant with the largest
        measured device-second share, then the newest (highest id)."""
        share = (self._fair.tenant_share(req.tenant)
                 if self._fair is not None else 0.0)
        return (req.priority == "batch", share, req.id)

    def _preempt(self, req: Request, reason: str) -> None:
        """Evict a decoding request back to QUEUED: slot and blocks free
        now, generated tokens are discarded, and it re-enters the queue in
        submission order to replay from its prompt and seed."""
        with self._lock:
            if req.finished:
                return
            if req.slot >= 0:
                self.engine.release(req.slot)
                self._by_slot.pop(req.slot, None)
            req.slot = -1
            req.tokens = []
            req.state = RequestState.QUEUED
            idx = next((i for i, q in enumerate(self._queue)
                        if q.id > req.id), len(self._queue))
            self._queue.insert(idx, req)
        self.metrics.record_preemption(priority=req.priority)
        self._events.emit("kv_preempt", req=req.id, reason=reason,
                          priority=req.priority, tenant=req.tenant,
                          queue_depth=self.queue_depth)

    # ------------------------------------------------------------------ #
    # overload policies                                                   #
    # ------------------------------------------------------------------ #

    def _shed_expired(self) -> None:
        """Error every request past its deadline with
        :class:`DeadlineExceededError`: queued ones leave the queue, and a
        decoding or chunking one is retired here, between engine calls,
        with its slot and blocks freed (the other slots' streams are
        untouched)."""
        now = time.perf_counter()
        shed: list[tuple[Request, str]] = []
        with self._lock:
            if not (self._queue or self._by_slot or self._prefilling):
                return
            hint = self._retry_after_locked()

            def expire(req, where, msg):
                req.error = DeadlineExceededError(msg, retry_after_s=hint)
                req.state = RequestState.ERRORED
                self.metrics.record_shed()
                shed.append((req, where))

            def late(req):
                return req.t_deadline is not None and now >= req.t_deadline

            keep: deque[Request] = deque()
            for req in self._queue:
                if late(req):
                    expire(req, "queue",
                           f"request {req.id} spent its {req.deadline_s}s "
                           "deadline in the admission queue")
                else:
                    keep.append(req)
            self._queue = keep
            for where, table in (("decode", self._by_slot),
                                 ("prefill", self._prefilling)):
                for slot in sorted(table):
                    req = table[slot]
                    if not late(req):
                        continue
                    self.engine.release(slot)
                    table.pop(slot)
                    expire(req, where,
                           f"request {req.id} passed its {req.deadline_s}s "
                           f"deadline after {len(req.tokens)} decoded "
                           f"token(s)" if where == "decode" else
                           f"request {req.id} passed its {req.deadline_s}s "
                           "deadline mid chunked prefill")
        for req, where in shed:
            self._events.emit("shed", req=req.id, where=where,
                              waited_s=now - req.t_submit)
            req._done.set()

    def _retry_after_locked(self) -> float:
        """Backpressure hint on rejections and sheds: grows with the
        queue depth."""
        return round(0.05 + 0.01 * len(self._queue), 3)

    def _policy_tick(self) -> None:
        """Once a step, before admissions: a self-driving brownout policy
        observes the interactive queue depth (a paused batch backlog must
        not hold the ladder up), and L4 sheds."""
        bo = self._brownout
        if bo is None:
            return
        with self._lock:
            depth = sum(1 for r in self._queue if r.priority != "batch")
        bo.auto_observe(depth)
        if bo.shed_lowest:
            self._brownout_shed()

    def _brownout_shed(self) -> None:
        """Brownout L4: error the lowest-effective-weight tenant's QUEUED
        requests with :class:`QueueFullError` and a Retry-After hint;
        in-flight work is never touched."""
        with self._lock:
            tenants = sorted({r.tenant for r in self._queue})
        if not tenants:
            return
        victim = (self._fair.lowest_weight_tenant(tenants)
                  if self._fair is not None else tenants[0])
        dropped: list[Request] = []
        with self._lock:
            hint = round(max(self._retry_after_locked(),
                             float(self._brownout.down_after_s)), 3)
            keep: deque[Request] = deque()
            for req in self._queue:
                if req.tenant == victim:
                    req.error = QueueFullError(
                        f"request {req.id} shed by brownout L4 "
                        f"(tenant {victim})", retry_after_s=hint)
                    req.state = RequestState.ERRORED
                    self.metrics.record_shed()
                    dropped.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in dropped:
            self.metrics.record_tenant_shed(req.tenant)
            self._events.emit("shed", req=req.id, where="brownout",
                              tenant=req.tenant,
                              retry_after_s=req.error.retry_after_s)
            req._done.set()

    # ------------------------------------------------------------------ #
    # delivery and retirement                                             #
    # ------------------------------------------------------------------ #

    def _deliver(self, req: Request, tok: int, now: float) -> None:
        req.tokens.append(int(tok))
        req.t_last_token = now
        if req.stream_cb is not None:
            try:
                req.stream_cb(int(tok))
            except Exception:  # noqa: BLE001 — a consumer must not kill
                pass           # the engine loop
        hit_eos = self.eos_id is not None and int(tok) == self.eos_id
        # brownout L3: a tighter budget gives a prefix of the stream
        limit = req.max_new_tokens
        if self._brownout is not None:
            cap = self._brownout.effective_max_new_cap
            if cap is not None:
                limit = min(limit, cap)
        if hit_eos or len(req.tokens) >= limit:
            self._retire(req, "eos" if hit_eos else "length")

    def _retire(self, req: Request, reason: str) -> None:
        with self._lock:
            if req.finished:   # a concurrent cancel() won the race
                return
            if self.engine.paged:
                self.metrics.record_request_blocks(
                    self.engine.slot_block_count(req.slot))
            self.engine.release(req.slot)
            self._by_slot.pop(req.slot, None)
            req.state = RequestState.DONE
            self.metrics.record_done()
        self._events.emit("slot_retire", req=req.id, slot=req.slot,
                          reason=reason, tokens=len(req.tokens))
        req._done.set()


__all__ = ["DeadlineExceededError", "EngineFailed", "FCFSScheduler",
           "QueueFullError", "Request", "RequestState", "SwapTicket"]
