"""FCFS admission and request lifecycle over the paged engine (the port's
subset of ``chainermn_tpu/serving/scheduler.py``).

Requests move through ``QUEUED -> PREFILL -> DECODE -> DONE`` (or
``CANCELLED`` / ``ERRORED``). One :meth:`FCFSScheduler.step` is one engine
round: admit from the queue head (a group of same-bucket requests in one
prefill call, at most ``max_prefills_per_step`` calls), make sure every
decoding slot has the block its next write needs, decode every slot one
token, deliver tokens, and retire slots that hit EOS or their budget.

Block-budget admission: a request admits only if its worst-case block
growth fits ``free + evictable - reserved``; an unaffordable head goes
back to the queue head (FCFS kept). When the pool still runs dry before a
decode step, the newest request is preempted back to the queue; its
re-admission replays the same prompt and seed, so its token stream comes
out the same.

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
from chainermn_torch.serving.metrics import ServingMetrics


class QueueFullError(RuntimeError):
    """Submission rejected: the bounded admission queue is full."""


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    ERRORED = "errored"


class EngineFailed(RuntimeError):
    """Stored on requests that were in flight when the engine raised (the
    engine's exception is the ``__cause__``)."""


@dataclass(eq=False)
class Request:
    """One inference request and its lifecycle state, created by
    :meth:`FCFSScheduler.submit`. ``seed`` seeds the request's sampler
    generator at (every) admission. Compares by identity."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: int = 0
    stream_cb: Optional[Callable[[int], None]] = None
    id: int = -1
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    tokens: list = field(default_factory=list)
    error: Optional[BaseException] = None
    t_submit: float = 0.0
    t_last_token: float = 0.0
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
    """First-come-first-served continuous-batching scheduler.

    ``eos_id``: a request retires as soon as it samples this token (kept
    as its last token). ``max_queue`` bounds the queue (submit raises
    :class:`QueueFullError` beyond it). ``max_prefills_per_step`` bounds
    the prefill calls interleaved with each decode step."""

    def __init__(self, engine, *, eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None,
                 max_prefills_per_step: int = 1) -> None:
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_prefills_per_step < 1:
            raise ValueError(f"max_prefills_per_step must be >= 1, got "
                             f"{max_prefills_per_step}")
        self.engine = engine
        self.eos_id = eos_id
        self.metrics = metrics or ServingMetrics(engine.n_slots)
        self.max_queue = max_queue
        self._max_prefills = int(max_prefills_per_step)
        self._events = get_event_log()
        self._lock = threading.Lock()
        self._queue: deque[Request] = deque()
        self._by_slot: dict[int, Request] = {}
        self._ids = itertools.count()

    # ------------------------------------------------------------------ #
    # submission surface (any thread)                                     #
    # ------------------------------------------------------------------ #

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               stream_cb: Optional[Callable[[int], None]] = None
               ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.validate_request(len(prompt), max_new_tokens)
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      seed=int(seed), stream_cb=stream_cb)
        req.t_submit = time.perf_counter()
        with self._lock:
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self.metrics.record_rejected()
                self._events.emit("reject", prompt_len=len(prompt),
                                  queue_depth=len(self._queue))
                raise QueueFullError(
                    f"admission queue full ({self.max_queue} queued)")
            req.id = next(self._ids)
            self._queue.append(req)
            self.metrics.record_submit()
        self._events.emit("submit", req=req.id, prompt_len=len(prompt),
                          max_new=int(max_new_tokens))
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel: dequeued if QUEUED, slot freed if decoding. False if it
        already finished."""
        with self._lock:
            if req.finished:
                return False
            if req.state is RequestState.QUEUED:
                try:
                    self._queue.remove(req)
                except ValueError:
                    return False
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
            return bool(self._queue) or bool(self._by_slot)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------------ #
    # the scheduling loop (one driving thread)                            #
    # ------------------------------------------------------------------ #

    def step(self) -> int:
        """One continuous-batching round; returns tokens emitted. Freed
        slots refill before the decode step."""
        emitted = 0
        calls = 0
        while self.engine.free_slots and calls < self._max_prefills:
            group = self._next_group()
            if not group:
                break
            calls += 1
            emitted += self._admit_group(group)
        self._ensure_decode_blocks()
        try:
            decoded = self.engine.decode_step(
                ctx={"reqs": [r.id for r in list(self._by_slot.values())]})
        except Exception as e:
            self._fail_inflight(e)
            raise
        for slot, tok in decoded.items():
            req = self._by_slot.get(slot)
            if req is None or req.finished:
                continue                   # cancelled during the step
            now = time.perf_counter()
            self.metrics.record_token(req.t_last_token, now)
            self._deliver(req, tok, now)
            emitted += 1
        self.metrics.record_step(self.queue_depth, self.engine.active_slots)
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

    def _next_group(self) -> list:
        """Pop the next admission group: the queue head anchors it, then
        queued companions whose padded suffix lands in the same bucket
        join (those sharing the head's cached prefix first) while the
        block budget, ``prefill_batch`` and the free slots allow. Returns
        ``[(req, plan), ...]``; unselected candidates' plans are
        cancelled."""
        eng = self.engine
        cap = min(eng.prefill_batch, len(eng.free_slots))
        with self._lock:
            if not self._queue:
                return []
            head = self._queue.popleft()
            head.state = RequestState.PREFILL
        plan = eng.plan_admission(head.prompt, head.seed,
                                  max_new=head.max_new_tokens)
        budget = eng.kv_blocks_admittable()
        need = eng.blocks_needed(len(head.prompt), head.max_new_tokens,
                                 plan.start)
        if need > budget:
            self._defer_admission(head, plan, need, budget)
            return []
        budget -= need
        group = [(head, plan)]
        if cap <= 1:
            return group
        with self._lock:
            candidates = list(self._queue)
        scored = []
        for idx, req in enumerate(candidates):
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
            need = eng.blocks_needed(len(req.prompt), req.max_new_tokens,
                                     p.start)
            if rank < cap - 1 and need <= budget:
                with self._lock:
                    try:
                        self._queue.remove(req)   # lost a cancel() race?
                    except ValueError:
                        eng.cancel_plan(p)
                        continue
                    req.state = RequestState.PREFILL
                group.append((req, p))
                budget -= need
            else:
                eng.cancel_plan(p)
        return group

    def _defer_admission(self, req: Request, plan, need: int,
                         available: int) -> None:
        """The block budget cannot cover the head: put it back at the
        queue head until retirements return blocks."""
        self.engine.cancel_plan(plan)
        with self._lock:
            req.state = RequestState.QUEUED
            self._queue.appendleft(req)
        self._events.emit("kv_admit_defer", req=req.id, need=need,
                          available=available)

    def _admit_group(self, group: list) -> int:
        """One prefill call for the group, then commit each member.
        Returns first tokens emitted. A failed admission errors only the
        group's requests."""
        reqs = [r for r, _ in group]
        plans = [p for _, p in group]
        try:
            results = self.engine.admit_batch(
                plans, ctx={"reqs": [r.id for r in reqs]})
        except Exception as e:  # noqa: BLE001 — contain to this group
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
            self._events.emit("slot_admit", req=req.id, slot=slot,
                              prompt_len=len(req.prompt), bucket=plan.bucket,
                              cached=plan.start)
            self.metrics.record_first_token(req.t_submit, now, req_id=req.id,
                                            cached_frac=plan.cached_frac)
            self._deliver(req, first, now)
            emitted += 1
        return emitted

    def _fail(self, reqs: list, e: BaseException, where: str) -> None:
        """Error ``reqs`` terminally with :class:`EngineFailed` (``wait()``
        re-raises), freeing any slot they hold."""
        with self._lock:
            for req in reqs:
                if req.finished:
                    continue
                if req.slot >= 0:
                    self._by_slot.pop(req.slot, None)
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

    def _fail_inflight(self, e: BaseException) -> None:
        """The decode step raised: every decoding request errors loudly
        (no waiter hangs on a dead engine); the caller re-raises."""
        with self._lock:
            victims = list(self._by_slot.values())
        self._fail(victims, e, "decode")
        self._events.dump(file=sys.stderr, last=32)

    # ------------------------------------------------------------------ #
    # paged-KV block management                                           #
    # ------------------------------------------------------------------ #

    def _ensure_decode_blocks(self) -> None:
        """Before a decode step, append a block for every slot whose next
        write crosses into an unallocated block. When the pool is dry even
        after trie eviction, preempt the newest request (highest id) back
        to the queue and retry."""
        eng = self.engine
        for slot in sorted(self._by_slot):
            req = self._by_slot.get(slot)
            if req is None:
                continue
            while eng.slot_needs_block(slot):
                if eng.append_block(slot):
                    continue
                victim = max(self._by_slot.values(), key=lambda r: r.id)
                self._preempt(victim)
                if victim is req:
                    break

    def _preempt(self, req: Request) -> None:
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
        self.metrics.record_preemption()
        self._events.emit("kv_preempt", req=req.id,
                          queue_depth=self.queue_depth)

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
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self._retire(req, "eos" if hit_eos else "length")

    def _retire(self, req: Request, reason: str) -> None:
        with self._lock:
            if req.finished:   # a concurrent cancel() won the race
                return
            self.metrics.record_request_blocks(
                self.engine.slot_block_count(req.slot))
            self.engine.release(req.slot)
            self._by_slot.pop(req.slot, None)
            req.state = RequestState.DONE
            self.metrics.record_done()
        self._events.emit("slot_retire", req=req.id, slot=req.slot,
                          reason=reason, tokens=len(req.tokens))
        req._done.set()


__all__ = ["EngineFailed", "FCFSScheduler", "QueueFullError", "Request",
           "RequestState"]
