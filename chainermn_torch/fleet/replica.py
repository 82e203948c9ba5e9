"""One serving replica: an engine and its scheduler on their own
thread, under a supervisor (the port's copy of
``chainermn_tpu/fleet/replica.py``).

The replica's :class:`~chainermn_torch.serving.scheduler.FCFSScheduler`
runs with ``restart_on_error=False``: an engine failure still errors
every in-flight request loudly, and the recovery decision comes here.
The supervisor then

1. drains the scheduler's queued work (and its migrated-in requests still
   waiting for their import) and hands it to the router's failure
   callback, which replays it on a healthy replica;
2. warm-``restart()``\\ s the engine (the same programs, nothing rebuilt)
   while the replica reports ``RESTARTING``;
3. past ``max_restarts``, or on a :class:`ReplicaKilled` poison,
   quarantines it: it takes no more work and its thread ends.

A fired engine :class:`~chainermn_torch.extensions.profiling.Watchdog`
(use ``on_timeout='warn'`` in a fleet) counts as a replica failure.

The replica's thread warms its engine, then drives it. On a card it runs
on the engine's own CUDA stream, so replicas sharing the card interleave
their launches; their CUDA-graph captures are serialised process-wide
(:mod:`chainermn_torch.serving._programs`).

Every transition is observable: the ``fleet_replica_state`` gauge per
replica (0 starting, 1 healthy, 2 restarting, 3 quarantined, 4 stopped,
5 draining, 6 retired), ``fleet_replica_restarts_total{replica=}``, and
the ``fleet_replica_error`` / ``fleet_replica_quarantine`` events.
"""

from __future__ import annotations

import contextlib
import enum
import sys
import threading
from typing import Callable, Optional

from chainermn_torch.analysis import sanitizer
from chainermn_torch.fleet.routing import ReplicaSnapshot
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.resilience.cutpoints import FLEET_REPLICA
from chainermn_torch.resilience.faults import inject


class ReplicaState(enum.Enum):
    STARTING = "starting"
    HEALTHY = "healthy"
    RESTARTING = "restarting"
    QUARANTINED = "quarantined"
    STOPPED = "stopped"
    DRAINING = "draining"     # graceful retire in progress (not accepting)
    RETIRED = "retired"       # drained clean and released (terminal)


_STATE_CODE = {
    ReplicaState.STARTING: 0,
    ReplicaState.HEALTHY: 1,
    ReplicaState.RESTARTING: 2,
    ReplicaState.QUARANTINED: 3,
    ReplicaState.STOPPED: 4,
    ReplicaState.DRAINING: 5,
    ReplicaState.RETIRED: 6,
}


class ReplicaKilled(RuntimeError):
    """Hard-kill poison: the replica fails terminally (no restart budget
    consulted — straight to quarantine). The continuity probe and
    the kill-one-replica tests use this to simulate a dead worker."""


class ReplicaHang(RuntimeError):
    """The replica's engine watchdog fired during a device call — the
    step eventually returned (or the injected hang cleared), but the
    replica is treated as failed and restarted."""


class EngineReplica:
    """One engine + scheduler + driving thread, supervised.

    Parameters
    ----------
    replica_id : int
        Fleet-unique id (labels, routing, events).
    engine : ServingEngine
        Built by the caller, on weights of its own (``swap_params``
        writes an engine's parameters in place). Warmup runs on the
        replica's thread at start.
    eos_id / retry : forwarded to the replica's scheduler.
    max_restarts : int
        Warm restarts before quarantine (the supervisor's budget — the
        scheduler's own restart path is disabled in fleet mode).
    on_failure : callable(replica, drained, exc, restarted)
        The router's failover hook, invoked from the replica thread after
        in-flight work was failed, QUEUED work drained, and the
        restart/quarantine decision taken.
    """

    def __init__(self, replica_id: int, engine, *,
                 eos_id: Optional[int] = None,
                 max_restarts: int = 2,
                 idle_wait_s: float = 0.02,
                 retry=None,
                 on_failure: Optional[Callable] = None,
                 labels: Optional[dict] = None,
                 autostart: bool = True,
                 fair=None, tenant_weights=None, brownout=None,
                 chunk_tokens_per_step: Optional[int] = None) -> None:
        from chainermn_torch.serving.metrics import ServingMetrics
        from chainermn_torch.serving.scheduler import FCFSScheduler

        self.replica_id = int(replica_id)
        self.engine = engine
        self.metrics = ServingMetrics(engine.n_slots)
        # restart_on_error=False: failure ESCALATES to this supervisor
        # (in-flight still errors loudly inside the scheduler first)
        self.scheduler = FCFSScheduler(
            engine, eos_id=eos_id, metrics=self.metrics, retry=retry,
            restart_on_error=False, fair=fair,
            tenant_weights=tenant_weights, brownout=brownout,
            chunk_tokens_per_step=chunk_tokens_per_step)
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._idle_wait_s = idle_wait_s
        self._on_failure = on_failure
        self._state = ReplicaState.STARTING
        # guards the state FIELD only (leaf: nothing nests under it) —
        # the warmup thread's STARTING->HEALTHY CAS races the retire
        # path's DRAINING; the metric gauge is updated outside the lock
        self._state_lock = sanitizer.make_lock(
            "EngineReplica._state_lock", leaf=True)
        self._poison: Optional[BaseException] = None
        self._work = threading.Event()
        self._stop = threading.Event()
        self.ready = threading.Event()
        self._events = get_event_log()
        reg = get_registry()
        # caller-supplied labels (the router's fleet= instance tag) keep
        # successive fleets' replica-N series apart in the registry
        labels = dict(labels or {}, replica=str(self.replica_id))
        self._g_state = reg.gauge("fleet_replica_state", labels)
        self._c_restarts = reg.counter("fleet_replica_restarts_total",
                                       labels)
        self._g_state.set(_STATE_CODE[self._state])
        self._thread = threading.Thread(
            target=self._loop, name=f"chainermn-fleet-replica-{replica_id}",
            daemon=True)
        if autostart:
            self.start()

    # ------------------------------------------------------------------ #
    # public surface (router-facing, any thread)                          #
    # ------------------------------------------------------------------ #

    @property
    def state(self) -> ReplicaState:
        return self._state  # graftlint: unguarded-ok — atomic enum read

    @property
    def accepting(self) -> bool:
        """Routable: warming up or serving (a RESTARTING replica is mid-
        recovery — don't pile new work onto it; QUARANTINED/STOPPED are
        out of the fleet)."""
        # the lock exists for check-then-set transitions, not snapshots
        # graftlint: unguarded-ok — one atomic enum read
        return self._state in (ReplicaState.STARTING, ReplicaState.HEALTHY)

    @property
    def busy(self) -> bool:
        """Work queued or decoding right now — the decode-stall deadman's
        ``active_fn`` gate (an idle replica not minting tokens is fine; a
        busy one not minting tokens is stalled)."""
        return self.scheduler.has_work

    def start(self) -> None:
        if not self._thread.is_alive() and not self._stop.is_set():
            self._thread.start()

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               stream_cb=None, deadline_s=None, tenant: str = "default",
               priority: str = "interactive"):
        """Enqueue onto this replica's scheduler (thread-safe) and wake
        the drive loop. The router owns the routing decision; this is
        mechanism only."""
        if not self.accepting:
            raise RuntimeError(
                # graftlint: unguarded-ok — diagnostic read only
                f"replica {self.replica_id} is {self._state.value}, "
                "not accepting work")
        req = self.scheduler.submit(prompt, max_new_tokens, seed=seed,
                                    stream_cb=stream_cb,
                                    deadline_s=deadline_s,
                                    tenant=tenant, priority=priority)
        self._work.set()
        return req

    def wake(self) -> None:
        """Wake an idle drive loop now (work was queued on the scheduler
        directly, such as a swap fence) instead of at its next idle
        poll."""
        self._work.set()

    def submit_migrated(self, req, payload: dict):
        """Accept a prefill-complete request handed over from a prefill-
        tier peer (thread-safe). The SAME Request object continues on
        this replica's scheduler — its stream/trace/waiter follow it.
        Raises when not accepting, so the source keeps decoding in
        place (the migration handshake never loses a request)."""
        if not self.accepting:
            raise RuntimeError(
                # graftlint: unguarded-ok — diagnostic read only
                f"replica {self.replica_id} is {self._state.value}, "
                "not accepting migrated work")
        out = self.scheduler.enqueue_migrated(req, payload)
        self._work.set()
        return out

    def request_prefix_export(self, tokens, *, min_blocks: int = 1):
        """Ask this replica's drive thread to export its cached KV for
        ``tokens``'s prefix (thread-safe); returns the scheduler's
        :class:`~chainermn_torch.serving.scheduler.KvReuseTicket` — the
        caller bounds its own wait. Raises when not accepting (a dying
        holder has nothing shareable)."""
        if not self.accepting:
            raise RuntimeError(
                # graftlint: unguarded-ok — diagnostic read only
                f"replica {self.replica_id} is {self._state.value}, "
                "not accepting export work")
        ticket = self.scheduler.request_prefix_export(
            tokens, min_blocks=min_blocks)
        self._work.set()
        return ticket

    def enqueue_prefix_import(self, payload: dict, on_done=None):
        """Hand a shared-prefix KV payload to this replica's drive
        thread for adoption into its block pool + trie (thread-safe;
        returns the scheduler's ticket — wait on it for a deterministic
        adopt-before-admit, or ignore it for fire-and-forget; any
        failure decays to a plain prefill). Raises when not accepting."""
        if not self.accepting:
            raise RuntimeError(
                # graftlint: unguarded-ok — diagnostic read only
                f"replica {self.replica_id} is {self._state.value}, "
                "not accepting import work")
        ticket = self.scheduler.enqueue_prefix_import(payload,
                                                      on_done=on_done)
        self._work.set()
        return ticket

    def request_rebalance(self, place_cb):
        """Ask this replica's drive thread to hand its cheapest live
        decode slot to ``place_cb`` (thread-safe); returns the ticket.
        Raises when not accepting — a quarantining replica's work moves
        through the supervisor drain instead."""
        if not self.accepting:
            raise RuntimeError(
                # graftlint: unguarded-ok — diagnostic read only
                f"replica {self.replica_id} is {self._state.value}, "
                "not accepting rebalance work")
        ticket = self.scheduler.request_rebalance(place_cb)
        self._work.set()
        return ticket

    def snapshot(self) -> ReplicaSnapshot:
        """Routing-time occupancy (host counters only — the policy's
        input)."""
        occ = self.engine.occupancy()
        ewma = self.metrics.ttft_ewma
        return ReplicaSnapshot(
            replica_id=self.replica_id,
            healthy=self.accepting,
            queue_depth=self.scheduler.queue_depth,
            active_slots=occ["active_slots"],
            n_slots=occ["n_slots"],
            ttft_ewma_s=float(ewma) if ewma is not None else 0.0,
            kv_free_frac=occ["kv_free_frac"],
        )

    def kill(self, exc: Optional[BaseException] = None) -> None:
        """Poison the replica: the drive loop raises on its next
        iteration and the supervisor quarantines (no restart) — the
        kill-one-replica continuity probe."""
        self._poison = exc if exc is not None else ReplicaKilled(
            f"replica {self.replica_id} killed")
        self._work.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the drive thread (in-flight work is abandoned; the
        router cancels outstanding requests)."""
        self._stop.set()
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        with self._state_lock:
            if self._state not in (ReplicaState.QUARANTINED,
                                   ReplicaState.RETIRED):
                self._state = ReplicaState.STOPPED
            st = self._state
        self._g_state.set(_STATE_CODE[st])

    # ------------------------------------------------------------------ #
    # graceful retire (the scale-down actuator)                           #
    # ------------------------------------------------------------------ #

    def begin_retire(self) -> None:
        """Enter DRAINING: stop accepting new work while the drive loop
        keeps stepping the in-flight requests to completion. The router's
        :meth:`~chainermn_torch.fleet.router.FleetRouter.retire_replica`
        owns the full sequence (drain QUEUED, wait in-flight, stop)."""
        with self._state_lock:
            if self._state not in (ReplicaState.STARTING,
                                   ReplicaState.HEALTHY):
                raise RuntimeError(
                    f"replica {self.replica_id} is {self._state.value}, "
                    "cannot retire")
            self._state = ReplicaState.DRAINING
        self._g_state.set(_STATE_CODE[ReplicaState.DRAINING])

    def finish_retire(self, timeout: float = 10.0) -> None:
        """Stop the drive thread and mark RETIRED (only reached when the
        drain completed; a failure mid-drain quarantines instead)."""
        self._stop.set()
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self._transition_if(ReplicaState.DRAINING, ReplicaState.RETIRED)

    # ------------------------------------------------------------------ #
    # the drive loop (one thread per replica)                             #
    # ------------------------------------------------------------------ #

    def _set_state(self, state: ReplicaState) -> None:
        with self._state_lock:
            self._state = state
        self._g_state.set(_STATE_CODE[state])

    def _transition_if(self, frm: ReplicaState, to: ReplicaState) -> bool:
        """Compare-and-set state transition. The guard matters: a replica
        retired (or killed) while its warmup is still compiling must NOT
        be resurrected to HEALTHY when the warmup lands — the controller
        scales down faster than a cold engine warms."""
        with self._state_lock:
            if self._state is not frm:
                return False
            self._state = to
        self._g_state.set(_STATE_CODE[to])
        return True

    def _stream(self):
        """The engine's own CUDA stream for this thread (no-op on the
        CPU), entered after the work other threads queued for the engine
        (weights, stores) has landed."""
        import torch

        stream = self.engine.stream
        if stream is None:
            return contextlib.nullcontext()
        torch.cuda.synchronize(self.engine.device)
        return torch.cuda.stream(stream)

    def _loop(self) -> None:
        with self._stream():
            self._drive()

    def _drive(self) -> None:
        try:
            # each replica warms its own programs on its own thread
            # (warmup is idempotent)
            self.engine.warmup()
            self._transition_if(ReplicaState.STARTING, ReplicaState.HEALTHY)
        except Exception as e:  # noqa: BLE001 — a replica that cannot warm
            self._quarantine(e)  # up must not take traffic
            self.ready.set()
            return
        finally:
            self.ready.set()
        while not self._stop.is_set():
            try:
                # the replica-level fault cut-point: a raise here models a
                # worker-process death (not just one device call failing)
                inject(FLEET_REPLICA, replica=self.replica_id)
                if self._poison is not None:
                    poison, self._poison = self._poison, None
                    raise poison
                if self.scheduler.has_work:
                    # interleaving point: the fuzzer stretches the gap
                    # between the has_work check and the step — the
                    # submit/step race window the router exercises
                    sanitizer.sync_point("replica:step")
                    self.scheduler.step()
                    self._check_watchdog()
                else:
                    self._work.clear()
                    if self.scheduler.has_work:
                        continue
                    self._work.wait(self._idle_wait_s)
            except Exception as e:  # noqa: BLE001 — the supervisor boundary
                self._supervise_failure(e)
                # graftlint: unguarded-ok — own-thread read after verdict
                if self._state is not ReplicaState.HEALTHY:
                    return

    def _check_watchdog(self) -> None:
        wd = getattr(self.engine, "watchdog", None)
        if wd is not None and wd.fired:
            raise ReplicaHang(
                f"replica {self.replica_id} watchdog fired mid-step")

    # ------------------------------------------------------------------ #
    # the supervisor boundary                                             #
    # ------------------------------------------------------------------ #

    def _supervise_failure(self, e: BaseException) -> None:
        """The scheduler's exception boundary one level up: fail in-flight
        work loudly (idempotent — a failure inside ``step()`` already did),
        drain QUEUED work for re-routing, then warm-restart within budget
        or quarantine. The router's callback runs LAST, once this
        replica's fate is decided, so re-routing sees the true fleet."""
        # a failure while DRAINING must not warm-restart the replica back
        # into the accepting pool — the retire decision stands, so the
        # failure is terminal (quarantine; in-flight work re-routes)
        # graftlint: unguarded-ok — atomic read on the replica's own thread
        fatal_drain = self._state is ReplicaState.DRAINING
        self._set_state(ReplicaState.RESTARTING)
        self.scheduler.fail_inflight(e)
        drained = self.scheduler.drain_queued()
        fatal = isinstance(e, ReplicaKilled) or fatal_drain
        restarted = False
        if (not fatal and self.restarts < self.max_restarts
                and not self._stop.is_set()):
            try:
                self.engine.restart()
                wd = getattr(self.engine, "watchdog", None)
                if wd is not None:
                    wd._fired.clear()   # re-arm hang detection post-restart
                self.restarts += 1
                self._c_restarts.inc()
                self._set_state(ReplicaState.HEALTHY)
                restarted = True
            except Exception as restart_exc:  # noqa: BLE001
                e = restart_exc
        if not restarted:
            self._quarantine(e)
        self._events.emit("fleet_replica_error", replica=self.replica_id,
                          error=type(e).__name__, detail=str(e)[:200],
                          drained=len(drained), restarted=restarted,
                          restarts=self.restarts)
        if self._on_failure is not None:
            try:
                self._on_failure(self, drained, e, restarted)
            except Exception as cb_exc:  # noqa: BLE001 — never kill the loop
                print(f"chainermn_torch.fleet: replica {self.replica_id} "
                      f"failure callback raised "
                      f"{type(cb_exc).__name__}: {cb_exc}",
                      file=sys.stderr, flush=True)

    def _quarantine(self, e: BaseException) -> None:
        self._set_state(ReplicaState.QUARANTINED)
        self._events.emit("fleet_replica_quarantine",
                          replica=self.replica_id,
                          error=type(e).__name__, detail=str(e)[:200],
                          restarts=self.restarts)


__all__ = [
    "EngineReplica",
    "ReplicaHang",
    "ReplicaKilled",
    "ReplicaState",
]
