"""The fleet router: N serving replicas behind one submit/wait/stream
surface (the port's copy of ``chainermn_tpu/fleet/router.py``).

Each :class:`~chainermn_torch.fleet.replica.EngineReplica` runs its own
:class:`~chainermn_torch.serving.engine.ServingEngine` on its own thread;
the :class:`FleetRouter` in front of them

- **routes** each submission by prefix affinity through a fleet-level
  trie, falling back to the least-loaded replica (queue depth, slot
  occupancy, EWMA TTFT; :mod:`~chainermn_torch.fleet.routing`);
- **admits at the edge**: a global ``max_queue`` sheds overload with
  :class:`~chainermn_torch.serving.scheduler.QueueFullError` at submit,
  and per-request deadlines ride through to the replicas' schedulers;
- **fails over**: a replica that errors is drained, warm-restarted or
  quarantined by its supervisor, and the router replays its drained and
  errored requests on a healthy replica (same prompt, same seed: the same
  stream), de-duplicating the tokens already streamed.

**Disaggregated tiers.** ``prefill_replicas=P, decode_replicas=D`` sends
new requests to the first ``P`` replicas; when a request's prefill
completes, its KV blocks are read out and handed to a decode-tier replica
(:meth:`FleetRouter._migrate`, each prefill scheduler's ``migrate_cb``).
The same scheduler ``Request`` moves, sampler state, position, stream
relay and waiter with it. Every failure decays to something safe: no
decode replica can take the payload, and the source decodes in place;
the destination dies before or after the import, and the request
replays elsewhere.

**Fleet KV reuse.** ``share_prefixes=True``: when the affinity trie knows
a holder but the policy routes elsewhere, the holder's cached prefix is
exported (once, through the :class:`~chainermn_torch.fleet.share.
SharePayloadCache`) and adopted by the destination before the request
admits there. :meth:`FleetRouter.rebalance_decode` moves a live decode
from one replica to a peer mid-stream.

The consumer surface is a :class:`FleetRequest` mirroring
:class:`~chainermn_torch.serving.scheduler.Request` (``wait`` /
``stream`` / ``output`` / ``state``). Observability: the
``fleet_requests_total``, ``fleet_reroutes_total``, ``fleet_shed_total``,
``fleet_affinity_{hits,misses}_total``, ``fleet_route_fallbacks_total``,
``kv_shares_total`` and ``kv_rebalances_total`` counters and
:meth:`FleetRouter.fleet_report`, which pools the replicas' metrics with
:func:`~chainermn_torch.monitor.merge_rank_payloads`.

Fault cut-points: ``fleet.route`` (an injected raise falls back to the
lowest-id accepting replica), ``fleet.replica`` (the supervisor path),
``fleet.breaker``, ``fleet.migrate``, ``fleet.share`` and
``fleet.rebalance`` (each decays to doing nothing).

**The control plane's surface.** :meth:`FleetRouter.publish` rolls new
weights through every replica's swap fence one replica at a time, new
work steering around the replica inside its fence;
:meth:`FleetRouter.attach_health` makes a
:class:`~chainermn_torch.monitor.health.HealthMonitor`'s levels the
leading routing key; :meth:`FleetRouter.attach_controller` puts a
:class:`~chainermn_torch.fleet.control.FleetController`'s report in
:meth:`FleetRouter.fleet_report`. :meth:`FleetRouter.spawn_replica`
brings a replica in from a constructed engine, or from a
:class:`~chainermn_torch.extensions.sharded_checkpoint.ShardedCheckpointer`
snapshot through :func:`~chainermn_torch.deploy.reshard.elastic_restore`
(at any tensor-parallel degree).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from chainermn_torch.analysis import sanitizer
from chainermn_torch.fleet.overload import RetryBudget, TenantBreaker
from chainermn_torch.fleet.replica import EngineReplica, ReplicaKilled
from chainermn_torch.fleet.routing import (
    FleetTrie,
    RouteDecision,
    RoutingPolicy,
)
from chainermn_torch.fleet.share import SharePayloadCache
from chainermn_torch.monitor import (
    get_event_log,
    get_registry,
    merge_cost_payloads,
    merge_rank_payloads,
)
from chainermn_torch.resilience.cutpoints import (
    FLEET_BREAKER,
    FLEET_MIGRATE,
    FLEET_REBALANCE,
    FLEET_ROUTE,
    FLEET_SHARE,
)
from chainermn_torch.resilience.faults import inject
from chainermn_torch.serving.scheduler import (
    DeadlineExceededError,
    EngineFailed,
    QueueFullError,
    RequestState,
)


_fleet_ids = itertools.count()


class FleetRequest:
    """One request's fleet-level handle: stable across re-routes.

    The underlying scheduler :class:`Request` may be replaced when a
    replica fails (the replay binds a fresh one on a healthy replica);
    this handle's ``tokens`` / ``wait`` / ``stream`` / ``output`` present
    one continuous request regardless. Terminal state is owned by the
    router (:meth:`FleetRouter._resolve`) — consumers block on the
    fleet-level event, never on a dead replica's scheduler."""

    def __init__(self, router: "FleetRouter", fid: int, prompt,
                 max_new_tokens: int, seed: int, stream_cb, deadline_s,
                 tenant: str = "default",
                 priority: str = "interactive") -> None:
        self._router = router
        self.id = fid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.seed = int(seed)
        self.stream_cb = stream_cb
        self.deadline_s = deadline_s
        # cost-attribution label: survives re-routes with the handle, so
        # a replayed binding bills the same tenant on the new replica
        self.tenant = str(tenant)
        # admission class: survives re-routes the same way, so a
        # replayed batch request stays batch on the new replica
        self.priority = str(priority)
        self.t_submit = time.perf_counter()
        self.t_deadline = (self.t_submit + float(deadline_s)
                           if deadline_s is not None else None)
        self.tokens: list = []           # delivered to THIS handle (deduped)
        self.error: Optional[BaseException] = None
        self.replica_id: Optional[int] = None
        self.reroutes = 0
        self.affinity_hit = False
        self._inner = None               # current scheduler Request binding
        self._terminal = threading.Event()
        self._final_state = None

    @property
    def finished(self) -> bool:
        return self._terminal.is_set()

    @property
    def retry_after_s(self) -> Optional[float]:
        """The structured backpressure hint riding a shed/rejected
        request's stored error (``QueueFullError`` / deadline shed), or
        None — a well-behaved client waits this long before retrying."""
        return getattr(self.error, "retry_after_s", None)

    @property
    def state(self):
        """Fleet-level request state (the serving ``RequestState``
        enum). Before a terminal decision this mirrors the current
        binding; after, the router's verdict."""
        if self._final_state is not None:
            return self._final_state
        inner = self._inner
        if inner is not None:
            return inner.state

        return RequestState.QUEUED

    @property
    def weight_version(self):
        """Weight version the current binding decoded under (stamped at
        admission; the fence guarantees it never changes mid-decode).
        None while still queued."""
        inner = self._inner
        return (getattr(inner, "weight_version", None)
                if inner is not None else None)

    @property
    def output(self) -> np.ndarray:
        """``prompt + generated`` tokens; an ERRORED request re-raises its
        stored exception (never a silent partial)."""
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the router settles this request (DONE / CANCELLED
        / ERRORED — re-routes are transparent); True when finished. An
        ERRORED request re-raises its stored exception here."""
        return self._router._await(self, timeout)

    def stream(self, poll_s: float = 0.01):
        """Yield generated tokens as they arrive, across re-routes
        (replayed tokens are de-duplicated); re-raises the stored
        exception at the end of an ERRORED request's stream."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self._terminal.is_set():
                while i < len(self.tokens):
                    yield self.tokens[i]
                    i += 1
                if self.error is not None:
                    raise self.error
                return
            self._router._await(self, poll_s, _raise=False)


class FleetRouter:
    """N engine replicas behind one serving surface (module docstring).

    Parameters
    ----------
    engines : sequence of ServingEngine
        One per replica, built by the caller (identical model/params/
        sampler config is the caller's contract — routing assumes any
        replica can serve any request). Warmup runs on each replica's
        own thread; :meth:`wait_ready` blocks until the fleet is warm.
    eos_id / retry : forwarded to every replica's scheduler.
    affinity : bool
        Prefix-affinity routing (auto-disabled when the engines have no
        prefix cache — there is nothing to be affine to).
    max_queue : int, optional
        GLOBAL queued-request bound: submissions beyond it are shed at
        the fleet edge with ``QueueFullError``.
    default_deadline_s : float, optional
        Default per-request deadline (applied through the replica
        schedulers; also bounds how long a re-route keeps retrying a
        request).
    max_restarts : int
        Per-replica warm-restart budget before quarantine.
    max_reroutes : int, optional
        Re-route budget per request (default: the replica count).
    prefill_replicas / decode_replicas : int, optional
        Disaggregated tiers (give both or neither): the first
        ``prefill_replicas`` engines form the prefill tier, the rest the
        decode tier; ``prefill + decode`` must cover every engine.
    chunk_tokens_per_step : int, optional
        Forwarded to every replica's scheduler: long prompts prefill in
        bounded chunks interleaved with decode.
    share_prefixes : bool
        Cross-replica prefix sharing: when the affinity trie knows a
        holder but the policy routes elsewhere (holder overloaded/
        degraded), export the holder's cached prefix KV and import it
        into the chosen replica instead of re-prefilling it there.
        Auto-disabled unless every engine supports block migration
        (paged) and affinity is on.
    prefix_share_min_blocks : int
        Smallest resident prefix worth shipping (below it the import
        round trip costs more than the prefill it saves).
    share_timeout_s : float
        Bound on the holder-export wait; a slow holder just means the
        destination prefills.
    share_cache_entries : int
        Host-side payload LRU size: a hot prefix is exported once and
        imported everywhere.
    """

    def __init__(self, engines: Sequence, *, eos_id: Optional[int] = None,
                 affinity: bool = True,
                 affinity_block_size: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 max_restarts: int = 2,
                 max_reroutes: Optional[int] = None,
                 policy: Optional[RoutingPolicy] = None,
                 retry=None, idle_wait_s: float = 0.02,
                 autostart: bool = True,
                 retry_budget: Optional[RetryBudget] = None,
                 breaker: Optional[TenantBreaker] = None,
                 fair=None, tenant_weights=None, brownout=None,
                 prefill_replicas: Optional[int] = None,
                 decode_replicas: Optional[int] = None,
                 chunk_tokens_per_step: Optional[int] = None,
                 share_prefixes: bool = False,
                 prefix_share_min_blocks: int = 2,
                 share_timeout_s: float = 5.0,
                 share_cache_entries: int = 8) -> None:
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if (prefill_replicas is None) != (decode_replicas is None):
            raise ValueError("prefill_replicas and decode_replicas must "
                             "be given together (or neither)")
        self._prefill_tier: Optional[frozenset] = None
        if prefill_replicas is not None:
            p, d = int(prefill_replicas), int(decode_replicas)
            if p < 1 or d < 1:
                raise ValueError(
                    f"both tiers need at least one replica, got "
                    f"prefill={p} decode={d}")
            if p + d != len(engines):
                raise ValueError(
                    f"prefill_replicas + decode_replicas must cover the "
                    f"fleet: {p}+{d} != {len(engines)} engines")
            self._prefill_tier = frozenset(range(p))
        prefix_on = all(getattr(e, "prefix_enabled", False) for e in engines)
        self.affinity = bool(affinity) and prefix_on
        # cross-replica prefix sharing needs the affinity trie to find
        # holders AND every engine able to export/import block rows
        # (paged). Anything less degrades to plain affinity routing —
        # never an error.
        self.share_prefixes = (bool(share_prefixes) and self.affinity
                               and all(getattr(e, "migration_supported",
                                               False) for e in engines))
        self.prefix_share_min_blocks = max(1, int(prefix_share_min_blocks))
        self.share_timeout_s = float(share_timeout_s)
        if affinity_block_size is None:
            affinity_block_size = (engines[0].prefix_cache.block_size
                                   if prefix_on else 16)
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self._policy = policy if policy is not None else RoutingPolicy(
            affinity=self.affinity)
        self._trie = FleetTrie(affinity_block_size)
        self._lock = sanitizer.make_rlock("FleetRouter._lock")
        self._ids = itertools.count()
        # sanitizer-guarded: mutation without _lock held raises when the
        # runtime sanitizer is on
        self._requests: dict[int, FleetRequest] = sanitizer.guarded(
            {}, lock=self._lock, name="FleetRouter._requests")
        self._closed = False
        self._events = get_event_log()
        reg = get_registry()
        # per-router instance label (the ServingMetrics convention):
        # successive/concurrent fleets in one process never mix series
        labels = {"fleet": str(next(_fleet_ids))}
        self._c_requests = reg.counter("fleet_requests_total", labels)
        self._c_reroutes = reg.counter("fleet_reroutes_total", labels)
        self._c_shed = reg.counter("fleet_shed_total", labels)
        self._c_aff_hits = reg.counter("fleet_affinity_hits_total", labels)
        self._c_aff_miss = reg.counter("fleet_affinity_misses_total", labels)
        self._c_fallbacks = reg.counter("fleet_route_fallbacks_total",
                                        labels)
        self._c_shares = reg.counter("kv_shares_total", labels)
        self._c_rebalances = reg.counter("kv_rebalances_total", labels)
        # one export serves every later importer of the same prefix
        self._share_cache = (SharePayloadCache(share_cache_entries,
                                               labels=labels)
                             if self.share_prefixes else None)
        self.max_reroutes = (int(max_reroutes) if max_reroutes is not None
                             else len(engines))
        # replicas added later (spawn_replica) are built with the same
        # configuration as the constructor's set
        self._replica_cfg = dict(eos_id=eos_id, max_restarts=max_restarts,
                                 retry=retry, idle_wait_s=idle_wait_s,
                                 fair=fair, tenant_weights=tenant_weights,
                                 brownout=brownout,
                                 chunk_tokens_per_step=chunk_tokens_per_step)
        # fleet-edge overload guards (None = feature off, zero overhead)
        self.retry_budget = retry_budget
        self.breaker = breaker
        self._labels = labels
        # replicas inside a publish fence: routing steers new work away
        # from them (unless nothing else is healthy)
        self._publishing: set[int] = sanitizer.guarded(
            set(), lock=self._lock, name="FleetRouter._publishing")
        # optional HealthMonitor (attach_health): its per-replica level
        # leads every routing decision
        self._health = None
        # optional FleetController (attach_controller): only for the
        # report; the controller calls into the router, never back
        self._controller = None
        # per-replica admission weights (the control plane's rebalance
        # actuator): missing key = full weight 1.0
        self._weights: dict[int, float] = sanitizer.guarded(
            {}, lock=self._lock, name="FleetRouter._weights")
        self.replicas = [
            EngineReplica(i, eng, on_failure=self._on_replica_failure,
                          labels=labels, autostart=autostart,
                          **self._replica_cfg)
            for i, eng in enumerate(engines)
        ]
        if self._prefill_tier is not None:
            # the handover hook: each prefill-tier scheduler offers its
            # prefill-complete requests back to the router for placement
            # on a decode replica (replicas spawned later join the
            # decode tier implicitly — they are never in _prefill_tier)
            for rid in self._prefill_tier:
                self.replicas[rid].scheduler.migrate_cb = self._migrate

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        """Start replica threads (only needed after ``autostart=False``,
        the deterministic-tests configuration)."""
        for r in self.replicas:
            r.start()

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Block until every replica still accepting work finished warmup
        (compiled programs built); True when all are ready within the
        timeout. Retired/quarantined replicas are skipped — a replica
        retired before it ever started will never signal ready."""
        deadline = time.perf_counter() + timeout
        for r in self.replicas:
            if not r.accepting:
                continue
            if not r.ready.wait(max(0.0, deadline - time.perf_counter())):
                return False
        return True

    @property
    def capacity(self) -> int:
        """Replicas currently accepting work (shrinks on quarantine)."""
        return sum(1 for r in self.replicas if r.accepting)

    def kill_replica(self, replica_id: int) -> None:
        """Hard-kill one replica (poison -> quarantine; its work is
        re-routed) — the continuity probe's entry point."""
        self.replicas[replica_id].kill()

    def attach_health(self, monitor) -> None:
        """Attach a :class:`~chainermn_torch.monitor.health.HealthMonitor`
        (usually through :func:`~chainermn_torch.monitor.health.
        fleet_health`): every routing decision then sorts by its
        per-replica level first, and :meth:`fleet_report` gains a
        ``health`` block. Detach with ``attach_health(None)``."""
        with self._lock:
            self._health = monitor

    def attach_controller(self, controller) -> None:
        """Attach a :class:`~chainermn_torch.fleet.control.
        FleetController` so :meth:`fleet_report` carries its state under
        ``"control"``. Detach with ``attach_controller(None)``."""
        with self._lock:
            self._controller = controller

    def set_admission_weight(self, replica_id: int, weight: float) -> None:
        """Scale how much new traffic ``replica_id`` attracts (0 < w <=
        1; 1.0 resets). The routing policy divides the replica's
        normalized load by its weight, so a shed replica looks
        proportionally busier and loses placements it would otherwise
        win — without ever becoming unroutable (pre-quarantine
        rebalancing, driven by the control plane)."""
        w = float(weight)
        if not 0.0 < w <= 1.0:
            raise ValueError(f"admission weight must be in (0, 1], got {w}")
        with self._lock:
            if w == 1.0:
                self._weights.pop(int(replica_id), None)
            else:
                self._weights[int(replica_id)] = w

    def admission_weight(self, replica_id: int) -> float:
        with self._lock:
            return self._weights.get(int(replica_id), 1.0)

    def close(self, timeout: float = 10.0) -> None:
        """Stop every replica thread and settle every outstanding request
        (CANCELLED) so no waiter hangs."""
        with self._lock:
            self._closed = True
        for r in self.replicas:
            r.stop(timeout)

        with self._lock:
            pending = [fr for fr in self._requests.values()
                       if not fr.finished]
            for fr in pending:
                self._finalize_locked(fr, RequestState.CANCELLED, None)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # submission surface (any thread)                                     #
    # ------------------------------------------------------------------ #

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               stream_cb: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default", priority: str = "interactive",
               retrying: bool = False) -> FleetRequest:
        """Route and enqueue one request; returns immediately. Raises
        ``QueueFullError`` when the fleet-wide queue bound is hit
        (counted as a fleet shed, ``retry_after_s`` hint attached), when
        ``tenant``'s circuit breaker is open, or when ``retrying=True``
        and the tenant's retry budget is dry; ``RuntimeError`` when no
        replica is accepting work. ``retrying`` is the client's honesty
        bit — mark resubmissions of previously-shed work so the budget
        can bound retry-storm amplification at the edge."""

        tenant = str(tenant)
        if self.breaker is not None or self.retry_budget is not None:
            # chaos boundary: a fault armed here fails CLOSED — the one
            # probed submission is refused, the fleet itself unharmed
            try:
                inject(FLEET_BREAKER, tenant=tenant, retrying=retrying)
            except Exception as e:
                self._c_shed.inc()
                self._events.emit("fleet_shed", reason="breaker_fault",
                                  tenant=tenant)
                raise QueueFullError(
                    f"tenant {tenant} refused at breaker cut-point: {e}",
                    retry_after_s=0.1) from e
        if self.breaker is not None and self.breaker.is_open(tenant):
            hint = self.breaker.retry_after(tenant) or self.breaker.open_s
            self._c_shed.inc()
            self._events.emit("fleet_shed", reason="breaker_open",
                              tenant=tenant, retry_after_s=hint)
            raise QueueFullError(
                f"tenant {tenant} circuit breaker is open "
                f"(sustained shed rate); retry after {hint}s",
                retry_after_s=hint)
        if (retrying and self.retry_budget is not None
                and not self.retry_budget.allow(tenant)):
            self._c_shed.inc()
            self._events.emit("fleet_shed", reason="retry_budget",
                              tenant=tenant)
            raise QueueFullError(
                f"tenant {tenant} retry budget exhausted; back off",
                retry_after_s=round(1.0 / max(
                    self.retry_budget.rate_per_s, 1e-6), 3))
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet router is closed")
            snaps = self._snapshots_locked()
            if not any(s.healthy for s in snaps):
                raise RuntimeError(
                    "no replica accepting work (all quarantined/stopped)")
            if self._policy.overloaded(snaps, self.max_queue):
                depth = sum(s.queue_depth for s in snaps)
                hint = round(0.05 + 0.01 * depth, 3)
                self._c_shed.inc()
                self._events.emit(
                    "fleet_shed", reason="queue_full",
                    queue_depth=depth, tenant=tenant)
                if self.breaker is not None:
                    self.breaker.record_shed(tenant)
                raise QueueFullError(
                    f"fleet admission queue full ({self.max_queue} queued "
                    f"across {self.capacity} replicas); retry later",
                    retry_after_s=hint,
                )
            fid = next(self._ids)
            fr = FleetRequest(self, fid, prompt, max_new_tokens, seed,
                              stream_cb, deadline_s, tenant=tenant,
                              priority=priority)
            decision = self._route_locked(fr.prompt, snaps)
            share = (self._plan_share_locked(fr, decision)
                     if self.share_prefixes else None)
            if share is None:
                self._bind_locked(fr, decision)
                self._requests[fid] = fr
                self._c_requests.inc()
                return fr
        # cross-replica share handshake OUTSIDE the router lock: both
        # halves are bounded waits on other replicas' drive threads
        # (export on the holder, adoption on the destination — never
        # under the router lock), and the destination serves pending
        # imports at step() start BEFORE fresh admissions, so by the
        # time the bind below enqueues the request its prompt's shared
        # blocks are already trie-resident there. Every failure or
        # timeout decays to a plain prefill on the destination — the
        # request lands either way.
        self._execute_share(fr, share)
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet router is closed")
            self._bind_locked(fr, decision)
            self._requests[fid] = fr
            self._c_requests.inc()
        return fr

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 tenant: str = "default",
                 priority: str = "interactive") -> np.ndarray:
        """Blocking single-request decode through the fleet — the
        ``ServingClient.generate`` shape."""
        fr = self.submit(prompt, max_new_tokens, seed=seed,
                         deadline_s=deadline_s, tenant=tenant,
                         priority=priority)
        if not fr.wait(timeout):
            self.cancel(fr)
            raise TimeoutError(
                f"fleet request {fr.id} did not finish within {timeout}s")
        return fr.output

    def cancel(self, fr: FleetRequest) -> bool:

        with self._lock:
            if fr.finished:
                return False
            inner = fr._inner
            self._finalize_locked(fr, RequestState.CANCELLED, None)
        if inner is not None and fr.replica_id is not None:
            self.replicas[fr.replica_id].scheduler.cancel(inner)
        return True

    # ------------------------------------------------------------------ #
    # routing internals                                                   #
    # ------------------------------------------------------------------ #

    def _snapshots_locked(self) -> list:
        """Occupancy snapshots of every replica, with the attached health
        monitor's level (0 without one) and their admission weights. The
        monitor's lock is a leaf: reading it under the router lock adds
        no lock-order edge."""
        snaps = [r.snapshot() for r in self.replicas]
        if self._health is not None:
            for s in snaps:
                s.health = self._health.level(str(s.replica_id))
        if self._weights:
            for s in snaps:
                s.admission_weight = self._weights.get(s.replica_id, 1.0)
        return snaps

    def _route_locked(self, prompt, snaps, exclude: Optional[int] = None
               ) -> RouteDecision:
        """The two-signal decision, with the ``fleet.route`` fault
        cut-point inside: an injected (or real) routing failure falls
        back to the lowest-id accepting replica — placement degrades,
        the request still lands."""
        candidates = [s for s in snaps if s.healthy
                      and s.replica_id != exclude
                      and s.replica_id not in self._publishing]
        if not candidates:
            # every healthy replica is inside a publish fence (or
            # excluded): queueing through a swap window beats shedding
            candidates = [s for s in snaps if s.healthy
                          and s.replica_id != exclude]
        if not candidates:
            candidates = [s for s in snaps if s.healthy]
        if self._prefill_tier is not None:
            # disaggregated mode: new work lands on the prefill tier —
            # unless none of it survived the filters above, in which
            # case the whole fleet serves (degraded but never shedding
            # for tier purity)
            tiered = [s for s in candidates
                      if s.replica_id in self._prefill_tier]
            if tiered:
                candidates = tiered

        try:
            inject(FLEET_ROUTE, candidates=len(candidates))
            rid, blocks = ((None, 0) if not self.affinity
                           else self._trie.lookup(prompt))
            decision = self._policy.route(candidates, rid, blocks)
            if decision is None:
                raise RuntimeError("no healthy replica")
            return decision
        except Exception as e:  # noqa: BLE001 — routing must not lose work
            fallback = min(s.replica_id for s in candidates)
            self._c_fallbacks.inc()
            self._events.emit("fleet_route_fallback",
                              error=type(e).__name__, replica=fallback)
            return RouteDecision(fallback, affinity_hit=False,
                                 reason=f"fallback:{type(e).__name__}")

    def _bind_locked(self, fr: FleetRequest, decision: RouteDecision,
                     rerouted: bool = False) -> None:
        """Submit ``fr`` to the decided replica (holding the router
        lock): install the de-duplicating token relay, stamp the fleet
        trie, and count the affinity outcome."""
        replica = self.replicas[decision.replica_id]
        replayed = len(fr.tokens)
        seen = 0

        def relay(tok: int, fr=fr) -> None:
            # engine-thread callback: skip the replayed prefix (identical
            # by the prompt+seed replay argument), append the rest
            nonlocal seen
            seen += 1
            if seen > replayed:
                fr.tokens.append(int(tok))
                if fr.stream_cb is not None:
                    try:
                        fr.stream_cb(int(tok))
                    except Exception:  # noqa: BLE001 — consumer's problem
                        pass

        remaining = None
        if fr.t_deadline is not None:
            remaining = fr.t_deadline - time.perf_counter()
        inner = replica.submit(fr.prompt, fr.max_new_tokens, seed=fr.seed,
                               stream_cb=relay, deadline_s=remaining,
                               tenant=fr.tenant, priority=fr.priority)
        fr._inner = inner
        fr.replica_id = decision.replica_id
        fr.affinity_hit = decision.affinity_hit
        (self._c_aff_hits if decision.affinity_hit
         else self._c_aff_miss).inc()
        if self.affinity:
            self._trie.note(fr.prompt, decision.replica_id)
        self._events.emit("fleet_route", req=fr.id,
                          replica=decision.replica_id,
                          affinity=decision.affinity_hit,
                          reason=decision.reason, rerouted=rerouted)

    def _migrate(self, req, payload: dict) -> bool:
        """A prefill-tier scheduler's handover hook (called on that
        replica's driving thread with a prefill-complete request and its
        exported KV payload). Picks the best decode-tier replica that can
        take the payload and enqueues the SAME request object there; True
        transfers ownership. Any failure — chaos at the ``fleet.migrate``
        cut-point, no candidate with capacity, a dying destination —
        returns False and the source decodes in place. The fleet-level
        handle needs no rebinding: ``fr._inner`` is unchanged, only
        ``fr.replica_id`` moves so failure attribution follows the KV."""

        with self._lock:
            if self._closed or self._prefill_tier is None:
                return False
            fr = next((f for f in self._requests.values()
                       if f._inner is req), None)
            if fr is None or fr.finished:
                return False
            try:
                inject(FLEET_MIGRATE, req=fr.id,
                        replica=fr.replica_id)
            except Exception as e:  # noqa: BLE001 — chaos: stay local
                self._events.emit("fleet_route_fallback",
                                  error=type(e).__name__,
                                  replica=fr.replica_id)
                return False
            snaps = self._snapshots_locked()
            cands = [s for s in snaps
                     if s.replica_id not in self._prefill_tier
                     and s.replica_id not in self._publishing]
            remaining = max(1, fr.max_new_tokens - len(fr.tokens))
            for snap in self._policy.migration_targets(cands):
                dest = self.replicas[snap.replica_id]
                try:
                    if not dest.engine.can_import(payload,
                                                  max_new=remaining):
                        continue
                    dest.submit_migrated(req, payload)
                except Exception:  # noqa: BLE001 — next candidate
                    continue
                src_rid = fr.replica_id
                fr.replica_id = dest.replica_id
                if self.affinity:
                    # the blocks MOVED: the importer now holds the
                    # prompt's KV, the exporter released it — keeping the
                    # exporter's stamps routes affinity traffic at KV
                    # that no longer exists (the disagg staleness bug)
                    self._trie.note(fr.prompt, dest.replica_id)
                    if src_rid is not None:
                        self._trie.forget(fr.prompt, src_rid)
                self._events.emit("fleet_route", req=fr.id,
                                  replica=dest.replica_id,
                                  affinity=False, reason="kv_migrate",
                                  rerouted=False)
                return True
            return False

    # ------------------------------------------------------------------ #
    # fleet-wide KV reuse (cross-replica prefix sharing + rebalancing)    #
    # ------------------------------------------------------------------ #

    def _plan_share_locked(self, fr: FleetRequest,
                           decision: RouteDecision) -> Optional[dict]:
        """Decide whether the routed request should import a shared
        prefix (router-locked, host-only). The trigger is exactly the
        affinity-policy's rejection: the trie knows a holder, but the
        policy sent the request elsewhere (holder overloaded, degraded,
        or out of blocks) — the miss that cross-replica sharing turns
        back into a hit."""
        if self._closed or decision.affinity_hit:
            return None            # routed TO the holder: nothing to move
        holder, blocks = self._trie.lookup(fr.prompt)
        if (holder is None or holder == decision.replica_id
                or blocks < self.prefix_share_min_blocks):
            return None
        if not self.replicas[holder].accepting:
            # a dying holder can't export — but a cached payload from an
            # earlier export still can serve (checked in _execute_share)
            holder = None
        return {"holder": holder, "blocks": blocks,
                "dest": decision.replica_id}

    def _execute_share(self, fr: FleetRequest, plan: dict) -> bool:
        """Run one share handshake (NO router lock held): payload-cache
        hit, else a bounded-wait export on the holder's drive thread;
        then a fire-and-forget import enqueue on the destination. The
        ``fleet.share`` cut-point covers the whole handshake — chaos (or
        any real failure) decays to the destination prefilling the
        prefix itself."""

        dest_rid = plan["dest"]
        try:
            inject(FLEET_SHARE, req=fr.id, holder=plan["holder"],
                    dest=dest_rid)
        except Exception as e:  # noqa: BLE001 — chaos: re-prefill
            self._events.emit("fleet_route_fallback",
                              error=type(e).__name__, replica=dest_rid)
            return False
        entry = self._share_cache.match(fr.prompt)
        if entry is None:
            holder = plan["holder"]
            if holder is None:
                return False
            try:
                ticket = self.replicas[holder].request_prefix_export(
                    fr.prompt, min_blocks=self.prefix_share_min_blocks)
            except Exception:  # noqa: BLE001 — holder dying: re-prefill
                return False
            payload = ticket.wait(self.share_timeout_s)
            if payload is None:
                return False
            entry = self._share_cache.put(payload)

        def _adopted(n: int, entry=entry) -> None:
            # destination drive thread: adoption outcome (0 = the blocks
            # were already cached there, or the import failed — either
            # way the request just prefills what's missing)
            self._share_cache.release(entry, imported=bool(n))
            if n:
                self._c_shares.inc()

        try:
            ticket = self.replicas[dest_rid].enqueue_prefix_import(
                entry.payload, on_done=_adopted)
        except Exception:  # noqa: BLE001 — dest dying: re-route handles it
            self._share_cache.release(entry)
            return False
        # bounded wait for the adoption so the bind that follows admits
        # against the populated trie; a timeout (wedged destination)
        # just means this request prefills — the import still lands for
        # the next one
        ticket.wait(self.share_timeout_s)
        return True

    def rebalance_decode(self, src_rid: int,
                         dest_rid: Optional[int] = None):
        """Ask replica ``src_rid`` to hand its cheapest live decode slot
        to a peer mid-stream (thread-safe, fire-and-forget; the control
        plane's pre-quarantine actuator — see
        :meth:`FleetController._rebalance_tick`). Returns the
        scheduler's ticket, or None when the source can't participate.
        The source picks the victim (batch class first, fewest live
        blocks — least payload to move); this router callback places it
        on the least-loaded peer that can import, ``dest_rid`` pinning
        the destination when given. Chaos at ``fleet.rebalance`` — or
        any placement failure — leaves the victim decoding in place."""

        def place(req, payload, src_rid=int(src_rid)) -> bool:
            # source drive thread (outside its scheduler lock): the same
            # lock pattern as _migrate — router-locked candidate walk,
            # host-only capacity checks

            with self._lock:
                if self._closed:
                    return False
                fr = next((f for f in self._requests.values()
                           if f._inner is req), None)
                if fr is None or fr.finished:
                    return False
                try:
                    inject(FLEET_REBALANCE, req=fr.id, replica=src_rid)
                except Exception as e:  # noqa: BLE001 — decode in place
                    self._events.emit("fleet_route_fallback",
                                      error=type(e).__name__,
                                      replica=src_rid)
                    return False
                snaps = self._snapshots_locked()
                cands = [s for s in snaps
                         if s.replica_id != src_rid
                         and s.replica_id not in self._publishing
                         and (dest_rid is None
                              or s.replica_id == int(dest_rid))
                         and (self._prefill_tier is None
                              or s.replica_id not in self._prefill_tier)]
                remaining = max(1, fr.max_new_tokens - len(fr.tokens))
                for snap in self._policy.migration_targets(cands):
                    dest = self.replicas[snap.replica_id]
                    try:
                        if not dest.engine.can_import(payload,
                                                      max_new=remaining):
                            continue
                        dest.submit_migrated(req, payload)
                    except Exception:  # noqa: BLE001 — next candidate
                        continue
                    fr.replica_id = dest.replica_id
                    if self.affinity:
                        self._trie.note(fr.prompt, dest.replica_id)
                        self._trie.forget(fr.prompt, src_rid)
                    self._c_rebalances.inc()
                    self._events.emit(
                        "rebalance", req=fr.id, src=src_rid,
                        dest=dest.replica_id,
                        blocks=int(payload["n_blocks"]),
                        tokens=len(fr.tokens))
                    return True
                return False

        try:
            return self.replicas[int(src_rid)].request_rebalance(place)
        except Exception:  # noqa: BLE001 — source dying/not accepting
            return None

    # ------------------------------------------------------------------ #
    # settlement (consumer waits + failover)                              #
    # ------------------------------------------------------------------ #

    def _await(self, fr: FleetRequest, timeout: Optional[float],
               _raise: bool = True) -> bool:
        end = (None if timeout is None
               else time.perf_counter() + float(timeout))
        while True:
            if fr._terminal.is_set():
                if _raise and fr.error is not None:
                    raise fr.error
                return True
            slice_s = 0.05 if end is None else min(
                0.05, end - time.perf_counter())
            if slice_s <= 0:
                return False
            inner = fr._inner
            if inner is None:
                time.sleep(min(slice_s, 0.002))   # mid-rebind blink
                continue
            inner._done.wait(slice_s)
            if inner.finished:
                self._resolve(fr, inner)

    def _resolve(self, fr: FleetRequest, inner) -> None:
        """One finished binding's verdict (idempotent, router-locked):
        DONE/CANCELLED settle the fleet request; an engine-failure error
        re-routes (replay on a healthy replica) within the deadline and
        re-route budgets, anything else settles ERRORED."""

        with self._lock:
            if fr.finished or fr._inner is not inner:
                return
            st = inner.state
            if st is RequestState.DONE:
                if self.breaker is not None:
                    self.breaker.record_ok(fr.tenant)
                self._finalize_locked(fr, st, None)
                return
            if st is RequestState.CANCELLED:
                self._finalize_locked(fr, st, None)
                return
            if st is not RequestState.ERRORED:
                return   # spurious wake: binding not actually terminal
            err = inner.error
            if not isinstance(err, EngineFailed):
                # deadline shed, validation, ... — the replica's verdict
                # IS the fleet verdict
                if isinstance(err, DeadlineExceededError):
                    self._c_shed.inc()
                    if self.breaker is not None:
                        self.breaker.record_shed(fr.tenant)
                self._finalize_locked(fr, st, err)
                return
            # engine failure: replay on a healthy replica if budgets allow
            if (fr.t_deadline is not None
                    and time.perf_counter() >= fr.t_deadline):
                self._c_shed.inc()
                self._finalize_locked(fr, st, DeadlineExceededError(
                    f"fleet request {fr.id} hit its {fr.deadline_s}s "
                    "deadline during replica failover"))
                return
            snaps = self._snapshots_locked()
            if (fr.reroutes >= self.max_reroutes
                    or not any(s.healthy for s in snaps)):
                self._finalize_locked(fr, st, err)
                return
            decision = self._route_locked(fr.prompt, snaps,
                                          exclude=fr.replica_id)
            fr.reroutes += 1
            self._c_reroutes.inc()
            try:
                self._bind_locked(fr, decision, rerouted=True)
            except Exception as bind_exc:  # noqa: BLE001 — target died too
                failure = EngineFailed(
                    f"fleet re-route of request {fr.id} failed: "
                    f"{type(bind_exc).__name__}: {bind_exc}")
                failure.__cause__ = bind_exc
                self._finalize_locked(fr, RequestState.ERRORED, failure)

    def _finalize_locked(self, fr: FleetRequest, state,
                         error: Optional[BaseException]) -> None:
        fr.error = error
        fr._final_state = state
        fr._terminal.set()
        self._requests.pop(fr.id, None)

    def _on_replica_failure(self, replica: EngineReplica, drained: list,
                            exc: BaseException, restarted: bool) -> None:
        """The supervisor's callback (replica thread): forget the failed
        replica's prefix beliefs, then proactively settle every fleet
        request it owned — drained QUEUED work re-binds immediately
        (nothing ever started, nothing lost); errored in-flight work goes
        through the normal :meth:`_resolve` replay path."""
        rid = replica.replica_id
        with self._lock:
            self._trie.drop_replica(rid)
            drained_ids = {id(req) for req in drained}
            affected = [fr for fr in list(self._requests.values())
                        if fr.replica_id == rid and not fr.finished]
        for fr in affected:
            inner = fr._inner
            if inner is None:
                continue
            if id(inner) in drained_ids:
                self._rebind_drained(fr, inner)
            elif inner.finished:
                self._resolve(fr, inner)

    def _rebind_drained(self, fr: FleetRequest, inner) -> None:

        with self._lock:
            if fr.finished or fr._inner is not inner:
                return
            if (fr.t_deadline is not None
                    and time.perf_counter() >= fr.t_deadline):
                self._c_shed.inc()
                self._finalize_locked(
                    fr, RequestState.ERRORED, DeadlineExceededError(
                        f"fleet request {fr.id} hit its {fr.deadline_s}s "
                        "deadline during replica failover"))
                return
            snaps = self._snapshots_locked()
            if (fr.reroutes >= self.max_reroutes
                    or not any(s.healthy for s in snaps)):
                failure = EngineFailed(
                    f"request {fr.id} drained from failed replica "
                    f"{fr.replica_id} with no healthy replica to take it")
                self._finalize_locked(fr, RequestState.ERRORED, failure)
                return
            decision = self._route_locked(fr.prompt, snaps,
                                          exclude=fr.replica_id)
            fr.reroutes += 1
            self._c_reroutes.inc()
            try:
                self._bind_locked(fr, decision, rerouted=True)
            except Exception as bind_exc:  # noqa: BLE001
                failure = EngineFailed(
                    f"fleet re-route of request {fr.id} failed: "
                    f"{type(bind_exc).__name__}: {bind_exc}")
                failure.__cause__ = bind_exc
                self._finalize_locked(fr, RequestState.ERRORED, failure)

    # ------------------------------------------------------------------ #
    # weight lifecycle (the deploy layer's fleet surface)                 #
    # ------------------------------------------------------------------ #

    def publish(self, params, *, step: Optional[int] = None,
                timeout: float = 60.0, canary: Optional[int] = None,
                exclude: Sequence = ()) -> dict:
        """Rolling weight publish: swap ``params`` (a ``state_dict``
        mapping) into every replica, one at a time. While a replica is
        fenced, routing sends new work to its peers, so the fleet serves
        at N-1 capacity through each window and every accepted request
        completes on the weights it started with. A replica that fails
        its swap, or is not accepting, is recorded and passed over: one
        bad replica never wedges the roll. Returns ``{"ok", "replicas":
        {rid: outcome}}``; ``ok`` holds when every targeted accepting
        replica took the new version.

        ``canary=rid`` swaps exactly that replica (the controller's
        canary); ``exclude=(rid, ...)`` rolls everyone else (the promote,
        the canary already on the new version); not both. Each replica's
        own drive loop steps through its fence, so this thread may block:
        it must not be one that drives a replica's scheduler."""
        from chainermn_torch.deploy.publish import WeightPublisher

        if canary is not None and exclude:
            raise ValueError("publish: canary= and exclude= are mutually "
                             "exclusive")
        if canary is not None:
            targets = [self.replicas[int(canary)]]
        else:
            skip = {int(i) for i in exclude}
            targets = [r for r in list(self.replicas)
                       if r.replica_id not in skip]
        results: dict[str, dict] = {}
        for replica in targets:
            rid = replica.replica_id
            if not replica.accepting:
                results[str(rid)] = {"ok": False,
                                     "skipped": replica.state.value}
                continue
            with self._lock:
                self._publishing.add(rid)
            try:
                publisher = WeightPublisher(replica.engine,
                                            replica.scheduler)
                handle = publisher.publish_async(params, step=step)
                replica.wake()
                version = handle.wait(timeout)
                results[str(rid)] = {
                    "ok": True, "version": version,
                    "commit_s": round(handle.commit_s, 6),
                    "fence_s": round(handle.fence_s or 0.0, 6)}
            except Exception as e:  # noqa: BLE001 — roll past one failure
                results[str(rid)] = {"ok": False,
                                     "error": f"{type(e).__name__}: {e}"}
            finally:
                with self._lock:
                    self._publishing.discard(rid)
        ok = all(r.get("ok") for r in results.values()
                 if "skipped" not in r) and bool(results)
        self._events.emit("fleet_publish", ok=ok, canary=canary,
                          replicas={k: v.get("version")
                                    for k, v in results.items()})
        return {"ok": ok, "replicas": results}

    def spawn_replica(self, engine=None, *, checkpoint=None,
                      engine_factory=None, params_template=None,
                      comm=None, model=None,
                      wait_ready: bool = True,
                      timeout: float = 300.0) -> EngineReplica:
        """Bring one more replica into the fleet without stopping traffic:
        it warms up on its own thread and takes routed traffic once
        healthy; existing replicas never pause.

        Either pass a constructed ``engine`` (on weights of its own), or a
        ``checkpoint`` (a :class:`~chainermn_torch.extensions.
        sharded_checkpoint.ShardedCheckpointer`) with ``params_template``
        (the new model's ``state_dict()``, filled in place) and
        ``engine_factory(params) -> ServingEngine``: the snapshot's
        ``"params"`` come through :func:`~chainermn_torch.deploy.reshard.
        elastic_restore` at the degree ``model`` and ``comm`` give, which
        may differ from the snapshot's and from the other replicas'.
        Raises ``RuntimeError`` when the checkpoint holds no snapshot."""
        if engine is None:
            if checkpoint is None or engine_factory is None \
                    or params_template is None:
                raise ValueError(
                    "spawn_replica needs either engine= or all of "
                    "checkpoint=/engine_factory=/params_template=")
            from chainermn_torch.deploy.reshard import elastic_restore

            state, ckpt_step = elastic_restore(
                checkpoint, {"params": params_template},
                comm=comm, model=model)
            if state is None:
                raise RuntimeError(
                    "spawn_replica: checkpoint has no snapshot to "
                    "restore from")
            engine = engine_factory(state["params"])
            self._events.emit("fleet_spawn_restore", step=ckpt_step)
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet router is closed")
            rid = len(self.replicas)
            replica = EngineReplica(
                rid, engine, on_failure=self._on_replica_failure,
                labels=self._labels, autostart=True, **self._replica_cfg)
            self.replicas.append(replica)
        self._events.emit("fleet_spawn", replica=rid)
        if wait_ready:
            replica.ready.wait(timeout)
        return replica

    def retire_replica(self, replica_id: int, *,
                       timeout: float = 60.0) -> dict:
        """Gracefully take one replica OUT of the fleet — the clean
        scale-down actuator (quarantine is the failure-driven one).

        Sequence: the replica enters DRAINING (no longer accepting, its
        drive loop keeps stepping), its QUEUED work is drained and
        re-routed to peers (nothing ever started, nothing lost), in-
        flight requests finish on the weights they started with, then
        the thread stops and the replica lands RETIRED. If in-flight
        work outlives ``timeout`` the replica is hard-killed instead —
        the supervisor's drain-failure path re-routes the stragglers and
        quarantines (``forced=True`` in the result)."""
        replica = self.replicas[replica_id]
        rid = replica.replica_id
        replica.begin_retire()          # raises unless accepting
        with self._lock:
            # its prefix beliefs die with it: stop routing affinity
            # traffic at KV that is about to be released
            self._trie.drop_replica(rid)
        drained = replica.scheduler.drain_queued()
        drained_ids = {id(req) for req in drained}
        with self._lock:
            affected = [fr for fr in list(self._requests.values())
                        if fr.replica_id == rid and not fr.finished]
        for fr in affected:
            inner = fr._inner
            if inner is not None and id(inner) in drained_ids:
                self._rebind_drained(fr, inner)
        deadline = time.perf_counter() + timeout
        while replica.scheduler.has_work \
                and time.perf_counter() < deadline:
            time.sleep(0.002)
        forced = bool(replica.scheduler.has_work)
        if forced:
            # stragglers past the drain budget: the supervisor path
            # fails them over to peers and quarantines the replica
            replica.kill(ReplicaKilled(
                f"replica {rid} retire drain exceeded {timeout}s"))
        else:
            replica.finish_retire()
        self._events.emit("fleet_retire", replica=rid,
                          drained=len(drained), forced=forced)
        return {"replica": rid, "drained": len(drained), "forced": forced,
                "state": replica.state.value}

    # ------------------------------------------------------------------ #
    # observability                                                       #
    # ------------------------------------------------------------------ #

    def fleet_report(self) -> dict:
        """One JSON-able fleet view: per-replica state/occupancy/restarts,
        router counters (reroutes, sheds, affinity outcomes, shares,
        rebalances), and the replicas' latency/occupancy series pooled
        with :func:`~chainermn_torch.monitor.merge_rank_payloads`, so
        ``pooled["histograms"]["serving_ttft_seconds"]`` carries the
        fleet-wide p50/p99, not one replica's."""
        replicas = {}
        for r in self.replicas:
            occ = r.engine.occupancy()
            replicas[str(r.replica_id)] = {
                "state": r.state.value,
                "restarts": r.restarts,
                "queue_depth": r.scheduler.queue_depth,
                "active_slots": occ["active_slots"],
                "n_slots": occ["n_slots"],
                "kv_free_frac": occ["kv_free_frac"],
                "recompiles_after_warmup":
                    sum(r.engine.recompiles.values()),
                "weight_version": occ.get("weight_version", 0),
                "requests_completed": r.metrics.requests_completed,
                "requests_errored": r.metrics.requests_errored,
            }
        pooled = merge_rank_payloads(
            [r.metrics.payload() for r in self.replicas])
        # a tenant's bill is fleet-wide: the ledgers pool (measured and
        # attributed seconds sum alike, so conservation still holds)
        cost_payloads = [r.metrics.costs.payload() for r in self.replicas
                         if r.metrics.costs is not None]
        costs = (merge_cost_payloads(cost_payloads)
                 if cost_payloads else None)
        hits = int(self._c_aff_hits.value)
        misses = int(self._c_aff_miss.value)
        with self._lock:
            hm = self._health
            ctrl = self._controller
            weights = dict(self._weights)
        for rid, w in weights.items():
            replicas.get(str(rid), {})["admission_weight"] = w
        health = hm.report() if hm is not None else None
        control = ctrl.report() if ctrl is not None else None
        overload = None
        if self.retry_budget is not None or self.breaker is not None:
            overload = {
                "retry_budget": (self.retry_budget.to_json()
                                 if self.retry_budget is not None else None),
                "breaker": (self.breaker.to_json()
                            if self.breaker is not None else None),
            }
        return {
            "health": health,
            "control": control,
            "costs": costs,
            "overload": overload,
            "replicas": replicas,
            "capacity": self.capacity,
            "n_replicas": len(self.replicas),
            "affinity": {
                "enabled": self.affinity,
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hits / max(hits + misses, 1), 4),
                "trie_nodes": self._trie.n_nodes,
            },
            "kv_reuse": {
                "share_enabled": self.share_prefixes,
                "shares": int(self._c_shares.value),
                "rebalances": int(self._c_rebalances.value),
                "payload_cache": (self._share_cache.to_json()
                                  if self._share_cache is not None
                                  else None),
            },
            "tiers": (None if self._prefill_tier is None else {
                "prefill": sorted(self._prefill_tier),
                "decode": [r.replica_id for r in self.replicas
                           if r.replica_id not in self._prefill_tier],
            }),
            "requests_total": int(self._c_requests.value),
            "reroutes_total": int(self._c_reroutes.value),
            "shed_total": int(self._c_shed.value),
            "route_fallbacks_total": int(self._c_fallbacks.value),
            "pooled": pooled,
        }


__all__ = ["FleetRequest", "FleetRouter"]
