"""Per-request resource attribution and tenant cost accounting.

Every shared mechanism in the serving path deliberately blurs per-request
cost: a bucketed prefill runs ``prefill_batch`` padded rows for the whole
group in one dispatch, a decode round advances every slot (idle rows ride
along masked), speculative verify burns device time on drafts that get
rejected, shared prefix blocks are held by several requests at once, and
a preemption throws away work that must be replayed. This module is the
ledger that un-blurs it — splitting each *measured* device interval into
per-tenant shares by explicit rules:

- **prefill** — one bucketed call of ``batch_rows`` rows × ``bucket``
  tokens splits evenly across rows; each member row splits by token
  share into ``useful`` (its real suffix) and ``padding`` (the pad tail);
  rows the group didn't fill are ``padding`` booked to the reserved
  unattributed tenant ``"-"``.
- **decode** — one dispatch splits evenly across the ``n_rows`` compiled
  rows; an active row is ``useful``, an inactive row is ``idle`` (booked
  to ``"-"``). A speculative row further splits its share by verify
  positions: ``committed/(committed+rejected)`` stays useful, the
  rejected remainder is ``wasted``.
- **replay** — after a preemption the request regenerates its discarded
  tokens (and re-runs its prefill) from scratch; that re-done work books
  as ``replay`` instead of ``useful``, metered by a per-request token
  debt so a second preemption never double-books (debt only grows by
  what was *discarded*, and each replayed token consumes it once).
- **migrate** — the host-bounce handover that moves a request's KV
  blocks from a prefill-tier replica to a decode-tier one is device+PCIe
  time spent on exactly one request; the whole measured interval books
  to its tenant as ``migrate`` (overhead, not goodput: it is weighed
  against the decode stalls the handover deletes).
- **KV block-seconds** — the integral of blocks held over wall time; a
  shared prefix block held by ``r`` requests contributes ``1/r`` per
  holder (the live refcount split), so the pool's occupancy always sums
  across tenants.

The load-bearing invariant is **conservation**: every ``record_*`` call
splits the measured interval into shares that sum back to it, so
attributed device-seconds can never silently lose or invent cost. The
ledger tracks the worst per-dispatch relative error and publishes it as
the ``cost_conservation_error`` gauge (should sit at float-epsilon).

Aggregates fold into the process registry on :meth:`CostLedger.flush`
(per-tenant ``tenant_device_seconds_total{kind=}`` /
``tenant_kv_block_seconds_total`` counters, fleet-visible
``goodput_fraction{kind=}`` gauges), which makes them scrapeable,
collectible by the continuous-telemetry spine, and — via
:func:`standard_tenant_sensors` — watchable by a noisy-neighbor detector
that names the offending tenant in a ``noisy_neighbor`` event.

This module imports nothing of the serving stack at module level (the
scheduler imports it): it is pure host-side dict arithmetic. The port's
copy of ``chainermn_tpu/monitor/costs.py``: its rules, metric names and
event names are the reference's.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence

from chainermn_torch.analysis import sanitizer
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.monitor.timeseries import (
    Detector,
    TimeSeriesStore,
    ZScoreDetector,
)

#: attribution kinds; together they partition every measured interval
KINDS = ("useful", "padding", "idle", "wasted", "replay", "migrate")

#: reserved tenant for shares no request owns (empty prefill rows, idle
#: decode slots) — kept out of per-tenant rankings but inside goodput
UNATTRIBUTED = "-"

_EPS = 1e-12


def tenant_device_key(instance: str, tenant: str, kind: str) -> str:
    """Registry series key of one tenant's device-seconds counter (label
    keys sorted, matching ``MetricsRegistry`` rendering) — what the
    collector samples and :func:`standard_tenant_sensors` watches."""
    return (f'tenant_device_seconds_total{{instance="{instance}",'
            f'kind="{kind}",tenant="{tenant}"}}')


def tenant_block_key(instance: str, tenant: str) -> str:
    """Registry series key of one tenant's KV block-seconds counter."""
    return (f'tenant_kv_block_seconds_total{{instance="{instance}",'
            f'tenant="{tenant}"}}')


class CostLedger:
    """The per-instance resource ledger (one per scheduler, created by
    ``FCFSScheduler(cost_accounting=True)`` and attached to its
    ``ServingMetrics``). All ``record_*`` methods are cheap host-side
    dict arithmetic behind one leaf lock — safe from the scheduler's
    driving thread and the submit/cancel threads alike."""

    def __init__(self, *, instance: str, registry=None, events=None,
                 flush_event_every_s: float = 1.0) -> None:
        self.instance = str(instance)
        self._registry = registry if registry is not None else get_registry()
        self._events = events if events is not None else get_event_log()
        self._flush_event_every_s = float(flush_event_every_s)
        # leaf: record_* runs under the scheduler's lock on some paths
        # (preempt), so nothing may be acquired while this is held —
        # flush() gathers deltas under it, then talks to the registry
        # (its own leaf locks) only after releasing
        self._lock = sanitizer.make_lock("CostLedger._lock", leaf=True)
        # (tenant, kind) -> cumulative attributed device seconds
        self._device: dict[tuple, float] = {}
        # tenant -> cumulative KV block-seconds (refcount-split integral)
        self._blocks: dict[str, float] = {}
        # tenant -> cumulative queue-wait wall seconds (not device time:
        # reported, but outside the conservation sum by definition)
        self._queue_wait: dict[str, float] = {}
        # conservation bookkeeping
        self._measured_s = 0.0
        self._attributed_s = 0.0
        self._dispatches = 0
        self._max_dispatch_err = 0.0
        # preempt-and-replay state: token debt still to regenerate, and
        # requests whose NEXT prefill is a replay of one already paid for
        self._replay_tokens: dict[int, int] = {}
        self._replay_prefill: set[int] = set()
        # flush watermarks (counter deltas are incs since last flush)
        self._flushed_device: dict[tuple, float] = {}
        self._flushed_blocks: dict[str, float] = {}
        self._t_last_event: Optional[float] = None
        self._last_summary: Optional[dict] = None

    # ------------------------------------------------------------------ #
    # recording (the splitting rules)                                     #
    # ------------------------------------------------------------------ #

    def record_queue_wait(self, tenant: str, seconds: float) -> None:
        """Wall seconds one request spent QUEUED before (re-)admission."""
        if seconds <= 0.0:
            return
        with self._lock:
            self._queue_wait[tenant] = (
                self._queue_wait.get(tenant, 0.0) + float(seconds))

    def record_prefill(self, interval_s: float, *, bucket: int,
                       batch_rows: int,
                       members: Sequence[tuple]) -> dict:
        """Split one bucketed-prefill dispatch of ``batch_rows`` rows
        across its ``members`` ``(req_id, tenant, suffix_tokens)`` by
        token share; pad tails and unfilled rows book as ``padding``.
        Returns this dispatch's ``{(tenant, kind): seconds}`` (summing to
        ``interval_s`` — the conservation contract)."""
        interval_s = float(interval_s)
        batch_rows = max(int(batch_rows), len(members), 1)
        bucket = max(int(bucket), 1)
        row_s = interval_s / batch_rows
        out: dict[tuple, float] = {}
        with self._lock:
            for req_id, tenant, suffix in members:
                real = min(max(int(suffix), 0), bucket)
                useful_s = row_s * (real / bucket)
                pad_s = row_s - useful_s
                kind = "useful"
                if req_id in self._replay_prefill:
                    # this prefill re-does one a preemption threw away
                    self._replay_prefill.discard(req_id)
                    kind = "replay"
                if useful_s > 0.0:
                    out[(tenant, kind)] = out.get((tenant, kind), 0.0) \
                        + useful_s
                if pad_s > 0.0:
                    out[(tenant, "padding")] = out.get(
                        (tenant, "padding"), 0.0) + pad_s
            empty = batch_rows - len(members)
            if empty > 0:
                out[(UNATTRIBUTED, "padding")] = out.get(
                    (UNATTRIBUTED, "padding"), 0.0) + row_s * empty
            self._book_locked(interval_s, out)
        return out

    def record_decode(self, interval_s: float, *, n_rows: int,
                      rows: Sequence[tuple]) -> dict:
        """Split one decode dispatch across the ``n_rows`` compiled rows:
        each ``(req_id, tenant, committed, rejected)`` active row's even
        share splits ``committed : rejected`` into useful vs ``wasted``
        (speculative verify; a plain decode row has ``rejected == 0``),
        inactive rows book as ``idle``. A row whose request still owes
        replay debt books its useful part as ``replay``, token-metered.
        Returns this dispatch's attribution (sums to ``interval_s``)."""
        interval_s = float(interval_s)
        n_rows = max(int(n_rows), len(rows), 1)
        row_s = interval_s / n_rows
        out: dict[tuple, float] = {}
        with self._lock:
            for req_id, tenant, committed, rejected in rows:
                committed = max(int(committed), 1)
                rejected = max(int(rejected), 0)
                positions = committed + rejected
                useful_s = row_s * (committed / positions)
                wasted_s = row_s - useful_s
                debt = self._replay_tokens.get(req_id, 0)
                if debt > 0:
                    replayed = min(debt, committed)
                    replay_s = useful_s * (replayed / committed)
                    useful_s -= replay_s
                    if debt - replayed > 0:
                        self._replay_tokens[req_id] = debt - replayed
                    else:
                        self._replay_tokens.pop(req_id, None)
                    out[(tenant, "replay")] = out.get(
                        (tenant, "replay"), 0.0) + replay_s
                if useful_s > 0.0:
                    out[(tenant, "useful")] = out.get(
                        (tenant, "useful"), 0.0) + useful_s
                if wasted_s > 0.0:
                    out[(tenant, "wasted")] = out.get(
                        (tenant, "wasted"), 0.0) + wasted_s
            idle = n_rows - len(rows)
            if idle > 0:
                out[(UNATTRIBUTED, "idle")] = out.get(
                    (UNATTRIBUTED, "idle"), 0.0) + row_s * idle
            self._book_locked(interval_s, out)
        return out

    def record_migration(self, interval_s: float, *, req_id: int,
                         tenant: str) -> dict:
        """Book one KV-block migration's wall interval (gather dispatch +
        host bounce + scatter dispatch) entirely to the owning tenant as
        ``migrate`` — a single-request transfer has no rows to split, so
        conservation is exact by construction. Returns the attribution
        (``{(tenant, 'migrate'): interval_s}``)."""
        interval_s = float(interval_s)
        out: dict[tuple, float] = {}
        if interval_s > 0.0:
            out[(tenant, "migrate")] = interval_s
        with self._lock:
            self._book_locked(interval_s, out)
        return out

    def record_block_seconds(self, dt_s: float,
                             holders: Iterable[tuple]) -> None:
        """Advance the block-seconds integral by ``dt_s`` wall seconds:
        each ``(tenant, share)`` holder held ``share`` refcount-weighted
        blocks (``sum(1/refs(b))`` over its table — a block shared by r
        requests counts 1/r per holder)."""
        dt_s = float(dt_s)
        if dt_s <= 0.0:
            return
        with self._lock:
            for tenant, share in holders:
                if share <= 0.0:
                    continue
                self._blocks[tenant] = (
                    self._blocks.get(tenant, 0.0) + dt_s * float(share))

    def note_preempt(self, req_id: int, tenant: str,
                     tokens_discarded: int) -> None:
        """A preemption discarded this request's generated-so-far tokens;
        its re-admission will replay the prefill and regenerate them.
        Grows the replay debt by exactly what was discarded — the
        double-booking guard: work already owed stays owed once, and a
        preempt-during-replay adds only the newly discarded tokens."""
        with self._lock:
            self._replay_prefill.add(req_id)
            if tokens_discarded > 0:
                self._replay_tokens[req_id] = (
                    self._replay_tokens.get(req_id, 0)
                    + int(tokens_discarded))

    def finalize(self, req_id: int) -> None:
        """Drop per-request replay state at any terminal transition
        (retire / cancel / shed / error / drain). Idempotent."""
        with self._lock:
            self._replay_tokens.pop(req_id, None)
            self._replay_prefill.discard(req_id)

    def _book_locked(self, measured_s: float, out: dict) -> None:
        """Fold one dispatch's attribution into the cumulative ledger
        and update the conservation bookkeeping (lock held)."""
        attributed = 0.0
        for key, s in out.items():
            self._device[key] = self._device.get(key, 0.0) + s
            attributed += s
        self._measured_s += measured_s
        self._attributed_s += attributed
        self._dispatches += 1
        err = abs(attributed - measured_s) / max(measured_s, _EPS)
        if err > self._max_dispatch_err:
            self._max_dispatch_err = err

    # ------------------------------------------------------------------ #
    # folding into the registry                                           #
    # ------------------------------------------------------------------ #

    def flush(self, force_event: bool = False) -> dict:
        """Fold accumulated deltas into the process registry: per-tenant
        ``tenant_device_seconds_total{kind=}`` and
        ``tenant_kv_block_seconds_total`` counters, the fleet-level
        ``goodput_fraction{kind=}`` gauge set and the
        ``cost_conservation_error`` gauge. Called once per scheduler
        step; a ``cost_flush`` event is emitted at most every
        ``flush_event_every_s`` (or always with ``force_event``).
        Returns the summary the event carries."""
        with self._lock:
            dev_deltas = {}
            for key, total in self._device.items():
                d = total - self._flushed_device.get(key, 0.0)
                if d > 0.0:
                    dev_deltas[key] = d
                    self._flushed_device[key] = total
            blk_deltas = {}
            for tenant, total in self._blocks.items():
                d = total - self._flushed_blocks.get(tenant, 0.0)
                if d > 0.0:
                    blk_deltas[tenant] = d
                    self._flushed_blocks[tenant] = total
            # idle fast path: flush() runs once per scheduler step, so a
            # quiet engine must not pay registry lookups every step
            if (not dev_deltas and not blk_deltas and not force_event
                    and self._last_summary is not None):
                return self._last_summary
            by_kind = self._by_kind_locked()
            measured = self._measured_s
            attributed = self._attributed_s
            dispatches = self._dispatches
            tenants = {t for t, _ in self._device if t != UNATTRIBUTED}
            err = abs(attributed - measured) / max(measured, _EPS)
            summary = {
                "measured_s": round(measured, 6),
                "attributed_s": round(attributed, 6),
                "conservation_error": round(err, 9),
                "dispatches": dispatches,
                "tenants": len(tenants),
            }
            self._last_summary = summary
        # registry/event work OUTSIDE the leaf lock (they take their own)
        reg = self._registry
        inst = self.instance
        for (tenant, kind), d in dev_deltas.items():
            reg.counter("tenant_device_seconds_total",
                        {"instance": inst, "tenant": tenant,
                         "kind": kind}).inc(d)
        for tenant, d in blk_deltas.items():
            reg.counter("tenant_kv_block_seconds_total",
                        {"instance": inst, "tenant": tenant}).inc(d)
        total = sum(by_kind.values())
        for kind in KINDS:
            frac = by_kind.get(kind, 0.0) / total if total > 0.0 else 0.0
            reg.gauge("goodput_fraction",
                      {"instance": inst, "kind": kind}).set(frac)
        reg.gauge("cost_conservation_error", {"instance": inst}).set(err)
        now = time.perf_counter()
        if (force_event or self._t_last_event is None
                or now - self._t_last_event >= self._flush_event_every_s):
            self._t_last_event = now
            self._events.emit("cost_flush", instance=inst, **summary)
        return summary

    # ------------------------------------------------------------------ #
    # reporting                                                           #
    # ------------------------------------------------------------------ #

    def _by_kind_locked(self) -> dict:
        by_kind: dict[str, float] = {}
        for (_, kind), s in self._device.items():
            by_kind[kind] = by_kind.get(kind, 0.0) + s
        return by_kind

    def payload(self) -> dict:
        """Plain-dict cumulative state for fleet pooling (see
        :func:`merge_cost_payloads`) — the cost analogue of
        ``ServingMetrics.payload()``."""
        with self._lock:
            return {
                "device": {f"{t}\x00{k}": s
                           for (t, k), s in self._device.items()},
                "blocks": dict(self._blocks),
                "queue_wait": dict(self._queue_wait),
                "measured_s": self._measured_s,
                "attributed_s": self._attributed_s,
                "dispatches": self._dispatches,
                "max_dispatch_error": self._max_dispatch_err,
            }

    def report(self) -> dict:
        """The ``/costs`` payload: per-tenant device-seconds by kind,
        block-seconds, queue wait; the goodput breakdown; and the
        conservation audit."""
        return _render_report(self.payload())

    def tenant_device_seconds(self) -> dict:
        """``{tenant: attributed device seconds}`` over real tenants
        (the unattributed ``"-"`` share excluded) — the cheap ranking
        the controller uses to name the top cost contributor."""
        out: dict[str, float] = {}
        with self._lock:
            for (tenant, _), s in self._device.items():
                if tenant != UNATTRIBUTED:
                    out[tenant] = out.get(tenant, 0.0) + s
        return out

    def top_tenant(self) -> Optional[tuple]:
        """``(tenant, device_seconds)`` of the heaviest real tenant, or
        ``None`` before any attributed work."""
        ranked = self.tenant_device_seconds()
        if not ranked:
            return None
        tenant = max(ranked, key=lambda t: (ranked[t], t))
        return tenant, ranked[tenant]

    @property
    def conservation_error(self) -> float:
        """|attributed − measured| / measured over the ledger's life."""
        with self._lock:
            return (abs(self._attributed_s - self._measured_s)
                    / max(self._measured_s, _EPS))


def merge_cost_payloads(payloads: Sequence[dict]) -> dict:
    """Pool N replicas' :meth:`CostLedger.payload` dicts into one
    fleet-level cost report (sums everywhere; fractions recomputed) —
    what ``FleetRouter.fleet_report()["costs"]`` embeds."""
    merged = {"device": {}, "blocks": {}, "queue_wait": {},
              "measured_s": 0.0, "attributed_s": 0.0, "dispatches": 0,
              "max_dispatch_error": 0.0}
    for p in payloads:
        for key, s in p.get("device", {}).items():
            merged["device"][key] = merged["device"].get(key, 0.0) + s
        for t, s in p.get("blocks", {}).items():
            merged["blocks"][t] = merged["blocks"].get(t, 0.0) + s
        for t, s in p.get("queue_wait", {}).items():
            merged["queue_wait"][t] = merged["queue_wait"].get(t, 0.0) + s
        merged["measured_s"] += p.get("measured_s", 0.0)
        merged["attributed_s"] += p.get("attributed_s", 0.0)
        merged["dispatches"] += p.get("dispatches", 0)
        merged["max_dispatch_error"] = max(
            merged["max_dispatch_error"], p.get("max_dispatch_error", 0.0))
    return _render_report(merged)


def _render_report(p: dict) -> dict:
    tenants: dict[str, dict] = {}
    by_kind: dict[str, float] = {}
    for key, s in p["device"].items():
        tenant, _, kind = key.partition("\x00")
        row = tenants.setdefault(
            tenant, {"device_s": {}, "device_total_s": 0.0,
                     "kv_block_s": 0.0, "queue_wait_s": 0.0})
        row["device_s"][kind] = round(
            row["device_s"].get(kind, 0.0) + s, 6)
        row["device_total_s"] = round(row["device_total_s"] + s, 6)
        by_kind[kind] = by_kind.get(kind, 0.0) + s
    for t, s in p["blocks"].items():
        row = tenants.setdefault(
            t, {"device_s": {}, "device_total_s": 0.0,
                "kv_block_s": 0.0, "queue_wait_s": 0.0})
        row["kv_block_s"] = round(row["kv_block_s"] + s, 6)
    for t, s in p["queue_wait"].items():
        row = tenants.setdefault(
            t, {"device_s": {}, "device_total_s": 0.0,
                "kv_block_s": 0.0, "queue_wait_s": 0.0})
        row["queue_wait_s"] = round(row["queue_wait_s"] + s, 6)
    total = sum(by_kind.values())
    goodput = {kind: (round(by_kind.get(kind, 0.0) / total, 6)
                      if total > 0.0 else 0.0) for kind in KINDS}
    measured = p["measured_s"]
    return {
        "tenants": tenants,
        "goodput": goodput,
        "device_time": {
            "measured_s": round(measured, 6),
            "attributed_s": round(p["attributed_s"], 6),
            "conservation_error": round(
                abs(p["attributed_s"] - measured) / max(measured, _EPS), 9),
            "max_dispatch_error": round(p["max_dispatch_error"], 9),
            "dispatches": p["dispatches"],
        },
    }


# ---------------------------------------------------------------------- #
# sensors: the noisy-neighbor spine                                       #
# ---------------------------------------------------------------------- #

class ShareOfTotal:
    """Derived signal: the ``num`` series' newest value over the sum of
    its sibling series' newest values — one tenant's share of the whole
    pool's rate (skipped while the total is 0)."""

    def __init__(self, num: str, siblings: Sequence[str],
                 name: str) -> None:
        self.num = num
        self.siblings = list(siblings)
        self.name = name

    def evaluate(self, store: TimeSeriesStore, now: float) -> None:
        n = store.last(self.num)
        if n is None:
            return
        total = 0.0
        for key in self.siblings:
            latest = store.last(key)
            if latest is not None:
                total += max(latest[1], 0.0)
        if total <= 0.0:
            return
        store.append(self.name, n[0], max(n[1], 0.0) / total)


class NoisyNeighborDetector(Detector):
    """Edge-triggered detector that NAMES its tenant: wraps either a
    fixed threshold (``threshold=`` — deterministic, for a share
    series) or a z-score drift check on the
    tenant's device-seconds rate. On the rising edge it emits a
    ``noisy_neighbor`` event carrying ``tenant=`` on top of the base
    class's ``detector_fired``."""

    def __init__(self, name: str, series: str, *, tenant: str,
                 threshold: Optional[float] = None, z: float = 3.0,
                 baseline: int = 64, min_points: int = 8,
                 severity: str = "degraded") -> None:
        super().__init__(name, series, severity)
        self.tenant = tenant
        self.threshold = (float(threshold) if threshold is not None
                          else None)
        self._z = (None if threshold is not None else ZScoreDetector(
            name + ":z", series, z=z, direction="above",
            baseline=baseline, min_points=min_points, severity=severity))

    def check(self, store: TimeSeriesStore, now: float) -> dict:
        if self.threshold is not None:
            latest = store.last(self.series)
            if latest is None:
                verdict = {"firing": False, "value": None,
                           "threshold": self.threshold}
            else:
                verdict = {"firing": latest[1] > self.threshold,
                           "value": latest[1],
                           "threshold": self.threshold}
        else:
            verdict = self._z.check(store, now)
        verdict["tenant"] = self.tenant
        return verdict

    def evaluate(self, store: TimeSeriesStore, now: float, *,
                 registry=None, events=None) -> dict:
        was = self.firing
        verdict = super().evaluate(store, now, registry=registry,
                                   events=events)
        if events is not None and self.firing and not was:
            fields = {k: v for k, v in verdict.items()
                      if isinstance(v, (int, float, str, bool))}
            fields.pop("tenant", None)
            events.emit("noisy_neighbor", tenant=self.tenant,
                        detector=self.name, series=self.series, **fields)
        return verdict


def standard_tenant_sensors(tenant: str, instance: str, *,
                            tenants: Optional[Sequence[str]] = None,
                            share_threshold: Optional[float] = None,
                            rate_threshold: Optional[float] = None,
                            z: float = 3.0, baseline: int = 64,
                            min_points: int = 8,
                            tag: Optional[str] = None) -> tuple:
    """The per-tenant sensor kit, mirroring
    :func:`~chainermn_torch.monitor.health.standard_replica_sensors`:
    returns ``(signals, detectors)`` for one tenant on one scheduler
    instance, ready for ``Collector(signals=..., detectors=...)``.

    Signals (when ``tenants`` — the full tenant list — is given): the
    tenant's share of the pool's useful device-seconds rate
    (``tenant_device_share:<tag>``) and of the KV block-seconds rate
    (``tenant_block_share:<tag>``), both derived from the counter
    ``:rate`` series the collector builds automatically.

    The detector watches, in order of preference: the device share
    against ``share_threshold`` (deterministic), the useful rate against
    ``rate_threshold``, or z-score
    drift of the useful rate (the open-world default).
    """
    tag = tag if tag is not None else f"{tenant}@{instance}"
    dev_rate = tenant_device_key(instance, tenant, "useful") + ":rate"
    blk_rate = tenant_block_key(instance, tenant) + ":rate"
    share_series = f"tenant_device_share:{tag}"
    signals = []
    if tenants:
        signals.append(ShareOfTotal(
            dev_rate,
            [tenant_device_key(instance, t, "useful") + ":rate"
             for t in tenants],
            name=share_series))
        signals.append(ShareOfTotal(
            blk_rate,
            [tenant_block_key(instance, t) + ":rate" for t in tenants],
            name=f"tenant_block_share:{tag}"))
    if share_threshold is not None and tenants:
        detector = NoisyNeighborDetector(
            f"noisy_neighbor:{tag}", share_series, tenant=tenant,
            threshold=share_threshold)
    elif rate_threshold is not None:
        detector = NoisyNeighborDetector(
            f"noisy_neighbor:{tag}", dev_rate, tenant=tenant,
            threshold=rate_threshold)
    else:
        detector = NoisyNeighborDetector(
            f"noisy_neighbor:{tag}", dev_rate, tenant=tenant, z=z,
            baseline=baseline, min_points=min_points)
    return signals, [detector]


__all__ = [
    "KINDS",
    "UNATTRIBUTED",
    "CostLedger",
    "NoisyNeighborDetector",
    "ShareOfTotal",
    "merge_cost_payloads",
    "standard_tenant_sensors",
    "tenant_block_key",
    "tenant_device_key",
]
