"""Serving statistics: TTFT, TPOT, tokens/s, queue depth, slot occupancy,
paged-pool occupancy, speculative accept accounting, sheds,
class-labelled preemptions and the request traces' critical path (the
port's subset of ``chainermn_tpu/serving/metrics.py``).

Every series lives in the metrics registry, labelled ``instance=N`` per
scheduler. Timestamps are caller-supplied ``time.perf_counter()`` values;
this class only aggregates.

- **TTFT**: submission -> first generated token (queue wait + prefill).
- **TPOT**: gap between consecutive tokens of the same request.
- **tokens/s**: generated tokens over the span from the first to the
  last recorded token across all requests.
- **occupancy**: fraction of the slot pool decoding, sampled per step.
- **critical path**: each retired traced request's phase durations feed
  ``trace_phase_seconds{phase=}``; the slowest request's whole breakdown
  is ``report()["critical_path"]``.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from chainermn_torch.monitor import (
    get_event_log,
    get_registry,
    latency_report,
)

_instance_ids = itertools.count()


class ServingMetrics:
    """Aggregate serving statistics for one scheduler."""

    def __init__(self, n_slots: int) -> None:
        self.n_slots = n_slots
        reg = self._registry = get_registry()
        self._events = get_event_log()
        labels = {"instance": str(next(_instance_ids))}
        self._c_submitted = reg.counter(
            "serving_requests_submitted_total", labels)
        self._c_completed = reg.counter(
            "serving_requests_completed_total", labels)
        self._c_cancelled = reg.counter(
            "serving_requests_cancelled_total", labels)
        self._c_rejected = reg.counter(
            "serving_requests_rejected_total", labels)
        self._c_errored = reg.counter(
            "serving_requests_errored_total", labels)
        self._c_shed = reg.counter("serving_requests_shed_total", labels)
        self._c_restarts = reg.counter("serving_scheduler_restarts_total",
                                       labels)
        self._c_tokens = reg.counter("serving_tokens_total", labels)
        self._c_preempt = reg.counter("kv_preemptions_total", labels)
        self._h_ttft = reg.histogram("serving_ttft_seconds", labels,
                                     unit="s")
        self._h_tpot = reg.histogram("serving_tpot_seconds", labels,
                                     unit="s")
        self._h_queue = reg.histogram("serving_queue_depth", labels)
        self._h_occ = reg.histogram("serving_slot_occupancy", labels)
        self._h_batch = reg.histogram("prefill_batch_size", labels)
        self._h_cached = reg.histogram("cached_prefix_frac", labels)
        self._h_req_blocks = reg.histogram("kv_blocks_per_request", labels)
        self._g_queue = reg.gauge("serving_queue_depth_now", labels)
        self._g_active = reg.gauge("serving_active_slots", labels)
        self._g_kv_used = reg.gauge("kv_blocks_in_use", labels)
        self._g_kv_free = reg.gauge("kv_blocks_free", labels)
        # speculative decoding: the draft economy and accept lengths
        self._c_spec_proposed = reg.counter("spec_tokens_proposed_total",
                                            labels)
        self._c_spec_accepted = reg.counter("spec_tokens_accepted_total",
                                            labels)
        self._h_spec_accept = reg.histogram("spec_accept_length", labels)
        # overload policies: per-class queue depth and preemptions
        self._g_class_queue = {
            cls: reg.gauge("serving_class_queue_depth",
                           dict(labels, priority=cls))
            for cls in ("interactive", "batch")}
        self._c_class_preempt = {
            cls: reg.counter("serving_class_preemptions_total",
                             dict(labels, priority=cls))
            for cls in ("interactive", "batch")}
        self._labels = labels
        # the registry label every series of this scheduler carries (the
        # health sensors key on it)
        self.instance = labels["instance"]
        # continuous telemetry (attach_health): a zero-arg callable whose
        # result report() embeds as its ``health`` block
        self._health_fn = None
        # the scheduler's CostLedger (attach_costs); report() embeds it
        self._costs = None
        # the slowest traced request's breakdown (record_trace)
        self._worst_trace: Optional[dict] = None
        # smoothed TTFT: the fleet's routing policy reads it as a load
        # signal (ReplicaSnapshot.ttft_ewma_s)
        self.ttft_ewma: Optional[float] = None
        self._t_first_token: Optional[float] = None
        self._t_last_token: Optional[float] = None

    def record_submit(self) -> None:
        self._c_submitted.inc()

    def record_first_token(self, t_submit: float, t_token: float,
                           req_id: Optional[int] = None,
                           cached_frac: Optional[float] = None) -> None:
        ttft = t_token - t_submit
        self._h_ttft.observe(ttft)
        self.ttft_ewma = (ttft if self.ttft_ewma is None
                          else 0.8 * self.ttft_ewma + 0.2 * ttft)
        self._record_token_time(t_token)
        self._c_tokens.inc()
        if cached_frac is not None:
            self._h_cached.observe(cached_frac)
        self._events.emit("first_token", req=req_id, ttft_s=round(ttft, 6))

    def record_admission(self, batch_size: int) -> None:
        """One prefill call admitted ``batch_size`` requests."""
        self._h_batch.observe(batch_size)

    def record_token(self, t_prev_token: float, t_token: float) -> None:
        self._h_tpot.observe(t_token - t_prev_token)
        self._record_token_time(t_token)
        self._c_tokens.inc()

    def record_done(self, cancelled: bool = False) -> None:
        (self._c_cancelled if cancelled else self._c_completed).inc()

    def record_rejected(self) -> None:
        self._c_rejected.inc()

    def record_errored(self) -> None:
        self._c_errored.inc()

    def record_restart(self) -> None:
        self._c_restarts.inc()

    @property
    def engine_restarts(self) -> int:
        return self._c_restarts.value

    def record_shed(self) -> None:
        """A request shed: past its deadline, or by brownout L4."""
        self._c_shed.inc()

    def record_preemption(self, priority: Optional[str] = None) -> None:
        """A decoding request went back to the queue (pool ran dry, or an
        injected ``serving.kv_append`` fault); ``priority`` feeds the
        per-class split."""
        self._c_preempt.inc()
        if priority in self._c_class_preempt:
            self._c_class_preempt[priority].inc()

    def record_tenant_shed(self, tenant: str) -> None:
        """Brownout L4 dropped one of ``tenant``'s queued requests."""
        get_registry().counter(
            "serving_tenant_sheds_total",
            dict(self._labels, tenant=str(tenant))).inc()

    def record_spec_window(self, proposed: int, accepted: int,
                           lengths: list) -> None:
        """One verify round's accounting (drained from the engine's
        ``pop_spec_window``): totals to the counters, each slot's accept
        length to the histogram."""
        self._c_spec_proposed.inc(proposed)
        self._c_spec_accepted.inc(accepted)
        for a in lengths:
            self._h_spec_accept.observe(a)

    def record_trace(self, req_id: int, breakdown: dict) -> None:
        """One retired request's span-tree breakdown
        (:meth:`~chainermn_torch.monitor.trace.Trace.breakdown`): each
        phase feeds a ``trace_phase_seconds{phase=}`` histogram, and the
        slowest request so far is kept whole as the critical-path
        exemplar."""
        for phase, dur in breakdown.get("phases_s", {}).items():
            self._registry.histogram("trace_phase_seconds",
                          dict(self._labels, phase=phase),
                          unit="s").observe(dur)
        total = breakdown.get("total_s", 0.0)
        if (self._worst_trace is None
                or total > self._worst_trace.get("total_s", 0.0)):
            self._worst_trace = dict(breakdown, req=req_id)

    def record_kv_pool(self, in_use: int, free: int) -> None:
        """Paged-store occupancy, sampled once per scheduler step."""
        self._g_kv_used.set(in_use)
        self._g_kv_free.set(free)

    def record_request_blocks(self, n_blocks: int) -> None:
        """Store blocks a retiring request's table referenced."""
        self._h_req_blocks.observe(n_blocks)

    def record_step(self, queue_depth: int, active_slots: int,
                    batch_depth: int = 0) -> None:
        self._h_queue.observe(queue_depth)
        self._h_occ.observe(active_slots / self.n_slots)
        self._g_queue.set(queue_depth)
        self._g_active.set(active_slots)
        self._g_class_queue["batch"].set(batch_depth)
        self._g_class_queue["interactive"].set(queue_depth - batch_depth)

    def attach_health(self, fn) -> None:
        """Attach a zero-arg callable returning this instance's health
        score JSON (wired by :func:`~chainermn_torch.monitor.health.
        fleet_health`); :meth:`report` then carries a ``health`` block.
        Detach with ``attach_health(None)``."""
        self._health_fn = fn

    def attach_costs(self, ledger) -> None:
        """Attach the scheduler's :class:`~chainermn_torch.monitor.costs.
        CostLedger`: :meth:`report` then carries a ``costs`` block
        (per-tenant device, block and queue seconds, the goodput split,
        the conservation audit) and the fleet report pools its
        ``payload()`` across replicas. Detach with
        ``attach_costs(None)``."""
        self._costs = ledger

    @property
    def costs(self):
        """The attached cost ledger, or None (accounting off)."""
        return self._costs

    def _record_token_time(self, t: float) -> None:
        if self._t_first_token is None:
            self._t_first_token = t
        self._t_last_token = t

    @property
    def tokens_generated(self) -> int:
        return self._c_tokens.value

    @property
    def requests_completed(self) -> int:
        return self._c_completed.value

    @property
    def requests_errored(self) -> int:
        return self._c_errored.value

    def payload(self) -> dict:
        """This scheduler's series keyed by plain metric names (no
        ``instance`` label), in the shape
        :func:`~chainermn_torch.monitor.merge_rank_payloads` pools: the
        fleet report merges its replicas' payloads into fleet-wide
        counters and TTFT/TPOT percentiles."""
        hists = {"serving_ttft_seconds": self._h_ttft,
                 "serving_tpot_seconds": self._h_tpot,
                 "serving_queue_depth": self._h_queue,
                 "serving_slot_occupancy": self._h_occ}
        return {
            "counters": {
                "serving_requests_submitted_total": self._c_submitted.value,
                "serving_requests_completed_total": self._c_completed.value,
                "serving_requests_cancelled_total": self._c_cancelled.value,
                "serving_requests_rejected_total": self._c_rejected.value,
                "serving_requests_shed_total": self._c_shed.value,
                "serving_requests_errored_total": self._c_errored.value,
                "serving_scheduler_restarts_total": self._c_restarts.value,
                "serving_tokens_total": self.tokens_generated,
            },
            "gauges": {
                "serving_queue_depth_now": float(self._g_queue.value),
                "serving_active_slots": float(self._g_active.value),
            },
            "hist": {name: {"unit": h.unit, "count": h.count, "sum": h.sum,
                            "samples": h.samples}
                     for name, h in hists.items()},
        }

    @property
    def tokens_per_sec(self) -> float:
        if self._t_first_token is None or self._t_last_token is None:
            return 0.0
        span = self._t_last_token - self._t_first_token
        if span <= 0.0:
            return 0.0
        # the first token opens the span, the rest fill it
        return (self.tokens_generated - 1) / span

    def report(self) -> dict:
        out = {
            "requests_submitted": self._c_submitted.value,
            "requests_completed": self._c_completed.value,
            "requests_cancelled": self._c_cancelled.value,
            "requests_rejected": self._c_rejected.value,
            "requests_shed": self._c_shed.value,
            "requests_errored": self._c_errored.value,
            "engine_restarts": self._c_restarts.value,
            "tokens_generated": self.tokens_generated,
            "tokens_per_sec": self.tokens_per_sec,
            "n_slots": self.n_slots,
            "kv_preemptions": self._c_preempt.value,
        }
        out.update(latency_report(self._h_ttft.samples, "ttft"))
        out.update(latency_report(self._h_tpot.samples, "tpot"))
        for hist, prefix in ((self._h_queue, "queue_depth"),
                             (self._h_occ, "slot_occupancy"),
                             (self._h_batch, "prefill_batch_size")):
            samples = hist.samples
            if samples:
                t = np.asarray(samples, np.float64)
                out[f"{prefix}_mean"] = float(t.mean())
                out[f"{prefix}_p50"] = float(np.percentile(t, 50))
                out[f"{prefix}_p99"] = float(np.percentile(t, 99))
        cached = self._h_cached.samples
        if cached:
            t = np.asarray(cached, np.float64)
            out["cached_prefix_frac_mean"] = float(t.mean())
            out["prefix_hit_rate"] = float((t > 0).mean())
        req_blocks = self._h_req_blocks.samples
        if req_blocks:
            out["kv_blocks_per_request_mean"] = float(np.mean(req_blocks))
            out["kv_blocks_in_use"] = int(self._g_kv_used.value)
            out["kv_blocks_free"] = int(self._g_kv_free.value)
        spec_prop = int(self._c_spec_proposed.value)
        if spec_prop:
            spec_acc = int(self._c_spec_accepted.value)
            out["spec_tokens_proposed"] = spec_prop
            out["spec_tokens_accepted"] = spec_acc
            out["spec_accept_rate"] = spec_acc / spec_prop
            accept = self._h_spec_accept.samples
            if accept:
                out["spec_accept_length_mean"] = float(np.mean(accept))
        if self._worst_trace is not None:
            # the slowest traced request's phase attribution
            out["critical_path"] = self._worst_trace
        if self._health_fn is not None:
            try:
                out["health"] = self._health_fn()
            except Exception as e:  # noqa: BLE001 — reporting never raises
                out["health"] = {"error": f"{type(e).__name__}: {e}"}
        if self._costs is not None:
            try:
                out["costs"] = self._costs.report()
            except Exception as e:  # noqa: BLE001 — reporting never raises
                out["costs"] = {"error": f"{type(e).__name__}: {e}"}
        return out


__all__ = ["ServingMetrics"]
