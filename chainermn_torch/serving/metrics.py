"""Serving statistics: TTFT, TPOT, tokens/s, queue depth, slot occupancy,
paged-pool occupancy, speculative accept accounting, sheds and
class-labelled preemptions (the port's subset of
``chainermn_tpu/serving/metrics.py``).

Every series lives in the metrics registry, labelled ``instance=N`` per
scheduler. Timestamps are caller-supplied ``time.perf_counter()`` values;
this class only aggregates.

- **TTFT**: submission -> first generated token (queue wait + prefill).
- **TPOT**: gap between consecutive tokens of the same request.
- **tokens/s**: generated tokens over the span from the first to the
  last recorded token across all requests.
- **occupancy**: fraction of the slot pool decoding, sampled per step.
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
        reg = get_registry()
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
        self._h_ttft = reg.histogram("serving_ttft_seconds", labels)
        self._h_tpot = reg.histogram("serving_tpot_seconds", labels)
        self._h_queue = reg.histogram("serving_queue_depth", labels)
        self._h_occ = reg.histogram("serving_slot_occupancy", labels)
        self._h_batch = reg.histogram("prefill_batch_size", labels)
        self._h_cached = reg.histogram("cached_prefix_frac", labels)
        self._h_req_blocks = reg.histogram("kv_blocks_per_request", labels)
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
        self._t_first_token: Optional[float] = None
        self._t_last_token: Optional[float] = None

    def record_submit(self) -> None:
        self._c_submitted.inc()

    def record_first_token(self, t_submit: float, t_token: float,
                           req_id: Optional[int] = None,
                           cached_frac: Optional[float] = None) -> None:
        ttft = t_token - t_submit
        self._h_ttft.observe(ttft)
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
        self._g_class_queue["batch"].set(batch_depth)
        self._g_class_queue["interactive"].set(queue_depth - batch_depth)

    def _record_token_time(self, t: float) -> None:
        if self._t_first_token is None:
            self._t_first_token = t
        self._t_last_token = t

    @property
    def tokens_generated(self) -> int:
        return self._c_tokens.value

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
        return out


__all__ = ["ServingMetrics"]
