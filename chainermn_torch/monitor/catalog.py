"""Canonical metric-name and event-kind catalog (the port's copy of
``chainermn_tpu/monitor/catalog.py``).

Metric and event names are wire protocol: dashboards, the ``/metrics``
scrape endpoint, the SLO engine and recorded baselines all key on them,
and a typo forks a time series silently. Every literal name the port
passes to ``MetricsRegistry.counter/gauge/histogram`` or
``EventLog.emit`` appears here (``tests/test_torch_monitor_core.py``
scans the package for them). Conventions: ``^[a-z][a-z0-9_]*$``,
counters end ``_total``, ``unit="s"`` histograms end ``_seconds``.

The names are the reference's, plus the few the port emits that the
reference's catalog leaves out (marked below). Stdlib only: a static
checker can parse this file without importing the package.
"""

from __future__ import annotations

METRIC_NAMES = frozenset({
    # dataflow / dispatch
    "device_bytes_in_use",
    "device_peak_bytes_in_use",
    "dispatch_inflight",
    "dispatch_lag_steps",
    "loss_fetch_seconds",
    "loss_fetch_total",
    "prefetch_batches_total",
    "prefetch_h2d_seconds",
    "prefetch_queue_depth",
    "prefetch_stall_seconds",
    "prefetch_stall_total",
    # training / resilience
    "checkpoint_async_errors_total",
    "checkpoint_async_save_seconds",
    "checkpoint_corrupt_total",
    "checkpoint_load_seconds",
    "checkpoint_save_seconds",
    "faults_injected_total",
    "recompiles_total",
    "retries_exhausted_total",
    "retries_total",
    "step_time_seconds",
    "steps_total",
    "trace_phase_seconds",
    "trainer_failures_total",
    "trainer_mttr_seconds",
    "trainer_restores_total",
    # serving engine / scheduler
    "cached_prefix_frac",
    "kv_block_appends_total",
    "kv_blocks_free",
    "kv_blocks_in_use",
    "kv_blocks_per_request",
    "kv_preemptions_total",
    # chunked prefill + KV migration (disaggregated prefill/decode tiers)
    "chunk_tokens",
    "kv_migrated_blocks_total",
    "kv_migrations_total",
    "migration_seconds",
    # fleet-wide KV reuse (prefix sharing + decode rebalancing)
    "kv_rebalances_total",
    "kv_shares_total",
    "share_payload_cache_evictions_total",
    "share_payload_cache_hits_total",
    "prefill_chunks_total",
    "prefill_batch_size",
    "prefix_cache_evictions_total",
    "prefix_cache_hits_total",
    "prefix_cache_inserted_blocks_total",
    "prefix_cache_misses_total",
    "serving_active_slots",
    "serving_decode_steps_total",
    "serving_engine_restarts_total",
    "serving_prefills_total",
    "serving_queue_depth",
    "serving_queue_depth_now",
    "serving_requests_cancelled_total",
    "serving_requests_completed_total",
    "serving_requests_errored_total",
    "serving_requests_rejected_total",
    "serving_requests_shed_total",
    "serving_requests_submitted_total",
    "serving_scheduler_restarts_total",
    "serving_slot_occupancy",
    # overload robustness (priority classes + fairness + brownout)
    "brownout_level",
    "serving_class_preemptions_total",
    "serving_class_queue_depth",
    "serving_tenant_sheds_total",
    "serving_tokens_total",
    "serving_tpot_seconds",
    "serving_ttft_seconds",
    "serving_weight_version",
    "spec_accept_length",
    "spec_tokens_accepted_total",
    "spec_tokens_proposed_total",
    # fleet / deploy
    "deploy_swap_failures_total",
    "deploy_swap_seconds",
    "deploy_swaps_total",
    "fleet_affinity_hits_total",
    "fleet_affinity_misses_total",
    "fleet_replica_restarts_total",
    "fleet_replica_state",
    "fleet_requests_total",
    "fleet_reroutes_total",
    "fleet_route_fallbacks_total",
    "fleet_shed_total",
    # fleet edge overload protection (retry budgets + circuit breaker)
    "fleet_breaker_state",
    "fleet_retry_denied_total",
    # control plane (autoscaler + canary deploys + rebalancing)
    "canary_deploys_total",
    "canary_promotes_total",
    "canary_rollbacks_total",
    "controller_canary_phase",
    "controller_scale_downs_total",
    "controller_scale_ups_total",
    "controller_target_replicas",
    "controller_ticks_total",
    "fleet_admission_weight",
    # cost accounting (per-tenant resource ledger + goodput breakdown)
    "cost_conservation_error",
    "goodput_fraction",
    "tenant_device_seconds_total",
    "tenant_kv_block_seconds_total",
    # SLO
    "slo_breaches_total",
    "slo_burn_rate",
    "slo_compliant",
    # continuous telemetry (time-series collector + health scoring)
    "detector_state",
    "health_state",
    "ts_collect_lag_seconds",
    "ts_samples_total",
    # concurrency sanitizer
    "lock_hold_seconds",
    # the port's KV handover timings (export/import host seconds)
    "kv_export_seconds",
    "kv_import_seconds",
})

EVENT_KINDS = frozenset({
    # training / resilience
    "checkpoint_async_error",
    "checkpoint_corrupt",
    "checkpoint_load",
    "checkpoint_save",
    "checkpoint_save_async_enqueued",
    "compile",
    "fault_injected",
    "recompile",
    "retry",
    "retry_exhausted",
    "step_end",
    "step_start",
    "trainer_failure",
    "trainer_giving_up",
    "trainer_recovered",
    "trainer_restore",
    "trainer_resume",
    "trainer_snapshot",
    # serving engine / scheduler
    "admission_error",
    "decode_step",
    "engine_error",
    "engine_restart",
    "first_token",
    "kv_admit_defer",
    "kv_append",
    "kv_migrate",
    "kv_preempt",
    # the reference's name, kept so that the catalog holds it; the port
    # has no fallback from the paged kernel, so nothing emits it
    # graftlint: name-ok
    "paged_kernel_fallback",
    "prefill",
    "prefill_chunk",
    "prefix_evict",
    "prefix_insert",
    "prefix_insert_error",
    "reject",
    "serving_warmup",
    "shed",
    "slot_admit",
    "slot_retire",
    "spec_rollback",
    "submit",
    "swap_fence",
    # fleet / deploy
    "breaker_close",
    "breaker_open",
    "brownout_step",
    "fleet_publish",
    "fleet_replica_error",
    "fleet_replica_quarantine",
    "fleet_retire",
    "fleet_route",
    "fleet_route_fallback",
    "fleet_shed",
    "fleet_spawn",
    "fleet_spawn_restore",
    # fleet-wide KV reuse (mid-stream decode rebalancing)
    "rebalance",
    # control plane (edge-triggered controller decisions)
    "canary_promote",
    "canary_rollback",
    "canary_start",
    "controller_rebalance",
    "controller_scale_down",
    "controller_scale_up",
    "publish",
    "publish_failed",
    "swap_exec",
    "weight_swap",
    # cost accounting (ledger folds + noisy-neighbor edges)
    "cost_flush",
    "noisy_neighbor",
    # SLO
    "slo_breach",
    # continuous telemetry (detector edges + health transitions)
    "detector_cleared",
    "detector_fired",
    "health_changed",
    # concurrency sanitizer
    "lock_contended",
    # the watchdog's arm/fire (the reference emits them through a helper
    # its catalog does not scan)
    "watchdog_arm",
    "watchdog_fire",
})

__all__ = ["EVENT_KINDS", "METRIC_NAMES"]
