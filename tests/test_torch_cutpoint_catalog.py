"""Drift pins for the port's two consistency catalogs (the twin of
``tests/analysis_tests/test_cutpoint_catalog.py``).

Every cut-point, metric name and event kind of ``chainermn_torch`` is
spelled out HERE as a literal. Adding one to the port without touching
this file fails these asserts; conversely the port's graftlint
consistency checker requires every catalog entry to be referenced by a
port test (``tests/test_torch_*.py``) — this file is that reference.
The reference's catalogs are held to be a subset of the port's.
"""

from chainermn_torch.monitor.catalog import EVENT_KINDS, METRIC_NAMES
from chainermn_torch.resilience.cutpoints import (
    ALL_CUTPOINTS,
    DYNAMIC_PREFIXES,
    comm_point,
)

PINNED_CUTPOINTS = (
    "checkpoint.save",
    "checkpoint.write",
    "checkpoint.load",
    "sharded_checkpoint.save",
    "sharded_checkpoint.load",
    "trainer.step",
    "dataloader.assemble",
    "objstore.put",
    "objstore.get",
    "comm.allgather_obj",
    "serving.prefill",
    "serving.prefill_batch",
    "serving.admit_fair",
    "serving.decode",
    "serving.kv_append",
    "serving.prefix_copy",
    "serving.spec_verify",
    "serving.chunk_prefill",
    "fleet.route",
    "fleet.replica",
    "fleet.breaker",
    "fleet.migrate",
    "fleet.share",
    "fleet.rebalance",
    "deploy.publish",
    "deploy.reshard",
)

PINNED_METRICS = frozenset({
    "brownout_level",
    "cached_prefix_frac",
    "canary_deploys_total",
    "canary_promotes_total",
    "canary_rollbacks_total",
    "checkpoint_async_errors_total",
    "checkpoint_async_save_seconds",
    "checkpoint_corrupt_total",
    "checkpoint_load_seconds",
    "checkpoint_save_seconds",
    "chunk_tokens",
    "controller_canary_phase",
    "controller_scale_downs_total",
    "controller_scale_ups_total",
    "controller_target_replicas",
    "controller_ticks_total",
    "cost_conservation_error",
    "deploy_swap_failures_total",
    "deploy_swap_seconds",
    "deploy_swaps_total",
    "detector_state",
    "device_bytes_in_use",
    "device_peak_bytes_in_use",
    "dispatch_inflight",
    "dispatch_lag_steps",
    "faults_injected_total",
    "fleet_admission_weight",
    "fleet_affinity_hits_total",
    "fleet_affinity_misses_total",
    "fleet_breaker_state",
    "fleet_replica_restarts_total",
    "fleet_replica_state",
    "fleet_requests_total",
    "fleet_reroutes_total",
    "fleet_retry_denied_total",
    "fleet_route_fallbacks_total",
    "fleet_shed_total",
    "goodput_fraction",
    "health_state",
    "kv_block_appends_total",
    "kv_blocks_free",
    "kv_blocks_in_use",
    "kv_blocks_per_request",
    "kv_export_seconds",
    "kv_import_seconds",
    "kv_migrated_blocks_total",
    "kv_migrations_total",
    "kv_preemptions_total",
    "kv_rebalances_total",
    "kv_shares_total",
    "lock_hold_seconds",
    "loss_fetch_seconds",
    "loss_fetch_total",
    "migration_seconds",
    "prefetch_batches_total",
    "prefetch_h2d_seconds",
    "prefetch_queue_depth",
    "prefetch_stall_seconds",
    "prefetch_stall_total",
    "prefill_batch_size",
    "prefill_chunks_total",
    "prefix_cache_evictions_total",
    "prefix_cache_hits_total",
    "prefix_cache_inserted_blocks_total",
    "prefix_cache_misses_total",
    "recompiles_total",
    "retries_exhausted_total",
    "retries_total",
    "serving_active_slots",
    "serving_class_preemptions_total",
    "serving_class_queue_depth",
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
    "serving_tenant_sheds_total",
    "serving_tokens_total",
    "serving_tpot_seconds",
    "serving_ttft_seconds",
    "serving_weight_version",
    "share_payload_cache_evictions_total",
    "share_payload_cache_hits_total",
    "slo_breaches_total",
    "slo_burn_rate",
    "slo_compliant",
    "spec_accept_length",
    "spec_tokens_accepted_total",
    "spec_tokens_proposed_total",
    "step_time_seconds",
    "steps_total",
    "tenant_device_seconds_total",
    "tenant_kv_block_seconds_total",
    "trace_phase_seconds",
    "trainer_failures_total",
    "trainer_mttr_seconds",
    "trainer_restores_total",
    "ts_collect_lag_seconds",
    "ts_samples_total",
})

PINNED_EVENTS = frozenset({
    "admission_error",
    "breaker_close",
    "breaker_open",
    "brownout_step",
    "canary_promote",
    "canary_rollback",
    "canary_start",
    "checkpoint_async_error",
    "checkpoint_corrupt",
    "checkpoint_load",
    "checkpoint_save",
    "checkpoint_save_async_enqueued",
    "compile",
    "controller_rebalance",
    "controller_scale_down",
    "controller_scale_up",
    "cost_flush",
    "decode_step",
    "detector_cleared",
    "detector_fired",
    "engine_error",
    "engine_restart",
    "fault_injected",
    "first_token",
    "fleet_publish",
    "fleet_replica_error",
    "fleet_replica_quarantine",
    "fleet_retire",
    "fleet_route",
    "fleet_route_fallback",
    "fleet_shed",
    "fleet_spawn",
    "fleet_spawn_restore",
    "health_changed",
    "kv_admit_defer",
    "kv_append",
    "kv_migrate",
    "kv_preempt",
    "lock_contended",
    "noisy_neighbor",
    "paged_kernel_fallback",
    "prefill",
    "prefill_chunk",
    "prefix_evict",
    "prefix_insert",
    "prefix_insert_error",
    "publish",
    "publish_failed",
    "rebalance",
    "recompile",
    "reject",
    "retry",
    "retry_exhausted",
    "serving_warmup",
    "shed",
    "slo_breach",
    "slot_admit",
    "slot_retire",
    "spec_rollback",
    "step_end",
    "step_start",
    "submit",
    "swap_exec",
    "swap_fence",
    "trainer_failure",
    "trainer_giving_up",
    "trainer_recovered",
    "trainer_restore",
    "trainer_resume",
    "trainer_snapshot",
    "watchdog_arm",
    "watchdog_fire",
    "weight_swap",
})


def test_cutpoint_catalog_pinned():
    assert ALL_CUTPOINTS == PINNED_CUTPOINTS


def test_cutpoints_unique_and_conventional():
    assert len(set(ALL_CUTPOINTS)) == len(ALL_CUTPOINTS)
    for point in ALL_CUTPOINTS:
        subsystem, _, site = point.partition(".")
        assert subsystem and site, point


def test_dynamic_comm_points():
    assert DYNAMIC_PREFIXES == ("comm.",)
    assert comm_point("allreduce") == "comm.allreduce"


def test_metric_catalog_pinned():
    assert METRIC_NAMES == PINNED_METRICS


def test_event_catalog_pinned():
    assert EVENT_KINDS == PINNED_EVENTS


def test_reference_catalogs_are_subsets_of_the_ports():
    from chainermn_tpu.monitor import catalog as ref_catalog
    from chainermn_tpu.resilience import cutpoints as ref_cutpoints

    assert ref_cutpoints.ALL_CUTPOINTS == ALL_CUTPOINTS
    assert ref_catalog.METRIC_NAMES <= METRIC_NAMES
    assert ref_catalog.EVENT_KINDS <= EVENT_KINDS
