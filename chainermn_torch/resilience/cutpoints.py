"""The fault-injection cut-point catalog (the port's copy of
``chainermn_tpu/resilience/cutpoints.py``).

Every ``inject()`` / ``torn_fraction()`` site names its cut-point with a
constant from this module, never a bare string, so the places a chaos
test can break the system stay one greppable list. The names are the
JAX package's (``subsystem.site``), so a fault plan reads the same in
both. Stdlib only.
"""

from __future__ import annotations

# -- checkpointing -------------------------------------------------------- #
CHECKPOINT_SAVE = "checkpoint.save"
CHECKPOINT_WRITE = "checkpoint.write"
CHECKPOINT_LOAD = "checkpoint.load"
SHARDED_CHECKPOINT_SAVE = "sharded_checkpoint.save"
SHARDED_CHECKPOINT_LOAD = "sharded_checkpoint.load"

# -- training ------------------------------------------------------------- #
TRAINER_STEP = "trainer.step"
DATALOADER_ASSEMBLE = "dataloader.assemble"
OBJSTORE_PUT = "objstore.put"
OBJSTORE_GET = "objstore.get"

# -- collectives ---------------------------------------------------------- #
COMM_ALLGATHER_OBJ = "comm.allgather_obj"

# -- serving -------------------------------------------------------------- #
SERVING_PREFILL = "serving.prefill"
SERVING_PREFILL_BATCH = "serving.prefill_batch"
SERVING_ADMIT_FAIR = "serving.admit_fair"
SERVING_DECODE = "serving.decode"
SERVING_KV_APPEND = "serving.kv_append"
SERVING_PREFIX_COPY = "serving.prefix_copy"
SERVING_SPEC_VERIFY = "serving.spec_verify"
SERVING_CHUNK_PREFILL = "serving.chunk_prefill"

# -- fleet / deploy ------------------------------------------------------- #
FLEET_ROUTE = "fleet.route"
FLEET_REPLICA = "fleet.replica"
FLEET_BREAKER = "fleet.breaker"
FLEET_MIGRATE = "fleet.migrate"
FLEET_SHARE = "fleet.share"
FLEET_REBALANCE = "fleet.rebalance"
DEPLOY_PUBLISH = "deploy.publish"
DEPLOY_RESHARD = "deploy.reshard"

# families of points minted at runtime (``comm.<collective-op>``); a
# resolved point matching one of these prefixes is catalog-sanctioned
DYNAMIC_PREFIXES = ("comm.",)


def comm_point(op: str) -> str:
    """Cut-point for one collective op (``comm.allreduce`` ...)."""
    return f"comm.{op}"


ALL_CUTPOINTS = (
    CHECKPOINT_SAVE,
    CHECKPOINT_WRITE,
    CHECKPOINT_LOAD,
    SHARDED_CHECKPOINT_SAVE,
    SHARDED_CHECKPOINT_LOAD,
    TRAINER_STEP,
    DATALOADER_ASSEMBLE,
    OBJSTORE_PUT,
    OBJSTORE_GET,
    COMM_ALLGATHER_OBJ,
    SERVING_PREFILL,
    SERVING_PREFILL_BATCH,
    SERVING_ADMIT_FAIR,
    SERVING_DECODE,
    SERVING_KV_APPEND,
    SERVING_PREFIX_COPY,
    SERVING_SPEC_VERIFY,
    SERVING_CHUNK_PREFILL,
    FLEET_ROUTE,
    FLEET_REPLICA,
    FLEET_BREAKER,
    FLEET_MIGRATE,
    FLEET_SHARE,
    FLEET_REBALANCE,
    DEPLOY_PUBLISH,
    DEPLOY_RESHARD,
)

__all__ = [
    "ALL_CUTPOINTS",
    "CHECKPOINT_LOAD",
    "CHECKPOINT_SAVE",
    "CHECKPOINT_WRITE",
    "COMM_ALLGATHER_OBJ",
    "DATALOADER_ASSEMBLE",
    "DEPLOY_PUBLISH",
    "DEPLOY_RESHARD",
    "DYNAMIC_PREFIXES",
    "FLEET_BREAKER",
    "FLEET_MIGRATE",
    "FLEET_REBALANCE",
    "FLEET_REPLICA",
    "FLEET_ROUTE",
    "FLEET_SHARE",
    "OBJSTORE_GET",
    "OBJSTORE_PUT",
    "SERVING_ADMIT_FAIR",
    "SERVING_CHUNK_PREFILL",
    "SERVING_DECODE",
    "SERVING_KV_APPEND",
    "SERVING_PREFILL",
    "SERVING_PREFILL_BATCH",
    "SERVING_PREFIX_COPY",
    "SERVING_SPEC_VERIFY",
    "SHARDED_CHECKPOINT_LOAD",
    "SHARDED_CHECKPOINT_SAVE",
    "TRAINER_STEP",
    "comm_point",
]
