"""Trainer-extension equivalents (the port of
``chainermn_tpu/extensions/``): checkpointing, persistence sync, metric
aggregation, profiling and sharded snapshots (``ShardedCheckpointer``,
on ``torch.distributed.checkpoint``). There is no trainer object: each
extension is a plain callable or class the training loop invokes at its
chosen interval."""

from chainermn_torch.extensions.allreduce_persistent import AllreducePersistent
from chainermn_torch.extensions.checkpoint import (
    MultiNodeCheckpointer,
    create_multi_node_checkpointer,
)
from chainermn_torch.extensions.observation_aggregator import (
    ObservationAggregator,
)
from chainermn_torch.extensions.profiling import (
    StepTimer,
    Watchdog,
    latency_report,
    trace,
)
from chainermn_torch.extensions.sharded_checkpoint import ShardedCheckpointer

__all__ = ["AllreducePersistent", "MultiNodeCheckpointer",
           "create_multi_node_checkpointer", "ObservationAggregator",
           "ShardedCheckpointer",
           "StepTimer", "Watchdog", "latency_report", "trace"]
