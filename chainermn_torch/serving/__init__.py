"""Continuous-batching serving over the paged KV store: engine
(mechanism), scheduler (policy), metrics, and the in-process client."""

from chainermn_torch.serving.client import ServingClient
from chainermn_torch.serving.engine import AdmitPlan, ServingEngine
from chainermn_torch.serving.metrics import ServingMetrics
from chainermn_torch.serving.prefix_cache import (
    BlockPool,
    PrefixCacheIndex,
    PrefixMatch,
)
from chainermn_torch.serving.scheduler import (
    EngineFailed,
    FCFSScheduler,
    QueueFullError,
    Request,
    RequestState,
)

__all__ = ["AdmitPlan", "BlockPool", "EngineFailed", "FCFSScheduler",
           "PrefixCacheIndex", "PrefixMatch", "QueueFullError", "Request",
           "RequestState", "ServingClient", "ServingEngine",
           "ServingMetrics"]
