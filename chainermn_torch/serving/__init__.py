"""Continuous-batching serving: engine (mechanism, paged or dense KV,
decode windows, speculative decoding, chunked prefill, fixed step
programs captured as CUDA graphs, warm restart, in-place weight swap),
scheduler (policy: FIFO or weighted-fair admission, deadlines, brownout,
restart on engine failure, the weight-swap fence), metrics, and the
in-process client."""

from chainermn_torch.serving.client import ServingClient
from chainermn_torch.serving.engine import (
    AdmitPlan,
    ChunkedPrefill,
    EngineStateError,
    ServingEngine,
)
from chainermn_torch.serving.fairness import (
    BROWNOUT_LEVELS,
    PRIORITY_CLASSES,
    BrownoutPolicy,
    FairAdmission,
    request_cost,
)
from chainermn_torch.serving.metrics import ServingMetrics
from chainermn_torch.serving.prefix_cache import (
    BlockPool,
    InsertPlan,
    PrefixCacheIndex,
    PrefixMatch,
)
from chainermn_torch.serving.scheduler import (
    DeadlineExceededError,
    EngineFailed,
    FCFSScheduler,
    QueueFullError,
    Request,
    RequestState,
    SwapTicket,
)
from chainermn_torch.serving.speculative import (
    DraftModelDrafter,
    NgramDrafter,
    SpeculativeConfig,
    build_drafter,
)

__all__ = ["AdmitPlan", "BROWNOUT_LEVELS", "BlockPool", "BrownoutPolicy",
           "ChunkedPrefill", "DeadlineExceededError", "DraftModelDrafter",
           "EngineFailed", "EngineStateError", "FCFSScheduler",
           "FairAdmission", "InsertPlan", "NgramDrafter",
           "PRIORITY_CLASSES", "PrefixCacheIndex", "PrefixMatch",
           "QueueFullError", "Request", "RequestState", "ServingClient",
           "ServingEngine", "ServingMetrics", "SpeculativeConfig",
           "SwapTicket", "build_drafter", "request_cost"]
