"""Differentiable communication (the port of ``chainermn_tpu/functions/``):
the collectives, and point-to-point ``send``/``recv``/``pseudo_connect``."""

from chainermn_torch.functions.collective_communication import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)
from chainermn_torch.functions.point_to_point import (
    DelegateVariable,
    current_rank,
    pseudo_connect,
    rank_context,
    recv,
    send,
)

__all__ = ["allreduce", "allgather", "alltoall", "bcast", "gather",
           "scatter", "DelegateVariable", "current_rank", "pseudo_connect",
           "rank_context", "recv", "send"]
