"""Differentiable communication (the port of ``chainermn_tpu/functions/``):
the collectives (with ``ppermute``, the tiled ``all_to_all`` and
Megatron's f/g pair), and point-to-point ``send``/``recv``/``pseudo_connect``."""

from chainermn_torch.functions.collective_communication import (
    all_to_all,
    allgather,
    allreduce,
    alltoall,
    bcast,
    copy_to_parallel_region,
    gather,
    ppermute,
    reduce_from_parallel_region,
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

__all__ = ["allreduce", "allgather", "alltoall", "all_to_all", "bcast",
           "copy_to_parallel_region", "gather", "ppermute",
           "reduce_from_parallel_region", "scatter", "DelegateVariable", "current_rank", "pseudo_connect",
           "rank_context", "recv", "send"]
