"""Differentiable collectives (the port of ``chainermn_tpu/functions/``;
point-to-point comes with ``MultiNodeChainList``)."""

from chainermn_torch.functions.collective_communication import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)

__all__ = ["allreduce", "allgather", "alltoall", "bcast", "gather",
           "scatter"]
