"""The part of ChainerMN's communicator contract that training uses, over
``torch.distributed`` (the port's subset of
``chainermn_tpu/communicators/communicator_base.py``).

The JAX package runs one controller over a device mesh, so its eager
collectives take rank-major arrays. The port runs one process per rank,
as ChainerMN did: every collective takes this rank's tensor and returns
this rank's result.
"""

from __future__ import annotations

import abc

ReduceOp = str  # 'sum' | 'mean' | 'max' | 'min' | 'prod'


class CommunicatorBase(abc.ABC):
    """Topology, the array reduction, and the model helpers of the
    data-parallel step."""

    @property
    @abc.abstractmethod
    def rank(self) -> int:
        """This process's rank."""

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of ranks."""

    @property
    @abc.abstractmethod
    def intra_rank(self) -> int:
        """Rank within the node (the GPU index on the host)."""

    @property
    @abc.abstractmethod
    def intra_size(self) -> int:
        """Ranks per node."""

    @property
    @abc.abstractmethod
    def inter_rank(self) -> int:
        """Node index."""

    @property
    @abc.abstractmethod
    def inter_size(self) -> int:
        """Number of nodes."""

    @abc.abstractmethod
    def allreduce(self, x, op: ReduceOp = "sum"):
        """Reference ``allreduce``: a new tensor holding the reduction of
        every rank's ``x``."""

    @abc.abstractmethod
    def bcast_data(self, model):
        """Reference ``bcast_data(model)``: rank 0's parameters and
        buffers to every rank, in place."""

    @abc.abstractmethod
    def multi_node_mean_grad(self, grads, zero_fill: bool = False):
        """Reference ``multi_node_mean_grad``: the mean over ranks of each
        gradient in a sequence of tensors."""

    def allreduce_grad(self, grads, zero_fill: bool = False):
        """Backward-compatible alias (the older reference name)."""
        return self.multi_node_mean_grad(grads, zero_fill)

    @abc.abstractmethod
    def finalize(self) -> None:
        """Release the process group this communicator started."""


__all__ = ["CommunicatorBase", "ReduceOp"]
