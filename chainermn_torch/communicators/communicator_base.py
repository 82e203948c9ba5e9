"""ChainerMN's communicator contract over ``torch.distributed`` (the
port's counterpart of ``chainermn_tpu/communicators/communicator_base.py``).

The JAX package runs one controller over a device mesh, so its eager
collectives take rank-major arrays. The port runs one process per rank,
as ChainerMN did: every collective takes this rank's tensor and returns
this rank's result. Array collectives ride the communicator's process
group (NCCL on the card, gloo on the CPU); object communication rides a
gloo group beside it, as ChainerMN's rode MPI beside NCCL.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Sequence

ReduceOp = str  # 'sum' | 'mean' | 'max' | 'min' | 'prod'


class CommunicatorBase(abc.ABC):
    """The contract every communicator implements. Strategies differ only
    in how :meth:`multi_node_mean_grad` moves bytes."""

    # ------------------------------------------------------------------ #
    # Topology                                                            #
    # ------------------------------------------------------------------ #

    @property
    @abc.abstractmethod
    def rank(self) -> int:
        """This process's rank in the communicator."""

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

    # ------------------------------------------------------------------ #
    # Array collectives: this rank's tensor in, this rank's result out    #
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def allreduce(self, x, op: ReduceOp = "sum"):
        """A new tensor holding the reduction of every rank's ``x``."""

    @abc.abstractmethod
    def bcast(self, x, root: int = 0):
        """Root's ``x`` on every rank (``x`` may be ``None`` elsewhere)."""

    @abc.abstractmethod
    def gather(self, x, root: int = 0):
        """The ``[size, ...]`` stack of every rank's ``x`` at root,
        ``None`` elsewhere."""

    @abc.abstractmethod
    def allgather(self, x):
        """The ``[size, ...]`` stack of every rank's ``x`` on every rank."""

    @abc.abstractmethod
    def scatter(self, x, root: int = 0):
        """Slice ``i`` of root's ``[size, ...]`` tensor on rank ``i``
        (``x`` may be ``None`` off the root)."""

    @abc.abstractmethod
    def alltoall(self, x):
        """Rank i's slice j goes to rank j's slice i (``x`` is
        ``[size, ...]``)."""

    @abc.abstractmethod
    def send(self, x, dest: int, tag: int = 0) -> None:
        """Host point-to-point send of a tensor or a list/tuple/dict tree
        of tensors: a header with the structure, shapes and dtypes first,
        then one buffer a leaf."""

    @abc.abstractmethod
    def recv(self, source: int, tag: int = 0):
        """Receive a tree sent by :meth:`send`, on this rank's device."""

    # ------------------------------------------------------------------ #
    # Object communication (pickled, host side)                           #
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None: ...

    @abc.abstractmethod
    def recv_obj(self, source: int, tag: int = 0) -> Any: ...

    @abc.abstractmethod
    def bcast_obj(self, obj: Any, root: int = 0) -> Any: ...

    @abc.abstractmethod
    def gather_obj(self, obj: Any, root: int = 0) -> list[Any] | None: ...

    @abc.abstractmethod
    def allgather_obj(self, obj: Any) -> list[Any]: ...

    @abc.abstractmethod
    def allreduce_obj(self, obj: Any,
                      reduce_func: Callable | None = None) -> Any: ...

    @abc.abstractmethod
    def scatter_obj(self, objs: Sequence[Any] | None,
                    root: int = 0) -> Any: ...

    @abc.abstractmethod
    def barrier(self) -> None:
        """Wait until every rank of the communicator arrives."""

    # ------------------------------------------------------------------ #
    # Model helpers                                                       #
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def bcast_data(self, model):
        """Rank 0's parameters and buffers to every rank, in place."""

    @abc.abstractmethod
    def multi_node_mean_grad(self, grads, zero_fill: bool = False):
        """The mean over ranks of each gradient in a sequence of tensors,
        as a new list (``None`` entries stay ``None``)."""

    def allreduce_grad(self, grads, zero_fill: bool = False):
        """Backward-compatible alias (the older reference name)."""
        return self.multi_node_mean_grad(grads, zero_fill)

    # ------------------------------------------------------------------ #
    # Topology surgery and lifecycle                                      #
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def split(self, color: int, key: int | None = None) -> "CommunicatorBase":
        """A communicator over the ranks that pass the same ``color``."""

    @abc.abstractmethod
    def finalize(self) -> None:
        """Release the process groups this communicator created."""


__all__ = ["CommunicatorBase", "ReduceOp"]
