"""AllreducePersistent — sync non-parameter model state across ranks (the
port of ``chainermn_tpu/extensions/allreduce_persistent.py``).

ChainerMN's extension averages every persistent array (BatchNorm running
mean and variance) over the ranks, so evaluation sees the same statistics
on every rank without multi-node BatchNorm. The JAX package averages the
non-``params`` collections of a flax variables dict; here the state is a
module's buffers.
"""

from __future__ import annotations

import torch
from torch import nn

from chainermn_torch.communicators.communicator_base import CommunicatorBase


class AllreducePersistent:
    """Callable extension: ``sync(model)`` replaces every floating-point
    buffer of ``model`` (what is not a parameter: BatchNorm running
    statistics) by its mean over the communicator's ranks, in place, and
    returns ``model``. Integer buffers (torch BatchNorm's
    ``num_batches_tracked``) are counters, not statistics, and stay.
    Every rank calls it."""

    def __init__(self, communicator: CommunicatorBase) -> None:
        self._comm = communicator

    @torch.no_grad()
    def __call__(self, model: nn.Module) -> nn.Module:
        if not isinstance(model, nn.Module):
            raise TypeError(
                f"expected a torch.nn.Module, got {type(model).__name__}")
        for buf in model.buffers():
            if buf.is_floating_point():
                buf.copy_(self._comm.allreduce(buf, "mean"))
        return model


__all__ = ["AllreducePersistent"]
