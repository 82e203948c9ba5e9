"""The flagship strategy: one flat all-reduce per dtype over every rank,
with an optional narrower wire dtype (``allreduce_grad_dtype``).

Port of ``chainermn_tpu/communicators/tpu_communicator.py``, itself the
counterpart of ChainerMN's ``pure_nccl`` strategy: gradients are packed
into one buffer per dtype, cast to the wire dtype when there is more than
one rank (a one-rank group has no wire, and the cast would only lose
bits), summed with one collective, cast back and scaled by ``1/size``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from chainermn_torch.communicators import _memory_utility
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, getattr(dtype, "name", None) or str(dtype))


class PureNcclCommunicator(ProcessGroupCommunicator):
    """Packed all-reduce per dtype; ``allreduce_grad_dtype`` (e.g.
    ``torch.bfloat16``) is the wire dtype of gradient averaging."""

    def __init__(self, device=None, allreduce_grad_dtype=None) -> None:
        super().__init__(device)
        self.allreduce_grad_dtype = _torch_dtype(allreduce_grad_dtype)

    def _copy_strategy_state(self, sub) -> None:
        sub.allreduce_grad_dtype = self.allreduce_grad_dtype

    def _mean_leaves(self, leaves: list) -> list:
        buffers, metas = _memory_utility.pack_leaves(leaves)
        wire = self.allreduce_grad_dtype if self.size > 1 else None
        out = []
        for buf in buffers:
            orig = buf.dtype
            if wire is not None and orig != wire:
                buf = buf.to(wire)
            dist.all_reduce(buf, group=self.group)
            out.append(buf.to(orig).mul_(1.0 / self.size))
        return _memory_utility.unpack_leaves(out, metas)


__all__ = ["PureNcclCommunicator"]
