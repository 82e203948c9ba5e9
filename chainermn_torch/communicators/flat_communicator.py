"""Flat-buffer strategy (the port of
``chainermn_tpu/communicators/flat_communicator.py``): every gradient
packed into one buffer per dtype, one all-reduce each, unpacked and
divided by the size."""

import torch.distributed as dist

from chainermn_torch.communicators import _memory_utility
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)


class FlatCommunicator(ProcessGroupCommunicator):
    def _mean_leaves(self, leaves: list) -> list:
        buffers, metas = _memory_utility.pack_leaves(leaves)
        for buf in buffers:
            dist.all_reduce(buf, group=self.group)
            buf.mul_(1.0 / self.size)
        return _memory_utility.unpack_leaves(buffers, metas)


__all__ = ["FlatCommunicator"]
