"""Flat-buffer strategy (the port of
``chainermn_tpu/communicators/flat_communicator.py``): every gradient
packed into one buffer per dtype, one all-reduce each, unpacked and
divided by the size."""

from chainermn_torch.communicators import _memory_utility
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)


class FlatCommunicator(ProcessGroupCommunicator):
    def _mean_leaves(self, leaves: list) -> list:
        buffers, metas = _memory_utility.pack_leaves(leaves)
        means = [self._all_reduce(buf, copy=False).mul_(1.0 / self.size)
                 for buf in buffers]
        return _memory_utility.unpack_leaves(means, metas)


__all__ = ["FlatCommunicator"]
