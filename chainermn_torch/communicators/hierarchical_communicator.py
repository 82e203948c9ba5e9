"""Two-level (intra-node / inter-node) strategies (the port of
``chainermn_tpu/communicators/hierarchical_communicator.py``).

The intra groups are the nodes' consecutive ranks (``LOCAL_WORLD_SIZE``
of them); the inter groups join the ranks with the same place on every
node. Every rank creates every group, in the same order. On a split
communicator the two-level structure is gone, and both strategies fall
back to one all-reduce a gradient over the split group, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from chainermn_torch.communicators import _memory_utility
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)


class HierarchicalCommunicator(ProcessGroupCommunicator):
    """Sum over the intra group, then over the inter group, times
    ``1/size`` (``hierarchical_communicator.py:48-58``)."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        n_intra, n_inter = self.intra_size, self.inter_size
        node, place = dist.get_rank() // n_intra, dist.get_rank() % n_intra
        for i in range(n_inter):
            g = self._new_group([i * n_intra + j for j in range(n_intra)])
            if i == node:
                self._intra = g
        for j in range(n_intra):
            g = self._new_group([i * n_intra + j for i in range(n_inter)])
            if j == place:
                self._inter = g

    def _mean_leaves(self, leaves: list) -> list:
        if self._split:
            return super()._mean_leaves(leaves)
        out = []
        for g in leaves:
            g = g.detach().clone()
            dist.all_reduce(g, group=self._intra)
            dist.all_reduce(g, group=self._inter)
            out.append(g.mul_(1.0 / self.size))
        return out


class TwoDimensionalCommunicator(HierarchicalCommunicator):
    """On the packed buffer, padded to a multiple of ``intra_size``:
    reduce-scatter over the intra group, all-reduce of the shard over the
    inter group, all-gather over the intra group
    (``hierarchical_communicator.py:79-96``)."""

    def _mean_leaves(self, leaves: list) -> list:
        if self._split:
            return ProcessGroupCommunicator._mean_leaves(self, leaves)
        n_intra = self.intra_size
        buffers, metas = _memory_utility.pack_leaves(leaves)
        out = []
        for buf in buffers:
            n = buf.numel()
            pad = (-n) % n_intra
            if pad:
                buf = torch.cat([buf, buf.new_zeros(pad)])
            shard = buf.new_empty(buf.numel() // n_intra)
            dist.reduce_scatter_tensor(shard, buf, group=self._intra)
            dist.all_reduce(shard, group=self._inter)
            dist.all_gather_into_tensor(buf, shard, group=self._intra)
            out.append(buf[:n].mul_(1.0 / self.size))
        return _memory_utility.unpack_leaves(out, metas)


class SingleNodeCommunicator(ProcessGroupCommunicator):
    """One node only (``hierarchical_communicator.py:103-110``): raises
    when the ranks span more than one node, else the naive strategy."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        if self.inter_size != 1:
            n = self.inter_size
            self.finalize()
            raise RuntimeError(
                f"SingleNodeCommunicator requires a single-node launch (got "
                f"{n} nodes of LOCAL_WORLD_SIZE={self.intra_size}); use "
                "'pure_nccl' or 'hierarchical' across nodes")


__all__ = ["HierarchicalCommunicator", "TwoDimensionalCommunicator",
           "SingleNodeCommunicator"]
