"""The flagship strategy: one flat all-reduce per dtype over every rank,
with an optional narrower wire dtype (``allreduce_grad_dtype``).

Port of ``chainermn_tpu/communicators/tpu_communicator.py``, itself the
counterpart of ChainerMN's ``pure_nccl`` strategy: gradients are packed
into one buffer per dtype, cast to the wire dtype when there is more than
one rank (a one-rank group has no wire, and the cast would only lose
bits), summed with one collective, cast back and scaled by ``1/size``.
The collectives are ``torch.distributed``'s: NCCL for a CUDA device, gloo
for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from chainermn_torch._device import resolve_device
from chainermn_torch.communicators import _memory_utility
from chainermn_torch.communicators.communicator_base import (
    CommunicatorBase,
    ReduceOp,
)

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "prod": dist.ReduceOp.PRODUCT}
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, getattr(dtype, "name", None) or str(dtype))


class PureNcclCommunicator(CommunicatorBase):
    """Communicator over the default ``torch.distributed`` process group.

    When no group is initialised it starts one: from ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` (with ``MASTER_PORT``) when they are
    set, otherwise as a one-rank group on an in-process store. The backend
    is NCCL for a CUDA ``device`` and gloo for the CPU; ``device`` is the
    current CUDA card when ``None`` (raises when there is none — pass
    ``device="cpu"``). :meth:`finalize` ends a group it started."""

    def __init__(self, device=None, allreduce_grad_dtype=None) -> None:
        self.device = resolve_device(device)
        self.allreduce_grad_dtype = _torch_dtype(allreduce_grad_dtype)
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            if all(k in os.environ for k in _ENV):
                dist.init_process_group(
                    backend, init_method="env://",
                    rank=int(os.environ["RANK"]),
                    world_size=int(os.environ["WORLD_SIZE"]))
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        self._intra_size = int(os.environ.get("LOCAL_WORLD_SIZE", self._size))
        self._intra_rank = int(os.environ.get("LOCAL_RANK",
                                              self._rank % self._intra_size))

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def intra_rank(self) -> int:
        return self._intra_rank

    @property
    def intra_size(self) -> int:
        return self._intra_size

    @property
    def inter_rank(self) -> int:
        return self._rank // self._intra_size

    @property
    def inter_size(self) -> int:
        return self._size // self._intra_size

    def allreduce(self, x, op: ReduceOp = "sum"):
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}; use one of "
                             f"{sorted(_OPS)}")
        y = x.detach().clone()
        dist.all_reduce(y, op=_OPS[op])
        return y / self._size if op == "mean" else y

    @torch.no_grad()
    def bcast_data(self, model):
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
        return model

    @torch.no_grad()
    def multi_node_mean_grad(self, grads, zero_fill: bool = False):
        """Means of a sequence of gradient tensors, as a new list;
        ``None`` entries stay ``None`` (``zero_fill`` is accepted for
        signature parity and ignored, as in the reference). The means are
        views of one flat buffer per dtype."""
        del zero_fill
        leaves = list(grads)
        live = [i for i, g in enumerate(leaves) if g is not None]
        buffers, metas = _memory_utility.pack_leaves(
            [leaves[i] for i in live])
        wire = self.allreduce_grad_dtype if self._size > 1 else None
        out = []
        for buf in buffers:
            orig = buf.dtype
            if wire is not None and orig != wire:
                buf = buf.to(wire)
            dist.all_reduce(buf)
            out.append(buf.to(orig).mul_(1.0 / self._size))
        means = list(leaves)
        for i, m in zip(live, _memory_utility.unpack_leaves(out, metas)):
            means[i] = m
        return means

    def finalize(self) -> None:
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} rank={self._rank} size={self._size}"
                f" device={self.device}>")


__all__ = ["PureNcclCommunicator"]
