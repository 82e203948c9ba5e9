"""Differentiable collectives as ``torch.autograd.Function``s (the port
of ``chainermn_tpu/functions/collective_communication.py``).

Each backward is the transpose of its forward, as the reference derives
them from JAX's transpose rules:

- ``allreduce`` (sum) <-> a sum all-reduce of the cotangents (mean: the
  mean all-reduce);
- ``allgather`` <-> a reduce-scatter-sum of the ``[size, ...]``
  cotangent;
- ``alltoall`` <-> ``alltoall``;
- ``bcast`` <-> the cotangents summed onto root (zeros elsewhere);
- ``gather`` <-> root's cotangent slices scattered back;
- ``scatter`` <-> the cotangents gathered onto root (zeros elsewhere).

Every rank must run the backward of a collective whose forward it ran:
the backward is a collective too. So pass an ``x`` that requires grad on
every rank (off the root, ``bcast`` and ``scatter`` read only its
presence), and on the ranks other than root put the empty tensor that
``gather`` returns there (ChainerMN's delegate variable) into the loss,
e.g. ``loss = loss + y.sum()``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, op):
        ctx.comm, ctx.op = comm, op
        return comm.allreduce(x, op)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.allgather(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty(g.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), g.view(-1),
                                   group=ctx.comm.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.alltoall(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.alltoall(g), None


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x, root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g, "sum")
        if ctx.comm.rank != ctx.root:
            total = total.zero_() if ctx.needs_input_grad[0] else None
        return total, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root):
        ctx.comm, ctx.root = comm, root
        out = comm.gather(x, root)
        return out if out is not None else x.new_empty(0)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.scatter(g if ctx.comm.rank == ctx.root else None,
                                ctx.root), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root):
        ctx.comm, ctx.root = comm, root
        ctx.shape = None if x is None else x.shape
        return comm.scatter(x, root)

    @staticmethod
    def backward(ctx, g):
        stacked = ctx.comm.gather(g, ctx.root)
        if stacked is None and ctx.needs_input_grad[0]:
            stacked = g.new_zeros(ctx.shape)
        return stacked, None, None


def allreduce(x, communicator, op: str = "sum"):
    """Differentiable all-reduce (``op`` 'sum' or 'mean'): the backward
    is the same all-reduce of the cotangents. (ChainerMN's divided by the
    size in backward; the reference keeps the forward op's symmetry.)"""
    if op not in ("sum", "mean"):
        raise ValueError(f"differentiable allreduce takes op 'sum' or "
                         f"'mean', not {op!r}")
    return _AllReduce.apply(x, communicator, op)


def allgather(x, communicator):
    """Differentiable all-gather to ``[size, ...]``; the backward
    reduce-scatters the cotangent back to each rank's slice."""
    return _AllGather.apply(x, communicator)


def alltoall(x, communicator):
    """Differentiable all-to-all of a ``[size, ...]`` tensor."""
    return _AllToAll.apply(x, communicator)


def bcast(x, communicator, root: int = 0):
    """Differentiable broadcast of root's ``x``; the backward sums every
    rank's cotangent onto root."""
    return _Bcast.apply(x, communicator, root)


def gather(x, communicator, root: int = 0):
    """Differentiable gather: the ``[size, ...]`` stack at root, an empty
    tensor that carries the graph elsewhere (see the module docstring)."""
    return _Gather.apply(x, communicator, root)


def scatter(x, communicator, root: int = 0):
    """Differentiable scatter of root's ``[size, ...]`` tensor; the
    backward gathers the cotangents onto root."""
    return _Scatter.apply(x, communicator, root)


__all__ = ["allreduce", "allgather", "alltoall", "bcast", "gather",
           "scatter"]
