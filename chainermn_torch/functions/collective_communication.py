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
- ``scatter`` <-> the cotangents gathered onto root (zeros elsewhere);
- ``ppermute`` along a permutation <-> ``ppermute`` along its inverse;
- ``all_to_all`` splitting one axis and concatenating another <-> the
  swapped exchange;
- the Megatron pair over a tensor-parallel group:
  :func:`copy_to_parallel_region` (Megatron's *f*: identity forward,
  sum all-reduce backward) and :func:`reduce_from_parallel_region`
  (*g*: sum all-reduce forward, identity backward).

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
        # a gloo group stages CUDA tensors through the host, as the
        # communicator's own collectives do
        to_wire = getattr(ctx.comm, "_to_wire", None)
        g, back = (to_wire(g, copy=False) if to_wire is not None
                   else (g, lambda y: y))
        out = g.new_empty(g.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), g.view(-1),
                                   group=ctx.comm.group)
        return back(out), None


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


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, perm):
        ctx.comm, ctx.perm = comm, perm
        return comm.ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.ppermute(g, [(d, s) for s, d in ctx.perm]), None, None


def _exchange(x, comm, split_axis: int, concat_axis: int):
    """The tiled all-to-all: ``x``'s ``split_axis`` cut into ``size``
    chunks, chunk ``j`` sent to rank ``j``, and the chunks received
    concatenated in rank order along ``concat_axis``."""
    n = comm.size
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)}"
                         f" does not split into {n} chunks")
    parts = x.unflatten(split_axis, (n, x.shape[split_axis] // n))
    got = comm.alltoall(parts.movedim(split_axis, 0))   # [n(source), ...]
    return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return _exchange(x, comm, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_exchange(g, ctx.comm, concat_axis, split_axis), None, None,
                None)


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g, "sum"), None


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.allreduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def ppermute(x, communicator, perm):
    """Differentiable ``ppermute`` (``lax.ppermute``): ``perm`` is a list
    of ``(source, dest)`` ranks; the backward sends the cotangents back
    along the inverse permutation."""
    return _PPermute.apply(x, communicator, [tuple(p) for p in perm])


def all_to_all(x, communicator, split_axis: int, concat_axis: int):
    """Differentiable tiled all-to-all (``lax.all_to_all(..., tiled=True)``):
    ``split_axis`` is cut into ``size`` chunks, chunk ``j`` goes to rank
    ``j``, and what arrives is concatenated along ``concat_axis``. The
    backward is the swapped exchange."""
    return _AllToAllTiled.apply(x, communicator, split_axis, concat_axis)


def copy_to_parallel_region(x, communicator):
    """Megatron's *f*: the identity forward, the cotangents summed over
    the tensor-parallel group in the backward. It stands where a
    replicated activation enters column-parallel layers."""
    return _CopyToParallel.apply(x, communicator)


def reduce_from_parallel_region(x, communicator):
    """Megatron's *g*: the partial results summed over the group in the
    forward, the identity backward. It closes a row-parallel layer."""
    return _ReduceFromParallel.apply(x, communicator)


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


__all__ = ["allreduce", "allgather", "alltoall", "all_to_all", "bcast",
           "copy_to_parallel_region", "gather", "ppermute",
           "reduce_from_parallel_region", "scatter"]
