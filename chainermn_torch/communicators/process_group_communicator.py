"""The concrete core of the port's communicators: every collective of the
contract over one ``torch.distributed`` process group (the port's
counterpart of ``chainermn_tpu/communicators/mesh_communicator.py``).

The group is NCCL for a CUDA device and gloo for the CPU; object
communication rides a gloo group over the same ranks. The topology is
ChainerMN's: ``LOCAL_WORLD_SIZE`` consecutive ranks form a node (all
ranks when it is unset). Strategy subclasses differ only in
:meth:`_mean_leaves`; this class's is the naive strategy, one all-reduce
per gradient (``mesh_communicator.py:636-641``).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from chainermn_torch._device import resolve_device
from chainermn_torch.communicators._object_comm import ObjectComm
from chainermn_torch.communicators.communicator_base import (
    CommunicatorBase,
    ReduceOp,
)
from chainermn_torch.monitor.annotations import annotate

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "prod": dist.ReduceOp.PRODUCT}
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# collectives of CUDA tensors over a gloo group (gloo moves no CUDA tensor
# in point-to-point or all-to-all, so the communicator stages them through
# the host itself): the bytes copied between the card and the host, both
# directions, and the seconds from the copy off the card to the copy back
HOST_STAGED = {"bytes": 0, "seconds": 0.0}


def _annotated(name: str):
    """Run the collective under ``annotate("chainermn.<name>")``: a named
    host region in a ``torch.profiler`` trace, free when none runs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with annotate(name):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


class _MessageType(NamedTuple):
    """The header :meth:`ProcessGroupCommunicator.send` sends before the
    leaves (the reference's ``_MessageType``)."""

    treedef: Any
    shapes: tuple
    dtypes: tuple


def _flatten(x) -> tuple[list, Any]:
    """Leaves and structure of a tensor or a list/tuple/dict tree."""
    if isinstance(x, torch.Tensor):
        return [x], None
    if isinstance(x, (list, tuple)):
        kind, keys, children = type(x), None, list(x)
    elif isinstance(x, dict):
        kind, keys, children = dict, list(x), list(x.values())
    else:
        raise TypeError(f"send takes tensors and list/tuple/dict trees of "
                        f"tensors, not {type(x).__name__}")
    leaves, defs = [], []
    for c in children:
        ls, d = _flatten(c)
        leaves += ls
        defs.append((len(ls), d))
    return leaves, (kind, keys, defs)


def _unflatten(leaves: list, treedef):
    if treedef is None:
        return leaves[0]
    kind, keys, defs = treedef
    out, at = [], 0
    for n, d in defs:
        out.append(_unflatten(leaves[at:at + n], d))
        at += n
    return dict(zip(keys, out)) if kind is dict else kind(out)


def _start_default_group(device: torch.device) -> None:
    """NCCL for a CUDA device, gloo for the CPU; from ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` (with ``MASTER_PORT``) when they are
    set, otherwise a one-rank group on an in-process store."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if all(k in os.environ for k in _ENV):
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


class ProcessGroupCommunicator(CommunicatorBase):
    """Communicator over the default ``torch.distributed`` group, which it
    starts when none is initialised (see :func:`_start_default_group`);
    :meth:`finalize` ends a group it started and the groups it created.
    ``device`` is the current CUDA card when ``None`` (raises when there
    is none — pass ``device="cpu"``)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._owns_default = not dist.is_initialized()
        if self._owns_default:
            _start_default_group(self.device)
        world = dist.get_world_size()
        self._intra_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if self._intra_size < 1 or world % self._intra_size:
            raise ValueError(f"LOCAL_WORLD_SIZE={self._intra_size} does not "
                             f"divide the world size {world}")
        self._created: list = []
        ranks = list(range(world))
        self._attach(None, self._obj_group(None, ranks), ranks, split=False)

    def _attach(self, group, obj_group, ranks: list[int], *,
                split: bool) -> None:
        """Bind this communicator to ``group`` over the global ``ranks``,
        with ``obj_group`` for object communication."""
        self._group = group
        self._ranks = ranks
        self._split = split
        self._obj = ObjectComm(obj_group, ranks)
        self._rank = self._obj.rank
        self._size = len(ranks)
        self._mailbox: dict[int, list] = {}
        self._stage = (self.device.type == "cuda"
                       and dist.get_backend(group) == "gloo")

    def _new_group(self, ranks: list[int], backend=None):
        """``dist.new_group`` over global ``ranks``; every rank of the
        world must make the same calls in the same order."""
        g = dist.new_group(ranks, backend=backend)
        self._created.append(g)
        return g

    def _obj_group(self, group, ranks: list[int]):
        """The object channel beside ``group``: the group itself when it
        is gloo, else a new gloo group over the same ranks."""
        if dist.get_backend() == "gloo":
            return group
        return self._new_group(ranks, backend="gloo")

    # ------------------------------------------------------------------ #
    # Topology                                                            #
    # ------------------------------------------------------------------ #

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def intra_rank(self) -> int:
        """The process's place on its node (split communicators keep the
        process's geometry, as in the reference)."""
        return int(os.environ.get("LOCAL_RANK",
                                  dist.get_rank() % self._intra_size))

    @property
    def intra_size(self) -> int:
        return self._intra_size

    @property
    def inter_rank(self) -> int:
        return dist.get_rank() // self._intra_size

    @property
    def inter_size(self) -> int:
        return dist.get_world_size() // self._intra_size

    @property
    def group(self):
        """The ``torch.distributed`` group of the array collectives (the
        port's counterpart of the reference's ``axis_name``); ``None`` is
        the default group."""
        return self._group

    def _global(self, r: int) -> int:
        if not 0 <= r < self._size:
            raise ValueError(f"rank {r} out of range for {self._size} ranks")
        return self._ranks[r]

    # ------------------------------------------------------------------ #
    # Array collectives                                                   #
    # ------------------------------------------------------------------ #

    def allreduce(self, x, op: ReduceOp = "sum"):
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}; use one of "
                             f"{sorted(_OPS)}")
        with annotate(f"chainermn.allreduce_{op}"):
            y = self._all_reduce(x, _OPS[op])
            return y / self._size if op == "mean" else y

    def _all_reduce(self, x, op=dist.ReduceOp.SUM, copy: bool = True):
        """The reduction of every rank's ``x``: a new tensor, or, with
        ``copy=False`` (the caller owns ``x``), ``x`` itself reduced in
        place unless it is staged through the host."""
        y, back = self._to_wire(x, copy)
        dist.all_reduce(y, op=op, group=self._group)
        return back(y)

    def _to_wire(self, x, copy: bool = True):
        """``x`` as the group's backend can move it, and the function that
        brings a result back to ``x``'s device: a CUDA tensor over a gloo
        group goes through the host, counted in ``HOST_STAGED``; any other
        is ``x`` itself, or a fresh copy of it when ``copy`` (the backend
        writes into it)."""
        if not (self._stage and x.is_cuda):
            return (x.detach().clone() if copy else x.detach()), lambda y: y
        torch.cuda.synchronize(x.device)   # the card's queue is not ours
        t0 = time.perf_counter()
        HOST_STAGED["bytes"] += x.numel() * x.element_size()
        dev = x.device

        def back(y):
            HOST_STAGED["bytes"] += y.numel() * y.element_size()
            y = y.to(dev)
            HOST_STAGED["seconds"] += time.perf_counter() - t0
            return y

        return x.detach().cpu(), back

    def _like_root(self, x, root: int, slice0: bool):
        """Root's tensor header (shape, dtype) on every rank, and an
        empty buffer of it here; ``slice0`` drops the leading axis."""
        head = None
        if self._rank == root:
            head = (tuple(x.shape[1:] if slice0 else x.shape), x.dtype)
        shape, dtype = self._obj.bcast_obj(head, root)
        return torch.empty(shape, dtype=dtype, device=self.device)

    @_annotated("chainermn.bcast")
    def bcast(self, x, root: int = 0):
        buf = self._like_root(x, root, slice0=False)
        if self._rank == root:
            buf.copy_(x.detach())
        dist.broadcast(buf, self._global(root), group=self._group)
        return buf

    def gather(self, x, root: int = 0):
        x = x.detach().contiguous()
        out = None
        if self._rank == root:
            out = x.new_empty((self._size,) + tuple(x.shape))
        dist.gather(x, None if out is None else list(out.unbind(0)),
                    dst=self._global(root), group=self._group)
        return out

    @_annotated("chainermn.allgather")
    def allgather(self, x):
        shape = (self._size,) + tuple(x.shape)
        x, back = self._to_wire(x.contiguous(), copy=False)
        out = x.new_empty((self._size * x.numel(),))
        dist.all_gather_into_tensor(out, x.reshape(-1), group=self._group)
        return back(out).view(shape)

    @_annotated("chainermn.scatter")
    def scatter(self, x, root: int = 0):
        if self._rank == root and x.shape[0] != self._size:
            raise ValueError(f"scatter input leading axis {x.shape[0]} != "
                             f"comm size {self._size}")
        out = self._like_root(x, root, slice0=True)
        parts = None
        if self._rank == root:
            parts = [p.contiguous() for p in x.detach().unbind(0)]
        dist.scatter(out, parts, src=self._global(root), group=self._group)
        return out

    @_annotated("chainermn.alltoall")
    def alltoall(self, x):
        if x.shape[0] != self._size:
            raise ValueError(f"alltoall input leading axis {x.shape[0]} != "
                             f"comm size {self._size}")
        x, back = self._to_wire(x.contiguous(), copy=False)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group)
        return back(out)

    @_annotated("chainermn.ppermute")
    def ppermute(self, x, perm):
        """Each rank's ``x`` moved along ``perm``, a list of ``(source,
        dest)`` pairs of this communicator's ranks (``lax.ppermute``): the
        result is what this rank's source sent, zeros where no pair ends
        here. The send and the receive are posted together, so a ring
        does not deadlock on two ranks."""
        perm = [(int(s), int(d)) for s, d in perm]
        dest = [d for s, d in perm if s == self._rank]
        source = [s for s, d in perm if d == self._rank]
        if len(dest) > 1 or len(source) > 1 or len(
                {s for s, _ in perm}) != len(perm) or len(
                {d for _, d in perm}) != len(perm):
            raise ValueError(f"ppermute needs a permutation, got {perm}")
        if dest == [self._rank] and source == [self._rank]:
            return x.detach().clone()
        buf, back = self._to_wire(x.contiguous(), copy=False)
        out = torch.zeros_like(buf)
        ops = []
        if dest:
            ops.append(dist.P2POp(dist.isend, buf, self._global(dest[0]),
                                  self._group))
        if source:
            ops.append(dist.P2POp(dist.irecv, out, self._global(source[0]),
                                  self._group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return back(out) if source else torch.zeros_like(x)

    def send(self, x, dest: int, tag: int = 0) -> None:
        leaves, treedef = _flatten(x)
        header = _MessageType(treedef, tuple(tuple(t.shape) for t in leaves),
                              tuple(t.dtype for t in leaves))
        if dest == self._rank:
            # fresh buffers, as a remote receiver gets
            self._mailbox.setdefault(tag, []).append(
                (header, [t.detach().clone() for t in leaves]))
            return
        self._obj.send_obj(header, dest, tag)
        for t in leaves:
            self._obj.send_tensor(t, dest, tag)

    def recv(self, source: int, tag: int = 0):
        if source == self._rank:
            queue = self._mailbox.get(tag)
            if not queue:
                raise RuntimeError(f"recv(source={source}, tag={tag}): "
                                   "nothing sent")
            header, leaves = queue.pop(0)
        else:
            header = self._obj.recv_obj(source, tag)
            if not isinstance(header, _MessageType):
                raise RuntimeError(
                    f"recv(source={source}, tag={tag}): expected a "
                    f"_MessageType header, got {type(header).__name__} — "
                    "pair comm.recv with comm.send (recv_obj with send_obj)")
            leaves = [self._obj.recv_tensor(s, d, source, tag).to(self.device)
                      for s, d in zip(header.shapes, header.dtypes)]
        return _unflatten(leaves, header.treedef)

    # ------------------------------------------------------------------ #
    # Object communication                                                #
    # ------------------------------------------------------------------ #

    def send_obj(self, obj, dest: int, tag: int = 0) -> None:
        self._obj.send_obj(obj, dest, tag)

    def recv_obj(self, source: int, tag: int = 0):
        return self._obj.recv_obj(source, tag)

    def bcast_obj(self, obj, root: int = 0):
        return self._obj.bcast_obj(obj, root)

    def gather_obj(self, obj, root: int = 0):
        return self._obj.gather_obj(obj, root)

    def allgather_obj(self, obj):
        return self._obj.allgather_obj(obj)

    def allreduce_obj(self, obj, reduce_func: Optional[Callable] = None):
        return self._obj.allreduce_obj(obj, reduce_func)

    def scatter_obj(self, objs, root: int = 0):
        return self._obj.scatter_obj(objs, root)

    def barrier(self) -> None:
        self._obj.barrier()

    # ------------------------------------------------------------------ #
    # Model helpers                                                       #
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def bcast_data(self, model):
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, self._global(0), group=self._group)
        return model

    def _mean_leaves(self, leaves: list) -> list:
        """Strategy hook: a list of gradients -> their means over ranks.
        Here: one all-reduce a gradient (the naive strategy)."""
        return [self._all_reduce(g).mul_(1.0 / self._size) for g in leaves]

    @torch.no_grad()
    def multi_node_mean_grad(self, grads, zero_fill: bool = False):
        """``zero_fill`` is accepted for signature parity and ignored, as
        in the reference."""
        del zero_fill
        means = list(grads)
        live = [i for i, g in enumerate(means) if g is not None]
        for i, m in zip(live, self._mean_leaves([means[i] for i in live])):
            means[i] = m
        return means

    # ------------------------------------------------------------------ #
    # Split and lifecycle                                                 #
    # ------------------------------------------------------------------ #

    def split(self, color: int, key: Optional[int] = None):
        """A communicator of this class over the ranks that pass the same
        ``color`` (every rank calls it). Ranks keep their order within a
        color: ``key`` is accepted and ignored, as in the reference
        (``torch.distributed`` orders a group's ranks itself). A split
        communicator keeps the process's node geometry, and the two-level
        strategies fall back to one all-reduce a gradient on it."""
        del key
        colors = self._obj.allgather_obj(color)
        sub = self._sub_communicator(type(self))
        mine = None
        for c in sorted(set(colors)):
            ranks = [self._ranks[r] for r, rc in enumerate(colors) if rc == c]
            g = sub._new_group(ranks)
            obj_group = sub._obj_group(g, ranks)
            if c == color:
                mine = (g, obj_group, ranks)
        sub._attach(*mine, split=True)
        self._copy_strategy_state(sub)
        return sub

    def _sub_communicator(self, cls):
        """An unattached communicator of ``cls`` on this process's device
        and node geometry, owning no group yet (``split`` and the mesh
        axes attach it to one)."""
        sub = object.__new__(cls)
        sub.device = self.device
        sub._owns_default = False
        sub._intra_size = self._intra_size
        sub._created = []
        return sub

    def _copy_strategy_state(self, sub) -> None:
        """Hook: copy a strategy's settings onto a split communicator."""

    def finalize(self) -> None:
        if not dist.is_initialized():
            return
        self._obj.wait_sends()
        for g in self._created:
            dist.destroy_process_group(g)
        self._created = []
        if self._owns_default:
            dist.destroy_process_group()
        self._owns_default = False

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} rank={self._rank} size={self._size}"
                f" device={self.device}>")


__all__ = ["ProcessGroupCommunicator"]
