"""Rank meshes and named axes (the port of
``chainermn_tpu/parallel/mesh.py``: ``make_mesh``,
``make_hierarchical_mesh``, ``make_3d_mesh`` and ``RankGeometry``).

The JAX package names mesh axes and binds them inside ``shard_map``. The
port runs one process per rank, so a mesh is a grid of global ranks, and
an axis of it is a ``torch.distributed`` group: this rank's group along
that axis, wrapped in a communicator whose ``rank`` is the axis index (a
Python int) and whose ``size`` is the axis size.
:class:`~chainermn_torch.communicators.MeshCommunicator` builds the
groups and binds each axis name while it lives; :func:`resolve_axis`
turns an axis argument (a name or a communicator) into that
communicator.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np

DEFAULT_AXIS = "ranks"
INTER_AXIS = "inter"   # across nodes
INTRA_AXIS = "intra"   # within a node

_BOUND: dict = {}      # axis name -> the communicator of this rank's group


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A grid of global ranks with one name an axis (the counterpart of a
    ``jax.sharding.Mesh`` over devices)."""

    ranks: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_groups(self, axis: str) -> list:
        """Every group along ``axis``: lists of global ranks in axis
        order, one for each coordinate of the other axes, in row-major
        order of those coordinates."""
        a = self.axis_names.index(axis)
        moved = np.moveaxis(self.ranks, a, -1)
        return [list(map(int, row)) for row in moved.reshape(-1,
                                                             moved.shape[-1])]


def _world(world_size: Optional[int]) -> int:
    return int(world_size if world_size is not None
               else os.environ.get("WORLD_SIZE", 1))


def make_mesh(world_size: Optional[int] = None,
              axis_name: str = DEFAULT_AXIS) -> RankMesh:
    """One flat axis over the ranks ``0 .. world_size-1`` (``WORLD_SIZE``
    when ``None``): the ``pure_nccl`` shape, one ring over every rank."""
    return RankMesh(np.arange(_world(world_size)), (axis_name,))


def make_hierarchical_mesh(world_size: Optional[int] = None,
                           inter_axis: str = INTER_AXIS,
                           intra_axis: str = INTRA_AXIS,
                           local_world_size: Optional[int] = None
                           ) -> RankMesh:
    """The two-level ``inter x intra`` grid of the reference's
    intra-node/inter-node split. With several nodes of
    ``local_world_size`` ranks (``LOCAL_WORLD_SIZE``) each, ``intra`` is a
    node's ranks and ``inter`` crosses nodes; with one node (or a
    ragged count) the rank count is factored into the most square grid,
    as the reference factors one process's devices."""
    n = _world(world_size)
    lws = int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE", n))
    if 0 < lws < n and n % lws == 0:
        grid = (n // lws, lws)
    else:
        inter = int(np.sqrt(n))
        while n % inter:
            inter -= 1
        grid = (inter, n // inter)
    return RankMesh(np.arange(n).reshape(grid), (inter_axis, intra_axis))


def _straddle_warning(shape, proc_counts: dict, n: int):
    """Warning text when an auto-factored (dp, sp, tp) shape's inner axes
    would straddle node boundaries, else None (the reference's
    ``_straddle_warning``; a node is ``LOCAL_WORLD_SIZE`` ranks here)."""
    if len(proc_counts) <= 1:
        return None
    per_proc = min(proc_counts.values())
    _, sp, tp = shape
    sptp = sp * tp
    if per_proc % tp:
        straddler = f"tp={tp}"
    elif per_proc % sptp and sptp % per_proc:
        straddler = f"sp x tp = {sptp}"
    else:
        return None
    return (
        f"make_3d_mesh auto-factored {n} ranks into dp x sp x tp = "
        f"{tuple(shape)}, but {straddler} does not align with the "
        f"{per_proc} ranks per node ({len(proc_counts)} nodes): the inner "
        "axes will straddle node boundaries — pass shape=(dp, sp, tp) with "
        "tp (and ideally sp x tp) dividing the ranks per node")


def balanced_3d_shape(n: int) -> tuple:
    """The most balanced ``(dp, sp, tp)`` factoring of ``n`` (the first
    found of least spread, as the reference's loop picks it)."""
    best = (1, 1, n)
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            cand = (a, b, m // b)
            if max(cand) - min(cand) < max(best) - min(best):
                best = cand
    return best


def make_3d_mesh(world_size: Optional[int] = None,
                 dp_axis: str = "dp", sp_axis: str = "sp",
                 tp_axis: str = "tp", shape: Optional[tuple] = None,
                 local_world_size: Optional[int] = None) -> RankMesh:
    """A ``dp x sp x tp`` grid of the ranks ``0 .. world_size-1``
    (``WORLD_SIZE`` when ``None``), ``tp`` innermost so a tensor-parallel
    group is consecutive ranks of one node. Without ``shape`` the count
    is factored into the most balanced triple, with the reference's
    warning when its inner axes straddle nodes of ``local_world_size``
    ranks (``LOCAL_WORLD_SIZE``, all ranks when unset)."""
    n = _world(world_size)
    if shape is None:
        shape = balanced_3d_shape(n)
        lws = int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE", n))
        counts = {node: min(lws, n - node * lws)
                  for node in range(-(-n // lws))}
        msg = _straddle_warning(shape, counts, n)
        if msg is not None:
            warnings.warn(msg, stacklevel=2)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"shape {shape} does not cover {n} ranks")
    return RankMesh(np.arange(n).reshape(shape), (dp_axis, sp_axis, tp_axis))


@dataclasses.dataclass(frozen=True)
class RankGeometry:
    """Rank geometry of the calling process (the reference's
    ``RankGeometry``). One process drives one rank here, so the device
    ranks it controls are its own rank, and a node is
    ``LOCAL_WORLD_SIZE`` consecutive ranks."""

    size: int
    rank: int
    intra_rank: int
    inter_rank: int
    intra_size: int
    inter_size: int
    process_size: int
    local_device_ranks: tuple

    @classmethod
    def from_mesh(cls, mesh: RankMesh, rank: int,
                  local_world_size: Optional[int] = None) -> "RankGeometry":
        n = mesh.size
        lws = int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE", n))
        if lws < 1 or n % lws:
            raise ValueError(f"LOCAL_WORLD_SIZE={lws} does not divide the "
                             f"{n} ranks of the mesh")
        return cls(size=n, rank=rank, intra_rank=rank % lws,
                   inter_rank=rank // lws, intra_size=lws,
                   inter_size=n // lws, process_size=n,
                   local_device_ranks=(rank,))


def bind_axes(axes: dict) -> None:
    """Bind axis names to communicators (what entering ``shard_map`` does
    to a mesh's axis names in the reference). A name already bound to
    another live communicator raises."""
    for name, comm in axes.items():
        if _BOUND.get(name) not in (None, comm):
            raise ValueError(f"axis {name!r} is already bound to another "
                             "mesh; finalize it first")
    _BOUND.update(axes)


def unbind_axes(axes: dict) -> None:
    for name, comm in axes.items():
        if _BOUND.get(name) is comm:
            del _BOUND[name]


def resolve_axis(axis):
    """The communicator an axis argument names: ``None`` stays ``None``;
    a name gives the communicator bound to it (``None`` when no live
    mesh binds it, as an unbound axis name outside ``shard_map``); a
    communicator is returned as it is."""
    if axis is None or not isinstance(axis, str):
        return axis
    return _BOUND.get(axis)


__all__ = ["RankGeometry", "RankMesh", "balanced_3d_shape", "bind_axes",
           "make_3d_mesh", "resolve_axis", "unbind_axes"]
