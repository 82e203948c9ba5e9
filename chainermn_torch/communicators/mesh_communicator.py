"""A communicator over a named rank mesh (the part of
``chainermn_tpu/communicators/mesh_communicator.py:103-216`` that sequence
and tensor parallelism need).

Its own collectives run over every rank of the mesh, its gradient mean
packed into one all-reduce per dtype (the flat strategy). Each axis is
one ``torch.distributed`` group per coordinate of the other axes; :meth:`MeshCommunicator.axis` hands out this rank's
group along an axis as a communicator, whose ``rank`` is the axis index
(``lax.axis_index``) and whose ``size`` the axis size. While the
communicator lives its axis names are bound
(:func:`chainermn_torch.parallel.mesh.resolve_axis`), so a model built
with ``sequence_axis="sp"`` or ``tensor_axis="tp"`` finds its groups.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from chainermn_torch.communicators.flat_communicator import FlatCommunicator
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)
from chainermn_torch.parallel import mesh as mesh_lib


class MeshCommunicator(FlatCommunicator):
    """``MeshCommunicator(mesh=None, device=None)``: ``mesh`` is a
    :class:`~chainermn_torch.parallel.mesh.RankMesh` over the world's
    ranks (default: :func:`~chainermn_torch.parallel.mesh.make_3d_mesh`
    of the world size). Joins the default group, or starts it as
    :class:`ProcessGroupCommunicator` does; every rank must build the
    same mesh."""

    def __init__(self, mesh: Optional[mesh_lib.RankMesh] = None, *,
                 device=None) -> None:
        super().__init__(device=device)
        world = dist.get_world_size()
        if mesh is None:
            mesh = mesh_lib.make_3d_mesh(world,
                                         local_world_size=self._intra_size)
        if mesh.size != world or sorted(mesh.ranks.flat) != list(range(world)):
            raise ValueError(f"mesh {mesh.shape} does not cover the "
                             f"{world} ranks of the world")
        self._mesh = mesh
        self._geom = mesh_lib.RankGeometry.from_mesh(
            mesh, dist.get_rank(), self._intra_size)
        me = dist.get_rank()
        self._axes = {}
        for name in mesh.axis_names:   # the same calls in the same order
            for ranks in mesh.axis_groups(name):   # on every rank
                g = self._new_group(ranks)
                obj_group = self._obj_group(g, ranks)
                if me in ranks:
                    sub = self._sub_communicator(ProcessGroupCommunicator)
                    sub._attach(g, obj_group, ranks, split=True)
                    self._axes[name] = sub
        mesh_lib.bind_axes(self._axes)

    @property
    def mesh(self) -> mesh_lib.RankMesh:
        return self._mesh

    @property
    def axis_name(self) -> tuple:
        """The mesh's axis names (the reference's tuple ``axis_name``)."""
        return self._mesh.axis_names

    @property
    def geometry(self) -> mesh_lib.RankGeometry:
        return self._geom

    def axis(self, name: str) -> ProcessGroupCommunicator:
        """This rank's group along axis ``name``, as a communicator."""
        if name not in self._axes:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{self._mesh.axis_names}")
        return self._axes[name]

    def axis_index(self, name: str) -> int:
        """This rank's index along axis ``name`` (``lax.axis_index``)."""
        return self.axis(name).rank

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def finalize(self) -> None:
        mesh_lib.unbind_axes(self._axes)
        self._axes = {}
        super().finalize()

    def __repr__(self) -> str:
        return (f"<MeshCommunicator rank={self.rank} mesh={self._mesh.shape} "
                f"device={self.device}>")


__all__ = ["MeshCommunicator"]
