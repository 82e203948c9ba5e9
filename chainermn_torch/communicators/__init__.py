"""Communicator factory (the port of
``chainermn_tpu/communicators/__init__.py``).

==================  ============================================
name                strategy
==================  ============================================
``naive``           :class:`NaiveCommunicator` (all-reduce a gradient)
``flat``            :class:`FlatCommunicator` (packed, one per dtype)
``pure_nccl``       :class:`PureNcclCommunicator` — the flagship
``tpu``             the same (the JAX package's name for it)
``pure_ici``        the same
``hierarchical``    :class:`HierarchicalCommunicator` (intra, then inter)
``two_dimensional`` :class:`TwoDimensionalCommunicator` (RS/AR/AG)
``single_node``     :class:`SingleNodeCommunicator`
``non_cuda_aware``  :class:`HierarchicalCommunicator`, with a warning
==================  ============================================

:class:`MeshCommunicator` (a named ``dp x sp x tp`` rank mesh with one
group per axis, for sequence and tensor parallelism) is built directly,
as in the reference. Only the flat NCCL strategy takes ``allreduce_grad_dtype``, as in the
reference.
"""

from __future__ import annotations

import warnings

from chainermn_torch.communicators.communicator_base import CommunicatorBase
from chainermn_torch.communicators.flat_communicator import FlatCommunicator
from chainermn_torch.communicators.hierarchical_communicator import (
    HierarchicalCommunicator,
    SingleNodeCommunicator,
    TwoDimensionalCommunicator,
)
from chainermn_torch.communicators.mesh_communicator import MeshCommunicator
from chainermn_torch.communicators.naive_communicator import NaiveCommunicator
from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)
from chainermn_torch.communicators.pure_nccl_communicator import (
    PureNcclCommunicator,
)

_FLAT = ("pure_nccl", "tpu", "pure_ici")
_OTHERS = {"naive": NaiveCommunicator, "flat": FlatCommunicator,
           "hierarchical": HierarchicalCommunicator,
           "non_cuda_aware": HierarchicalCommunicator,
           "two_dimensional": TwoDimensionalCommunicator,
           "single_node": SingleNodeCommunicator}


def create_communicator(communicator_name: str = "pure_nccl", *,
                        device=None,
                        allreduce_grad_dtype=None) -> CommunicatorBase:
    """Create a communicator by strategy name (see the module docstring).

    ``device``: the rank's device (the current CUDA card when ``None``;
    raises when there is none — pass ``device="cpu"`` for gloo on the
    CPU). ``allreduce_grad_dtype``: the wire dtype of gradient averaging,
    e.g. ``torch.bfloat16``; the flat NCCL strategy only."""
    name = communicator_name.lower()
    if name in _FLAT:
        return PureNcclCommunicator(
            device=device, allreduce_grad_dtype=allreduce_grad_dtype)
    if name not in _OTHERS:
        raise ValueError(f"unknown communicator: {communicator_name!r}")
    if allreduce_grad_dtype is not None:
        raise ValueError("allreduce_grad_dtype is supported only by the "
                         "'pure_nccl' strategy")
    if name == "non_cuda_aware":
        warnings.warn("communicator 'non_cuda_aware' stages through the "
                      "host in ChainerMN; using 'hierarchical'",
                      stacklevel=2)
    return _OTHERS[name](device=device)


__all__ = ["CommunicatorBase", "MeshCommunicator", "ProcessGroupCommunicator",
           "NaiveCommunicator", "FlatCommunicator", "PureNcclCommunicator",
           "HierarchicalCommunicator", "TwoDimensionalCommunicator",
           "SingleNodeCommunicator", "create_communicator"]
