"""Communicator factory (the port's subset of
``chainermn_tpu/communicators/__init__.py``).

``'pure_nccl'`` — ChainerMN's name — and ``'tpu'``, the JAX package's
name for the same flat strategy, give a :class:`PureNcclCommunicator`.
The other strategies (``naive``, ``flat``, ``hierarchical``,
``two_dimensional``, ``single_node``, ``non_cuda_aware``, ``pure_ici``)
come with the data-parallel training slice.
"""

from __future__ import annotations

from chainermn_torch.communicators.communicator_base import CommunicatorBase
from chainermn_torch.communicators.pure_nccl_communicator import (
    PureNcclCommunicator,
)

_FLAT = ("pure_nccl", "tpu")
_LATER = ("naive", "flat", "hierarchical", "two_dimensional", "single_node",
          "non_cuda_aware", "pure_ici")


def create_communicator(communicator_name: str = "pure_nccl", *,
                        device=None,
                        allreduce_grad_dtype=None) -> CommunicatorBase:
    """Create a communicator by strategy name.

    ``device``: the rank's device (the current CUDA card when ``None``;
    raises when there is none — pass ``device="cpu"`` for gloo on the
    CPU). ``allreduce_grad_dtype``: the wire dtype of gradient averaging,
    e.g. ``torch.bfloat16`` (ChainerMN's pure_nccl-only option)."""
    name = communicator_name.lower()
    if name in _FLAT:
        return PureNcclCommunicator(
            device=device, allreduce_grad_dtype=allreduce_grad_dtype)
    if name in _LATER:
        raise NotImplementedError(
            f"communicator {communicator_name!r} is not ported yet; it "
            "comes with the data-parallel training slice (ROADMAP.md, "
            "Queue A)")
    raise ValueError(f"unknown communicator: {communicator_name!r}")


__all__ = ["CommunicatorBase", "PureNcclCommunicator", "create_communicator"]
