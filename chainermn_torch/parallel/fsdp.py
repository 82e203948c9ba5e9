"""FSDP (ZeRO-3): parameters, gradients and optimizer state sharded at
rest (the port of ``chainermn_tpu/parallel/fsdp.py``).

In the reference, FSDP is a layout: every leaf lives scattered over the
data axis and one global jitted program gathers each weight where it is
used and reduce-scatters the gradients. The port runs one process a
rank, so the layout is PyTorch's FSDP2 (``fully_shard``) over the
communicator's ranks: each block of the model and then the model itself
become FSDP units whose parameters are ``DTensor`` shards, gathered for
the forward and backward and reduce-scattered (averaged) after it. A
plain ``torch.optim`` optimizer built over the sharded parameters keeps
its state co-sharded with them.

What carries over from the reference:

- **the sharding rule** (:func:`spec_for_shape`): each parameter is split
  along its largest axis divisible by the shard count, the earlier axis
  on ties, counted in flax's axis order (a convolution kernel ``[kh, kw,
  I, O]``, a dense kernel ``[in, out]``) and mapped to the torch
  parameter's dim (``[O, I, kh, kw]``, ``[out, in]``,
  :func:`shard_dim`). A parameter with no divisible axis stays
  replicated, as in the reference: it is left out of FSDP and its
  gradient is averaged over all ranks by one all-reduce each;
- **global-batch BatchNorm**: the reference step is one program over the
  global batch, so its BatchNorm normalises over the global batch.
  :func:`fsdp_shard` turns every BatchNorm into a
  :class:`~chainermn_torch.links.MultiNodeBatchNormalization` over the
  communicator (hyperparameters kept), which pools the statistics over
  every rank — sync-BN by construction, as there;
- **HSDP**: on the two-level communicators (``hierarchical``,
  ``two_dimensional``) ``axis`` picks the level the weights scatter over
  (``"intra"`` for HSDP: shards within a node, replicas across nodes),
  through a two-dimensional device mesh of the communicator's inter and
  intra groups; the batch still spans every rank;
- the checks: ``split()`` communicators are refused, a two-level
  communicator needs ``axis``, and a communicator's
  ``allreduce_grad_dtype`` is ignored with a warning (FSDP reduces in the
  gradient's own dtype).

The step takes this rank's batch (one process a rank), not the global
one, and returns the global-batch mean loss.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from chainermn_torch.communicators import (
    CommunicatorBase,
    HierarchicalCommunicator,
)
from chainermn_torch.links import create_mnbn_model
from chainermn_torch.training import classification_loss_fn

_AXES = ("inter", "intra")


def _shard_axis(comm: CommunicatorBase, axis: Optional[str]):
    """The level the weights scatter over: ``None`` on a flat
    communicator (all ranks), ``"inter"`` or ``"intra"`` on a two-level
    one, where it must be given (``fsdp.py:57-82``)."""
    if getattr(comm, "_split", False):
        raise ValueError("FSDP does not support split() sub-communicators")
    if not isinstance(comm, HierarchicalCommunicator):
        if axis is not None:
            raise ValueError(f"axis {axis!r}: a flat communicator has one "
                             "axis, over all ranks (omit axis)")
        return None
    if axis is None:
        raise ValueError(
            f"two-level communicator has axes {_AXES!r}: pass axis=... to "
            "choose the level the weights scatter over (the intra axis "
            "for HSDP)")
    if axis not in _AXES:
        raise ValueError(f"axis {axis!r} not in communicator axes {_AXES!r}")
    return axis


def spec_for_shape(shape, n: int) -> Optional[int]:
    """The reference's rule on a flax-ordered shape: the index of the
    largest ``n``-divisible axis (earlier axis on ties), ``None`` to
    replicate."""
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and d > 0 and (best is None or d > shape[best]):
            best = i
    return best


def _flax_order(ndim: int) -> tuple:
    """The torch dims of a parameter in flax's axis order: a convolution
    weight ``[O, I, kh, kw]`` is ``[kh, kw, I, O]`` there, a linear
    weight ``[out, in]`` is ``[in, out]``."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def shard_dim(shape, n: int) -> Optional[int]:
    """The torch dim a parameter of ``shape`` is sharded on over ``n``
    ranks (:func:`spec_for_shape` in flax's order), ``None`` to
    replicate."""
    order = _flax_order(len(shape))
    best = spec_for_shape([shape[d] for d in order], n)
    return None if best is None else order[best]


def _mesh(comm: CommunicatorBase, axis: Optional[str]):
    """The FSDP2 device mesh: one dim (``"shard"``) over a new group of
    every rank on a flat communicator; ``("replicate", "shard")`` over the
    communicator's inter and intra groups on a two-level one."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = comm.device.type
    world = dist.get_world_size()
    if axis is None:
        group = comm._new_group(list(range(world)))
        return DeviceMesh.from_group(group, device_type,
                                     mesh_dim_names=("shard",))
    n_intra = comm.intra_size
    ranks = torch.arange(world).view(world // n_intra, n_intra)
    groups = [comm._inter, comm._intra]
    if axis == "inter":          # shards across nodes, replicas within
        ranks, groups = ranks.t().contiguous(), groups[::-1]
    return DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                 mesh_dim_names=("replicate", "shard"))


def fsdp_spec(model: nn.Module, comm: CommunicatorBase,
              axis: Optional[str] = None) -> dict:
    """Each parameter's shard dim (``None``: replicated) over ``axis``'s
    ranks, by name."""
    axis = _shard_axis(comm, axis)
    n = comm.size if axis is None else (
        comm.intra_size if axis == "intra" else comm.inter_size)
    return {name: shard_dim(tuple(p.shape), n)
            for name, p in model.named_parameters()}


def fsdp_shard(model: nn.Module, comm: CommunicatorBase,
               axis: Optional[str] = None) -> nn.Module:
    """A copy of ``model`` laid out for FSDP over ``comm``: every
    BatchNorm made multi-node over ``comm`` (global-batch statistics),
    then each of ``model.blocks`` (when it has them) and the model itself
    made an FSDP2 unit, each parameter sharded on :func:`fsdp_spec`'s dim
    and the ones with no divisible dim kept whole. Every rank calls it,
    with the same weights (``comm.bcast_data`` first). Build the
    optimizer over the returned model's parameters. The parameters kept
    whole are listed in the returned model's ``fsdp_replicated``, for
    :func:`fsdp_train_step`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    axis = _shard_axis(comm, axis)
    spec = fsdp_spec(model, comm, axis)
    model = create_mnbn_model(model, comm)
    by_param = {p: spec[name] for name, p in model.named_parameters()}
    replicated = {p for p, d in by_param.items() if d is None}
    mesh = _mesh(comm, axis)
    kw = dict(mesh=mesh, ignored_params=replicated,
              shard_placement_fn=lambda p: Shard(by_param[p]))
    for blk in getattr(model, "blocks", ()):
        fully_shard(blk, **kw)
    fully_shard(model, **kw)
    model.fsdp_replicated = [p for p in model.parameters()
                             if p in replicated]
    return model


def fsdp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    comm: CommunicatorBase, *,
                    train_kwargs: Optional[dict] = None,
                    label_smoothing: float = 0.0,
                    axis: Optional[str] = None) -> Callable:
    """The FSDP classification step (``jit_fsdp_train_step``): call as
    ``step(images, labels) -> loss`` with this rank's batch; ``model``
    comes from :func:`fsdp_shard` (same ``axis``) and ``optimizer`` is a
    plain ``torch.optim`` optimizer over its parameters — no multi-node
    wrapper: FSDP averages the sharded gradients, and the step averages
    the replicated ones. Returns the global-batch mean loss, a device
    tensor."""
    _shard_axis(comm, axis)
    if getattr(comm, "allreduce_grad_dtype", None) is not None:
        warnings.warn(
            "fsdp_train_step ignores the communicator's "
            f"allreduce_grad_dtype={comm.allreduce_grad_dtype!r}: FSDP "
            "reduces the sharded gradients in their own dtype, not through "
            "the communicator strategy", stacklevel=2)
    replicated = getattr(model, "fsdp_replicated", [])

    def step(images, labels):
        dev = comm.device
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        optimizer.zero_grad(set_to_none=True)
        loss = classification_loss_fn(model, images, labels, train_kwargs,
                                      label_smoothing)
        loss.backward()
        with torch.no_grad():
            for p in replicated:
                if p.grad is not None:
                    p.grad = comm.allreduce(p.grad, "mean")
        optimizer.step()
        return comm.allreduce(loss.detach(), "mean")

    return step


__all__ = ["fsdp_shard", "fsdp_spec", "fsdp_train_step", "shard_dim",
           "spec_for_shape"]
