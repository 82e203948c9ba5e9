"""The train steps (the port's counterparts of
``chainermn_tpu.training.jit_train_step`` and ``jit_lm_train_step``, the
latter dense, sequence-parallel and tensor-parallel).

PyTorch's idiom replaces JAX's pure step: the model and the optimizer are
updated in place, and each step returns its loss as a device tensor (no
host sync).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.communicators import CommunicatorBase
from chainermn_torch.communicators import _memory_utility
from chainermn_torch.links.batch_normalization import BatchNorm
from chainermn_torch.parallel.mesh import resolve_axis
from chainermn_torch.parallel.sequence import zigzag_positions
from chainermn_torch.parallel.tensor import (
    global_objective,
    sliced_parameters,
    vocab_parallel_cross_entropy,
)


def classification_loss_fn(model, images, labels,
                           train_kwargs: Optional[dict] = None,
                           label_smoothing: float = 0.0):
    """The mean softmax cross entropy of ``model(images, **train_kwargs)``
    against integer ``labels``, on float32 logits; with
    ``label_smoothing`` s the targets are ``(1 - s) * one_hot + s / K``
    (``optax.smooth_labels``), as in ``training.py:26-59``."""
    logits = model(images, **(train_kwargs or {}))
    return F.cross_entropy(logits.float(), labels,
                           label_smoothing=label_smoothing)


def _running_buffers(model) -> list:
    """Every BatchNorm's running statistics: each rank updates them from
    its own batch, so the step averages them over ranks."""
    return [b for m in model.modules()
            if isinstance(m, (BatchNorm, nn.modules.batchnorm._BatchNorm))
            for b in (m.running_mean, m.running_var) if b is not None]


def train_step(model, optimizer, comm: CommunicatorBase, *,
               train_kwargs: Optional[dict] = None,
               label_smoothing: float = 0.0) -> Callable:
    """The data-parallel classification step (``training.py:62-160``).
    Call as ``step(images, labels) -> loss`` with this rank's batch
    (``[N, C, H, W]`` images, ``channels_last`` for convolutions, and
    ``[N]`` integer labels). One call:

    1. runs forward and backward on this rank's batch only — the loss is
       the local one, so the optimizer's cross-rank mean is the one
       reduction of the gradients (no ``DistributedDataParallel``);
    2. steps ``optimizer`` (normally
       :func:`~chainermn_torch.optimizers.create_multi_node_optimizer` or
       :func:`~chainermn_torch.optimizers.create_zero_optimizer` over
       ``comm``): the gradient mean, then the update;
    3. replaces every BatchNorm running buffer by its mean over ranks, in
       one all-reduce;
    4. returns ``comm.allreduce(loss, "mean")``, a device tensor."""
    buffers = _running_buffers(model)

    def step(images, labels):
        dev = next(model.parameters()).device
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        optimizer.zero_grad(set_to_none=True)
        loss = classification_loss_fn(model, images, labels, train_kwargs,
                                      label_smoothing)
        loss.backward()
        optimizer.step()
        if buffers:
            with torch.no_grad():
                packed, metas = _memory_utility.pack_leaves(buffers)
                means = [comm.allreduce(b, "mean") for b in packed]
                for b, m in zip(buffers,
                                _memory_utility.unpack_leaves(means, metas)):
                    b.copy_(m)
        return comm.allreduce(loss.detach(), "mean")

    return step


_SEQUENCE_KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
                   "ulysses_flash")


def _shard_positions(model, seq_axis, t_local: int):
    """Global positions of this rank's sequence shard
    (``training.py:163``): ``0`` unsharded, the scalar base
    ``rank * T_local`` for a contiguous layout, zigzag's ``[T_local]``
    position vector for the zigzag kinds."""
    comm = resolve_axis(seq_axis)
    if comm is None:
        return 0
    if getattr(model, "attention", None) in ("zigzag", "zigzag_flash"):
        return zigzag_positions(comm.rank, comm.size, t_local,
                                device=model.device)
    return comm.rank * t_local


def _ce(logits, targets):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def lm_train_step(model, optimizer, comm: CommunicatorBase, *,
                  shard_sequence: bool = False,
                  fused_ce: bool = False) -> Callable:
    """Next-token-prediction step for a
    :class:`~chainermn_torch.models.TransformerLM`-shaped model. Call as
    ``step(tokens, targets) -> (loss, stats)`` with this rank's ``[B, T]``
    integer tokens and targets.

    The loss is the token-mean cross entropy of the float32 logits
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` in the
    reference); ``optimizer`` — normally
    :func:`~chainermn_torch.optimizers.create_multi_node_optimizer` over
    ``comm`` — averages the gradients over ranks and updates the model;
    the returned loss is ``comm.allreduce(loss, "mean")``.

    ``shard_sequence=True`` is context parallelism
    (``training.py:308-443``): the model is built with a sequence-parallel
    ``attention`` kind and ``sequence_axis`` over ``comm``'s ranks, the
    tokens are this rank's shard of the sequence (zigzag-permuted for the
    zigzag kinds, :func:`~chainermn_torch.parallel.sequence.
    zigzag_permutation`), and the step threads the shard's global
    positions.

    A model built with ``tensor_axis`` takes the tensor-parallel step
    (``training.py:178-305``): ``comm`` is a
    :class:`~chainermn_torch.communicators.MeshCommunicator` holding the
    axis, the batch is sharded over its other axes (and the sequence over
    the model's ``sequence_axis`` with ``shard_sequence=True``), the loss
    is :func:`~chainermn_torch.parallel.tensor.
    vocab_parallel_cross_entropy` under ``vocab_parallel_head``, and the
    step assembles the exact global gradient itself — the sliced leaves'
    gradients summed over the tensor axis, every gradient averaged over
    the other ranks — so ``optimizer`` is a plain ``torch.optim``
    optimizer, as the reference's is a plain optax transform.

    Raises for ``fused_ce=True`` (the chunked cross entropy of
    ``ops/losses.py`` is a later slice)."""
    attn = getattr(model, "attention", None)
    seq_axis = getattr(model, "sequence_axis", None)
    if fused_ce:
        raise NotImplementedError(
            "fused_ce (the chunked cross entropy of ops/losses.py) is not "
            "ported yet (ROADMAP.md, Queue A: the LM)")
    if getattr(model, "tensor_axis", None) is not None:
        return _tp_lm_train_step(model, optimizer, comm, shard_sequence)
    if shard_sequence:
        if attn == "flash":
            raise ValueError(
                "shard_sequence=True needs a sequence-parallel attention "
                "kind; attention='flash' is local (unsharded) attention")
        seq = resolve_axis(seq_axis)
        if attn not in _SEQUENCE_KINDS or seq is None or (
                seq is not comm and seq._ranks != comm._ranks):
            raise ValueError(
                "shard_sequence=True needs the model built with attention="
                "'ring'|'ring_flash'|'zigzag'|'zigzag_flash'|'ulysses'(+_flash)"
                " and a sequence_axis over the step's communicator's ranks; "
                f"got attention={attn!r}, sequence_axis={seq_axis!r}")
    elif seq_axis is not None:
        raise ValueError(
            f"model has sequence_axis={seq_axis!r} but shard_sequence=False "
            "shards the batch axis — the sequence-parallel attention would "
            "mix different batch shards' K/V")

    def step(tokens, targets):
        dev = model.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        pos = _shard_positions(model, seq_axis if shard_sequence else None,
                               tokens.shape[1])
        optimizer.zero_grad(set_to_none=True)
        loss = _ce(model(tokens, pos), targets)
        loss.backward()
        optimizer.step()
        return comm.allreduce(loss.detach(), "mean"), {}

    return step


def _tp_lm_train_step(model, optimizer, comm, shard_sequence: bool):
    """The tensor-parallel LM step (see :func:`lm_train_step`)."""
    tensor_axis = model.tensor_axis
    seq_axis = getattr(model, "sequence_axis", None)
    axes = tuple(getattr(comm, "axis_name", None) or ())
    if tensor_axis not in axes:
        raise ValueError(
            f"model.tensor_axis={tensor_axis!r} is not one of the "
            f"communicator's mesh axes {axes}")
    if shard_sequence and seq_axis is None:
        raise ValueError(
            "shard_sequence=True with a TP model needs the model built with "
            "sequence_axis (and attention='ring'|'zigzag'|'ulysses' or a "
            "_flash variant)")
    if seq_axis is not None and (seq_axis == tensor_axis
                                 or seq_axis not in axes):
        raise ValueError(
            f"model.sequence_axis={seq_axis!r} must be a mesh axis distinct "
            f"from tensor_axis={tensor_axis!r} (mesh axes {axes})")
    if seq_axis is not None and not shard_sequence:
        raise ValueError(
            f"model has sequence_axis={seq_axis!r}: the TP step shards the "
            "sequence over it — pass shard_sequence=True (or build the model "
            "without sequence_axis for batch-only sharding)")
    if seq_axis is not None and model.attention not in _SEQUENCE_KINDS:
        raise ValueError(
            f"sequence_axis={seq_axis!r} needs attention='ring'|'zigzag'|"
            f"'ulysses' (or _flash); got {model.attention!r} — plain 'full' "
            "would attend within each sequence shard only")
    n_tp = comm.axis_size(tensor_axis)
    sliced = {id(p) for p in sliced_parameters(model)}
    params = list(model.parameters())

    def step(tokens, targets):
        dev = model.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        pos = _shard_positions(model, seq_axis, tokens.shape[1])
        optimizer.zero_grad(set_to_none=True)
        logits = model(tokens, pos)
        if model.vocab_parallel_head:
            ce = vocab_parallel_cross_entropy(logits, targets,
                                              tensor_axis).mean()
        else:
            ce = _ce(logits, targets)
        ce.backward()
        # the exact global gradient: the sliced leaves' zero-padded slices
        # summed over the tensor axis (n_tp times their mean over it), then
        # every leaf averaged over all ranks — the tensor ranks of a
        # replicated leaf hold the same gradient, so that is its mean over
        # the data (dp x sp) ranks
        live = [p for p in params if p.grad is not None]
        with torch.no_grad():
            for p in live:
                if id(p) in sliced:
                    p.grad.mul_(n_tp)
        for p, g in zip(live, comm.multi_node_mean_grad(
                [p.grad for p in live])):
            p.grad = g
        optimizer.step()
        return global_objective(ce.detach(), comm), {}

    return step


__all__ = ["classification_loss_fn", "train_step", "lm_train_step"]
