"""The train steps (the port's counterparts of
``chainermn_tpu.training.jit_train_step`` and of the dense, unsharded
branch of ``jit_lm_train_step``).

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


def lm_train_step(model, optimizer, comm: CommunicatorBase, *,
                  shard_sequence: bool = False,
                  fused_ce: bool = False) -> Callable:
    """Next-token-prediction step for a
    :class:`~chainermn_torch.models.TransformerLM`-shaped model. Call as
    ``step(tokens, targets) -> (loss, stats)`` with ``[B, T]`` integer
    tokens and targets.

    The loss is the token-mean cross entropy of the float32 logits
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` in the
    reference); ``optimizer`` — normally
    :func:`~chainermn_torch.optimizers.create_multi_node_optimizer` over
    ``comm`` — averages the gradients over ranks and updates the model;
    the returned loss is ``comm.allreduce(loss, "mean")``.

    Raises for what the port does not run: ``shard_sequence=True``
    (``attention='flash'`` is local attention, as in the reference; the
    sequence-parallel kinds are not ported) and ``fused_ce=True`` (the
    chunked cross entropy of ``ops/losses.py`` is a later slice)."""
    attn = getattr(model, "attention", None)
    if fused_ce:
        raise NotImplementedError(
            "fused_ce (the chunked cross entropy of ops/losses.py) is not "
            "ported yet (ROADMAP.md, Queue A: the LM)")
    if shard_sequence:
        if attn == "flash":
            raise ValueError(
                "shard_sequence=True needs a sequence-parallel attention "
                "kind; attention='flash' is local (unsharded) attention")
        raise NotImplementedError(
            "shard_sequence=True (context parallelism) is not ported yet "
            "(ROADMAP.md, Queue A: parallel strategies)")

    def step(tokens, targets):
        dev = model.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        optimizer.zero_grad(set_to_none=True)
        logits = model(tokens)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        optimizer.step()
        return comm.allreduce(loss.detach(), "mean"), {}

    return step


__all__ = ["classification_loss_fn", "train_step", "lm_train_step"]
