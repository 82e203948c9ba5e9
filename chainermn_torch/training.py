"""The LM train step (the port's counterpart of the dense, unsharded
branch of ``chainermn_tpu.training.jit_lm_train_step``).

PyTorch's idiom replaces JAX's pure step: the model and the optimizer are
updated in place, and the step returns ``(loss, stats)`` with ``loss`` a
device tensor (no host sync) and ``stats`` ``{}`` for dense models.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from chainermn_torch.communicators import CommunicatorBase


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


__all__ = ["lm_train_step"]
