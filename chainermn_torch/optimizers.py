"""Multi-node optimizer wrapper — ChainerMN's idiom over
``torch.optim``.

Port of ``create_multi_node_optimizer`` in
``chainermn_tpu/optimizers.py``. There the wrapper is an optax
transformation inside a traced step; here it wraps a
``torch.optim.Optimizer``: :meth:`step` replaces every parameter's
``.grad`` by the communicator's cross-rank mean of it, then steps the
inner optimizer, as ChainerMN's ``update()`` did. Anything else
(``zero_grad``, ``param_groups``, ``state_dict`` ...) goes to the inner
optimizer.

Semantics differ between optax and torch in defaults, not formulas:
``optax.adamw`` decays weights by 1e-4 by default, ``torch.optim.AdamW``
by 1e-2, so a port of ``optax.adamw(lr)`` is ``AdamW(lr,
weight_decay=1e-4)``.
"""

from __future__ import annotations

import torch

from chainermn_torch.communicators import CommunicatorBase


class _MultiNodeOptimizer:
    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase) -> None:
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator

    def step(self, closure=None):
        """Average the gradients over ranks, then step. Parameters without
        a gradient are left out of the mean and of the inner step."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        live = [p for group in self.actual_optimizer.param_groups
                for p in group["params"] if p.grad is not None]
        means = self.communicator.multi_node_mean_grad(
            [p.grad for p in live])
        for p, g in zip(live, means):
            p.grad = g
        self.actual_optimizer.step()
        return loss

    def __getattr__(self, name):
        if name == "actual_optimizer":   # not set yet (e.g. unpickling)
            raise AttributeError(name)
        return getattr(self.actual_optimizer, name)


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase,
                                double_buffering: bool = False,
                                zero_fill: bool = False):
    """Wrap ``actual_optimizer`` so that each ``step()`` first averages
    the gradients over the communicator's ranks. ``zero_fill`` is
    accepted for signature parity with the reference, which ignores it
    too. ``double_buffering`` (one-step-stale means) is not ported yet."""
    del zero_fill
    if double_buffering:
        raise NotImplementedError(
            "double_buffering is not ported yet; it comes with the "
            "data-parallel training slice (ROADMAP.md, Queue A)")
    return _MultiNodeOptimizer(actual_optimizer, communicator)


__all__ = ["create_multi_node_optimizer"]
