"""Multi-node optimizer wrappers — ChainerMN's idiom over ``torch.optim``.

Port of ``chainermn_tpu/optimizers.py``. There each wrapper is an optax
transformation inside a traced step; here it wraps a
``torch.optim.Optimizer``:

- :func:`create_multi_node_optimizer`: :meth:`step` replaces every
  parameter's ``.grad`` by the communicator's cross-rank mean of it, then
  steps the inner optimizer, as ChainerMN's ``update()`` did; with
  ``double_buffering`` the step applies the previous step's mean;
- :func:`create_zero_optimizer`: ZeRO-1, the inner optimizer's state
  sharded over the ranks;
- :func:`clip_by_global_norm_sharded`: gradient clipping by the global
  norm of sharded gradients, for use inside ZeRO-1;
- :func:`warmup_cosine_decay_schedule`: ``optax``'s schedule of the same
  name as a plain function of the step, for
  ``torch.optim.lr_scheduler.LambdaLR``.

Anything else (``zero_grad``, ``param_groups``, ``state_dict`` ...) goes
to the inner optimizer. optax and torch differ in defaults, not formulas:
``optax.adamw`` decays weights by 1e-4 by default, ``torch.optim.AdamW``
by 1e-2, so a port of ``optax.adamw(lr)`` is ``AdamW(lr,
weight_decay=1e-4)``; ``optax.sgd(lr, momentum=m)`` is ``SGD(lr,
momentum=m)``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from chainermn_torch.communicators import (
    CommunicatorBase,
    HierarchicalCommunicator,
)
from chainermn_torch.communicators.pure_nccl_communicator import _torch_dtype


def _params(optimizer: torch.optim.Optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


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
        live = [p for p in _params(self.actual_optimizer)
                if p.grad is not None]
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


class _DoubleBufferingOptimizer(_MultiNodeOptimizer):
    """One-step-stale means (``optimizers.py:87-115``): step t applies the
    mean of step t-1's gradients, and the first step applies zero
    gradients. The parameters' ``.grad`` keep this step's local
    gradients; :func:`wait_double_buffering` returns the pending mean."""

    def __init__(self, actual_optimizer, communicator) -> None:
        super().__init__(actual_optimizer, communicator)
        self.stale_mean: Optional[list] = None

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = _params(self.actual_optimizer)
        local = [p.grad for p in params]
        fresh = self.communicator.multi_node_mean_grad(local)
        stale = self.stale_mean
        if stale is None:
            stale = [None if g is None else torch.zeros_like(g)
                     for g in fresh]
        for p, g in zip(params, stale):
            p.grad = g
        self.actual_optimizer.step()
        for p, g in zip(params, local):
            p.grad = g
        self.stale_mean = fresh
        return loss


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase,
                                double_buffering: bool = False,
                                zero_fill: bool = False):
    """Wrap ``actual_optimizer`` so that each ``step()`` first averages
    the gradients over the communicator's ranks; with ``double_buffering``
    it applies the previous step's mean instead (any strategy, as in the
    reference). ``zero_fill`` is accepted for signature parity with the
    reference, which ignores it too."""
    del zero_fill
    if double_buffering:
        return _DoubleBufferingOptimizer(actual_optimizer, communicator)
    return _MultiNodeOptimizer(actual_optimizer, communicator)


def wait_double_buffering(optimizer) -> Optional[list]:
    """The mean still pending in a double-buffering optimizer (one tensor
    a parameter, in ``param_groups`` order; ``None`` before the first
    step): apply it after the last step for parity with unbuffered
    training (``optimizers.py:387-392``)."""
    return optimizer.stale_mean


class ZeroOptimizer:
    """ZeRO-1 over a one-group torch optimizer (see
    :func:`create_zero_optimizer`). ``shard`` is this rank's float32
    slice of the flat parameter vector; the inner optimizer, and so its
    state, holds only that slice."""

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator, wire_dtype=None,
                 grad_transform: Optional[Callable] = None) -> None:
        if isinstance(communicator, HierarchicalCommunicator):
            raise ValueError(
                "create_zero_optimizer needs a flat single-group "
                "communicator; a two-level one would scatter over two "
                "groups — use 'pure_nccl', 'flat' or 'naive'")
        if getattr(communicator, "_split", False):
            raise ValueError("create_zero_optimizer does not support split() "
                             "sub-communicators")
        if len(actual_optimizer.param_groups) != 1:
            raise ValueError("create_zero_optimizer takes an optimizer with "
                             "one parameter group")
        if actual_optimizer.state:
            raise ValueError("create_zero_optimizer takes an optimizer that "
                             "has not stepped yet")
        self.communicator = communicator
        group = actual_optimizer.param_groups[0]
        self.params = list(group["params"])
        if wire_dtype is None:
            wire_dtype = getattr(communicator, "allreduce_grad_dtype", None)
        self.wire_dtype = _torch_dtype(wire_dtype)
        self.grad_transform = grad_transform
        n = communicator.size
        total = sum(p.numel() for p in self.params)
        self._shard_len = -(-total // n)
        self.shard = torch.nn.Parameter(torch.zeros(
            self._shard_len, dtype=torch.float32,
            device=self.params[0].device))
        # the inner optimizer now steps the shard, with its own settings
        group["params"] = [self.shard]
        self.actual_optimizer = actual_optimizer

    def _flat(self, tensors, dtype) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
        pad = self._shard_len * self.communicator.size - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        """Reduce-scatter the gradients' mean in the wire dtype, step the
        inner optimizer on this rank's float32 shard, all-gather the
        update shards in the wire dtype and add them to the parameters.
        A parameter without a gradient counts as a zero gradient."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        comm, n = self.communicator, self.communicator.size
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        wire = self.wire_dtype or functools.reduce(
            torch.promote_types, [g.dtype for g in grads])
        flat_g = self._flat(grads, wire)
        g_shard = flat_g.new_empty(self._shard_len)
        dist.reduce_scatter_tensor(g_shard, flat_g, group=comm.group)
        g_shard = (g_shard / n).float()
        if self.grad_transform is not None:
            (g_shard,) = self.grad_transform([g_shard])
        lo = comm.rank * self._shard_len
        before = self._flat([p.detach() for p in self.params],
                            torch.float32)[lo:lo + self._shard_len]
        self.shard.copy_(before)
        self.shard.grad = g_shard
        self.actual_optimizer.step()
        update = (self.shard - before).to(wire)
        flat_u = update.new_empty(self._shard_len * n)
        dist.all_gather_into_tensor(flat_u, update, group=comm.group)
        at = 0
        for p in self.params:
            p.add_(flat_u[at:at + p.numel()].view_as(p).to(p.dtype))
            at += p.numel()
        return loss


def create_zero_optimizer(actual_optimizer: torch.optim.Optimizer,
                          communicator: CommunicatorBase,
                          wire_dtype=None,
                          grad_transform: Optional[Callable] = None
                          ) -> ZeroOptimizer:
    """ZeRO-1 (``optimizers.py:164-289``): shard the optimizer state over
    the communicator's ranks. Each step:

    1. the gradients are flattened in the **wire dtype**, padded to a
       multiple of ``size`` and reduce-scattered: each rank receives the
       cross-rank mean of its 1/size slice;
    2. ``grad_transform`` (e.g. :func:`clip_by_global_norm_sharded`), then
       the inner optimizer, run on that slice in float32, so its state is
       1/size of the unsharded one;
    3. the update slices are all-gathered in the wire dtype and added to
       the parameters, which stay replicated.

    ``actual_optimizer`` (one parameter group, not stepped yet) is taken
    over: its group's parameters become the shard. It must be elementwise
    (SGD, momentum, Adam(W), RMSprop ...). The wire dtype is
    ``wire_dtype``, else the communicator's
    ``allreduce_grad_dtype``, else the gradients' common dtype. Raises for
    the two-level strategies and for split communicators, as the
    reference does."""
    return ZeroOptimizer(actual_optimizer, communicator, wire_dtype,
                         grad_transform)


def clip_by_global_norm_sharded(max_norm: float,
                                communicator: CommunicatorBase) -> Callable:
    """A gradient transform that scales gradients by
    ``max_norm / global_norm`` when the global norm exceeds ``max_norm``
    (optax ``clip_by_global_norm``'s rule), where the global norm's square
    is the sum over ranks of each rank's squared norm
    (``optimizers.py:292-384``). Pass it as ``create_zero_optimizer(...,
    grad_transform=...)``.

    It is exact only on sharded gradients, each rank holding a disjoint
    part: the port has no replication tracking, so on replicated
    gradients (every rank the same) it would count each one ``size``
    times and clip by a ``sqrt(size)``-times larger norm."""

    def transform(grads: list) -> list:
        local = sum(g.float().square().sum() for g in grads)
        norm = communicator.allreduce(local, "sum").sqrt()
        scale = torch.where(norm > max_norm, max_norm / norm,
                            torch.ones_like(norm))
        return [(g * scale).to(g.dtype) for g in grads]

    return transform


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule`` as a function of the step
    count (the number of updates already applied): a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), held
    there after. With ``torch.optim.lr_scheduler.LambdaLR(opt, schedule)``
    over an optimizer built with ``lr=1.0``, update ``t`` uses
    ``schedule(t)``, as optax's ``count`` does."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine part needs decay_steps > warmup_steps,"
                         f" got {decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:    # optax.linear_schedule
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


class ComponentWiseOptimizer:
    """One optimizer per component of a
    :class:`~chainermn_torch.links.MultiNodeChainList` (made by
    :func:`create_component_wise_optimizer`); ``step`` and ``zero_grad``
    act on each."""

    def __init__(self, optimizers: list) -> None:
        self.optimizers = optimizers

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers:
            opt.step()



def create_component_wise_optimizer(make_optimizer: Callable,
                                    model) -> ComponentWiseOptimizer:
    """An optimizer for each component of ``model`` (a
    ``MultiNodeChainList``) that this rank holds and that has parameters,
    each made by ``make_optimizer(parameters)`` (``optimizers.py:118-144``;
    a torch optimizer binds its parameters when it is built, so this takes
    a factory, e.g. ``lambda ps: torch.optim.Adam(ps, 1e-3)``). Each
    rank's optimizers see only its own components, as in upstream
    ChainerMN; no gradient crosses ranks."""
    return ComponentWiseOptimizer([
        make_optimizer(list(m.parameters()))
        for m in model.local_components() if any(True for _ in m.parameters())])


__all__ = ["create_multi_node_optimizer", "wait_double_buffering",
           "create_zero_optimizer", "ZeroOptimizer",
           "ComponentWiseOptimizer", "create_component_wise_optimizer",
           "clip_by_global_norm_sharded", "warmup_cosine_decay_schedule"]
