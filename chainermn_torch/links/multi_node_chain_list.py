"""Model-parallel composition: MultiNodeChainList (the port of
``chainermn_tpu/links/multi_node_chain_list.py``).

Every process declares the WHOLE chain, as the JAX package's single
controller does: ``add_link(link, rank, rank_in, rank_out)`` names the
rank that owns each component, where its inputs come from (``None``: the
model inputs) and where its output goes (``None``: a model output).
Each process runs only its own components, in insertion order, over the
same mailbox walk as the reference (``_run``): an input from another
rank is a differentiable :func:`~chainermn_torch.functions.recv`, an
output for another rank a :func:`~chainermn_torch.functions.send`, and a
hop to a later component of the same rank stays local.

Backward order. Every transfer of a rank takes the previous transfer's
delegate as an input and makes a new one, so each is an autograd
consumer of the one before and their backwards run in the transposed
order of their forwards — the order that cannot deadlock across ranks
(``functions/point_to_point.py``). The last delegate is grafted onto this
rank's model output; a rank without one gets the delegate back from the
forward and calls ``.backward()`` on it, as in upstream ChainerMN.

Memory. A component of another rank is moved to the ``meta`` device when
it is added: its structure stays (for :meth:`replicate`) and its
parameters take no memory. ``parameters()`` are those of the components
this rank runs. :meth:`replicate` broadcasts every component from its
owner, after which ``forward(..., fused=True)`` runs the whole chain on
this rank with no transfer, values identical to the default mode.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

import torch
from torch import nn

from chainermn_torch.functions.point_to_point import (
    pseudo_connect,
    recv_tree,
    send_tree,
)


def _as_tuple(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


@dataclasses.dataclass
class _Component:
    link: nn.Module
    rank: int                      # the rank that owns it
    rank_in: tuple[int, ...]       # () => consumes the model inputs
    rank_out: tuple[int, ...]      # () => contributes to the model outputs


def _graft(token, y):
    """``y`` (a tensor or a tuple of them) with ``token`` grafted onto its
    first floating tensor."""
    if isinstance(y, torch.Tensor):
        return pseudo_connect(token, y)
    y = list(y)
    for i, t in enumerate(y):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            y[i] = pseudo_connect(token, t)
            break
    return tuple(y)


class MultiNodeChainList(nn.Module):
    """Cross-rank model as an ordered component list (reference name).

    Usage (2-rank MLP, every process runs the same code)::

        model = MultiNodeChainList(comm)
        model.add_link(MLP0(), rank=0, rank_in=None, rank_out=1)
        model.add_link(MLP1(), rank=1, rank_in=0, rank_out=None)
        y = model(x)         # rank 1: the logits; rank 0: a delegate
        (loss_fn(y) if comm.rank == 1 else y).backward()
    """

    def __init__(self, comm) -> None:
        super().__init__()
        self._comm = comm
        self._components: list[_Component] = []
        self._replicated = False

    def add_link(self, link: nn.Module, rank: int, rank_in=None,
                 rank_out=None) -> None:
        if not 0 <= rank < self._comm.size:
            raise ValueError(f"rank {rank} out of range [0, {self._comm.size})")
        if rank == self._comm.rank:
            link.to(self._comm.device)
            self.add_module(str(len(self._components)), link)
        else:
            link.to("meta")
        self._components.append(
            _Component(link, rank, _as_tuple(rank_in), _as_tuple(rank_out)))

    @property
    def components(self) -> list[nn.Module]:
        """Every component's module, in insertion order (those of other
        ranks on ``meta`` until :meth:`replicate`)."""
        return [c.link for c in self._components]

    def local_components(self) -> list[nn.Module]:
        """The components this rank holds: its own, and after
        :meth:`replicate` every one."""
        return list(self.children())

    # ------------------------------------------------------------------ #

    def forward(self, *inputs, mutable: bool = False, fused: bool = False):
        """This rank's part of the chain. Returns this rank's model
        output(s) (one tensor, or a tuple in insertion order); a rank
        without a model output returns the delegate of its last transfer
        (``None`` when it ran none). With ``mutable``, returns
        ``(output, updated)``: :meth:`state` after the forward.

        ``fused=True`` (after :meth:`replicate`) runs every component on
        this rank with no transfer and returns every model output."""
        self._check_wiring()
        if fused:
            if not self._replicated:
                raise RuntimeError("fused=True runs every component on this "
                                   "rank: call replicate() first")
            out = self._run_local(inputs)
        else:
            out = self._run(inputs)
        return (out, self.state()) if mutable else out

    def state(self) -> list[dict]:
        """The buffers (BatchNorm running statistics) of each component
        this rank holds, a dict a component (``{}`` for a stateless one or
        one of another rank): the counterpart of the reference's
        ``apply(..., mutable=...)`` updates."""
        held = set(map(id, self.local_components()))
        return [{k: b.detach().clone() for k, b in c.link.named_buffers()}
                if id(c.link) in held else {} for c in self._components]

    @torch.no_grad()
    def merge_updates(self, updated: Sequence[dict]) -> "MultiNodeChainList":
        """Copy per-component buffers (as :meth:`state` returns them) into
        the components."""
        for comp, upd in zip(self._components, updated):
            bufs = dict(comp.link.named_buffers())
            for k, v in upd.items():
                bufs[k].copy_(torch.as_tensor(v))
        return self

    @torch.no_grad()
    def replicate(self) -> "MultiNodeChainList":
        """Broadcast every component from its owner rank, so every rank
        holds the whole chain (every rank calls this; components of other
        ranks leave ``meta``). Do it before building the optimizers for
        ``fused=True`` training."""
        comm = self._comm
        for idx, comp in enumerate(self._components):
            if comp.rank != comm.rank and not self._replicated:
                comp.link.to_empty(device=comm.device)
                self.add_module(str(idx), comp.link)
            for t in list(comp.link.parameters()) + list(comp.link.buffers()):
                t.copy_(comm.bcast(t, root=comp.rank))
        self._replicated = True
        return self

    # ------------------------------------------------------------------ #

    def _check_wiring(self) -> None:
        """The reference's wiring errors (``_run``), found from the
        declared chain alone, so every rank raises the same one before any
        transfer."""
        if not self._components:
            raise ValueError("MultiNodeChainList has no components; call "
                             "add_link")
        box: Counter = Counter()
        n_outputs = 0
        for idx, comp in enumerate(self._components):
            for src in comp.rank_in:
                if not box[(src, comp.rank)]:
                    raise RuntimeError(
                        f"component #{idx} (rank {comp.rank}) expects an "
                        f"input from rank {src}, but nothing was sent — "
                        "check add_link order and rank_in/rank_out wiring")
                box[(src, comp.rank)] -= 1
            n_outputs += not comp.rank_out
            for dst in comp.rank_out:
                box[(comp.rank, dst)] += 1
        undelivered = {k: v for k, v in box.items() if v}
        if undelivered:
            raise RuntimeError(
                f"undelivered sends remain {undelivered}: a rank_out named a "
                "rank that no later component (rank_in) consumes")
        if not n_outputs:
            raise RuntimeError("no component declared rank_out=None (model "
                               "output)")

    def _run(self, inputs):
        """This rank's components in insertion order, with transfers at
        the rank boundaries threaded through one delegate chain."""
        comm, me = self._comm, self._comm.rank
        inputs = [x.to(comm.device) if isinstance(x, torch.Tensor) else x
                  for x in inputs]
        token = None        # the delegate of this rank's last transfer
        local: list = []    # outputs sent to a later component of this rank
        outputs = []
        for comp in self._components:
            if comp.rank != me:
                continue
            args = [] if comp.rank_in else list(inputs)
            for src in comp.rank_in:
                if src == me:
                    args.append(local.pop(0))
                else:
                    y, token = recv_tree(comm, src, token)
                    args.append(y)
            y = comp.link(*args)
            if not comp.rank_out:
                outputs.append(y)
            for dst in comp.rank_out:
                if dst == me:
                    local.append(y)
                else:
                    token = send_tree(y, comm, dst, token)
        if not outputs:
            return token
        if token is not None:
            outputs[0] = _graft(token, outputs[0])
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def _run_local(self, inputs):
        """The whole mailbox walk on this rank (the fused mode)."""
        dev = self._comm.device
        inputs = [x.to(dev) if isinstance(x, torch.Tensor) else x
                  for x in inputs]
        mailbox: dict = {}
        outputs = []
        for comp in self._components:
            args = ([mailbox[(src, comp.rank)].pop(0) for src in comp.rank_in]
                    if comp.rank_in else list(inputs))
            y = comp.link(*args)
            if not comp.rank_out:
                outputs.append(y)
            for dst in comp.rank_out:
                mailbox.setdefault((comp.rank, dst), []).append(y)
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


__all__ = ["MultiNodeChainList"]
