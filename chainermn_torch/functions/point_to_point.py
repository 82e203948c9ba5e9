"""Differentiable point-to-point communication (the port of
``chainermn_tpu/functions/point_to_point.py``).

The JAX package runs one program over every rank, so there a transfer is
one ``ppermute`` whose transpose is the backward transfer. The port runs
one process a rank, as ChainerMN did, and takes upstream ChainerMN's
per-process semantics:

- :func:`send` ships a tensor (or a list/tuple/dict tree of tensors) to a
  peer and returns a *delegate variable*, a zero-size tensor that carries
  the autograd edge; its backward receives the gradient from the peer;
- :func:`recv` materialises what the peer sent; its backward sends the
  gradient back;
- :func:`pseudo_connect` grafts a delegate onto other tensors, so that
  disjoint pieces of one rank's graph backpropagate in a fixed order.

Both ride the communicator's host ``send``/``recv``: a header, then one
buffer a leaf, staged through the host over the gloo object channel.

Backward order is the hard part (upstream's deadlock class). In backward
only :func:`send` blocks (it waits for the gradient); :func:`recv` only
sends. A rank that enters a blocking ``send`` backward while a ``recv``
backward that its peer waits for is still pending never returns. So a
rank's transfers must run their backwards in the transposed order of
their forwards. Autograd orders a node only after every node that
consumes its outputs, and among ready nodes by creation order, which is
not the transposed one in general. Passing the previous transfer's
delegate to :func:`recv` (``delegate_variable``), or grafting it onto the
next payload with :func:`pseudo_connect`, makes each transfer a consumer
of the one before; :class:`~chainermn_torch.links.MultiNodeChainList`
threads its transfers that way.

``rank_context`` and :func:`current_rank` keep the JAX package's
interface: there the single controller must be told which rank the code
plays; here it is this process's rank unless a context says otherwise.

:data:`STATS` counts the transfers run in each direction, their payload
bytes and the host seconds spent in them (a ``recv`` waits for its peer,
so its seconds include that wait).
"""

from __future__ import annotations

import contextlib
import time

import torch

from chainermn_torch.communicators.process_group_communicator import (
    _flatten,
    _unflatten,
)

_RANK_CONTEXT: list[int] = []


@contextlib.contextmanager
def rank_context(rank: int):
    """Declare that the enclosed code plays logical rank ``rank``
    (nestable)."""
    _RANK_CONTEXT.append(int(rank))
    try:
        yield
    finally:
        _RANK_CONTEXT.pop()


def current_rank(communicator=None) -> int:
    """The rank the calling code plays: the innermost ``rank_context``,
    else ``communicator.rank``."""
    if _RANK_CONTEXT:
        return _RANK_CONTEXT[-1]
    if communicator is None:
        raise RuntimeError(
            "send/recv need a logical rank: pass the communicator or wrap "
            "the call in `with chainermn_torch.functions.rank_context(r):`")
    return communicator.rank


class TransferStats:
    """Counts of the point-to-point transfers this process ran: one a
    forward ``send``/``recv`` and one a backward, with their payload bytes
    and host seconds."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.forward = 0
        self.backward = 0
        self.bytes = 0
        self.seconds = 0.0

    def add(self, direction: str, leaves, seconds: float) -> None:
        setattr(self, direction, getattr(self, direction) + 1)
        self.bytes += sum(t.numel() * t.element_size() for t in leaves)
        self.seconds += seconds

    def as_dict(self) -> dict:
        return {"forward": self.forward, "backward": self.backward,
                "bytes": self.bytes, "seconds": self.seconds}


STATS = TransferStats()


class DelegateVariable(torch.Tensor):
    """A zero-size tensor carrying the autograd edge of a transfer made on
    rank ``src`` toward ``dst``. ``backward()`` needs no gradient, so a
    rank whose part of the model ends in a send calls
    ``delegate.backward()`` as upstream does."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def backward(self, gradient=None, *args, **kwargs):
        if gradient is None:
            gradient = torch.empty(self.shape, device=self.device)
        return torch.Tensor.backward(self, gradient, *args, **kwargs)


def _delegate(t: torch.Tensor, src: int, dst: int) -> DelegateVariable:
    d = t.as_subclass(DelegateVariable)
    d.src, d.dst = src, dst
    return d


def _token(token, device) -> torch.Tensor:
    """The previous transfer's delegate, or a fresh leaf: a transfer's
    autograd node needs an input that requires grad to exist at all."""
    if token is None:
        return torch.empty(0, device=device, requires_grad=True)
    return token


class _Send(torch.autograd.Function):
    """Forward: send the tree of ``leaves`` to ``peer``; backward: receive
    the gradients of its floating leaves from there."""

    @staticmethod
    def forward(ctx, comm, peer, tag, treedef, token, *leaves):
        ctx.comm, ctx.peer, ctx.tag = comm, peer, tag
        ctx.grad_to = [t.device if t.is_floating_point() else None
                       for t in leaves]
        t0 = time.perf_counter()
        comm.send(_unflatten(list(leaves), treedef), peer, tag)
        STATS.add("forward", leaves, time.perf_counter() - t0)
        return token.new_empty(0)

    @staticmethod
    def backward(ctx, grad_delegate):
        t0 = time.perf_counter()
        grads = iter(ctx.comm.recv(ctx.peer, ctx.tag))
        out = [None if dev is None else next(grads).to(dev)
               for dev in ctx.grad_to]
        STATS.add("backward", [g for g in out if g is not None],
                  time.perf_counter() - t0)
        return (None, None, None, None, torch.zeros_like(grad_delegate),
                *out)


class _Recv(torch.autograd.Function):
    """Forward: receive a tree from ``peer`` (its structure goes into
    ``box``); backward: send the gradients of its floating leaves back.
    The last output is a new delegate."""

    @staticmethod
    def forward(ctx, comm, peer, tag, box, token):
        ctx.comm, ctx.peer, ctx.tag = comm, peer, tag
        t0 = time.perf_counter()
        leaves, box["treedef"] = _flatten(comm.recv(peer, tag))
        STATS.add("forward", leaves, time.perf_counter() - t0)
        ctx.floating = [t.is_floating_point() for t in leaves]
        ctx.mark_non_differentiable(
            *[t for t in leaves if not t.is_floating_point()])
        return (*leaves, token.new_empty(0))

    @staticmethod
    def backward(ctx, *grads):
        gleaves = [g for g, f in zip(grads[:-1], ctx.floating) if f]
        t0 = time.perf_counter()
        ctx.comm.send(gleaves, ctx.peer, ctx.tag)
        STATS.add("backward", gleaves, time.perf_counter() - t0)
        return None, None, None, None, torch.zeros_like(grads[-1])


class _PseudoConnect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delegate, *xs):
        ctx.shape, ctx.device = delegate.shape, delegate.device
        return xs

    @staticmethod
    def backward(ctx, *grads):
        return (torch.zeros(ctx.shape, device=ctx.device), *grads)


def _check_peer(who: str, rank: int, communicator) -> None:
    if not 0 <= rank < communicator.size:
        raise ValueError(f"{who}: peer rank {rank} out of range "
                         f"[0, {communicator.size})")


def _check_plays(who: str, local: int, communicator) -> None:
    if local != communicator.rank:
        raise ValueError(
            f"{who}: the code plays rank {local} (rank_context) but runs on "
            f"rank {communicator.rank}; a process plays its own rank")


def send_tree(x, communicator, rank: int, token=None, tag: int = 0):
    """:func:`send` without the checks, threading ``token`` (the previous
    transfer's delegate, or ``None``)."""
    leaves, treedef = _flatten(x)
    out = _Send.apply(communicator, rank, tag, treedef,
                      _token(token, communicator.device), *leaves)
    return _delegate(out, communicator.rank, rank)


def recv_tree(communicator, rank: int, token=None, tag: int = 0):
    """:func:`recv` without the checks, threading ``token``: returns the
    received tree and a new delegate."""
    box: dict = {}
    *leaves, out = _Recv.apply(communicator, rank, tag, box,
                               _token(token, communicator.device))
    return (_unflatten(leaves, box["treedef"]),
            _delegate(out, communicator.rank, rank))


def send(x, communicator, rank: int, tag: int = 0) -> DelegateVariable:
    """Send ``x`` (a tensor, or a list/tuple/dict tree of tensors) from
    this rank to ``rank``; returns the delegate variable. Differentiable:
    the gradient that reaches the matching :func:`recv`'s output comes back
    to ``x``."""
    src = current_rank(communicator)
    _check_peer("send", rank, communicator)
    if rank == src:
        raise ValueError("send: source and destination rank are both "
                         f"{src}; self-sends are the identity — drop the send")
    _check_plays("send", src, communicator)
    return send_tree(x, communicator, rank, tag=tag)


def recv(communicator, rank: int, delegate_variable=None, tag: int = 0,
         force_tuple: bool = False):
    """Receive what ``rank`` sent to this rank, on the communicator's
    device, in the structure it was sent. ``delegate_variable``: a
    delegate this rank made earlier (a :func:`send`'s); it makes this
    recv's backward run before that transfer's, the order that cannot
    deadlock. ``force_tuple`` wraps a single tensor in a tuple."""
    dst = current_rank(communicator)
    _check_peer("recv", rank, communicator)
    if rank == dst:
        raise ValueError(f"recv: source and destination rank are both {dst}")
    made_on = getattr(delegate_variable, "src", dst)
    if made_on != dst:
        raise ValueError(
            f"recv endpoint mismatch: the delegate was made on rank "
            f"{made_on}, recv runs on rank {dst}")
    _check_plays("recv", dst, communicator)
    y, _ = recv_tree(communicator, rank, delegate_variable, tag=tag)
    if force_tuple and not isinstance(y, tuple):
        return (y,)
    return y


def pseudo_connect(delegate_variable, *actual_variables):
    """``actual_variables`` unchanged, with ``delegate_variable``'s
    autograd edge grafted on: the delegate's transfer runs its backward
    after theirs. ``None`` as the delegate returns them as they are."""
    if delegate_variable is not None:
        actual_variables = _PseudoConnect.apply(delegate_variable,
                                                *actual_variables)
    if len(actual_variables) == 1:
        return actual_variables[0]
    return tuple(actual_variables)


__all__ = ["DelegateVariable", "STATS", "TransferStats", "current_rank",
           "pseudo_connect", "rank_context", "recv", "recv_tree", "send",
           "send_tree"]
