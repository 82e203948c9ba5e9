"""Host-side object communication: pickled objects and raw CPU tensors
over a gloo process group (the port's counterpart of
``chainermn_tpu/communicators/_object_comm.py``, whose transport is the
jax.distributed key-value store). The collectives are
``torch.distributed``'s object collectives; point-to-point sends a length
header, then the bytes, both under the caller's tag.

Ranks are those of the group; ``ranks`` maps them to the global ranks
``torch.distributed`` addresses. A send to oneself goes to a mailbox, as
in the reference. Sends do not wait for their receiver (a gloo send
completes only when the peer receives, so a ring of blocking sends would
deadlock): each is started with ``isend`` and its buffer kept until it
completes.
"""

from __future__ import annotations

import functools
import operator
import pickle
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


class ObjectComm:
    """Object communication among ``ranks`` (global ranks, in group order)
    over the gloo group ``group``."""

    def __init__(self, group, ranks: Sequence[int]) -> None:
        self.group = group
        self.ranks = list(ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.size = len(self.ranks)
        self._mailbox: dict[int, list] = {}
        self._in_flight: list = []   # (work, buffer) of unfinished sends

    def _check(self, who: str, r: int) -> int:
        if not 0 <= r < self.size:
            raise ValueError(f"{who}={r} out of range for {self.size} ranks")
        return self.ranks[r]

    def _isend(self, buf: torch.Tensor, dest: int, tag: int) -> None:
        self._in_flight = [(w, b) for w, b in self._in_flight
                           if not w.is_completed()]
        work = dist.isend(buf, self._check("dest", dest), self.group, tag)
        self._in_flight.append((work, buf))

    def wait_sends(self) -> None:
        """Wait until every send this rank started has been received."""
        for work, _ in self._in_flight:
            work.wait()
        self._in_flight = []

    # -- raw tensors (the leaves of comm.send / comm.recv) -------------- #

    def send_tensor(self, t: torch.Tensor, dest: int, tag: int = 0) -> None:
        """Send a CPU tensor's bytes (``dest`` != this rank)."""
        if t.numel():
            buf = t.detach().cpu().contiguous().view(-1).view(torch.uint8)
            self._isend(buf.clone(), dest, tag)

    def recv_tensor(self, shape, dtype, source: int,
                    tag: int = 0) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype)
        if out.numel():
            dist.recv(out.view(-1).view(torch.uint8),
                      self._check("source", source), self.group, tag)
        return out

    # -- pickled objects ------------------------------------------------- #

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        if dest == self.rank:
            self._mailbox.setdefault(tag, []).append(pickle.dumps(obj))
            return
        payload = pickle.dumps(obj)
        self._isend(torch.tensor([len(payload)], dtype=torch.int64), dest,
                    tag)
        self._isend(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                    dest, tag)

    def recv_obj(self, source: int, tag: int = 0) -> Any:
        if source == self.rank:
            queue = self._mailbox.get(tag)
            if not queue:
                raise RuntimeError(f"recv_obj(source={source}, tag={tag}): "
                                   "nothing sent")
            return pickle.loads(queue.pop(0))
        peer = self._check("source", source)
        n = torch.empty(1, dtype=torch.int64)
        dist.recv(n, peer, self.group, tag)
        buf = torch.empty(int(n), dtype=torch.uint8)
        dist.recv(buf, peer, self.group, tag)
        return pickle.loads(buf.numpy().tobytes())

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, self._check("root", root), self.group)
        return box[0]

    def gather_obj(self, obj: Any, root: int = 0) -> list[Any] | None:
        out = [None] * self.size if self.rank == root else None
        dist.gather_object(obj, out, self._check("root", root), self.group)
        return out

    def allgather_obj(self, obj: Any) -> list[Any]:
        out = [None] * self.size
        dist.all_gather_object(out, obj, self.group)
        return out

    def allreduce_obj(self, obj: Any,
                      reduce_func: Callable | None = None) -> Any:
        """Reduce every rank's object with ``reduce_func`` (``+`` by
        default, as in the reference)."""
        return functools.reduce(reduce_func or operator.add,
                                self.allgather_obj(obj))

    def scatter_obj(self, objs: Sequence[Any] | None, root: int = 0) -> Any:
        if self.rank == root and (objs is None or len(objs) != self.size):
            raise ValueError(f"root must supply a sequence of length "
                             f"{self.size}")
        out = [None]
        dist.scatter_object_list(
            out, list(objs) if self.rank == root else None,
            self._check("root", root), self.group)
        return out[0]

    def barrier(self) -> None:
        self.wait_sends()
        dist.barrier(self.group)


__all__ = ["ObjectComm"]
