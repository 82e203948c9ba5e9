"""Host-side object communication: pickled objects and raw CPU tensors
between the ranks of a communicator (the port's counterpart of
``chainermn_tpu/communicators/_object_comm.py``). Two transports:

- :class:`ObjectComm` (the default) rides a gloo process group:
  ``torch.distributed``'s object collectives, and point-to-point as a
  length header then the bytes, both under the caller's tag. A send to
  oneself goes to a mailbox, as in the reference. Sends do not wait for
  their receiver (a gloo send completes only when the peer receives, so
  a ring of blocking sends would deadlock): each is started with
  ``isend`` and its buffer kept until it completes.
- :class:`KVObjectComm` is the reference's transport-independent
  key-value protocol (``KVStoreObjectComm``: per-op sequence keys,
  per-pair point-to-point keys, the ack-based lazy garbage collection),
  over four transport hooks. :class:`~chainermn_torch.native.objstore.
  NativeObjectComm` runs it on the C++ TCP sidecar. The reference's
  second transport, the jax.distributed key-value store, has no twin:
  the gloo :class:`ObjectComm` holds its place.

:func:`create_object_comm` picks one, as the reference selects its own
(``CHAINERMN_TORCH_OBJSTORE`` names a sidecar store and its library
builds → the sidecar; otherwise gloo).

Ranks are those of the group; ``ranks`` maps them to the global ranks
``torch.distributed`` addresses.
"""

from __future__ import annotations

import functools
import operator
import os
import pickle
import time
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

    def close(self) -> None:
        self.wait_sends()


# communicators attached so far over each tuple of global ranks: every
# member of a group attaches its communicators in the same order, so the
# count names the same namespace on every member (a process-wide counter
# would not: ``split`` attaches only the caller's color)
_GROUP_ATTACHES: dict = {}


def group_namespace(ranks: Sequence[int]) -> str:
    """A key namespace that every member of the group over ``ranks``
    derives alike: the global ranks, then this group's attach count."""
    key = tuple(int(r) for r in ranks)
    n = _GROUP_ATTACHES.get(key, 0)
    _GROUP_ATTACHES[key] = n + 1
    return f"{'-'.join(map(str, key))}/{n}"


class KVObjectComm:
    """Object communication over a key-value store with blocking gets:
    the reference's ``KVStoreObjectComm`` protocol, transport-independent.

    Chunked pickled payloads under per-round keys. Collective ops use a
    per-op counter that every rank advances identically (SPMD host code
    calls collectives in the same order everywhere, the assumption MPI
    collectives make); point-to-point ops use a per-(src, dst, tag)
    sequence advanced by both endpoints, so uninvolved ranks never
    desynchronize. The namespace (:func:`group_namespace`) keeps two
    communicators from sharing keys.

    GC without races: a round's keys are deleted only once every reader
    has consumed them. Single-reader rounds (p2p recv; gather at root)
    are deleted by that reader at once. Multi-reader rounds (bcast,
    allgather, scatter) get an ``ack/<rank>`` key from each reader; the
    round's writer checks acks lazily, on its next use of the same op,
    and deletes only fully-acked rounds (a bounded leak beats a failed
    blocking get on a slow rank). :meth:`flush_gc` drains what is left.

    Subclasses provide the transport: ``_put``, ``_get``,
    ``_delete_dir``, ``_ack`` and ``_count_acks``.
    """

    def _init_protocol_state(self, rank: int, size: int,
                             namespace: str) -> None:
        self.rank = rank
        self.size = size
        self._ns = f"chainermn_torch/obj/{namespace}"
        self._op_seq: dict[str, int] = {}
        self._p2p_seq: dict[tuple[int, int, int], int] = {}
        # rounds this rank wrote, awaiting reader acks: op -> [(key, n)]
        self._pending: dict[str, list[tuple[str, int]]] = {}

    # -- transport hooks -------------------------------------------------- #

    def _put(self, key: str, payload: bytes) -> None:
        raise NotImplementedError

    def _get(self, key: str, timeout_ms: int = 600_000) -> bytes:
        raise NotImplementedError

    def _delete_dir(self, key_prefix: str) -> None:
        raise NotImplementedError

    def _ack(self, round_key: str) -> None:
        raise NotImplementedError

    def _count_acks(self, prefix: str) -> int:
        raise NotImplementedError

    # -- keys ------------------------------------------------------------- #

    @property
    def namespace(self) -> str:
        """The key prefix every round of this communicator lives under."""
        return self._ns

    def _op_key(self, op: str) -> str:
        """Advance the collective counter for ``op`` (no GC here — see
        the class docstring for the ack-based scheme)."""
        seq = self._op_seq.get(op, 0)
        self._op_seq[op] = seq + 1
        return f"{self._ns}/{op}/{seq}"

    def _p2p_key(self, src: int, dst: int, tag: int) -> str:
        pair = (src, dst, tag)
        seq = self._p2p_seq.get(pair, 0)
        self._p2p_seq[pair] = seq + 1
        return f"{self._ns}/p2p/{src}/{dst}/{tag}/{seq}"

    # -- ack-based lazy GC ------------------------------------------------ #

    def _gc_pending(self, op: str) -> None:
        """Delete previously written rounds of ``op`` whose readers have
        all acked. Every rank calls this on every use of ``op`` (its
        pending list holds only rounds *it* wrote, so ownership follows
        the writer even when roots rotate). Failures mean 'keep' — leak,
        never race."""
        pend = self._pending.setdefault(op, [])
        keep = []
        for rk, expected_acks in pend:
            done = False
            try:
                done = self._count_acks(f"{rk}/ack/") >= expected_acks
            except Exception:
                done = False
            if done:
                self._delete_dir(rk)
            else:
                keep.append((rk, expected_acks))
        self._pending[op] = keep

    def flush_gc(self, timeout_s: float = 60.0) -> int:
        """Collect every round this rank wrote, waiting up to
        ``timeout_s`` for the readers' acks; returns how many rounds are
        still pending (0 once every reader has acked)."""
        deadline = time.monotonic() + timeout_s
        while True:
            for op in list(self._pending):
                self._gc_pending(op)
            left = sum(len(v) for v in self._pending.values())
            if not left or time.monotonic() >= deadline:
                return left
            time.sleep(0.005)

    def _check(self, who: str, r: int) -> int:
        if not 0 <= r < self.size:
            raise ValueError(f"{who}={r} out of range for {self.size} ranks")
        return r

    # -- raw tensors (the leaves of comm.send / comm.recv) ---------------- #

    def send_tensor(self, t: torch.Tensor, dest: int, tag: int = 0) -> None:
        """Send a tensor's bytes with its dtype and shape (the receiver
        checks both against what it expects)."""
        self._check("dest", dest)
        t = t.detach().cpu().contiguous()
        head = f"{t.dtype}|{','.join(map(str, t.shape))}".encode()
        raw = t.view(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        self._put(self._p2p_key(self.rank, dest, tag),
                  len(head).to_bytes(4, "little") + head + raw)

    def recv_tensor(self, shape, dtype, source: int,
                    tag: int = 0) -> torch.Tensor:
        self._check("source", source)
        key = self._p2p_key(source, self.rank, tag)
        payload = self._get(key)
        self._delete_dir(key)  # sole reader: immediate GC is race-free
        n = int.from_bytes(payload[:4], "little")
        head = payload[4:4 + n].decode()
        want = f"{dtype}|{','.join(map(str, shape))}"
        if head != want:
            raise RuntimeError(f"recv_tensor(source={source}, tag={tag}): "
                               f"got {head}, expected {want}")
        out = torch.empty(tuple(shape), dtype=dtype)
        if out.numel():
            out.view(-1).view(torch.uint8).copy_(torch.frombuffer(
                bytearray(payload[4 + n:]), dtype=torch.uint8))
        return out

    def wait_sends(self) -> None:
        """Sends complete when the store holds them: nothing to wait for."""

    # -- objects ---------------------------------------------------------- #

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        self._check("dest", dest)
        self._put(self._p2p_key(self.rank, dest, tag), pickle.dumps(obj))

    def recv_obj(self, source: int, tag: int = 0) -> Any:
        self._check("source", source)
        key = self._p2p_key(source, self.rank, tag)
        out = pickle.loads(self._get(key))
        self._delete_dir(key)  # sole reader: immediate GC is race-free
        return out

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        self._check("root", root)
        key = self._op_key("bcast")
        self._gc_pending("bcast")
        if self.rank == root:
            self._put(f"{key}/payload", pickle.dumps(obj))
            self._pending["bcast"].append((key, self.size - 1))
            return obj
        out = pickle.loads(self._get(f"{key}/payload"))
        self._ack(key)
        return out

    def gather_obj(self, obj: Any, root: int = 0) -> list[Any] | None:
        self._check("root", root)
        key = self._op_key("gather")
        self._put(f"{key}/val/{self.rank}", pickle.dumps(obj))
        if self.rank != root:
            return None
        out = [pickle.loads(self._get(f"{key}/val/{r}"))
               for r in range(self.size)]
        self._delete_dir(key)  # root is the only reader and has read all
        return out

    def allgather_obj(self, obj: Any) -> list[Any]:
        key = self._op_key("allgather")
        self._gc_pending("allgather")
        self._put(f"{key}/val/{self.rank}", pickle.dumps(obj))
        out = [pickle.loads(self._get(f"{key}/val/{r}"))
               for r in range(self.size)]
        self._ack(key)
        if self.rank == 0:  # one designated janitor per round is enough
            self._pending["allgather"].append((key, self.size))
        return out

    def allreduce_obj(self, obj: Any,
                      reduce_func: Callable | None = None) -> Any:
        return functools.reduce(reduce_func or operator.add,
                                self.allgather_obj(obj))

    def scatter_obj(self, objs: Sequence[Any] | None, root: int = 0) -> Any:
        self._check("root", root)
        key = self._op_key("scatter")
        self._gc_pending("scatter")
        if self.rank == root:
            if objs is None or len(objs) != self.size:
                raise ValueError(f"root must supply a sequence of length "
                                 f"{self.size}")
            for r, o in enumerate(objs):
                if r != root:
                    self._put(f"{key}/val/{r}", pickle.dumps(o))
            self._pending["scatter"].append((key, self.size - 1))
            return objs[root]
        out = pickle.loads(self._get(f"{key}/val/{self.rank}"))
        self._ack(key)
        return out

    def barrier(self) -> None:
        self.allgather_obj(None)

    def close(self) -> None:
        """Release the transport (subclasses)."""


OBJSTORE_ENV = "CHAINERMN_TORCH_OBJSTORE"


def create_object_comm(group, ranks: Sequence[int]):
    """The object transport for a communicator over the global ``ranks``
    (``group`` is their gloo group): the C++ sidecar when
    ``CHAINERMN_TORCH_OBJSTORE`` names a store and its library builds,
    else gloo's object collectives (the reference selects the same way,
    ``chainermn_tpu/communicators/_object_comm.py:create_object_comm``)."""
    ranks = list(ranks)
    if os.environ.get(OBJSTORE_ENV):
        from chainermn_torch.native import objstore

        if objstore.available():
            return objstore.NativeObjectComm(
                rank=ranks.index(dist.get_rank()), size=len(ranks),
                namespace=group_namespace(ranks))
    return ObjectComm(group, ranks)


__all__ = ["KVObjectComm", "OBJSTORE_ENV", "ObjectComm",
           "create_object_comm", "group_namespace"]
