"""Distributed checkpoint/resume for fail-and-restart fault tolerance
(the port of ``chainermn_tpu/extensions/checkpoint.py``).

Every semantic of the JAX package's checkpointer, kept:

- each rank writes **iteration-stamped, rank-local** snapshots
  (``snapshot_<name>_<iteration>.<rank>``) of its training state;
- old snapshots are garbage-collected, keeping the newest ``n_retains``;
- on startup ``maybe_load`` resumes every rank from the **newest commonly
  available** iteration, agreed over the communicator's object channel;
- resume requires the same world size (snapshots are per-rank local);
- every snapshot carries a **CRC32 checksum footer**; a corrupt newest
  common iteration is **skipped back** collectively; orphaned ``.tmp``
  files are swept at startup; the save/load paths carry the
  ``checkpoint.save`` / ``checkpoint.write`` / ``checkpoint.load``
  cut-points and an optional :class:`~chainermn_torch.resilience.RetryPolicy`,
  and publish save/load histograms and ``checkpoint_corrupt_total``;
- ``save_async`` fixes the snapshot's content on the calling thread and
  writes it on one writer thread; write and GC share one lock;
  ``wait_async`` joins, and ``maybe_load``/``finalize`` join first.

The file format is the JAX package's, byte for byte: a pickle (protocol
4) of ``{"world_size": W, "state": state}`` whose array leaves are numpy
arrays, then the ``CMNTPUC1`` footer, so a snapshot written by either
package loads in the other. Tensors go to numpy on save (one process a
rank, so ``world_size`` is the communicator's size); a bf16 tensor, which
has no numpy dtype, is stored as ``{"__bfloat16_bits__": uint16 array}``
and never widened. A loaded state comes back as numpy, and the caller
puts it back on its device (:func:`to_tensors`).
"""

from __future__ import annotations

import os
import pickle
import queue
import re
import struct
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from chainermn_torch.communicators.communicator_base import CommunicatorBase
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.resilience.cutpoints import (
    CHECKPOINT_LOAD,
    CHECKPOINT_SAVE,
    CHECKPOINT_WRITE,
)
from chainermn_torch.resilience.faults import inject, torn_fraction

# Footer: | payload ... | MAGIC (8B) | crc32 (4B, LE) | payload_len (8B, LE) |
_FOOTER_MAGIC = b"CMNTPUC1"
_FOOTER_TAIL = struct.Struct("<IQ")
_FOOTER_LEN = len(_FOOTER_MAGIC) + _FOOTER_TAIL.size


# bfloat16 has no numpy dtype: a bf16 tensor is stored as its bits,
# {_BF16: uint16 array}, never widened
_BF16 = "__bfloat16_bits__"


def _tree_map(fn, tree):
    """``fn`` over the leaves of a dict/list/tuple tree (other objects,
    and the bf16 tag, are leaves)."""
    if isinstance(tree, dict) and _BF16 not in tree:
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(leaf):
    """A leaf as host data with OWNED bytes: a tensor as a numpy array (a
    bf16 one as its tagged bits), a numpy array copied — an aliased leaf
    would let the training loop mutate a snapshot that is still queued for
    the async writer."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16: t.view(torch.int16).numpy().view(np.uint16).copy()}
        try:
            return t.numpy().copy()
        except TypeError as e:
            raise TypeError(f"checkpoint: a {t.dtype} tensor has no numpy "
                            "dtype to be stored as") from e
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def host_state(state: Any) -> Any:
    """``state`` as the checkpointer stores it: every tensor a numpy
    array (bf16 as tagged bits), every numpy array copied."""
    return _tree_map(_host_copy, state)


def to_tensors(tree: Any) -> Any:
    """The inverse of :func:`host_state` for a loaded (sub)tree: numpy
    arrays (and tagged bf16 bits) as CPU tensors, other leaves as they
    are (``load_state_dict`` then puts them on the device). Apply it to
    the model and optimizer parts of a snapshot, not to an iterator's
    state (its RNG state holds a numpy array that must stay one)."""
    def leaf(x):
        if isinstance(x, dict):
            bits = torch.from_numpy(np.array(x[_BF16]).view(np.int16))
            return bits.view(torch.bfloat16)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x))
        return x
    return _tree_map(leaf, tree)


def _add_footer(payload: bytes) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return payload + _FOOTER_MAGIC + _FOOTER_TAIL.pack(crc, len(payload))


def _strip_footer(data: bytes) -> tuple[bytes, Optional[bool]]:
    """``(payload, verified)`` — ``True``: checksum matched; ``False``:
    footer present but corrupt; ``None``: legacy file without a footer
    (the unpickle is then the only check)."""
    if len(data) >= _FOOTER_LEN and data[-_FOOTER_LEN:-_FOOTER_TAIL.size] \
            == _FOOTER_MAGIC:
        crc, ln = _FOOTER_TAIL.unpack(data[-_FOOTER_TAIL.size:])
        payload = data[:-_FOOTER_LEN]
        ok = ln == len(payload) and (zlib.crc32(payload) & 0xFFFFFFFF) == crc
        return payload, ok
    return data, None


class MultiNodeCheckpointer:
    """See module docstring. Build via :func:`create_multi_node_checkpointer`."""

    def __init__(
        self,
        name: str,
        comm: CommunicatorBase,
        path: Optional[str] = None,
        n_retains: int = 5,
        *,
        rank: Optional[int] = None,
        retry=None,
    ) -> None:
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", name):
            raise ValueError(f"checkpoint name must be filename-safe, got {name!r}")
        self.name = name
        self._comm = comm
        self._rank = comm.rank if rank is None else rank
        self.path = os.path.abspath(path or os.getcwd())
        os.makedirs(self.path, exist_ok=True)
        self._n_retains = int(n_retains)
        self._retry = retry
        self.stats: dict[str, list[float]] = {
            "save": [], "load": [], "save_async": []}
        reg = get_registry()
        labels = {"name": name}
        self._h_save = reg.histogram("checkpoint_save_seconds", labels)
        self._h_load = reg.histogram("checkpoint_load_seconds", labels)
        self._c_corrupt = reg.counter("checkpoint_corrupt_total", labels)
        self._h_async = reg.histogram("checkpoint_async_save_seconds",
                                      labels)
        self._c_async_err = reg.counter("checkpoint_async_errors_total",
                                        labels)
        self._events = get_event_log()
        # One lock serializes every write+GC (sync save, async writer): a
        # snapshot must never be GC-deleted while its successor is still
        # `.tmp` — a crash in that window would leave NO intact newest
        # snapshot even though the save "mostly worked".
        self._io_lock = threading.Lock()
        self._async_q: Optional[queue.Queue] = None
        self._async_thread: Optional[threading.Thread] = None
        self._async_cv = threading.Condition()
        self._async_pending = 0
        self._async_errors: list[BaseException] = []
        self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        """Remove this rank's orphaned ``.tmp`` files from crashed saves."""
        pat = re.compile(
            rf"snapshot_{re.escape(self.name)}_\d+\.{self._rank}\.tmp$"
        )
        for f in os.listdir(self.path):
            if pat.fullmatch(f):
                try:
                    os.remove(os.path.join(self.path, f))
                except OSError:
                    pass

    def _world_size(self) -> int:
        """Per-rank snapshots exist per process, and the port runs one
        process a rank."""
        return self._comm.size

    # -- naming ---------------------------------------------------------- #

    def filename(self, iteration: int, rank: Optional[int] = None) -> str:
        r = self._rank if rank is None else rank
        return os.path.join(
            self.path, f"snapshot_{self.name}_{int(iteration)}.{r}"
        )

    def _local_iterations(self) -> list[int]:
        pat = re.compile(
            rf"snapshot_{re.escape(self.name)}_(\d+)\.{self._rank}$"
        )
        its = []
        for f in os.listdir(self.path):
            m = pat.fullmatch(f)
            if m:
                its.append(int(m.group(1)))
        return sorted(its)

    # -- save ------------------------------------------------------------ #

    def save(self, state: Any, iteration: int) -> str:
        """Snapshot this rank's ``state`` at ``iteration``; GC old ones."""
        t0 = time.time()
        inject(CHECKPOINT_SAVE, iteration=int(iteration))
        target = self._write_snapshot(host_state(state), iteration)
        dt = time.time() - t0
        self.stats["save"].append(dt)
        self._h_save.observe(dt)
        return target

    def _write_snapshot(self, snapshot: Any, iteration: int) -> str:
        """Serialize + CRC footer + atomic rename + GC — the I/O half of a
        save, shared by the sync path and the async writer thread. Write
        AND GC run under one lock so a snapshot is never deleted while its
        successor is still ``.tmp`` (and sync/async writes never
        interleave)."""
        target = self.filename(iteration)
        tmp = target + ".tmp"
        payload = {"world_size": self._world_size(), "state": snapshot}
        blob = _add_footer(pickle.dumps(payload, protocol=4))
        # torn-write cut-point: a fired fault silently truncates the bytes
        # that reach disk — the data-loss case only the checksum catches
        frac = torn_fraction(CHECKPOINT_WRITE, iteration=int(iteration))
        data = blob if frac is None else blob[: int(len(blob) * frac)]

        def write() -> None:
            # _io_lock IS the I/O serializer: sync and async savers must
            # not interleave writes, so disk work under it is the
            # invariant, not a bug
            with open(tmp, "wb") as f:
                f.write(data[: len(data) // 2])
                # mid-write cut-point: a raise here leaves a torn .tmp —
                # the crash the atomic rename + startup sweep absorb
                inject(CHECKPOINT_WRITE, iteration=int(iteration))
                f.write(data[len(data) // 2:])
            # atomic publish belongs inside the same _io_lock hold as
            # the bytes it publishes
            os.replace(tmp, target)

        with self._io_lock:
            if self._retry is not None:
                self._retry.call(write, op="checkpoint.save")
            else:
                write()
            self._gc()
        self._events.emit("checkpoint_save", iteration=int(iteration),
                          bytes=len(data))
        return target

    # -- async save ------------------------------------------------------ #

    def save_async(self, state: Any, iteration: int) -> str:
        """Snapshot without blocking the caller on serialization or disk.

        The calling thread does only the host copy (:func:`host_state`)
        — the consistency point: the snapshot's content is fixed here, so the training loop
        is free to keep mutating device buffers (donation included) the
        moment this returns. A single writer thread then runs the exact
        sync-save I/O path (:meth:`_write_snapshot`): same CRC footer,
        same ``checkpoint.write`` / torn-write cut-points, same retry
        policy, same atomic rename, and GC under the same lock.

        Failure surfacing: a writer-thread error is counted
        (``checkpoint_async_errors_total``), event-logged, and re-raised
        from the NEXT ``save_async`` or from :meth:`wait_async`;
        :meth:`maybe_load` and :meth:`finalize` join pending saves first,
        so a restore can never race (or trust) a half-written snapshot.
        """
        self.wait_async(raise_errors=True, join=False)
        inject(CHECKPOINT_SAVE, iteration=int(iteration))
        snapshot = host_state(state)
        self._ensure_writer()
        with self._async_cv:
            self._async_pending += 1
        self._async_q.put((snapshot, int(iteration), time.time()))
        self._events.emit("checkpoint_save_async_enqueued",
                          iteration=int(iteration))
        return self.filename(iteration)

    def _ensure_writer(self) -> None:
        if self._async_q is None:
            self._async_q = queue.Queue()
        if self._async_thread is None or not self._async_thread.is_alive():
            self._async_thread = threading.Thread(
                target=self._writer_loop, name=f"ckpt-writer-{self.name}",
                daemon=True)
            self._async_thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._async_q.get()
            if job is None:
                return
            snapshot, iteration, t_enq = job
            try:
                self._write_snapshot(snapshot, iteration)
                dt = time.time() - t_enq
                self.stats["save_async"].append(dt)
                self._h_async.observe(dt)
            except BaseException as e:  # noqa: BLE001 — surfaced at join
                self._c_async_err.inc()
                self._events.emit(
                    "checkpoint_async_error", iteration=int(iteration),
                    error=f"{type(e).__name__}: {e}"[:200])
                with self._async_cv:
                    self._async_errors.append(e)
            finally:
                with self._async_cv:
                    self._async_pending -= 1
                    self._async_cv.notify_all()

    def wait_async(self, raise_errors: bool = True, join: bool = True
                   ) -> bool:
        """Join every pending async save (the pre-restore / end-of-run
        barrier). Returns True when all saves since the last wait landed
        intact. ``raise_errors=False`` is the restore path's posture —
        failures stay counted/evented only, because a missing snapshot is
        already handled by the newest-common-iteration agreement."""
        with self._async_cv:
            if join:
                while self._async_pending:
                    self._async_cv.wait(timeout=0.5)
            errs = list(self._async_errors)
            self._async_errors.clear()
        if errs and raise_errors:
            raise errs[0]
        return not errs

    def _shutdown_writer(self) -> None:
        if self._async_thread is not None and self._async_thread.is_alive():
            self._async_q.put(None)
            self._async_thread.join(timeout=5.0)
        self._async_thread = None

    def _gc(self) -> None:
        its = self._local_iterations()
        for it in its[: max(0, len(its) - self._n_retains)]:
            try:
                # GC under the write lock is deliberate: a snapshot
                # must never be deleted while its successor is still a
                # torn .tmp
                os.remove(self.filename(it))
            except OSError:
                pass  # already gone; never fail training over GC

    # -- load ------------------------------------------------------------ #

    def _try_load(self, iteration: int) -> Optional[dict]:
        """Read + verify + unpickle one local snapshot; None when corrupt
        (counted and event-logged, never raised — corruption is a vote to
        skip back, not a crash)."""
        try:
            def read() -> bytes:
                with open(self.filename(iteration), "rb") as f:
                    return f.read()

            data = (self._retry.call(read, op="checkpoint.load")
                    if self._retry is not None else read())
            payload_bytes, verified = _strip_footer(data)
            if verified is False:
                raise ValueError("checksum mismatch (torn write?)")
            payload = pickle.loads(payload_bytes)
            if not isinstance(payload, dict) or "state" not in payload:
                raise ValueError("malformed snapshot payload")
            return payload
        except Exception as e:
            self._c_corrupt.inc()
            self._events.emit("checkpoint_corrupt",
                              iteration=int(iteration),
                              error=f"{type(e).__name__}: {e}"[:200])
            return None

    def maybe_load(self, state: Any = None) -> tuple[Any, int]:
        """Resume from the newest iteration available AND intact on ALL
        ranks.

        Returns ``(loaded_state, iteration)``; when no common snapshot
        exists, returns ``(state, 0)`` unchanged (fresh start) — the
        reference's ``resume = checkpointer.maybe_load(trainer)`` contract.
        A corrupt copy anywhere (checksum/unpickle failure) makes every
        rank discard that iteration and re-agree on the next-newest — the
        skip-back loop is collective, so ranks never split over which
        snapshot to trust.
        """
        # pre-restore join: never race (or half-trust) a pending async
        # save — a failed one is just a missing/old snapshot to the
        # agreement below, so errors are not re-raised here
        self.wait_async(raise_errors=False)
        inject(CHECKPOINT_LOAD)
        local = set(self._local_iterations())
        while True:
            all_sets = self._comm.allgather_obj(local)
            common = set.intersection(*map(set, all_sets)) if all_sets else set()
            if not common:
                return state, 0
            it = max(common)
            t0 = time.time()
            payload = self._try_load(it)
            oks = self._comm.allgather_obj(payload is not None)
            if all(oks):
                world_now = self._world_size()
                if payload["world_size"] != world_now:
                    raise RuntimeError(
                        f"snapshot '{self.name}' iteration {it} was taken with "
                        f"{payload['world_size']} processes but this job has "
                        f"{world_now}; per-rank snapshots require the same "
                        "world size"
                    )
                dt = time.time() - t0
                self.stats["load"].append(dt)
                self._h_load.observe(dt)
                self._events.emit("checkpoint_load", iteration=int(it))
                return payload["state"], it
            # someone's copy of `it` is corrupt: skip back collectively
            local.discard(it)

    # -- misc ------------------------------------------------------------ #

    def get_stats(self) -> dict[str, float]:
        """Mean save/load seconds (reference exposes timing stats)."""
        return {
            k: (sum(v) / len(v) if v else 0.0) for k, v in self.stats.items()
        }

    def finalize(self) -> None:
        """Remove every snapshot this rank owns (reference ``finalize``).
        Joins pending async saves and stops the writer thread first."""
        self.wait_async(raise_errors=False)
        self._shutdown_writer()
        for it in self._local_iterations():
            try:
                os.remove(self.filename(it))
            except OSError:
                pass


def create_multi_node_checkpointer(
    name: str,
    comm: CommunicatorBase,
    path: Optional[str] = None,
    n_retains: int = 5,
    **kwargs,
) -> MultiNodeCheckpointer:
    """Reference ``create_multi_node_checkpointer(name, comm, ...)``."""
    return MultiNodeCheckpointer(name, comm, path, n_retains, **kwargs)


__all__ = ["MultiNodeCheckpointer", "create_multi_node_checkpointer",
           "host_state", "to_tensors"]
