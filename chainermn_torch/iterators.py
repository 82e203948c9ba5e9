"""Multi-node iterators (the port of ``chainermn_tpu/iterators``, host
code copied as it is).

- :class:`SerialIterator`: an epoch-aware batch iterator over an
  indexable dataset, with ``epoch``, ``epoch_detail``, ``is_new_epoch``,
  ``reset``, ``reseed`` and ``state_dict``/``load_state_dict``. It
  shuffles with numpy's ``RandomState``, so a seed gives the reference's
  order bit for bit.
- :func:`create_multi_node_iterator`: the master rank runs the real
  iterator and broadcasts every batch over the communicator's object
  channel (``bcast_obj``); the other ranks run a stub that receives.
- :func:`create_synchronized_iterator`: every rank keeps its own
  iterator, re-seeded with root's broadcast seed, so all draw the same
  order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chainermn_torch.communicators.communicator_base import CommunicatorBase


class SerialIterator:
    """Minimal epoch-aware batch iterator over an indexable dataset.

    Batches are lists of dataset records (examples collate them to
    arrays, not here). With ``repeat=False`` iteration raises
    ``StopIteration`` at epoch end, after flushing a final short batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        repeat: bool = True,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self._repeat = bool(repeat)
        self._shuffle = bool(shuffle)
        self._seed = seed
        self.reset()

    # -- protocol ------------------------------------------------------- #

    def __iter__(self):
        return self

    def __next__(self) -> list:
        n = len(self.dataset)
        if n == 0 or self._exhausted:
            raise StopIteration
        if self._cursor >= n:
            self._order = self._draw_order()
            self._cursor = 0
        begin = self._cursor
        end = min(begin + self.batch_size, n)
        batch = [self.dataset[int(self._order[i])] for i in range(begin, end)]
        self._cursor = end
        self._consumed += end - begin
        if end >= n:
            self.epoch += 1
            self.is_new_epoch = True
            if not self._repeat:
                self._exhausted = True
        else:
            self.is_new_epoch = False
        return batch

    next = __next__

    @property
    def epoch_detail(self) -> float:
        return self._consumed / max(1, len(self.dataset))

    def reset(self) -> None:
        self._rng = np.random.RandomState(self._seed)
        self.epoch = 0
        self.is_new_epoch = False
        self._exhausted = False
        self._consumed = 0
        self._order = self._draw_order()
        self._cursor = 0

    def reseed(self, seed: int) -> None:
        """Replace the shuffle RNG (synchronized_iterator hook)."""
        self._seed = int(seed)
        self._rng = np.random.RandomState(self._seed)
        self._order = self._draw_order()

    # -- checkpointing --------------------------------------------------- #

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "cursor": self._cursor,
            "consumed": self._consumed,
            "order": np.asarray(self._order).tolist(),
            "rng": self._rng.get_state(),
            "exhausted": self._exhausted,
            "is_new_epoch": self.is_new_epoch,
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self._consumed = int(state["consumed"])
        self._order = np.asarray(state["order"], dtype=np.int64)
        self._rng.set_state(state["rng"])
        self._exhausted = bool(state["exhausted"])
        # a snapshot taken exactly at an epoch boundary must restore the
        # boundary flag too (epoch-cadenced callers key off it); absent in
        # older snapshots -> False, matching mid-epoch behaviour
        self.is_new_epoch = bool(state.get("is_new_epoch", False))

    # -- internals ------------------------------------------------------- #

    def _draw_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self._shuffle:
            return self._rng.permutation(n)
        return np.arange(n, dtype=np.int64)


_STOP = "__chainermn_torch_iterator_stop__"


class _MultiNodeIteratorMaster:
    def __init__(self, actual_iterator, comm: CommunicatorBase, rank_master: int) -> None:
        self._it = actual_iterator
        self._comm = comm
        self._rank_master = rank_master
        self.epoch = getattr(actual_iterator, "epoch", 0)
        self.epoch_detail = getattr(actual_iterator, "epoch_detail", 0.0)
        self.is_new_epoch = getattr(actual_iterator, "is_new_epoch", False)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self._it)
        except StopIteration:
            self._comm.bcast_obj(
                (_STOP, None, None, None), root=self._rank_master
            )
            raise
        payload = (
            batch,
            getattr(self._it, "epoch", 0),
            getattr(self._it, "epoch_detail", 0.0),
            getattr(self._it, "is_new_epoch", False),
        )
        self._comm.bcast_obj(payload, root=self._rank_master)
        self.epoch, self.epoch_detail, self.is_new_epoch = payload[1:]
        return batch

    next = __next__

    def reset(self) -> None:
        if hasattr(self._it, "reset"):
            self._it.reset()

    def state_dict(self) -> dict:
        return self._it.state_dict() if hasattr(self._it, "state_dict") else {}

    def load_state_dict(self, state: dict) -> None:
        if hasattr(self._it, "load_state_dict"):
            self._it.load_state_dict(state)


class _MultiNodeIteratorSlave:
    def __init__(self, comm: CommunicatorBase, rank_master: int) -> None:
        self._comm = comm
        self._rank_master = rank_master
        self.epoch = 0
        self.epoch_detail = 0.0
        self.is_new_epoch = False

    def __iter__(self):
        return self

    def __next__(self):
        payload = self._comm.bcast_obj(None, root=self._rank_master)
        if payload[0] == _STOP:
            raise StopIteration
        batch, self.epoch, self.epoch_detail, self.is_new_epoch = payload
        return batch

    next = __next__

    def reset(self) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def create_multi_node_iterator(
    actual_iterator, communicator: CommunicatorBase, rank_master: int = 0
):
    """Reference ``create_multi_node_iterator``: rank ``rank_master`` drives
    the real iterator and broadcasts each batch; every other process gets a
    stub that receives. Pass the real iterator on the master and ``None``
    elsewhere (passing it everywhere also works — non-masters ignore it)."""
    if communicator.rank == rank_master:
        if actual_iterator is None:
            raise ValueError("master rank must supply the actual iterator")
        return _MultiNodeIteratorMaster(actual_iterator, communicator, rank_master)
    return _MultiNodeIteratorSlave(communicator, rank_master)


def create_synchronized_iterator(
    actual_iterator, communicator: CommunicatorBase, seed: Optional[int] = None
):
    """Reference ``create_synchronized_iterator``: force all ranks' shuffle
    RNGs into lockstep so every process draws the same order. Root draws a
    fresh seed (or uses ``seed`` — handy when emulating ranks within one
    process) and broadcasts it; iterators exposing ``reseed`` (ours) or a
    ``_rng`` attribute are re-seeded in place."""
    if communicator.rank == 0 and seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    seed = communicator.bcast_obj(seed, root=0)
    if hasattr(actual_iterator, "reseed"):
        actual_iterator.reseed(seed)
    elif hasattr(actual_iterator, "_rng"):
        actual_iterator._rng = np.random.RandomState(seed)
        if hasattr(actual_iterator, "reset"):
            actual_iterator.reset()
    else:
        raise TypeError(
            "iterator has no reseed()/_rng hook to synchronize; wrap a "
            "SerialIterator or add a reseed(seed) method"
        )
    return actual_iterator


__all__ = [
    "SerialIterator",
    "create_multi_node_iterator",
    "create_synchronized_iterator",
]
