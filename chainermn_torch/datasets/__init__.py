"""Dataset scattering across ranks (the port of
``chainermn_tpu/datasets/__init__.py``, host code copied as it is).

Root draws the (optionally shuffled) permutation of the index space and
broadcasts it with ``bcast_obj``; each rank keeps a :class:`SubDataset`
view of its near-equal contiguous slice. With ``force_transport=True``
root ships the records themselves, for sources only root can read (the
reference behaviour of ChainerMN).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from chainermn_torch.communicators.communicator_base import CommunicatorBase


class SubDataset:
    """An index-remapped view of a dataset; supports len, getitem (ints
    and slices) and iteration."""

    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self._dataset = dataset
        self._indices = np.asarray(indices, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self._indices[i]]
        return self._dataset[int(self._indices[i])]

    def __iter__(self):
        for j in self._indices:
            yield self._dataset[int(j)]

    @property
    def indices(self) -> np.ndarray:
        return self._indices


def scatter_index(n_total: int, comm: CommunicatorBase, root: int = 0, *,
                  n_shards: Optional[int] = None,
                  shard_id: Optional[int] = None) -> tuple[int, int]:
    """This shard's ``(begin, end)`` of ``range(n_total)`` split into
    near-equal contiguous shards, one a rank; the first ``n_total %
    n_shards`` shards get one extra element."""
    del root  # arithmetic only: nothing travels
    n = n_shards if n_shards is not None else comm.size
    i = shard_id if shard_id is not None else comm.rank
    if not 0 <= i < n:
        raise ValueError(f"shard_id {i} out of range [0, {n})")
    base, extra = divmod(n_total, n)
    begin = i * base + min(i, extra)
    return begin, begin + base + (1 if i < extra else 0)


def scatter_dataset(dataset, comm: CommunicatorBase, shuffle: bool = False,
                    root: int = 0, seed: Optional[int] = None, *,
                    n_shards: Optional[int] = None,
                    shard_id: Optional[int] = None,
                    force_transport: bool = False) -> SubDataset:
    """Shard ``dataset`` across ranks: disjoint, exhaustive shards of
    root's (optionally shuffled, from ``seed``) permutation.
    ``n_shards``/``shard_id`` override the geometry (one process can then
    play every shard)."""
    n = n_shards if n_shards is not None else comm.size
    i = shard_id if shard_id is not None else comm.rank
    order = None
    if comm.rank == root:
        n_total = len(dataset)
        order = (np.random.RandomState(seed).permutation(n_total) if shuffle
                 else np.arange(n_total))
    order = comm.bcast_obj(order, root=root)
    shards = [order[slice(*scatter_index(len(order), comm, n_shards=n,
                                         shard_id=s))] for s in range(n)]
    if not force_transport:
        return SubDataset(dataset, shards[i])
    payloads = None
    if comm.rank == root:
        payloads = [[dataset[int(j)] for j in idx] for idx in shards]
    if n == comm.size and shard_id is None:
        local = comm.scatter_obj(payloads, root=root)
    else:   # another geometry: ship every shard, pick locally
        local = comm.bcast_obj(payloads, root=root)[i]
    return SubDataset(local, np.arange(len(local)))


def create_empty_dataset(dataset) -> SubDataset:
    """A zero-length placeholder with the dataset interface, for ranks
    that hold no data."""
    return SubDataset(dataset, np.empty((0,), np.int64))


def get_n_iterations_for_one_epoch(dataset, local_batch_size: int) -> int:
    """``ceil(len(dataset) / local_batch_size)``."""
    return -(-len(dataset) // local_batch_size)


def equal_shards(shard, comm: CommunicatorBase) -> SubDataset:
    """``shard`` padded with its own first records to the longest rank's
    length (ChainerMN's ``force_equal_length``), so every rank draws the
    same number of batches an epoch — one process a rank runs a
    collective step cadence. Every rank calls it."""
    longest = comm.allreduce_obj(len(shard), max)
    if len(shard) == longest:
        return shard
    idx = list(range(len(shard)))
    return SubDataset(shard, idx + idx[:longest - len(shard)])


__all__ = ["SubDataset", "scatter_dataset", "scatter_index",
           "create_empty_dataset", "get_n_iterations_for_one_epoch",
           "equal_shards"]
