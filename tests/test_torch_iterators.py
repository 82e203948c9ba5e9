"""The port's iterators (``chainermn_torch.iterators``) against the JAX
package's: ``SerialIterator``'s order (numpy ``RandomState``, so the
same seed gives the same permutation bit for bit), epochs,
``epoch_detail``, ``is_new_epoch``, ``reseed``, ``repeat=False`` and the
``state_dict`` round trip, step by step beside the reference; then the
multi-node and synchronized iterators on 2 gloo ranks against the
reference iterator driven the same way.
"""

import numpy as np
import pytest

from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.testing import run_ranks


def _trace(it, n):
    return [(next(it), it.epoch, it.epoch_detail, it.is_new_epoch)
            for _ in range(n)]


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 7),
                                          (False, None)])
@pytest.mark.parametrize("n,bs", [(10, 3), (12, 4)])
def test_serial_iterator_matches_the_reference(n, bs, shuffle, seed):
    data = list(range(n))
    got = _trace(SerialIterator(data, bs, shuffle=shuffle, seed=seed), 12)
    want = _trace(JaxSerialIterator(data, bs, shuffle=shuffle, seed=seed),
                  12)
    assert got == want


def test_reseed_and_single_pass_match_the_reference():
    pairs = [cls(list(range(9)), 4, shuffle=True, seed=1)
             for cls in (SerialIterator, JaxSerialIterator)]
    for it in pairs:
        next(it)
        it.reseed(11)
    assert _trace(pairs[0], 5) == _trace(pairs[1], 5)
    one = [list(cls(list(range(7)), 3, repeat=False))
           for cls in (SerialIterator, JaxSerialIterator)]
    assert one[0] == one[1] == [[0, 1, 2], [3, 4, 5], [6]]


def test_state_dict_round_trip_and_interchange():
    """A snapshot mid-epoch and one exactly at an epoch boundary restore
    the same batches and flags, onto the port's iterator or the
    reference's (the two share the state format)."""
    it = SerialIterator(list(range(10)), 3, shuffle=True, seed=2)
    for _ in range(2):
        next(it)
    mid = it.state_dict()
    rest = _trace(it, 6)
    for cls in (SerialIterator, JaxSerialIterator):
        other = cls(list(range(10)), 3, shuffle=True, seed=99)
        other.load_state_dict(mid)
        assert _trace(other, 6) == rest
    it = SerialIterator(list(range(6)), 3, shuffle=True, seed=2)
    next(it)
    next(it)
    edge = it.state_dict()
    back = SerialIterator(list(range(6)), 3, shuffle=True, seed=2)
    back.load_state_dict(edge)
    assert back.is_new_epoch and back.epoch == 1
    assert next(back) == next(it)


_WORKER = """
from chainermn_torch import (
    SerialIterator, create_communicator, create_multi_node_iterator,
    create_synchronized_iterator)

comm = create_communicator("naive", device="cpu")
data = list(range(10))
master = SerialIterator(data, 3, shuffle=True, seed=5) if RANK == 0 else None
mn = create_multi_node_iterator(master, comm)
seen = [(next(mn), mn.epoch, mn.is_new_epoch) for _ in range(5)]
single = create_multi_node_iterator(
    SerialIterator(data, 4, repeat=False) if RANK == 0 else None, comm)
flushed = list(single)
sync = create_synchronized_iterator(
    SerialIterator(data, 3, shuffle=True, seed=RANK), comm, seed=None)
synced = [next(sync) for _ in range(4)]
fixed = create_synchronized_iterator(
    SerialIterator(data, 3, shuffle=True, seed=RANK), comm, seed=123)
save({"seen": seen, "flushed": flushed, "synced": synced,
      "fixed": [next(fixed) for _ in range(4)]})
comm.finalize()
"""


def test_multi_node_and_synchronized_iterators_on_two_ranks():
    got = run_ranks(_WORKER, 2)
    ref = JaxSerialIterator(list(range(10)), 3, shuffle=True, seed=5)
    want = [(next(ref), ref.epoch, ref.is_new_epoch) for _ in range(5)]
    for rank in got:
        assert rank["seen"] == want                    # master's batches
        assert rank["flushed"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert got[0]["synced"] == got[1]["synced"]        # lockstep orders
    ref = JaxSerialIterator(list(range(10)), 3, shuffle=True, seed=0)
    ref.reseed(123)
    assert got[0]["fixed"] == got[1]["fixed"] == [next(ref)
                                                   for _ in range(4)]
