"""The port's ``DevicePrefetcher`` (``chainermn_torch.dataflow``) on the
CPU (``device="cpu"``: the host-side prefetch; the copy onto the card
runs in ``chip_smoke.py``): the same batches, in the same order, as the
JAX package's prefetcher over the same ``SerialIterator``; the epoch and
``is_new_epoch`` of delivered batches; ``state_dict`` resume mid-epoch
through either the prefetcher or the bare iterator; ``close`` joining
the producer; exceptions relayed to the consumer; arrays delivered as
tensors; the stall counter; and no quiet CPU run when no card is
named.
"""

import threading
import time

import numpy as np
import pytest
import torch

from chainermn_tpu.dataflow import DevicePrefetcher as JaxPrefetcher
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_torch.dataflow import DevicePrefetcher
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.monitor import get_registry


def _it(n=30, bs=3, seed=1, cls=SerialIterator):
    return cls(list(range(n)), batch_size=bs, shuffle=True, seed=seed)


def test_same_batches_and_epochs_as_the_reference():
    """Batch by batch, with the delivered batch's epoch and
    ``is_new_epoch``, over three epochs."""
    with DevicePrefetcher(_it(n=9), depth=3, device="cpu",
                          name="tpf_same") as pre:
        got = [(next(pre), pre.epoch, pre.is_new_epoch) for _ in range(9)]
    with JaxPrefetcher(_it(n=9, cls=JaxSerialIterator), depth=3,
                       name="tpf_same_ref") as ref:
        want = [(next(ref), ref.epoch, ref.is_new_epoch) for _ in range(9)]
    assert got == want
    assert [e for _, e, new in got if new] == [1, 2, 3]


def test_state_dict_round_trip_mid_epoch():
    """Resume mid-epoch gives the same batches: prefetched but undelivered
    batches are not consumed."""
    pre = DevicePrefetcher(_it(), depth=3, device="cpu", name="tpf_rt")
    consumed = [next(pre) for _ in range(4)]
    time.sleep(0.05)          # let the producer run ahead into the queue
    state = pre.state_dict()
    rest = [next(pre) for _ in range(5)]
    pre.close()

    fresh = _it()
    fresh.load_state_dict(state)                    # bare-iterator restore
    assert [next(fresh) for _ in range(5)] == rest

    pre2 = DevicePrefetcher(_it(), depth=2, device="cpu", name="tpf_rt2")
    pre2.load_state_dict(state)                     # prefetcher restore
    assert [next(pre2) for _ in range(5)] == rest
    pre2.close()
    assert len(consumed) + len(rest) == 9


def test_close_joins_the_producer():
    before = {t.ident for t in threading.enumerate()}
    pre = DevicePrefetcher(_it(n=3000, bs=1), depth=2, device="cpu",
                           name="tpf_leak")
    next(pre)
    worker = pre._thread
    assert worker is not None and worker.is_alive()
    pre.close()
    assert not worker.is_alive()
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name.startswith("prefetch-")]
    assert not leaked
    with pytest.raises(StopIteration):   # closed: no silent batch skipping
        next(pre)


def test_exhaustion_and_producer_errors():
    it = SerialIterator(list(range(6)), batch_size=3, repeat=False)
    pre = DevicePrefetcher(it, depth=2, device="cpu", name="tpf_done")
    assert list(pre) == [[0, 1, 2], [3, 4, 5]]
    assert pre._thread is None

    def bad():
        yield [1]
        raise RuntimeError("loader exploded")

    pre = DevicePrefetcher(bad(), depth=2, device="cpu", name="tpf_err")
    assert next(pre) == [1]
    with pytest.raises(RuntimeError, match="loader exploded"):
        next(pre)
    with pytest.raises(StopIteration):
        next(pre)


def test_arrays_arrive_as_tensors_after_the_transform():
    """A collating transform runs on the producer; its arrays come out as
    tensors sharing the numpy buffers; labels and other leaves pass."""
    rng = np.random.RandomState(0)
    xs = [rng.rand(4, 3).astype(np.float32) for _ in range(3)]

    def collate(batch):
        return np.stack(batch), {"n": len(batch)}

    it = SerialIterator(xs, batch_size=3, repeat=False)
    with DevicePrefetcher(it, device="cpu", transform=collate,
                          name="tpf_tf") as pre:
        images, meta = next(pre)
    assert isinstance(images, torch.Tensor) and meta == {"n": 3}
    np.testing.assert_array_equal(images.numpy(), np.stack(xs))


def test_stall_counter_counts_a_slow_producer():
    c = get_registry().counter("prefetch_stall_total", {"name": "tpf_slow"})
    before = c.value

    def slow():
        for i in range(3):
            time.sleep(0.03)
            yield i

    with DevicePrefetcher(slow(), depth=2, device="cpu",
                          name="tpf_slow") as pre:
        assert [next(pre) for _ in range(3)] == [0, 1, 2]
    assert c.value > before


def test_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(_it())
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(_it(), depth=0, device="cpu")
