"""The multi-node checkpointer (``chainermn_torch.extensions.checkpoint``)
against the JAX package's (``tests/extensions_tests/test_checkpoint.py``):
save/GC/newest-common-iteration resume, the CRC footer, torn writes and
the collective skip-back, the ``.tmp`` sweep, async saves, cut-point
injection — and the file format: the same state written by both packages
is the same bytes, and a snapshot written by either loads in the other,
leaf for leaf.

One in-process rank for most cases; 2 gloo ranks (started once) for the
cross-rank agreement.
"""

import os
import pickle
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chainermn_tpu
from chainermn_torch import create_communicator
from chainermn_torch.extensions.checkpoint import (
    create_multi_node_checkpointer,
    to_tensors,
)
from chainermn_torch.monitor import get_registry
from chainermn_torch.resilience import FaultInjector, InjectedFault, RetryPolicy
from chainermn_torch.testing import run_ranks


@pytest.fixture(scope="module")
def comm():
    c = create_communicator("naive", device="cpu")
    yield c
    c.finalize()


@pytest.fixture(scope="module")
def jcomm():
    return chainermn_tpu.create_communicator("naive")


def _state(step):
    return {"params": {"w": torch.full((3, 3), float(step)),
                       "b": torch.zeros(3)},
            "iteration": step}


def _np_state(step):
    # keys in sorted order: jax.device_get rebuilds dicts sorted (pytree
    # order), the port keeps a dict's own order
    return {"iteration": step,
            "params": {"b": np.zeros(3, np.float32),
                       "w": np.full((3, 3), float(step), np.float32)},
            "tag": ("mnist", [1, 2])}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_save_load_roundtrip(comm, tmp_path):
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    cp.save(_state(7), iteration=7)
    loaded, it = cp.maybe_load()
    assert it == 7 and loaded["iteration"] == 7
    assert isinstance(loaded["params"]["w"], np.ndarray)   # comes back numpy
    np.testing.assert_array_equal(loaded["params"]["w"], np.full((3, 3), 7.0))
    back = to_tensors(loaded["params"])
    assert torch.equal(back["w"], torch.full((3, 3), 7.0))


def test_fresh_start_when_empty(comm, tmp_path):
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    sentinel = {"x": 1}
    state, it = cp.maybe_load(sentinel)
    assert it == 0 and state is sentinel


def test_gc_retains_newest(comm, tmp_path):
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                        n_retains=3)
    for i in range(1, 8):
        cp.save(_state(i), iteration=i)
    assert cp._local_iterations() == [5, 6, 7]
    assert cp.maybe_load()[1] == 7


def test_atomic_write_ignores_partial(comm, tmp_path):
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    cp.save(_state(1), iteration=1)
    orphan = cp.filename(9) + ".tmp"
    with open(orphan, "wb") as f:
        f.write(b"partial garbage")
    assert cp._local_iterations() == [1]
    cp2 = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    assert not os.path.exists(orphan)          # swept at startup
    assert cp2.maybe_load()[1] == 1


def test_finalize_removes_all(comm, tmp_path):
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    cp.save(_state(1), 1)
    cp.save(_state(2), 2)
    cp.finalize()
    assert cp._local_iterations() == []
    assert cp.maybe_load("fresh") == ("fresh", 0)


def test_iterator_state_in_snapshot(comm, tmp_path):
    from chainermn_torch import SerialIterator

    it = SerialIterator(list(range(10)), batch_size=3, shuffle=True, seed=5)
    next(it)
    cp = create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    cp.save({"iterator": it.state_dict()}, iteration=1)
    expected = [next(it) for _ in range(3)]
    it2 = SerialIterator(list(range(10)), batch_size=3, shuffle=True, seed=5)
    it2.load_state_dict(cp.maybe_load()[0]["iterator"])
    assert [next(it2) for _ in range(3)] == expected


def test_bad_name_rejected(comm, tmp_path):
    with pytest.raises(ValueError):
        create_multi_node_checkpointer("../evil", comm, path=str(tmp_path))


def test_same_state_same_bytes_as_jax(comm, jcomm, tmp_path):
    """The footer and the pickle: a numpy state written by both packages
    is the same file."""
    cp = create_multi_node_checkpointer("b", comm, path=str(tmp_path / "t"))
    jcp = chainermn_tpu.create_multi_node_checkpointer(
        "b", jcomm, path=str(tmp_path / "j"))
    data = _read(cp.save(_np_state(3), 3))
    assert data == _read(jcp.save(_np_state(3), 3))
    payload, crc, length = data[:-20], data[-12:-8], data[-8:]
    assert data[-20:-12] == b"CMNTPUC1"
    assert int.from_bytes(length, "little") == len(payload)
    assert int.from_bytes(crc, "little") == zlib.crc32(payload)
    assert pickle.loads(payload)["world_size"] == 1


def test_jax_snapshot_loads_in_the_port(comm, jcomm, tmp_path):
    jcp = chainermn_tpu.create_multi_node_checkpointer(
        "x", jcomm, path=str(tmp_path))
    w = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    jcp.save({"w": jnp.asarray(w), "n": jnp.arange(3), "it": 4}, 4)
    loaded, it = create_multi_node_checkpointer(
        "x", comm, path=str(tmp_path)).maybe_load()
    assert it == 4 and loaded["it"] == 4
    np.testing.assert_array_equal(loaded["w"], w)
    np.testing.assert_array_equal(loaded["n"], np.arange(3))


def test_port_snapshot_loads_in_jax(comm, jcomm, tmp_path):
    cp = create_multi_node_checkpointer("y", comm, path=str(tmp_path))
    w = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    cp.save({"w": w, "n": torch.arange(3), "opt": [torch.ones(2), 0.5]}, 6)
    loaded, it = chainermn_tpu.create_multi_node_checkpointer(
        "y", jcomm, path=str(tmp_path)).maybe_load()
    assert it == 6
    np.testing.assert_array_equal(loaded["w"], w.numpy())
    np.testing.assert_array_equal(loaded["n"], np.arange(3))
    np.testing.assert_array_equal(loaded["opt"][0], np.ones(2, np.float32))
    assert loaded["opt"][1] == 0.5


def test_bfloat16_stored_as_bits_not_widened(comm, tmp_path):
    cp = create_multi_node_checkpointer("h", comm, path=str(tmp_path))
    x = torch.randn(8, generator=torch.Generator().manual_seed(1)).bfloat16()
    cp.save({"x": x}, 1)
    loaded, _ = cp.maybe_load()
    bits = loaded["x"]["__bfloat16_bits__"]
    assert bits.dtype == np.uint16
    back = to_tensors(loaded)["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    with pytest.raises(TypeError, match="no numpy dtype"):
        cp.save({"x": torch.zeros(2, dtype=torch.float8_e4m3fn)}, 2)


def test_torn_write_detected_and_skipped_back(comm, tmp_path):
    cp = create_multi_node_checkpointer("tw", comm, path=str(tmp_path))
    cp.save(_state(1), 1)
    c = get_registry().counter("checkpoint_corrupt_total", {"name": "tw"})
    before = c.value
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="torn_write", frac=0.5, times=1)
    with inj:
        cp.save(_state(2), 2)                  # truncation is silent
    assert os.path.exists(cp.filename(2))
    loaded, it = cp.maybe_load()
    assert it == 1 and loaded["iteration"] == 1   # the checksum skipped back
    assert c.value == before + 1


def test_cutpoints_fire_on_save_and_load(comm, tmp_path):
    cp = create_multi_node_checkpointer("cut", comm, path=str(tmp_path))
    inj = FaultInjector()
    inj.arm("checkpoint.save", kind="raise", times=1)
    inj.arm("checkpoint.load", kind="raise", times=1)
    with inj:
        with pytest.raises(InjectedFault):
            cp.save(_state(1), 1)
        assert cp._local_iterations() == []
        with pytest.raises(InjectedFault):
            cp.maybe_load()
    assert [p for p, _ in inj.fired_log] == ["checkpoint.save",
                                             "checkpoint.load"]


def test_mid_write_raise_leaves_only_a_tmp(comm, tmp_path):
    cp = create_multi_node_checkpointer("mw", comm, path=str(tmp_path))
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=1)
    with inj, pytest.raises(InjectedFault):
        cp.save(_state(1), 1)
    assert cp._local_iterations() == []
    assert os.path.exists(cp.filename(1) + ".tmp")


def test_save_async_roundtrip_and_content_identical(comm, tmp_path):
    cp = create_multi_node_checkpointer("a", comm, path=str(tmp_path))
    sync_bytes = _read(cp.save(_state(3), 3))
    cp.finalize()
    cp.save_async(_state(3), 3)
    assert cp.wait_async() is True
    assert _read(cp.filename(3)) == sync_bytes
    loaded, it = cp.maybe_load()
    assert it == 3 and loaded["iteration"] == 3
    assert cp.stats["save_async"] and cp.stats["save_async"][0] > 0


def test_save_async_snapshot_content_fixed_at_call(comm, tmp_path):
    cp = create_multi_node_checkpointer("c", comm, path=str(tmp_path))
    state = {"w": torch.arange(4.0), "v": np.arange(4.0)}
    cp.save_async(state, 1)
    state["w"][:] = -1.0            # mutate right after the call returns
    state["v"][:] = -1.0
    cp.wait_async()
    loaded, _ = cp.maybe_load()
    np.testing.assert_array_equal(loaded["w"], np.arange(4.0))
    np.testing.assert_array_equal(loaded["v"], np.arange(4.0))


def test_maybe_load_joins_pending_async_save(comm, tmp_path):
    cp = create_multi_node_checkpointer("j", comm, path=str(tmp_path))
    for i in (1, 2, 3):
        cp.save_async(_state(i), i)
    loaded, it = cp.maybe_load()        # no explicit wait_async
    assert it == 3 and loaded["iteration"] == 3


def test_async_gc_under_lock_retains_newest(comm, tmp_path):
    cp = create_multi_node_checkpointer("g", comm, path=str(tmp_path),
                                        n_retains=2)
    for i in range(1, 7):
        cp.save_async(_state(i), i)
    cp.wait_async()
    assert cp._local_iterations() == [5, 6]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert cp.maybe_load()[1] == 6


def test_async_writer_error_surfaces_on_wait_and_next_save(comm, tmp_path):
    cp = create_multi_node_checkpointer("e", comm, path=str(tmp_path))
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=1)
    with inj:
        cp.save_async(_state(1), 1)
        with pytest.raises(InjectedFault):
            cp.wait_async()
    cp.save_async(_state(2), 2)
    assert cp.wait_async() is True
    assert cp.maybe_load()[1] == 2
    c = get_registry().counter("checkpoint_async_errors_total", {"name": "e"})
    assert c.value >= 1
    inj2 = FaultInjector()
    inj2.arm("checkpoint.write", kind="raise", times=1)
    with inj2:
        cp.save_async(_state(3), 3)
        deadline = time.time() + 5
        while cp._async_pending and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(InjectedFault):
            cp.save_async(_state(4), 4)     # the pending error re-raises


def test_async_torn_write_detected_on_load(comm, tmp_path):
    cp = create_multi_node_checkpointer("atw", comm, path=str(tmp_path))
    cp.save_async(_state(1), 1)
    cp.wait_async()
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="torn_write", frac=0.5, times=1)
    with inj:
        cp.save_async(_state(2), 2)
        cp.wait_async()
    loaded, it = cp.maybe_load()
    assert it == 1 and loaded["iteration"] == 1


def test_retry_absorbs_a_transient_write(comm, tmp_path):
    cp = create_multi_node_checkpointer(
        "r", comm, path=str(tmp_path),
        retry=RetryPolicy(3, base_delay_s=0.001, jitter=0))
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=1)
    with inj:
        cp.save_async(_state(5), 5)
        assert cp.wait_async() is True
    assert cp.maybe_load()[1] == 5


_AGREE = """
import os
import torch
from chainermn_torch import create_communicator
from chainermn_torch.extensions.checkpoint import create_multi_node_checkpointer

comm = create_communicator("naive", device="cpu")
r = comm.rank
out = {}
path = os.path.join(ARGS[0], "agree")
cp = create_multi_node_checkpointer("j", comm, path=path)
for i in (1, 2, 3):
    if not (r == 1 and i == 3):          # rank 1 crashed before saving 3
        cp.save({"it": i, "w": torch.full((2,), float(i + r))}, i)
state, it = cp.maybe_load()
out["newest_common"] = (it, state["it"], state["w"].tolist())

path = os.path.join(ARGS[0], "skip")
cp = create_multi_node_checkpointer("k", comm, path=path)
for i in (1, 2, 3):
    cp.save({"it": i}, i)
if r == 1:                               # only rank 1's copy of 3 is torn
    data = open(cp.filename(3), "rb").read()
    open(cp.filename(3), "wb").write(data[: len(data) // 2])
state, it = cp.maybe_load()
out["skip_back"] = (it, state["it"])

path = os.path.join(ARGS[0], "world")   # a snapshot of a 3-rank job
cp = create_multi_node_checkpointer("w", comm, path=path)
cp._world_size = lambda: 3
cp.save({"it": 1}, 1)
del cp._world_size
try:
    cp.maybe_load()
except RuntimeError as e:
    out["world_error"] = str(e)
save(out)
comm.finalize()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("agree")
    return run_ranks(_AGREE, 2, args=[str(d)], timeout=120)


def test_newest_common_iteration_across_ranks(two_ranks):
    for r, out in enumerate(two_ranks):
        assert out["newest_common"] == (2, 2, [2.0 + r] * 2)


def test_corrupt_copy_skips_every_rank_back(two_ranks):
    for out in two_ranks:
        assert out["skip_back"] == (2, 2)


def test_world_size_must_match(two_ranks):
    for out in two_ranks:
        assert "same world size" in out["world_error"]
