"""The port's C++ objstore sidecar (``chainermn_torch.native.objstore``)
and the key-value object protocol over it: the twins of
``tests/native_tests/test_objstore.py``, interop with the JAX package's
sidecar in both directions (one wire protocol), and a 2-rank gloo world
whose communicators take the sidecar transport.

In the first tests the 'ranks' are threads, each with its own TCP
connection to the C++ store: the transport and the protocol run for
real, only the process boundary is simulated. The last ones start real
processes through :func:`chainermn_torch.testing.run_ranks`.
"""

import concurrent.futures as cf
import re
import time
import zlib

import numpy as np
import pytest
import torch

from chainermn_torch.native import objstore


@pytest.fixture()
def server():
    with objstore.ObjStoreServer() as s:
        yield s


def test_sidecar_builds_here():
    """``g++`` is part of the test toolchain: the library must build, so
    the tests below run the C++ store."""
    objstore._load()


def test_put_get_roundtrip(server):
    c = objstore.ObjStoreClient("127.0.0.1", server.port)
    payload = b"\x00\x01binary\xff" * 1000
    c.put("a/key", payload)
    assert c.get("a/key") == payload
    c.close()


def test_blocking_get_waits_for_put(server):
    writer = objstore.ObjStoreClient("127.0.0.1", server.port)
    reader = objstore.ObjStoreClient("127.0.0.1", server.port)
    with cf.ThreadPoolExecutor(2) as ex:
        fut = ex.submit(reader.get, "late/key", 10_000)
        time.sleep(0.2)  # the reader parks on the store's cv by now
        writer.put("late/key", b"worth-the-wait")
        assert fut.result(timeout=10) == b"worth-the-wait"
    writer.close()
    reader.close()


def test_get_timeout(server):
    c = objstore.ObjStoreClient("127.0.0.1", server.port)
    with pytest.raises(TimeoutError):
        c.get("never/put", timeout_ms=200)
    c.close()


def test_delete_prefix_and_dir(server):
    c = objstore.ObjStoreClient("127.0.0.1", server.port)
    for i in range(4):
        c.put(f"round/0/ack/{i}", b"1")
    c.put("round/1/x", b"keep")
    assert sorted(c.list_prefix("round/0/ack/")) == [
        f"round/0/ack/{i}" for i in range(4)]
    c.delete_prefix("round/0/")
    assert c.list_prefix("round/0/") == []
    assert c.get("round/1/x") == b"keep"
    c.close()


def test_large_payload(server):
    c = objstore.ObjStoreClient("127.0.0.1", server.port)
    big = np.random.RandomState(0).bytes(8 << 20)  # 8 MiB
    c.put("big", big)
    assert c.get("big") == big
    c.close()


def test_crc32_matches_zlib_and_the_jax_package():
    from chainermn_tpu.native import objstore as ref_objstore

    for data in (b"", b"integrity check payload" * 99,
                 np.random.RandomState(1).bytes(4097)):
        assert objstore.crc32(data) == zlib.crc32(data)
        assert objstore.crc32(data) == ref_objstore.crc32(data)


@pytest.mark.parametrize("direction", ["port_client_ref_server",
                                       "ref_client_port_server"])
def test_one_wire_protocol_both_directions(direction):
    """A port client against a JAX-package server, and the other way
    round: puts, blocking gets, listing, deletion and timeouts agree."""
    from chainermn_tpu.native import objstore as ref_objstore

    srv_mod, cli_mod = ((ref_objstore, objstore)
                        if direction == "port_client_ref_server"
                        else (objstore, ref_objstore))
    with srv_mod.ObjStoreServer() as srv:
        a = cli_mod.ObjStoreClient("127.0.0.1", srv.port)
        b = srv_mod.ObjStoreClient("127.0.0.1", srv.port)
        payload = np.random.RandomState(2).bytes(3 << 20)
        a.put("x/1", payload)
        assert b.get("x/1") == payload
        b.put("x/2", b"back")
        assert a.get("x/2") == b"back"
        assert sorted(a.list_prefix("x/")) == ["x/1", "x/2"]
        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(a.get, "late", 10_000)
            time.sleep(0.1)
            b.put("late", b"!")
            assert fut.result(timeout=10) == b"!"
        a.delete_prefix("x/")
        assert b.list_prefix("x/") == []
        with pytest.raises(TimeoutError):
            a.get("never", timeout_ms=100)
        a.close()
        b.close()


def _comm_world(server, n, ns):
    """Thread ranks of one world: in real use each process derives the
    namespace from its group (``group_namespace``); threads of one
    process pass a common one."""
    return [objstore.NativeObjectComm(rank=r, size=n, namespace=ns,
                                      address=f"127.0.0.1:{server.port}")
            for r in range(n)]


def _run_world(comms, fn):
    """Run fn(comm) concurrently for every rank, return results by rank."""
    with cf.ThreadPoolExecutor(len(comms)) as ex:
        futs = [ex.submit(fn, c) for c in comms]
        return [f.result(timeout=60) for f in futs]


def test_native_comm_bcast_gather_scatter(server):
    n = 4
    comms = _comm_world(server, n, "bgs")
    outs = _run_world(comms, lambda c: c.bcast_obj(
        {"arr": np.arange(5), "s": "hello"} if c.rank == 0 else None))
    for o in outs:
        np.testing.assert_array_equal(o["arr"], np.arange(5))
        assert o["s"] == "hello"
    outs = _run_world(comms, lambda c: c.gather_obj(c.rank * 10, root=1))
    assert outs[1] == [0, 10, 20, 30]
    assert outs[0] is None and outs[2] is None
    outs = _run_world(comms, lambda c: c.scatter_obj(
        [f"part{r}" for r in range(n)] if c.rank == 2 else None, root=2))
    assert outs == [f"part{r}" for r in range(n)]


def test_native_comm_allgather_allreduce_p2p(server):
    n = 3
    comms = _comm_world(server, n, "aap")
    outs = _run_world(comms, lambda c: c.allgather_obj(c.rank))
    assert all(o == [0, 1, 2] for o in outs)
    outs = _run_world(comms, lambda c: c.allreduce_obj(c.rank + 1))
    assert all(o == 6 for o in outs)

    def p2p(c):
        if c.rank == 0:
            c.send_obj({"payload": np.ones(3)}, dest=2, tag=7)
            return None
        if c.rank == 2:
            return c.recv_obj(source=0, tag=7)
        return None

    outs = _run_world(comms, p2p)
    np.testing.assert_array_equal(outs[2]["payload"], np.ones(3))
    # the receiver GCs each p2p round (sole reader); nothing may leak
    probe = objstore.ObjStoreClient("127.0.0.1", server.port)
    leaked = [k for k in probe.list_prefix("chainermn_torch/obj/")
              if "/p2p/" in k]
    assert leaked == [], leaked
    probe.close()


def test_native_comm_tensors_carry_dtype_and_shape(server):
    comms = _comm_world(server, 2, "t")
    sent = {torch.float32: torch.arange(12.).reshape(3, 4),
            torch.bfloat16: torch.linspace(-2, 2, 10).to(torch.bfloat16),
            torch.int64: torch.tensor([[7]]),
            torch.float16: torch.empty(0, 5, dtype=torch.float16)}

    def run(c):
        if c.rank == 0:
            for t in sent.values():
                c.send_tensor(t, 1, tag=2)
            return None
        return [c.recv_tensor(tuple(t.shape), t.dtype, 0, tag=2)
                for t in sent.values()]

    outs = _run_world(comms, run)
    for got, want in zip(outs[1], sent.values()):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    # a receiver that expects another dtype or shape is told so
    comms[0].send_tensor(torch.ones(2), 1, tag=9)
    with pytest.raises(RuntimeError, match="expected"):
        comms[1].recv_tensor((3,), torch.float32, 0, tag=9)


def test_multi_chunk_reassembly_and_hdr_last(server):
    """Payloads above ``_CHUNK`` split into numbered frames with the hdr
    frame written LAST, so a reader blocked on the hdr never observes a
    partial payload."""
    writer, reader = _comm_world(server, 2, "chunky")
    for c in (writer, reader):
        c._CHUNK = 7
    key = "chainermn_torch/test/chunky"
    payload = bytes(range(256)) * 3  # 768 B -> 110 frames of <= 7 B
    n_frames = -(-len(payload) // 7)
    assert n_frames >= 3
    with cf.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(reader._get, key, 30_000)
        time.sleep(0.2)  # the reader parks on the hdr key (written last)
        writer._put(key, payload)
        assert fut.result(timeout=30) == payload
    keys = writer._store.list_prefix(key + "/")
    assert len([k for k in keys if re.search(r"/c\d+$", k)]) == n_frames
    assert key + "/hdr" in keys

    comms = _comm_world(server, 2, "chunky-obj")
    for c in comms:
        c._CHUNK = 64
    big = {"blob": np.arange(300, dtype=np.int64), "tag": "multi-chunk"}
    outs = _run_world(comms, lambda c: c.bcast_obj(
        big if c.rank == 0 else None))
    for o in outs:
        np.testing.assert_array_equal(o["blob"], big["blob"])
        assert o["tag"] == "multi-chunk"


def test_native_comm_repeated_rounds_gc(server):
    """Rounds of the same op do not collide; ack-GC deletes fully
    consumed rounds lazily, and ``flush_gc`` deletes the last one."""
    comms = _comm_world(server, 2, "gc")
    for i in range(5):
        outs = _run_world(comms, lambda c, i=i: c.bcast_obj(
            f"round{i}" if c.rank == 0 else None))
        assert outs == [f"round{i}", f"round{i}"]
    probe = objstore.ObjStoreClient("127.0.0.1", server.port)
    live = probe.list_prefix("chainermn_torch/obj/gc/")
    payload_keys = [k for k in live if "/bcast/" in k and "/payload/" in k]
    rounds = {re.search(r"/bcast/(\d+)/", k).group(1) for k in payload_keys}
    assert rounds == {"4"}, (payload_keys, live)
    assert [c.flush_gc(10) for c in comms] == [0, 0]
    assert probe.list_prefix("chainermn_torch/obj/gc/") == []
    probe.close()


def _world_ops(c):
    """The collectives both packages' comms run in the parity test."""
    out = {"bcast": c.bcast_obj({"k": list(range(4))} if c.rank == 0
                                else None)}
    out["gather"] = c.gather_obj(c.rank ** 2, root=1)
    out["allgather"] = c.allgather_obj(f"r{c.rank}")
    out["allreduce"] = c.allreduce_obj(c.rank + 1)
    out["scatter"] = c.scatter_obj(
        [("s", r) for r in range(c.size)] if c.rank == 0 else None)
    if c.rank == 0:
        c.send_obj(np.arange(3), dest=c.size - 1, tag=4)
    if c.rank == c.size - 1:
        out["p2p"] = c.recv_obj(source=0, tag=4).tolist()
    c.barrier()
    return out


@pytest.mark.parametrize("n", [3, 4])
def test_equal_results_to_the_jax_packages_comm(n):
    from chainermn_tpu.native import objstore as ref_objstore

    with ref_objstore.ObjStoreServer() as srv:
        ref = [ref_objstore.NativeObjectComm(
            rank=r, size=n, address=f"127.0.0.1:{srv.port}")
            for r in range(n)]
        for c in ref:
            c._uid = 4242
        want = _run_world(ref, _world_ops)
    with objstore.ObjStoreServer() as srv:
        got = _run_world(_comm_world(srv, n, "parity"), _world_ops)
    assert got == want


_GLOO_WORLD = r"""
import os
import torch
from chainermn_torch import create_communicator
from chainermn_torch.datasets import scatter_dataset
from chainermn_torch.native import objstore

def ops(comm):
    out = {"transport": comm.object_transport}
    data = list(range(10 * comm.size + 3))
    out["scatter_dataset"] = list(scatter_dataset(data, comm, shuffle=True,
                                                  seed=5))
    out["bcast"] = comm.bcast_obj("payload" if comm.rank == 0 else None)
    out["allgather"] = comm.allgather_obj(comm.rank * 3)
    out["gather"] = comm.gather_obj(comm.rank)
    out["scatter"] = comm.scatter_obj([10, 11] if comm.rank == 0 else None)
    out["allreduce_obj"] = comm.allreduce_obj(comm.rank + 1)
    sub = comm.split(comm.rank % 2)
    out["split"] = (sub.object_transport, sub.size,
                    sub.allgather_obj(comm.rank))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + comm.rank
    if comm.rank == 0:
        comm.send({"a": x, "b": [x.to(torch.bfloat16)]}, 1, tag=3)
        comm.send_obj(("hello", 1), 1, tag=4)
    else:
        got = comm.recv(0, tag=3)
        out["p2p"] = (got["a"].tolist(), got["b"][0].float().tolist(),
                      str(got["b"][0].dtype), comm.recv_obj(0, tag=4))
    out["allreduce"] = comm.allreduce(x).tolist()
    return out, sub

gloo = create_communicator("flat", device="cpu")
plain, _ = ops(gloo)
server = objstore.ObjStoreServer() if gloo.rank == 0 else None
port = gloo.bcast_obj(server.port if server else None)
os.environ["CHAINERMN_TORCH_OBJSTORE"] = f"127.0.0.1:{port}"
comm = create_communicator("flat", device="cpu")
native, sub = ops(comm)
left = comm._obj.flush_gc(30) + sub._obj.flush_gc(30)
gloo.barrier()
keys = (server and comm._obj._store.list_prefix("chainermn_torch/obj/"))
gloo.barrier()
save({"plain": plain, "native": native, "left": left, "keys": keys})
sub.finalize()
comm.finalize()
gloo.barrier()
if server is not None:
    server.stop()
"""


@pytest.fixture(scope="module")
def gloo_world():
    from chainermn_torch.testing import run_ranks

    return run_ranks(_GLOO_WORLD, 2, timeout=240)


@pytest.mark.parametrize("op", ["scatter_dataset", "bcast", "allgather",
                                "gather", "scatter", "allreduce_obj",
                                "allreduce", "p2p"])
def test_sidecar_world_equals_gloo_world(gloo_world, op):
    for r, out in enumerate(gloo_world):
        assert out["plain"]["transport"] == "gloo"
        assert out["native"]["transport"] == "objstore"
        assert out["native"].get(op) == out["plain"].get(op), (r, op)


def test_sidecar_world_split_and_gc(gloo_world):
    for r, out in enumerate(gloo_world):
        transport, size, members = out["native"]["split"]
        assert transport == "objstore" and size == 1 and members == [r]
        assert out["plain"]["split"][1:] == (size, members)
        assert out["left"] == 0
    assert gloo_world[0]["keys"] == []
