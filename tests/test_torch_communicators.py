"""Every communicator strategy of the port on 4 gloo ranks with
``LOCAL_WORLD_SIZE=2`` (2 nodes of 2) against
``chainermn_tpu.create_communicator(name, devices=jax.devices()[:4])``
on the same per-rank inputs — a 2x2 mesh for the two-level strategies
(``mesh.py:77-81``) — and the rest of the communicator contract: the
array collectives, send/recv of tensor trees, the object collectives,
``split`` and the differentiable collectives of
``chainermn_torch.functions``.

The 4 ranks start once per module and run every case; the tests
parametrize over the results.

Tolerances: float32 means agree to atol 1e-6 (four addends in another
order); with the bf16 wire to atol 1.6e-2, two bf16 steps at the sums'
magnitude (each framework rounds its own partial sums); the array
collectives, objects, p2p and the differentiable collectives' gradients
(against numpy transposes) agree exactly or to 1e-6.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu
from chainermn_torch import create_communicator
from chainermn_torch.testing import run_ranks

torch.set_num_threads(1)

N = 4
SHAPES = [(3, 4), (5,), (7,), (3,)]   # 27 elements: odd, so 2D pads
STRATEGIES = {   # port name -> (class, JAX name, wire)
    "naive": ("NaiveCommunicator", "naive", None),
    "flat": ("FlatCommunicator", "flat", None),
    "pure_nccl": ("PureNcclCommunicator", "tpu", None),
    "tpu": ("PureNcclCommunicator", "tpu", None),
    "pure_ici": ("PureNcclCommunicator", "pure_ici", None),
    "pure_nccl_bf16": ("PureNcclCommunicator", "tpu", "bfloat16"),
    "hierarchical": ("HierarchicalCommunicator", "hierarchical", None),
    "non_cuda_aware": ("HierarchicalCommunicator", "hierarchical", None),
    "two_dimensional": ("TwoDimensionalCommunicator", "two_dimensional",
                        None),
}


def rank_major(seed, shape):
    """Every rank's input, rank-major: the worker takes its slice."""
    return np.random.default_rng(seed).standard_normal(
        (N,) + tuple(shape)).astype(np.float32)


_WORKER = """
import numpy as np
import torch
from chainermn_torch import create_communicator, functions

SHAPES = [(3, 4), (5,), (7,), (3,)]


def mine(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4,) + tuple(shape)).astype(np.float32)[RANK])


out = {"means": {}, "classes": {}}
world = create_communicator("naive", device="cpu")
grads = [mine(10 + i, s) for i, s in enumerate(SHAPES)]
for name in ARGS:
    strategy, wire, _ = name.partition("_bf16")
    comm = create_communicator(
        "pure_nccl" if wire else strategy, device="cpu",
        allreduce_grad_dtype=torch.bfloat16 if wire else None)
    means = comm.multi_node_mean_grad(grads[:2] + [None] + grads[2:])
    out["means"][name] = means
    out["classes"][name] = type(comm).__name__
    out["geometry"] = (comm.rank, comm.size, comm.intra_rank,
                       comm.intra_size, comm.inter_rank, comm.inter_size)
    comm.finalize()
try:
    create_communicator("single_node", device="cpu")
except RuntimeError as e:
    out["single_node"] = str(e)

N = world.size
x = mine(1, (N, 3))
out["allreduce"] = {op: world.allreduce(x, op)
                    for op in ("sum", "mean", "max", "min", "prod")}
out["bcast"] = world.bcast(x if RANK == 1 else None, root=1)
out["gather"] = world.gather(x, root=2)
out["allgather"] = world.allgather(x)
out["scatter"] = world.scatter(x if RANK == 3 else None, root=3)
out["alltoall"] = world.alltoall(x)

tree = {"a": x, "b": [x[0].to(torch.bfloat16), torch.arange(3)],
        "c": (torch.zeros(0),)}
world.send(tree, (RANK + 1) % N, tag=7)
world.send(x * 2, RANK, tag=9)                      # to oneself
out["recv"] = world.recv((RANK - 1) % N, tag=7)
out["recv_self"] = world.recv(RANK, tag=9)
world.send_obj({"from": RANK}, (RANK + 1) % N, tag=3)
out["recv_obj"] = world.recv_obj((RANK - 1) % N, tag=3)
out["bcast_obj"] = world.bcast_obj(["root", RANK] if RANK == 2 else None,
                                   root=2)
out["gather_obj"] = world.gather_obj(RANK * 10, root=1)
out["allgather_obj"] = world.allgather_obj((RANK, "x"))
out["allreduce_obj"] = world.allreduce_obj(RANK + 1)
out["allreduce_obj_max"] = world.allreduce_obj(RANK, max)
out["scatter_obj"] = world.scatter_obj(
    [f"to{r}" for r in range(N)] if RANK == 0 else None)
world.barrier()

for name in ("naive", "hierarchical", "two_dimensional"):
    comm = create_communicator(name, device="cpu")
    sub = comm.split(RANK % 2)
    out.setdefault("split", {})[name] = {
        "rank": sub.rank, "size": sub.size, "class": type(sub).__name__,
        "allreduce": sub.allreduce(x), "allgather": sub.allgather(x),
        "mean": sub.multi_node_mean_grad([x])[0],
        "bcast_obj": sub.bcast_obj(RANK if sub.rank == 0 else None)}
    sub.finalize()
    comm.finalize()

fns = {"sum": lambda t: functions.allreduce(t, world, "sum"),
       "mean": lambda t: functions.allreduce(t, world, "mean"),
       "allgather": lambda t: functions.allgather(t, world),
       "alltoall": lambda t: functions.alltoall(t, world),
       "bcast": lambda t: functions.bcast(t, world, root=1),
       "gather": lambda t: functions.gather(t, world, root=2),
       "scatter": lambda t: functions.scatter(t, world, root=3)}
out["grads"] = {}
for k, (name, fn) in enumerate(fns.items()):
    t = x.clone().requires_grad_()
    y = fn(t)
    (y * mine(20 + k, tuple(y.shape))).sum().backward()
    out["grads"][name] = (y.detach(), t.grad)
world.finalize()
save(out)
"""


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_WORKER, N, local_world_size=2, args=list(STRATEGIES),
                     timeout=120)


@pytest.fixture(scope="module")
def jax_comm():
    return chainermn_tpu.create_communicator("naive",
                                             devices=jax.devices()[:N])


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_strategy_means_match_the_reference(ranks, name):
    cls, jname, wire = STRATEGIES[name]
    grads = [rank_major(10 + i, s) for i, s in enumerate(SHAPES)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcomm = chainermn_tpu.create_communicator(
            jname, devices=jax.devices()[:N], allreduce_grad_dtype=wire)
    want = [np.asarray(m, np.float32)
            for m in jcomm.multi_node_mean_grad(grads)]
    tol = 1.6e-2 if wire else 1e-6
    for r, res in enumerate(ranks):
        assert res["classes"][name] == cls
        got = res["means"][name]
        assert got[2] is None
        got = got[:2] + got[3:]
        for g, w_, s in zip(got, want, SHAPES):
            assert g.shape == s and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w_[r], atol=tol, rtol=0)
    if wire:   # the wire rounds: not the float32 means
        f32 = ranks[0]["means"]["pure_nccl"]
        assert not torch.equal(f32[0], ranks[0]["means"][name][0])


def test_geometry_and_single_node(ranks):
    for r, res in enumerate(ranks):
        assert res["geometry"] == (r, N, r % 2, 2, r // 2, 2)
        assert "single-node" in res["single_node"]


def test_single_node_on_one_node():
    comm = create_communicator("single_node", device="cpu")
    try:
        assert type(comm).__name__ == "SingleNodeCommunicator"
        assert comm.inter_size == 1
    finally:
        comm.finalize()


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod"])
def test_allreduce_ops_match_the_reference(ranks, jax_comm, op):
    x = rank_major(1, (N, 3))
    want = np.asarray(jax_comm.allreduce(x, op))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["allreduce"][op].numpy(), want[r],
                                   atol=1e-6, rtol=1e-6)


def test_array_collectives_match_the_reference(ranks, jax_comm):
    x = rank_major(1, (N, 3))
    want = {"bcast": np.asarray(jax_comm.bcast(x, root=1)),
            "allgather": np.asarray(jax_comm.allgather(x)),
            "scatter": np.asarray(jax_comm.scatter(x, root=3)),
            "alltoall": np.asarray(jax_comm.alltoall(x))}
    gathered = np.asarray(jax_comm.gather(x, root=2))
    for r, res in enumerate(ranks):
        for name, ref in want.items():
            np.testing.assert_array_equal(res[name].numpy(), ref[r],
                                          err_msg=name)
        if r == 2:
            np.testing.assert_array_equal(res["gather"].numpy(), gathered)
        else:
            assert res["gather"] is None


def test_send_recv_trees(ranks):
    for r, res in enumerate(ranks):
        src = (r - 1) % N
        x = torch.from_numpy(rank_major(1, (N, 3))[src])
        got = res["recv"]
        assert set(got) == {"a", "b", "c"} and isinstance(got["c"], tuple)
        assert torch.equal(got["a"], x)
        assert got["b"][0].dtype == torch.bfloat16
        assert torch.equal(got["b"][0], x[0].to(torch.bfloat16))
        assert torch.equal(got["b"][1], torch.arange(3))
        assert got["c"][0].shape == (0,)
        own = torch.from_numpy(rank_major(1, (N, 3))[r])
        assert torch.equal(res["recv_self"], own * 2)


def test_object_collectives(ranks):
    for r, res in enumerate(ranks):
        assert res["recv_obj"] == {"from": (r - 1) % N}
        assert res["bcast_obj"] == ["root", 2]
        assert res["gather_obj"] == ([0, 10, 20, 30] if r == 1 else None)
        assert res["allgather_obj"] == [(i, "x") for i in range(N)]
        assert res["allreduce_obj"] == 10
        assert res["allreduce_obj_max"] == 3
        assert res["scatter_obj"] == f"to{r}"


@pytest.mark.parametrize("name", ["naive", "hierarchical", "two_dimensional"])
def test_split_matches_the_reference(ranks, name):
    """Colors rank % 2: groups {0, 2} and {1, 3}; the two-level
    strategies fall back to the flat mean on a split communicator."""
    x = rank_major(1, (N, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsub = chainermn_tpu.create_communicator(
            name, devices=jax.devices()[:N]).split([r % 2 for r in range(N)])
    want_sum = np.asarray(jsub.allreduce(x))
    want_mean = np.asarray(jsub.multi_node_mean_grad([x])[0])
    for r, res in enumerate(ranks):
        sub = res["split"][name]
        assert (sub["rank"], sub["size"]) == (r // 2, 2)
        assert sub["class"] == ranks[0]["split"][name]["class"]
        np.testing.assert_allclose(sub["allreduce"].numpy(), want_sum[r],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(sub["mean"].numpy(), want_mean[r],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(sub["allgather"].numpy(),
                                      x[[r % 2, r % 2 + 2]])
        assert sub["bcast_obj"] == r % 2


def _transposes():
    """Forward values and input gradients of the loss ``sum_r <W_r,
    f(x)_r>``, in numpy, for each differentiable collective; ``W_r`` is
    drawn for the shape of rank r's output."""
    x = rank_major(1, (N, 3))
    order = ["sum", "mean", "allgather", "alltoall", "bcast", "gather",
             "scatter"]
    shape = {"allgather": (N, N, 3), "gather": (N, N, 3),
             "scatter": (3,)}
    w = {n: rank_major(20 + k, shape.get(n, (N, 3)))
         for k, n in enumerate(order)}
    zero = np.zeros_like(x[0])
    return {
        "sum": ([x.sum(0)] * N, [w["sum"].sum(0)] * N),
        "mean": ([x.mean(0)] * N, [w["mean"].mean(0)] * N),
        "allgather": ([x] * N, [w["allgather"][:, s].sum(0)
                                for s in range(N)]),
        "alltoall": ([x[:, r] for r in range(N)],
                     [w["alltoall"][:, s] for s in range(N)]),
        "bcast": ([x[1]] * N, [w["bcast"].sum(0) if s == 1 else zero
                               for s in range(N)]),
        "gather": ([x if r == 2 else np.zeros(0) for r in range(N)],
                   [w["gather"][2, s] for s in range(N)]),
        "scatter": ([x[3, r] for r in range(N)],
                    [w["scatter"] if s == 3 else zero for s in range(N)]),
    }


@pytest.mark.parametrize("name", ["sum", "mean", "allgather", "alltoall",
                                  "bcast", "gather", "scatter"])
def test_differentiable_collectives_are_transposed(ranks, name):
    values, grads = _transposes()[name]
    for r, res in enumerate(ranks):
        y, g = res["grads"][name]
        np.testing.assert_allclose(y.numpy(), values[r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.numpy(), grads[r], atol=1e-6, rtol=0)


def test_allreduce_grad_dtype_only_on_the_flat_strategy():
    for name in ("naive", "flat", "hierarchical", "two_dimensional",
                 "single_node", "non_cuda_aware"):
        with pytest.raises(ValueError, match="pure_nccl"):
            create_communicator(name, device="cpu",
                                allreduce_grad_dtype=torch.bfloat16)
