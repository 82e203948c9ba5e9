"""Differentiable point-to-point communication
(``chainermn_torch.functions.send``/``recv``/``pseudo_connect``) on 3 gloo
ranks, against the JAX package's (``tests/functions_tests/
test_point_to_point.py``), one case a JAX test.

The JAX package plays every rank in one SPMD program; the port runs one
process a rank with upstream ChainerMN's per-process semantics. The same
seeded inputs go to both; forward values and gradients agree to 1e-5 in
f32. The ranks start once for the module (``run_ranks``, under its
timeout: a hang in a backward is a fault) and run every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu import create_communicator
from chainermn_tpu import functions as JF
from chainermn_torch.testing import run_ranks

N_RANKS = 3
TOL = dict(rtol=1e-5, atol=1e-5)

_WORKER = """
import torch
from chainermn_torch import create_communicator
from chainermn_torch import functions as F

x = torch.load(ARGS[0])["x"]          # [n_devices, 2]: row r is rank r's
comm = create_communicator("naive", device="cpu")
r = comm.rank
out = {}


def error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


# send_recv_forward
if r == 0:
    F.send(x[0], comm, rank=1)
elif r == 1:
    out["forward"] = F.recv(comm, rank=0).detach()

# gradient_is_transposed_comm: the loss lives on rank 1
if r == 0:
    x0 = x[0].clone().requires_grad_()
    F.send(x0, comm, rank=1).backward()
    out["grad"] = x0.grad
elif r == 1:
    y = F.recv(comm, rank=0)
    y.pow(2).sum().backward()

# rank_context: the context, else the process's rank
with F.rank_context(2):
    out["context_rank"] = F.current_rank(comm)
out["own_rank"] = F.current_rank(comm)
out["no_rank_error"] = error(F.current_rank)

# send_self_rejected
out["self_send_error"] = error(lambda: F.send(x[r], comm, rank=r))
out["out_of_range_error"] = error(lambda: F.send(x[r], comm, rank=7))

# recv_endpoint_mismatch: a delegate made playing rank 0, used playing 1
if r == 0:
    with F.rank_context(0):
        phi = F.send(x[0], comm, rank=1)
    with F.rank_context(1):
        out["mismatch_error"] = error(
            lambda: F.recv(comm, rank=0, delegate_variable=phi))
elif r == 1:
    F.recv(comm, rank=0)                 # the payload sent above

# pseudo_connect_preserves_value_and_gradient
if r == 0:
    x0 = torch.ones(2, requires_grad=True)
    phi = F.send(x0 * 2.0, comm, rank=1)
    z = F.pseudo_connect(phi, x0 * 3.0)
    out["pc_value"] = z.sum().detach()
    z.sum().backward()
    out["pc_grad"] = x0.grad
elif r == 1:
    (F.recv(comm, rank=0) * 0.0).sum().backward()

# delegate_chain_two_hops: 0 -> 1 -> 2, the loss on rank 2
if r == 0:
    x0 = x[0].clone().requires_grad_()
    F.send(x0, comm, rank=1).backward()
    out["hops_grad"] = x0.grad
elif r == 1:
    h = F.recv(comm, rank=0)
    F.send(h + 10.0, comm, rank=2).backward()
elif r == 2:
    y = F.recv(comm, rank=1)
    out["hops"] = y.detach()
    y.pow(2).sum().backward()

# relay 0 -> 1 -> 0: rank 0 holds the first send and the last recv; the
# delegate makes the recv's backward (which sends) run before the
# send's (which waits)
if r == 0:
    x0 = x[0].clone().requires_grad_()
    d = F.send(x0, comm, rank=1)
    y = F.recv(comm, rank=1, delegate_variable=d)
    y.pow(2).sum().backward()
    out["relay"] = y.detach()
    out["relay_grad"] = x0.grad
elif r == 1:
    h = F.recv(comm, rank=0)
    F.send(h * 3.0, comm, rank=0).backward()

# a tuple payload with an integer leaf, force_tuple
if r == 0:
    x0 = x[0].clone().requires_grad_()
    F.send((x0, torch.arange(3)), comm, rank=1).backward()
    out["tuple_grad"] = x0.grad
elif r == 1:
    a, b = F.recv(comm, rank=0, force_tuple=True)
    out["tuple"] = (a.detach(), b, b.requires_grad)
    (a * 5.0).sum().backward()

save(out)
comm.finalize()
"""


@pytest.fixture(scope="module")
def x(n_devices):
    return np.random.RandomState(0).randn(n_devices, 2).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(x, tmp_path_factory):
    path = tmp_path_factory.mktemp("p2p") / "x.pt"
    torch.save({"x": torch.from_numpy(x)}, path)
    return run_ranks(_WORKER, N_RANKS, args=[str(path)], timeout=180)


@pytest.fixture(scope="module")
def comm():
    return create_communicator("naive")


def _spmd(comm, step):
    return jax.jit(comm.shard_map(step, in_specs=P(comm.axis_name),
                                  out_specs=P(comm.axis_name)))


def test_send_recv_forward(comm, x, ranks):
    def step(xl):
        with JF.rank_context(0):
            phi = JF.send(xl, comm, rank=1)
        with JF.rank_context(1):
            return JF.recv(comm, rank=0, delegate_variable=phi)

    want = np.asarray(_spmd(comm, step)(x))[1]
    np.testing.assert_allclose(ranks[1]["forward"].numpy(), want, **TOL)


def test_send_recv_gradient_is_transposed_comm(comm, x, ranks):
    def loss_fn(xs):
        def step(xl):
            with JF.rank_context(0):
                phi = JF.send(xl, comm, rank=1)
            with JF.rank_context(1):
                y = JF.recv(comm, rank=0, delegate_variable=phi)
            contrib = jnp.where(comm.axis_index() == 1, jnp.sum(y**2), 0.0)
            return comm.allreduce(contrib, "sum")[None]

        f = comm.shard_map(step, in_specs=P(comm.axis_name),
                           out_specs=P(comm.axis_name))
        return jnp.sum(f(xs)) / comm.size

    want = np.asarray(jax.grad(loss_fn)(jnp.asarray(x)))[0]
    np.testing.assert_allclose(ranks[0]["grad"].numpy(), want, **TOL)


def test_rank_context(comm, ranks):
    # the JAX package needs a context; the port falls back to comm.rank
    with pytest.raises(RuntimeError, match="rank_context"):
        JF.send(jnp.ones(2), comm, rank=1)
    for r, out in enumerate(ranks):
        assert out["context_rank"] == 2
        assert out["own_rank"] == r
        assert out["no_rank_error"][0] == "RuntimeError"
        assert "rank_context" in out["no_rank_error"][1]


def test_send_self_rejected(comm, ranks):
    with JF.rank_context(1):
        with pytest.raises(ValueError, match="self-send"):
            JF.send(jnp.ones(2), comm, rank=1)
        with pytest.raises(ValueError, match="out of range"):
            JF.send(jnp.ones(2), comm, rank=comm.size + 5)
    for out in ranks:
        assert out["self_send_error"][0] == "ValueError"
        assert "self-send" in out["self_send_error"][1]
        assert out["out_of_range_error"][0] == "ValueError"
        assert "out of range" in out["out_of_range_error"][1]


def test_recv_endpoint_mismatch(comm, ranks):
    def step(xl):
        with JF.rank_context(0):
            phi = JF.send(xl, comm, rank=1)
        with JF.rank_context(2):
            return JF.recv(comm, rank=0, delegate_variable=phi)

    with pytest.raises(ValueError, match="mismatch"):
        _spmd(comm, step)(np.ones((comm.size, 2), np.float32))
    kind, msg = ranks[0]["mismatch_error"]
    assert kind == "ValueError" and "mismatch" in msg


def test_recv_without_delegate(comm, x, ranks):
    """The JAX package needs the delegate (the payload travels through
    the program); per process, as upstream, recv takes it from the
    peer — and gets what the JAX recv gets with it."""
    with JF.rank_context(1):
        with pytest.raises(ValueError, match="delegate_variable"):
            JF.recv(comm, rank=0)

    def step(xl):
        with JF.rank_context(0):
            phi = JF.send(xl, comm, rank=1)
        with JF.rank_context(1):
            return JF.recv(comm, rank=0, delegate_variable=phi)

    want = np.asarray(_spmd(comm, step)(x))[1]
    np.testing.assert_allclose(ranks[1]["forward"].numpy(), want, **TOL)


def test_pseudo_connect_preserves_value_and_gradient(comm, ranks):
    if not hasattr(jax, "typeof"):
        pytest.skip("the JAX reference needs vma-tracking shard_map")
    n = comm.size

    def loss_fn(xs):
        def step(xl):
            with JF.rank_context(0):
                phi = JF.send(xl * 2.0, comm, rank=1)
            return JF.pseudo_connect(phi, xl * 3.0)

        f = comm.shard_map(step, in_specs=P(comm.axis_name),
                           out_specs=P(comm.axis_name))
        return jnp.sum(f(xs))

    xs = jnp.ones((n, 2), jnp.float32)
    np.testing.assert_allclose(float(ranks[0]["pc_value"]),
                               float(loss_fn(xs)) / n, **TOL)
    np.testing.assert_allclose(ranks[0]["pc_grad"].numpy(),
                               np.asarray(jax.grad(loss_fn)(xs))[0], **TOL)


def test_delegate_chain_two_hops(comm, x, ranks):
    def step(xl):
        with JF.rank_context(0):
            phi1 = JF.send(xl, comm, rank=1)
        with JF.rank_context(1):
            h = JF.recv(comm, rank=0, delegate_variable=phi1)
            phi2 = JF.send(h + 10.0, comm, rank=2)
        with JF.rank_context(2):
            return JF.recv(comm, rank=1, delegate_variable=phi2)

    want = np.asarray(_spmd(comm, step)(x))[2]
    np.testing.assert_allclose(ranks[2]["hops"].numpy(), want, **TOL)
    # d/dx0 of sum((x0 + 10)^2), through both hops' backward transfers
    np.testing.assert_allclose(ranks[0]["hops_grad"].numpy(), 2.0 * want,
                               **TOL)


def test_relay_back_to_the_sender(x, ranks):
    np.testing.assert_allclose(ranks[0]["relay"].numpy(), 3.0 * x[0], **TOL)
    np.testing.assert_allclose(ranks[0]["relay_grad"].numpy(), 18.0 * x[0],
                               **TOL)


def test_tuple_payload_with_an_integer_leaf(x, ranks):
    a, b, b_requires_grad = ranks[1]["tuple"]
    np.testing.assert_allclose(a.numpy(), x[0], **TOL)
    assert b.tolist() == [0, 1, 2] and not b_requires_grad
    np.testing.assert_allclose(ranks[0]["tuple_grad"].numpy(), [5.0, 5.0])
