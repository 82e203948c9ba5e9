"""MultiNodeChainList (``chainermn_torch.links.MultiNodeChainList``) on 3
gloo ranks against the JAX package's, one case a test of
``tests/links_tests/test_multi_node_chain_list.py``, plus the cross-rank
2-stage chain of ``__graft_entry__.py:406-417``.

The JAX chain is initialised on the 8-device CPU mesh; its per-component
flax variables reach the port's chain through
``interop.load_chain_from_flax``; the same seeded inputs go to both.
Forward values, gradients (across the rank boundaries, backward transfers
included), BatchNorm state and 3 Adam steps agree to 1e-5 in f32. The
ranks start once for the module and run every case under ``run_ranks``'
timeout (a hang in a backward is a fault).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu import MultiNodeChainList, create_communicator
from chainermn_tpu.optimizers import create_component_wise_optimizer
from chainermn_torch.testing import run_ranks

N_RANKS, STEPS, LR = 3, 3, 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)


class Stage0(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.relu(nn.Dense(16)(x))


class Stage1(nn.Module):
    @nn.compact
    def __call__(self, h):
        return nn.Dense(4)(h)


class BnStage(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Dense(8)(x)
        return nn.BatchNorm(use_running_average=False)(x)


class Combine(nn.Module):
    @nn.compact
    def __call__(self, a, b):
        return nn.Dense(4)(jnp.concatenate([a, b], axis=-1))


_WORKER = """
import torch
from torch import nn
from chainermn_torch import (MultiNodeChainList, create_communicator,
                             create_component_wise_optimizer)
from chainermn_torch.interop import load_chain_from_flax, mlp_params_from_flax
from chainermn_torch.links import BatchNorm

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
comm = create_communicator("naive", device="cpu")
r = comm.rank
out = {}


class Dense(nn.Module):                 # flax Dense_0 [+ relu]
    def __init__(self, i, o, relu=False):
        super().__init__()
        self.fcs = nn.ModuleList([nn.Linear(i, o)])
        self.relu = relu

    def forward(self, x):
        y = self.fcs[0](x)
        return torch.relu(y) if self.relu else y


class Combine(Dense):
    def forward(self, a, b):
        return self.fcs[0](torch.cat([a, b], -1))


class BnStage(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(12, 8)
        self.bn = BatchNorm(8, momentum=0.99, eps=1e-5, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def t(a):
    return torch.from_numpy(a.copy())


def bare_dense(v):                      # a bare flax nn.Dense
    p = v["params"]
    return {"weight": t(p["kernel"].T), "bias": t(p["bias"])}


def bn_stage(v):
    p, s = v["params"], v["batch_stats"]["BatchNorm_0"]
    return {"fc.weight": t(p["Dense_0"]["kernel"].T),
            "fc.bias": t(p["Dense_0"]["bias"]),
            "bn.weight": t(p["BatchNorm_0"]["scale"]),
            "bn.bias": t(p["BatchNorm_0"]["bias"]),
            "bn.running_mean": t(s["mean"]), "bn.running_var": t(s["var"])}


def chain(case, links, converters):
    m = MultiNodeChainList(comm)
    for link, (rank, rank_in, rank_out) in zip(links, spec[case]["wiring"]):
        m.add_link(link, rank=rank, rank_in=rank_in, rank_out=rank_out)
    load_chain_from_flax(m, spec[case]["variables"], converters)
    return m


def grads(m):
    # this rank's components' gradients, by component index
    return {i: {k: p.grad.clone() for k, p in c.named_parameters()}
            for i, c in enumerate(m.components)
            if c in m.local_components()}


def val(y):
    # a model output's value; None for a delegate or for no component
    if isinstance(y, torch.Tensor) and y.numel():
        return y.detach()
    return None


def backward(y, loss_fn):
    if val(y) is not None:
        loss = loss_fn(y)
        loss.backward()
        return loss.detach()
    if y is not None:
        y.backward()


def two_stage(case):
    return chain(case, [Dense(12, 16, relu=True), Dense(16, 4)],
                 mlp_params_from_flax)


def train(m, x, target, fused=False):
    opt = create_component_wise_optimizer(
        lambda ps: torch.optim.Adam(ps, lr=spec["lr"]), m)
    losses = []
    for _ in range(spec["steps"]):
        opt.zero_grad()
        loss = backward(m(x, fused=fused), lambda y: (y - target).pow(2).mean())
        if loss is not None:
            losses.append(float(loss))
        opt.step()
    return losses


sq = lambda y: y.pow(2).sum()

# forward_matches_monolithic / gradients_cross_the_boundary
m = two_stage("two")
x = torch.from_numpy(spec["two"]["x"]).requires_grad_()
y = m(x)
out["two_y"] = val(y)
backward(y, sq)
out["two_grads"] = grads(m)
out["two_gx"] = x.grad
# params_live_on_their_ranks
out["placement"] = ([n for n, _ in m.named_parameters()],
                    [next(c.parameters()).device.type for c in m.components])

# three_stage_relay_and_training (rank 0 -> 2 -> 1, a non-adjacent hop)
m = chain("relay", [Dense(12, 16, relu=True), nn.Linear(16, 16),
                    Dense(16, 4)],
          [mlp_params_from_flax, bare_dense, mlp_params_from_flax])
out["relay_losses"] = train(m, torch.from_numpy(spec["relay"]["x"]),
                            torch.from_numpy(spec["relay"]["target"]))

# multi_input_component (ranks 0 and 1 -> 2)
m = chain("multi", [Dense(12, 16, relu=True), Dense(12, 16, relu=True),
                    Combine(32, 4)], mlp_params_from_flax)
y = m(torch.from_numpy(spec["multi"]["x"]))
out["multi_y"] = val(y)
backward(y, sq)
out["multi_grads"] = grads(m)

# stateful_component_batch_stats
m = chain("bn", [BnStage(), Dense(8, 4)], [bn_stage, mlp_params_from_flax])
y, updated = m(torch.from_numpy(spec["bn"]["x"]), mutable=True)
out["bn_y"] = val(y)
out["bn_updated"] = updated
m.merge_updates(updated)

# fused_matches_default_forward_and_grad
m = two_stage("fused")
x = torch.from_numpy(spec["fused"]["x"])
y = m(x)
out["default_y"] = val(y)
backward(y, sq)
out["default_grads"] = grads(m)
m.replicate()
m.zero_grad()
y = m(x, fused=True)
out["fused_y"] = y.detach()
backward(y, sq)
out["fused_grads"] = grads(m)

# fused_mutable_matches_default
m = chain("bn_fused", [BnStage(), Dense(8, 4)], [bn_stage, mlp_params_from_flax])
x = torch.from_numpy(spec["bn_fused"]["x"])
snapshot = [{k: v.clone() for k, v in c.state_dict().items()}
            for c in m.local_components()]
y_d, upd_d = m(x, mutable=True)
for c, s in zip(m.local_components(), snapshot):
    c.load_state_dict(s)               # back to the state before the call
m.replicate()
y_f, upd_f = m(x, mutable=True, fused=True)
out["bn_fused"] = (val(y_d), upd_d, val(y_f), upd_f)

# fused_training_converges (3 steps, every rank trains every component)
m = two_stage("fused_train").replicate()
out["fused_losses"] = train(m, torch.from_numpy(spec["fused_train"]["x"]),
                            torch.from_numpy(spec["fused_train"]["target"]),
                            fused=True)

# the dry run's cross-rank 2-stage chain (rank 0 -> the last rank)
m = chain("graft", [nn.Linear(8, 16), nn.Linear(16, 4)], bare_dense)
x = torch.from_numpy(spec["graft"]["x"]).requires_grad_()
y = m(x)
out["graft_y"] = val(y)
backward(y, sq)
out["graft_gx"] = x.grad
out["graft_grads"] = grads(m)


def error(wiring, width):
    m = MultiNodeChainList(comm)
    try:
        for rank, rank_in, rank_out in wiring:
            m.add_link(nn.Linear(width, 4), rank=rank, rank_in=rank_in,
                       rank_out=rank_out)
        m(torch.zeros(2, width))
    except Exception as e:
        return type(e).__name__, str(e)


out["errors"] = [error([(1, 0, None)], 16),
                 error([(0, None, 1), (1, None, None)], 12),
                 error([(comm.size + 5, None, None)], 12)]
save(out)
comm.finalize()
"""


def _jax_chain(comm, links, wiring):
    m = MultiNodeChainList(comm)
    for link, (rank, rank_in, rank_out) in zip(links, wiring):
        m.add_link(link, rank=rank, rank_in=rank_in, rank_out=rank_out)
    return m


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _train(apply, params, x, target, opt):
    state = opt.init(params)
    loss = lambda ps: jnp.mean((apply(ps, x) - target) ** 2)  # noqa: E731
    losses = []
    for _ in range(STEPS):
        value, g = jax.value_and_grad(loss)(params)
        losses.append(float(value))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return losses


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's results, and the spec the ranks load."""
    comm = create_communicator("naive")
    rs = np.random.RandomState
    spec, res = {"lr": LR, "steps": STEPS}, {}
    sq = lambda y: jnp.sum(y ** 2)  # noqa: E731

    def case(name, links, wiring, x, key, **extra):
        m = _jax_chain(comm, links, wiring)
        variables = m.init(jax.random.PRNGKey(key), *x)
        spec[name] = {"wiring": wiring, "variables": _host(variables),
                      "x": x[0], **extra}
        return m, variables

    two = [(0, None, 1), (1, 0, None)]
    x = rs(1).randn(4, 12).astype(np.float32)
    m, v = case("two", [Stage0(), Stage1()], two, (x,), 0)
    res["two_y"] = np.asarray(m.apply(v, x))
    gp, gx = jax.grad(lambda ps, xb: sq(m.apply(ps, xb)), argnums=(0, 1))(
        v, jnp.asarray(x))
    res["two_grads"], res["two_gx"] = _host(gp), np.asarray(gx)

    x = rs(2).randn(16, 12).astype(np.float32)
    target = rs(3).randn(16, 4).astype(np.float32)
    m, v = case("relay", [Stage0(), nn.Dense(16), Stage1()],
                [(0, None, 2), (2, 0, 1), (1, 2, None)], (x,), 1,
                target=target)
    res["relay_losses"] = _train(m.apply, v, x, target,
                                 create_component_wise_optimizer(
                                     optax.adam(LR)))

    x = rs(4).randn(4, 12).astype(np.float32)
    m, v = case("multi", [Stage0(), Stage0(), Combine()],
                [(0, None, 2), (1, None, 2), (2, [0, 1], None)], (x,), 2)
    res["multi_y"] = np.asarray(m.apply(v, x))
    res["multi_grads"] = _host(jax.grad(lambda ps: sq(m.apply(ps, x)))(v))

    x = (rs(5).randn(6, 12) * 3 + 1).astype(np.float32)
    m, v = case("bn", [BnStage(), Stage1()], two, (x,), 0)
    y, upd = m.apply(v, x, mutable=["batch_stats"])
    res["bn_y"], res["bn_updated"] = np.asarray(y), _host(upd)

    x = rs(7).randn(8, 12).astype(np.float32)
    m, v = case("fused", [Stage0(), Stage1()], two, (x,), 0)
    rep = m.replicate(v)
    res["fused_y"] = np.asarray(m.apply(rep, x, fused=True))
    res["fused_grads"] = _host(jax.grad(
        lambda ps: sq(m.apply(ps, x, fused=True)))(rep))

    x = (rs(8).randn(6, 12) * 2 - 1).astype(np.float32)
    m, v = case("bn_fused", [BnStage(), Stage1()], two, (x,), 0)
    y, upd = m.apply(m.replicate(v), x, mutable=["batch_stats"], fused=True)
    res["bn_fused_y"], res["bn_fused_updated"] = np.asarray(y), _host(upd)

    x = rs(9).randn(16, 12).astype(np.float32)
    target = rs(10).randn(16, 4).astype(np.float32)
    m, v = case("fused_train", [Stage0(), Stage1()], two, (x,), 3,
                target=target)
    res["fused_losses"] = _train(
        lambda ps, xb: m.apply(ps, xb, fused=True), m.replicate(v), x,
        target, optax.adam(LR))

    # __graft_entry__.py:406-417 with n_devices = N_RANKS
    last = N_RANKS - 1
    x = rs(11).randn(4, 8).astype(np.float32)
    m, v = case("graft", [nn.Dense(16), nn.Dense(4)],
                [(0, None, last), (last, 0, None)], (x,), 2)
    res["graft_y"] = np.asarray(m.apply(v, x))
    gp, gx = jax.grad(lambda ps, xb: sq(m.apply(ps, xb)), argnums=(0, 1))(
        v, jnp.asarray(x))
    res["graft_grads"], res["graft_gx"] = _host(gp), np.asarray(gx)
    res["graft_zeros_shape"] = m.apply(v, jnp.zeros((4, 8))).shape

    path = tmp_path_factory.mktemp("chain") / "spec.pt"
    torch.save(spec, path)
    return res, path


@pytest.fixture(scope="module")
def ranks(ref):
    return run_ranks(_WORKER, N_RANKS, args=[str(ref[1])], timeout=240)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _dense_grads(got: dict, p: dict, prefix: str) -> None:
    _close(got[f"{prefix}weight"].numpy(), p["kernel"].T)
    _close(got[f"{prefix}bias"].numpy(), p["bias"])


def test_forward_matches_jax(ref, ranks):
    _close(ranks[1]["two_y"], ref[0]["two_y"])
    assert ranks[0]["two_y"] is None           # rank 0 got its delegate


def test_params_live_on_their_ranks(ranks):
    for r, out in enumerate(ranks):
        names, devices = out["placement"]
        assert names == ([f"{r}.fcs.0.weight", f"{r}.fcs.0.bias"]
                         if r < 2 else [])
        assert devices == [("cpu" if c == r else "meta") for c in (0, 1)]


def test_gradients_cross_the_boundary(ref, ranks):
    res = ref[0]
    for r in (0, 1):
        _dense_grads(ranks[r]["two_grads"][r],
                     res["two_grads"][r]["params"]["Dense_0"], "fcs.0.")
    _close(ranks[0]["two_gx"], res["two_gx"])


def test_three_stage_relay_and_training(ref, ranks):
    losses = ranks[1]["relay_losses"]
    assert len(losses) == STEPS
    _close(losses, ref[0]["relay_losses"])
    assert ranks[0]["relay_losses"] == [] == ranks[2]["relay_losses"]


def test_multi_input_component(ref, ranks):
    res = ref[0]
    _close(ranks[2]["multi_y"], res["multi_y"])
    for r in range(3):
        _dense_grads(ranks[r]["multi_grads"][r],
                     res["multi_grads"][r]["params"]["Dense_0"], "fcs.0.")


def test_stateful_component_batch_stats(ref, ranks):
    res = ref[0]
    _close(ranks[1]["bn_y"], res["bn_y"])
    upd = ranks[0]["bn_updated"]
    stats = res["bn_updated"][0]["batch_stats"]["BatchNorm_0"]
    _close(upd[0]["bn.running_mean"], stats["mean"])
    _close(upd[0]["bn.running_var"], stats["var"])
    assert upd[1] == {} and res["bn_updated"][1] == {}
    assert ranks[1]["bn_updated"] == [{}, {}]


def test_fused_matches_default_forward_and_grad(ref, ranks):
    res = ref[0]
    for r in range(3):
        _close(ranks[r]["fused_y"], res["fused_y"])
        for i in (0, 1):
            _dense_grads(ranks[r]["fused_grads"][i],
                         res["fused_grads"][i]["params"]["Dense_0"], "fcs.0.")
    # the default mode on the same weights: identical values
    _close(ranks[1]["default_y"], ranks[1]["fused_y"])
    for r in (0, 1):
        for k, g in ranks[r]["default_grads"][r].items():
            _close(g, ranks[r]["fused_grads"][r][k])


def test_fused_mutable_matches_default(ref, ranks):
    res = ref[0]
    stats = res["bn_fused_updated"][0]["batch_stats"]["BatchNorm_0"]
    y_d, upd_d, y_f, upd_f = ranks[1]["bn_fused"]
    _close(y_d, res["bn_fused_y"])
    _close(y_f, res["bn_fused_y"])
    for r in range(3):
        _, upd_d, _, upd_f = ranks[r]["bn_fused"]
        _close(upd_f[0]["bn.running_mean"], stats["mean"])
        _close(upd_f[0]["bn.running_var"], stats["var"])
        if r == 0:
            _close(upd_d[0]["bn.running_mean"], stats["mean"])


def test_fused_training_matches_jax(ref, ranks):
    for out in ranks:
        assert len(out["fused_losses"]) == STEPS
        _close(out["fused_losses"], ref[0]["fused_losses"])


def test_graft_entry_two_stage_chain(ref, ranks):
    res = ref[0]
    last = N_RANKS - 1
    assert tuple(ranks[last]["graft_y"].shape) == res["graft_zeros_shape"]
    _close(ranks[last]["graft_y"], res["graft_y"])
    _close(ranks[0]["graft_gx"], res["graft_gx"])
    for r, i in ((0, 0), (last, 1)):
        p = res["graft_grads"][i]["params"]
        _close(ranks[r]["graft_grads"][i]["weight"], p["kernel"].T)
        _close(ranks[r]["graft_grads"][i]["bias"], p["bias"])


def test_wiring_errors(ranks):
    want = [("RuntimeError", "nothing was sent"),
            ("RuntimeError", "undelivered"),
            ("ValueError", "out of range")]
    for out in ranks:
        for (kind, msg), got in zip(want, out["errors"]):
            assert got[0] == kind and msg in got[1], got
