"""Mixture of experts in the port (``chainermn_torch/parallel/moe.py``, the
MoE blocks of ``TransformerLM`` and ``lm_train_step``'s MoE branch)
against the JAX package.

The routing function is compared exactly in one process. The
expert-parallel layer and the MoE LM's train step run on four gloo CPU
ranks, started once for the module; the JAX side runs the same layer and
step inside ``shard_map`` over four of the eight virtual CPU devices,
with the same seeded inputs and the JAX init converted by
``params_from_flax``. Tolerances: f32 outputs, aux and drop fractions
1e-5; gradients 1e-5 absolute plus 1e-4 relative; LM losses 1e-4 (Adam's
eps 1e-5, see ``test_torch_training.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.parallel.moe import ExpertParallelMLP as JaxEP
from chainermn_tpu.parallel.moe import GShardMoE as JaxGShard
from chainermn_tpu.parallel.moe import _route as jax_route
from chainermn_tpu.training import jit_lm_train_step
from chainermn_torch.interop import params_from_flax
from chainermn_torch.parallel.moe import (
    GShardMoE,
    MoeStatsAccumulator,
    _route,
    drop_frac_from_sown,
)
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")

N = 4
D, FF = 8, 16
# name: (n_experts, top_k, capacity_factor); 1.0 binds, 8.0 drops nothing
EP_CASES = {"top1_e1": (4, 1, 1.0), "top2_e1": (4, 2, 1.0),
            "top1_e2": (8, 1, 1.0), "top2_e2": (8, 2, 1.0),
            "top2_e2_ample": (8, 2, 8.0)}
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=64)
LM_MOE = dict(moe_experts=8, moe_top_k=2)
LM_STEPS, LR, EPS = 3, 1e-2, 1e-5


def _jax_comm():
    return chainermn_tpu.create_communicator("tpu", devices=jax.devices()[:N])


def _moe_sd(tree):
    p = tree.get("params", tree)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {"gate.weight": t(p["gate"]["kernel"]).T.contiguous(),
          "gate.bias": t(p["gate"]["bias"])}
    sd.update({k: t(p[k]) for k in ("w1", "b1", "w2", "b2")})
    return sd


def _ep_inputs(name):
    rng = np.random.default_rng(10 + list(EP_CASES).index(name))
    x = rng.standard_normal((N, 2, 6, D)).astype(np.float32)
    cot = rng.standard_normal((N, 2, 6, D)).astype(np.float32)
    return x, cot


def _jax_ep(comm, name):
    """Params, per-rank outputs, aux, drop fraction and the gradient of
    ``sum(out * cot) + aux`` (the global objective) of the JAX layer."""
    e, k, cf = EP_CASES[name]
    layer = JaxEP(n_experts=e, d_model=D, d_ff=FF, axis_name=comm.axis_name,
                  capacity_factor=cf, top_k=k)
    x, cot = _ep_inputs(name)
    params = jax.jit(comm.shard_map(
        lambda xb: layer.init(jax.random.PRNGKey(e + k), xb[0]),
        in_specs=comm.data_spec, out_specs=P()))(x)

    def apply(p, xs):
        def body(pp, xb):
            (y, aux), st = layer.apply(pp, xb[0], mutable=["moe_stats"])
            drop = st["moe_stats"]["drop_frac"][0]
            return y[None], aux, drop
        return comm.shard_map(body, in_specs=(P(), comm.data_spec),
                              out_specs=(comm.data_spec, P(), P()))(p, xs)

    def objective(p):
        yy, a, drop = apply(p, x)
        return jnp.sum(yy * cot) + a, (yy, a, drop)

    (_, (y, aux, drop)), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    return {"params": jax.device_get(params), "y": np.asarray(y),
            "aux": float(aux), "drop": float(drop),
            "grads": _moe_sd(jax.device_get(grads))}


def _lm_tokens():
    rng = np.random.default_rng(21)
    return rng.integers(0, LM["vocab_size"], (N * 2, 8)).astype(np.int32)


def _jax_lm(comm):
    return JaxLM(**LM, **LM_MOE, moe_axis=comm.axis_name,
                 compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_side():
    comm = _jax_comm()
    out = {"ep": {name: _jax_ep(comm, name) for name in EP_CASES}}
    tokens = _lm_tokens()
    lm = _jax_lm(comm)
    params = jax.jit(comm.shard_map(
        lambda t: lm.init(jax.random.PRNGKey(5), t), in_specs=comm.data_spec,
        out_specs=P()))(tokens)
    out["lm_init"] = jax.device_get(params)
    opt = chainermn_tpu.create_multi_node_optimizer(optax.adam(LR, eps=EPS),
                                                    comm)
    state = jax.device_put(opt.init(params), comm.named_sharding())
    step = jit_lm_train_step(lm, opt, comm, donate=False, monitored=False)
    losses, drops = [], []
    for _ in range(LM_STEPS):
        params, state, loss, stats = step(params, state,
                                          jnp.asarray(tokens),
                                          jnp.asarray(tokens))
        losses.append(float(loss))
        drops.append(float(stats["moe_drop_frac"]))
    out["lm_losses"], out["lm_drops"] = losses, drops
    out["lm_final"] = params_from_flax(jax.device_get(params))
    return out


_RANKS = """
import torch
from chainermn_torch import create_communicator, create_multi_node_optimizer
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel.moe import ExpertParallelMLP
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
comm = create_communicator("flat", device="cpu")
n, r = comm.size, comm.rank
res = {"ep": {}}
for name, (e, k, cf) in d["ep_cases"].items():
    c = d["ep"][name]
    layer = ExpertParallelMLP(e, d["dim"], d["ff"], comm, capacity_factor=cf,
                              top_k=k, device="cpu")
    layer.load_state_dict(c["params"])
    y, aux = layer(torch.from_numpy(c["x"][r]))
    (n * (y * torch.from_numpy(c["cot"][r])).sum() + aux).backward()
    names = [nm for nm, _ in layer.named_parameters()]
    grads = comm.multi_node_mean_grad([p.grad for p in layer.parameters()])
    res["ep"][name] = {"y": y.detach(), "aux": float(aux),
                       "drop": float(layer.stats["drop_frac"]),
                       "grads": dict(zip(names, grads))}

tokens = torch.from_numpy(d["tokens"]).long()
mine = tokens[r * 2:(r + 1) * 2]

def lm(**kw):
    m = TransformerLM(**d["lm"], **d["lm_moe"], moe_axis=comm,
                      attention="flash", compute_dtype=torch.float32,
                      device="cpu", **kw)
    m.load_state_dict(d["lm_init"])
    return m

# remat re-runs each block's forward, its two exchanges included, in the
# backward: the gradients must not change by a bit
grads = []
for remat in (False, True):
    m = lm(remat=remat)
    logits, aux = m(mine, return_aux=True)
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), mine.reshape(-1)
    ).add(0.01 * aux).backward()
    grads.append([p.grad.clone() for p in m.parameters()])
res["remat_bitwise"] = all(torch.equal(a, b) for a, b in zip(*grads))

m = lm()
opt = create_multi_node_optimizer(
    torch.optim.Adam(m.parameters(), lr=d["lr"], eps=d["eps"]), comm)
step = lm_train_step(m, opt, comm)
out = [step(mine, mine) for _ in range(d["steps"])]
res["lm_losses"] = [float(l) for l, _ in out]
res["lm_drops"] = [float(s["moe_drop_frac"]) for _, s in out]
res["lm_final"] = {k: v.detach().clone() for k, v in m.state_dict().items()}
comm.finalize()
save(res)
"""


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    ep = {}
    for name in EP_CASES:
        x, cot = _ep_inputs(name)
        ep[name] = {"x": x, "cot": cot,
                    "params": _moe_sd(jax_side["ep"][name]["params"])}
    payload = {"ep_cases": EP_CASES, "ep": ep, "dim": D, "ff": FF,
               "lm": LM, "lm_moe": LM_MOE, "tokens": _lm_tokens(),
               "lm_init": params_from_flax(jax_side["lm_init"]),
               "lr": LR, "eps": EPS, "steps": LM_STEPS}
    path = tmp_path_factory.mktemp("moe") / "cases.pt"
    torch.save(payload, path)
    return run_ranks(_RANKS, N, args=[str(path)], timeout=240)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 8.0])
def test_route_matches_jax_exactly(top_k, capacity_factor):
    """``_route`` (``moe.py:39``) on the same gate probabilities: the same
    indices, slots, keep mask and capacity; combine weights and
    first-choice loads to 1e-7."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((37, 6)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jax_route(jnp.asarray(probs), 6, top_k, capacity_factor)
    got = _route(torch.from_numpy(probs), 6, top_k, capacity_factor)
    assert got[5] == want[5]
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in (got[0], want[0]), (got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_matches_jax(port, jax_side, name):
    """Output, aux loss, drop fraction and the global objective's gradient
    (the ranks' gradients averaged, as the multi-node optimizer does) of
    the EP layer, top-1 and top-2, one and two experts a rank, with a
    capacity that binds (``drop > 0``) and one that does not. The gate's
    gradient passes through the aux statistics' mean all-reduce."""
    want = jax_side["ep"][name]
    got_y = np.stack([r["ep"][name]["y"].numpy() for r in port])
    np.testing.assert_allclose(got_y, want["y"], atol=1e-5, rtol=1e-5)
    for r in port:
        rec = r["ep"][name]
        np.testing.assert_allclose(rec["aux"], want["aux"], atol=1e-5)
        np.testing.assert_allclose(rec["drop"], want["drop"], atol=1e-6)
        for leaf, w in want["grads"].items():
            np.testing.assert_allclose(rec["grads"][leaf].numpy(),
                                       w.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=leaf)
    if EP_CASES[name][2] == 1.0:
        assert want["drop"] > 0      # the capacity binds in these cases
    else:
        assert abs(want["drop"]) < 1e-6


@pytest.mark.parametrize("top_k", [1, 2])
def test_gshard_matches_jax_and_expert_parallel(port, jax_side, top_k):
    """The einsum-dispatch twin in one process on the global batch against
    JAX's ``GShardMoE`` on the same weights (outputs, aux, drop), and, at
    a capacity where nothing drops, against the port's EP layer over four
    ranks."""
    name = f"top{top_k}_e2_ample" if top_k == 2 else "top1_e2"
    e, k, cf = EP_CASES[name]
    cf = 8.0
    x = _ep_inputs(name)[0].reshape(N * 2, 6, D)
    params = jax_side["ep"][name]["params"]
    jl = JaxGShard(n_experts=e, d_model=D, d_ff=FF, capacity_factor=cf,
                   top_k=k)
    (jy, jaux), st = jl.apply(params, jnp.asarray(x), mutable=["moe_stats"])
    layer = GShardMoE(e, D, FF, capacity_factor=cf, top_k=k, device="cpu")
    layer.load_state_dict(_moe_sd(params))
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    np.testing.assert_allclose(float(layer.stats["drop_frac"]),
                               float(st["moe_stats"]["drop_frac"][0]),
                               atol=1e-6)
    if name == "top2_e2_ample":
        ep_y = np.concatenate([r["ep"][name]["y"].numpy() for r in port])
        np.testing.assert_allclose(y.numpy(), ep_y, atol=1e-5, rtol=1e-5)


def test_moe_lm_train_step_matches_jax(port, jax_side):
    """Three Adam steps of the MoE LM (8 experts over 4 ranks, top-2, one
    MoE block of two) through ``lm_train_step`` against
    ``jit_lm_train_step``: losses (``ce + 0.01 * aux``) to 1e-4, the
    per-step ``moe_drop_frac`` to 1e-6, the trained parameters to 1e-4,
    and the expert stacks stored in the compute dtype."""
    for r in port:
        np.testing.assert_allclose(r["lm_losses"], jax_side["lm_losses"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["lm_drops"], jax_side["lm_drops"],
                                   atol=1e-6)
        for leaf, w in jax_side["lm_final"].items():
            np.testing.assert_allclose(r["lm_final"][leaf].numpy(),
                                       w.numpy(), atol=1e-4, rtol=0,
                                       err_msg=leaf)


def test_remat_gives_bitwise_equal_gradients(port):
    """``remat=True`` wraps every block in ``torch.utils.checkpoint``; the
    recomputed forward (its all-to-alls included) changes no gradient bit
    on the CPU."""
    assert all(r["remat_bitwise"] for r in port)


def test_drop_stats_helpers():
    """``drop_frac_from_sown`` averages the layers' records (0 with none),
    and ``MoeStatsAccumulator`` sums steps into mean and max."""
    recs = [{"drop_frac": torch.tensor(0.25)}, {"drop_frac": torch.tensor(
        0.75)}, {}]
    assert float(drop_frac_from_sown(recs)) == 0.5
    assert float(drop_frac_from_sown([])) == 0.0
    acc = MoeStatsAccumulator()
    acc.update({})
    assert acc.summary() == {"moe_drop_frac_mean": 0.0,
                             "moe_drop_frac_max": 0.0, "steps": 0}
    for v in (0.1, 0.3, 0.2):
        acc.update({"moe_drop_frac": torch.tensor(v)})
    s = acc.summary()
    assert s["steps"] == 3
    np.testing.assert_allclose(s["moe_drop_frac_mean"], 0.2, atol=1e-7)
    np.testing.assert_allclose(s["moe_drop_frac_max"], 0.3, atol=1e-7)


def test_parameter_dtypes_follow_the_reference():
    """At bf16 compute the reference declares the expert stacks in the
    compute dtype and every other leaf (the gate included: flax's
    ``Dense`` keeps float32 parameters) in float32; the port stores them
    alike, and the converted tree loads into them."""
    lm = JaxLM(**LM, **LM_MOE, moe_impl="gshard", compute_dtype=jnp.bfloat16)
    tree = jax.device_get(lm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4), jnp.int32)))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    jax_bf16 = sorted(jax.tree_util.keystr(k) for k, v in flat
                      if v.dtype == jnp.bfloat16)
    from chainermn_torch.models import TransformerLM

    model = TransformerLM(**LM, **LM_MOE, moe_impl="gshard",
                          compute_dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(params_from_flax(tree))
    port_bf16 = sorted(n for n, p in model.named_parameters()
                       if p.dtype == torch.bfloat16)
    assert port_bf16 == [f"blocks.1.moe.{k}" for k in ("b1", "b2", "w1",
                                                       "w2")]
    assert len(jax_bf16) == 4 and all("moe" in k for k in jax_bf16)
