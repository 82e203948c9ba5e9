"""The weights-at-rest Megatron layout of the port
(``chainermn_torch/parallel/gspmd.py``) against the JAX package's
(``chainermn_tpu/parallel/gspmd.py``).

The port runs as four gloo CPU ranks, started once for the module; the
JAX side places the same converted init with ``megatron_shard`` on four
of the eight virtual CPU devices and trains it with its plain-jit step.
Checked: each rank stores exactly the slice JAX's sharding gives that
device, the stored parameter and optimizer fractions equal JAX's
``shard_shape`` fractions, and three Adam steps (eps 1e-5) give JAX's
losses and drop fractions to 1e-4 — for the dense LM, for gshard MoE at
top-1 and top-2, and for dp x tp = 2 x 2 against the replicated model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.parallel import gspmd_lm_train_step as jax_step
from chainermn_tpu.parallel import megatron_opt_shard as jax_opt_shard
from chainermn_tpu.parallel import megatron_shard as jax_shard
from chainermn_torch import create_communicator
from chainermn_torch.interop import megatron_params_from_flax, params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import gspmd
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")

N = 4
LM = dict(vocab_size=64, d_model=32, n_heads=8, n_layers=2, max_len=64)
# name: MoE fields (empty: dense)
CASES = {"dense": {},
         "gshard_top1": dict(moe_experts=4, moe_impl="gshard", moe_top_k=1),
         "gshard_top2": dict(moe_experts=8, moe_impl="gshard", moe_top_k=2)}
STEPS, LR, EPS = 3, 1e-2, 1e-5


def _tokens():
    rng = np.random.default_rng(30)
    tok = rng.integers(0, LM["vocab_size"], (4, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _fraction(tree):
    total = local = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "sharding") and leaf.shape:
            total += leaf.size
            local += int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
    return local / total


def _shard_tree(tree, device):
    """The tree of the shards ``device`` holds."""
    def shard(leaf):
        return next(np.asarray(s.data) for s in leaf.addressable_shards
                    if s.device == device)
    return jax.tree_util.tree_map(shard, tree)


@pytest.fixture(scope="module")
def jax_side():
    comm = chainermn_tpu.create_communicator("tpu",
                                             devices=jax.devices()[:N])
    tok, tgt = _tokens()
    out = {}
    for name, moe in CASES.items():
        model = JaxLM(**LM, **moe, compute_dtype=jnp.float32)
        init = model.init(jax.random.PRNGKey(7), jnp.asarray(tok[:1]))
        params = jax_shard(init, comm)
        opt = optax.adam(LR, eps=EPS)
        state = jax_opt_shard(opt, jax.jit(opt.init)(params), params, comm)
        rec = {"init": jax.device_get(init),
               "shards": [params_from_flax(_shard_tree(params, dev))
                          for dev in comm.mesh.devices.flat],
               "param_frac": _fraction(params), "opt_frac": _fraction(state)}
        step = jax_step(model, opt, comm, donate=False)
        losses, drops = [], []
        for _ in range(STEPS):
            params, state, loss, stats = step(params, state, jnp.asarray(tok),
                                              jnp.asarray(tgt))
            losses.append(float(loss))
            drops.append(float(stats.get("moe_drop_frac", 0.0)))
        rec["losses"], rec["drops"] = losses, drops
        out[name] = rec
    # the replicated dense model trained alike in one program
    model = JaxLM(**LM, compute_dtype=jnp.float32)
    params = out["dense"]["init"]
    opt = optax.adam(LR, eps=EPS)
    state = opt.init(params)

    @jax.jit
    def plain(params, state):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(p, jnp.asarray(tok)), jnp.asarray(tgt)).mean()
        loss, g = jax.value_and_grad(loss_fn)(params)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state, loss

    ref = []
    for _ in range(STEPS):
        params, state, loss = plain(params, state)
        ref.append(float(loss))
    out["replicated_losses"] = ref
    return out


_RANKS = """
import torch
from chainermn_torch import MeshCommunicator, create_communicator
from chainermn_torch.interop import megatron_params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import gspmd
from chainermn_torch.parallel.mesh import make_3d_mesh

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
base = create_communicator("naive", device="cpu")   # owns the default group
tok, tgt = (torch.from_numpy(a).long() for a in d["data"])
res = {}

def build(moe, sd):
    m = TransformerLM(**d["lm"], **moe, attention="flash",
                      compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(sd)
    return m

for name, moe in d["cases"].items():
    c = create_communicator("flat", device="cpu")
    model = gspmd.megatron_shard(build(moe, d["full"][name]), c)
    shards = {k: v.detach().clone() for k, v in model.state_dict().items()}
    conv = megatron_params_from_flax(d["trees"][name], model, c.rank, c.size)
    opt = torch.optim.Adam(model.parameters(), lr=d["lr"], eps=d["eps"])
    step = gspmd.gspmd_lm_train_step(model, opt, c)
    out = [step(tok, tgt) for _ in range(d["steps"])]
    res[name] = {"shards": shards, "converted": conv,
                 "losses": [float(l) for l, _ in out],
                 "drops": [float(s.get("moe_drop_frac", 0.0))
                           for _, s in out],
                 "fraction": gspmd.stored_fraction(model, opt)}
    c.finalize()

# megatron_opt_shard: AdamW state made on the whole model, then cut
c = create_communicator("flat", device="cpu")
model = build({}, d["full"]["dense"])
opt = torch.optim.AdamW(model.parameters(), lr=d["lr"])
model(tok).sum().backward()
opt.step()
whole = {n: opt.state[p]["exp_avg"].clone()
         for n, p in model.named_parameters()}
gspmd.megatron_opt_shard(opt, gspmd.megatron_shard(model, c))
specs = gspmd.megatron_param_specs(build({}, d["full"]["dense"]), c.size)
want = gspmd.shard_state_dict(whole, specs, c.rank, c.size, d["lm"]["n_heads"])
res["opt_shard"] = all(
    torch.equal(opt.state[p]["exp_avg"], want[n]) and
    opt.state[p]["exp_avg_sq"].shape == p.shape
    for n, p in model.named_parameters())
c.finalize()

c = MeshCommunicator(make_3d_mesh(shape=(2, 1, 2)), device="cpu")
model = build({}, d["full"]["dense"])
opt = torch.optim.Adam(model.parameters(), lr=d["lr"], eps=d["eps"])
step = gspmd.gspmd_lm_train_step(model, opt, c, tp_axis="tp", dp_axis="dp")
di, half = c.axis_index("dp"), tok.shape[0] // 2
res["dp_tp"] = [float(step(tok[di * half:(di + 1) * half],
                           tgt[di * half:(di + 1) * half])[0])
                for _ in range(d["steps"])]
c.finalize()
save(res)
base.finalize()
"""


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    payload = {"lm": LM, "cases": CASES, "data": _tokens(), "lr": LR,
               "eps": EPS, "steps": STEPS,
               "full": {n: params_from_flax(jax_side[n]["init"])
                        for n in CASES},
               "trees": {n: jax_side[n]["init"] for n in CASES}}
    path = tmp_path_factory.mktemp("gspmd") / "cases.pt"
    torch.save(payload, path)
    return run_ranks(_RANKS, N, args=[str(path)], timeout=240)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_stores_the_slice_jax_places_there(port, jax_side, name):
    """``megatron_shard`` of the converted weights, and
    ``megatron_params_from_flax`` of the flax tree, give rank ``r`` bit
    for bit what JAX's ``megatron_shard`` puts on device ``r``."""
    for r, rec in enumerate(port):
        want = jax_side[name]["shards"][r]
        assert set(rec[name]["shards"]) == set(want)
        for leaf, w in want.items():
            np.testing.assert_array_equal(rec[name]["shards"][leaf].numpy(),
                                          w.numpy(), err_msg=leaf)
            np.testing.assert_array_equal(rec[name]["converted"][leaf].numpy(),
                                          w.numpy(), err_msg=leaf)


@pytest.mark.parametrize("name", list(CASES))
def test_stored_fraction_matches_jax(port, jax_side, name):
    """Parameter and Adam-moment elements a rank stores over the
    replicated model's equal JAX's ``shard_shape`` fractions (the sharded
    leaves at 1/4, the replicated ones whole)."""
    for rec in port:
        frac = rec[name]["fraction"]
        assert frac["params"] == pytest.approx(jax_side[name]["param_frac"],
                                               rel=1e-9)
        assert frac["opt"] == pytest.approx(jax_side[name]["opt_frac"],
                                            rel=1e-9)
        assert frac["params"] <= 1 / N + frac["replicated_share"] + 1e-9


@pytest.mark.parametrize("name", list(CASES))
def test_gspmd_step_matches_jax(port, jax_side, name):
    """Three Adam steps of ``gspmd_lm_train_step`` against the JAX
    plain-jit step: losses (``ce + 0.01 * aux`` for MoE) to 1e-4 and the
    per-step drop fractions to 1e-6; every rank reports the same loss.
    The dense model's losses also equal the replicated model's."""
    for rec in port:
        np.testing.assert_allclose(rec[name]["losses"],
                                   jax_side[name]["losses"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(rec[name]["drops"],
                                   jax_side[name]["drops"], atol=1e-6)
        assert rec[name]["losses"] == port[0][name]["losses"]
    if name == "dense":
        np.testing.assert_allclose(port[0]["dense"]["losses"],
                                   jax_side["replicated_losses"], atol=1e-4,
                                   rtol=0)


def test_opt_shard_cuts_existing_optimizer_state(port):
    """``megatron_opt_shard`` cuts AdamW moments made on the whole model to
    the same shards as their parameters (``gspmd.py:231``)."""
    assert all(rec["opt_shard"] for rec in port)


def test_dp_by_tp_matches_the_replicated_model(port, jax_side):
    """dp x tp = 2 x 2 on a ``MeshCommunicator``: each data rank trains on
    its half of the batch; the losses equal the replicated model's on the
    whole batch."""
    for rec in port:
        np.testing.assert_allclose(rec["dp_tp"],
                                   jax_side["replicated_losses"], atol=1e-4,
                                   rtol=0)


def test_specs_report_and_guards():
    """The leaf table over the port's names (every block's qkv, proj,
    fc1, fc2, the head and the embedding sharded; norms, pos_embed,
    row-parallel biases and the gate known-replicated; nothing
    unmatched), an undividable rule replicated, and the reference's
    refusals."""
    model = TransformerLM(**LM, moe_experts=4, moe_impl="gshard",
                          compute_dtype=torch.float32, device="cpu")
    specs, rep = gspmd.megatron_param_specs(model, 4, report=True)
    assert rep["paths"]["unmatched"] == [] == rep["paths"]["undividable"]
    assert specs["blocks.0.qkv.weight"] == "heads"
    assert specs["blocks.1.moe.w1"] == 0 and specs["embed.weight"] == 0
    assert specs["blocks.1.moe.gate.weight"] is None
    assert specs["pos_embed.weight"] is None
    _, rep3 = gspmd.megatron_param_specs(model, 3, report=True)
    assert "blocks.0.qkv.weight" in rep3["paths"]["undividable"]
    comm = create_communicator("naive", device="cpu")
    try:
        opt = torch.optim.Adam(model.parameters())
        tp = TransformerLM(**LM, tensor_axis=comm, device="cpu")
        with pytest.raises(ValueError, match="DENSE"):
            gspmd.gspmd_lm_train_step(tp, opt, comm)
        ep = TransformerLM(**LM, moe_experts=4, moe_axis=comm, device="cpu")
        with pytest.raises(ValueError, match="gshard"):
            gspmd.gspmd_lm_train_step(ep, opt, comm)
        gspmd.megatron_shard(model, comm)
        with pytest.raises(ValueError, match="Megatron shards"):
            model(torch.zeros((1, 4), dtype=torch.long))
    finally:
        comm.finalize()
