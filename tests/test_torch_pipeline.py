"""The port's GPipe schedule (``chainermn_torch/ops/pipeline.py``)
against the JAX package's (``chainermn_tpu/ops/pipeline.py``).

The port runs as four gloo CPU ranks, one stage each, started once for
the module; the JAX side runs ``pipeline_apply`` and the pipelined LM's
step inside ``shard_map`` over four of the eight virtual CPU devices, on
the same seeded inputs and the JAX init (``pipeline_params_from_flax``
hands each rank its stage). Tolerances: outputs and gradients 1e-5
absolute plus 1e-4 relative, LM losses and parameters 1e-5 (Adam's eps
1e-5).

Reference fault, not copied (ROADMAP Queue C): the JAX step sums the
embedding's gradient over the ranks although, under ``shard_map``'s
varying-value tracking, the transpose of the injection already summed
it onto every rank, so its embedding gradient is ``n_stages`` times the
true one. The port's embedding gradient lives on rank 0 only, and the
sum is right there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.ops import init_pipeline_lm as jax_init
from chainermn_tpu.ops import jit_pp_lm_train_step as jax_pp_step
from chainermn_tpu.ops import make_pipeline_lm as jax_make
from chainermn_tpu.ops import pipeline_apply as jax_pipeline_apply
from chainermn_tpu.ops import pp_lm_opt_init as jax_opt_init
from chainermn_torch.interop import pipeline_params_from_flax
from chainermn_torch.ops import make_pipeline_lm
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")

N = 4
D, B = 6, 12
MICRO = (1, 4)
LM = dict(vocab_size=64, d_model=32, n_heads=4, max_len=64)
LM_MICRO, STEPS, LR, EPS = 4, 3, 1e-2, 1e-5


def _stage_inputs():
    rng = np.random.default_rng(50)
    return {"w": (0.3 * rng.standard_normal((N, D, D))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((N, D))).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32),
            "y": rng.standard_normal((B, D)).astype(np.float32)}


def _lm_data():
    rng = np.random.default_rng(51)
    tok = rng.integers(0, LM["vocab_size"], (8, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _jax_comm():
    return chainermn_tpu.create_communicator("tpu", devices=jax.devices()[:N])


def _undo_embedding_sum(n):
    """Divides the embedding's gradient by ``n`` before the optimizer:
    undoes the reference fault (module docstring) so that the JAX step's
    trajectory is the true one."""
    def update(updates, state, params=None):
        del params
        return {**updates, "embed": jax.tree_util.tree_map(
            lambda g: g / n, updates["embed"])}, state

    return optax.GradientTransformation(lambda _: optax.EmptyState(), update)


@pytest.fixture(scope="module")
def jax_side():
    comm = _jax_comm()
    s = _stage_inputs()
    stacked = {"w": jnp.asarray(s["w"]), "b": jnp.asarray(s["b"])}

    def stage(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    out = {"apply": {}}
    for micro in MICRO:
        def loss(p, micro=micro):
            def body(st, x, y):
                local = jax.tree_util.tree_map(lambda l: l[0], st)
                o = jax_pipeline_apply(stage, local, x, comm.axis_name, micro)
                return jnp.mean((o - y) ** 2), o
            return comm.shard_map(body, in_specs=(comm.data_spec, P(), P()),
                                  out_specs=(P(), P()))(
                p, jnp.asarray(s["x"]), jnp.asarray(s["y"]))
        (val, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
        out["apply"][micro] = {"loss": float(val), "out": np.asarray(o),
                               "grads": {k: np.asarray(v)
                                         for k, v in g.items()}}
    tok, tgt = _lm_data()
    mods = jax_make(**LM, n_stages=N)
    params = jax_init(mods, jax.random.PRNGKey(3), jnp.asarray(tok[:1]), N)
    out["lm_init"] = jax.device_get(params)
    opt = optax.chain(_undo_embedding_sum(N), optax.adam(LR, eps=EPS))
    state = jax_opt_init(opt, params)
    step = jax_pp_step(mods, opt, comm, n_microbatches=LM_MICRO,
                       donate=False)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(tok),
                                   jnp.asarray(tgt))
        losses.append(float(loss))
    out["lm_losses"] = losses
    return out


_RANKS = """
import torch
import torch.nn.functional as F
from chainermn_torch import create_communicator
from chainermn_torch.ops import (jit_pp_lm_train_step, make_pipeline_lm,
                                 pipeline_apply, pp_lm_opt_init)

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
comm = create_communicator("naive", device="cpu")
r = comm.rank
res = {"apply": {}}
s = d["stage"]
x, y = (torch.from_numpy(s[k]) for k in ("x", "y"))
for micro in d["micro"]:
    for remat in (False, True):
        w = torch.from_numpy(s["w"][r]).requires_grad_()
        b = torch.from_numpy(s["b"][r]).requires_grad_()
        o = pipeline_apply(lambda t: t + torch.tanh(t @ w + b), x, comm,
                           micro, remat=remat)
        loss = ((o - y) ** 2).mean()
        loss.backward()
        res["apply"][micro, remat] = {"loss": float(loss), "out": o.detach(),
                                      "w": w.grad, "b": b.grad}

tok, tgt = (torch.from_numpy(a).long() for a in d["data"])
mods = make_pipeline_lm(**d["lm"], n_stages=comm.size, device="cpu")
for part, sd in zip(mods, (d["parts"][r][k]
                           for k in ("embed", "block", "head"))):
    part.load_state_dict(sd)
opt = pp_lm_opt_init(lambda ps: torch.optim.Adam(ps, lr=d["lr"],
                                                 eps=d["eps"]), mods)
step = jit_pp_lm_train_step(mods, opt, comm, d["micro_lm"])
res["lm_losses"] = [float(step(tok, tgt)) for _ in range(d["steps"])]
res["lm_final"] = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                   for m in mods]
comm.finalize()
save(res)
"""


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    payload = {"stage": _stage_inputs(), "micro": MICRO, "lm": LM,
               "data": _lm_data(), "micro_lm": LM_MICRO, "steps": STEPS,
               "lr": LR, "eps": EPS,
               "parts": [pipeline_params_from_flax(jax_side["lm_init"], r)
                         for r in range(N)]}
    path = tmp_path_factory.mktemp("pp") / "cases.pt"
    torch.save(payload, path)
    return run_ranks(_RANKS, N, args=[str(path)], timeout=240)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("micro", MICRO)
def test_pipeline_apply_matches_jax(port, jax_side, micro, remat):
    """``pipeline_apply`` of a residual tanh stage, one stage a rank: the
    output on every rank and each stage's gradient against the JAX
    schedule's, at one and at four microbatches, with and without remat
    (``test_pipeline.py:48,69,95``)."""
    want = jax_side["apply"][micro]
    for r, rec in enumerate(port):
        got = rec["apply"][micro, remat]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-6)
        np.testing.assert_allclose(got["out"].numpy(), want["out"],
                                   atol=1e-5, rtol=1e-4)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].numpy(), want["grads"][k][r],
                                       atol=1e-5, rtol=1e-4, err_msg=k)


def _sequential(parts_per_stage, tok, tgt, steps):
    """The four-block stack in one process (no pipeline) trained alike:
    its losses and final parameters."""
    embed, _, head = make_pipeline_lm(**LM, n_stages=N, device="cpu")
    embed.load_state_dict(parts_per_stage[0]["embed"])
    head.load_state_dict(parts_per_stage[0]["head"])
    blocks = []
    for parts in parts_per_stage:
        blk = make_pipeline_lm(**LM, n_stages=N, device="cpu")[1]
        blk.load_state_dict(parts["block"])
        blocks.append(blk)
    mods = [embed, *blocks, head]
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=LR,
                           eps=EPS)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        x = embed(torch.from_numpy(tok).long())
        for blk in blocks:
            x = blk(x)
        logits = head(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               torch.from_numpy(tgt).long().reshape(-1))
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses, [m.state_dict() for m in mods]


def test_pp_lm_train_step_matches_sequential_and_jax(port, jax_side):
    """Three Adam steps of ``jit_pp_lm_train_step`` (4 stages, 4
    microbatches, remat): the losses equal the unpipelined four-block
    stack trained alike in one process (the first one is the pre-update
    loss, cell b6's check) to 1e-5, and its parameters after the steps on
    every rank; and the JAX step's losses to 1e-5, with the reference's
    ``n_stages``-fold embedding gradient divided back before its
    optimizer."""
    parts = [pipeline_params_from_flax(jax_side["lm_init"], r)
             for r in range(N)]
    want, final = _sequential(parts, *_lm_data(), STEPS)
    for r, rec in enumerate(port):
        np.testing.assert_allclose(rec["lm_losses"], want, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(rec["lm_losses"], jax_side["lm_losses"],
                                   atol=1e-5, rtol=0)
        for got, ref in zip(rec["lm_final"], (final[0], final[1 + r],
                                              final[-1])):
            for leaf, w in ref.items():
                np.testing.assert_allclose(got[leaf].numpy(), w.numpy(),
                                           atol=1e-5, rtol=0, err_msg=leaf)


def test_reference_embedding_gradient_is_n_stages_times_too_large():
    """The JAX step's embedding update under SGD(1.0) is ``n_stages`` times
    the sequential stack's gradient, while its head and stages are exact:
    the reference fault this port does not copy."""
    comm = _jax_comm()
    tok, tgt = (jnp.asarray(a) for a in _lm_data())
    mods = jax_make(**LM, n_stages=N)
    params = jax_init(mods, jax.random.PRNGKey(3), tok[:1], N)
    opt = optax.sgd(1.0)
    step = jax_pp_step(mods, opt, comm, n_microbatches=LM_MICRO, remat=False,
                       donate=False)
    new, _, _ = step(params, jax_opt_init(opt, params), tok, tgt)
    embed, block, head = mods

    def seq_loss(p):
        x = embed.apply(p["embed"], tok)
        for i in range(N):
            x = block.apply(jax.tree_util.tree_map(lambda l: l[i],
                                                   p["blocks"]), x)
        return optax.softmax_cross_entropy_with_integer_labels(
            head.apply(p["head"], x), tgt).mean()

    g = jax.grad(seq_loss)(params)
    ratio = {k: float(jnp.abs(params[k]["params"]["embed"]["embedding"]
                              - new[k]["params"]["embed"]["embedding"]).sum()
                      / jnp.abs(g[k]["params"]["embed"]["embedding"]).sum())
             for k in ("embed",)}
    np.testing.assert_allclose(ratio["embed"], N, rtol=1e-4)
    head_ratio = float(
        jnp.abs(params["head"]["params"]["lm_head"]["kernel"]
                - new["head"]["params"]["lm_head"]["kernel"]).sum()
        / jnp.abs(g["head"]["params"]["lm_head"]["kernel"]).sum())
    np.testing.assert_allclose(head_ratio, 1.0, rtol=1e-4)


def test_guards():
    """A batch that does not divide into microbatches, and a stage count
    that is not the group's size, are refused; ``pp_lm_specs`` places
    the block on its stage and the rest replicated."""
    from chainermn_torch import create_communicator
    from chainermn_torch.ops import jit_pp_lm_train_step, pipeline_apply
    from chainermn_torch.ops.pipeline import pp_lm_specs

    specs = pp_lm_specs(make_pipeline_lm(**LM, n_stages=2, device="cpu"))
    assert {v for k, v in specs.items() if k.startswith("block.")} == {
        "stage"}
    assert {v for k, v in specs.items() if not k.startswith("block.")} == {
        "replicated"}
    comm = create_communicator("naive", device="cpu")
    try:
        with pytest.raises(ValueError, match="divisible"):
            pipeline_apply(lambda t: t, torch.zeros(10, 4), comm, 4)
        mods = make_pipeline_lm(**LM, n_stages=2, device="cpu")
        with pytest.raises(ValueError, match="stages"):
            jit_pp_lm_train_step(mods, None, comm, 2)
    finally:
        comm.finalize()
