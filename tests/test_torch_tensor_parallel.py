"""Tensor parallelism of the port (``chainermn_torch/parallel/tensor.py``,
the ``tensor_axis`` LM and its train step, the ``dp x sp x tp`` mesh)
against the JAX package.

The port runs as four gloo CPU ranks, started once for the module, which
build one :class:`MeshCommunicator` after another; the JAX side runs the
same layers and steps inside ``shard_map`` over meshes of four of the
eight virtual CPU devices. Both sides take the same seeded inputs and the
same weights (the JAX package's init, converted by ``params_from_flax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.communicators import MeshCommunicator as JaxMesh
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.parallel import TensorParallelAttention as JaxTPAttention
from chainermn_tpu.parallel import TensorParallelMLP as JaxTPMLP
from chainermn_tpu.parallel import make_3d_mesh as jax_3d_mesh
from chainermn_tpu.parallel import reshard_tp_qkv as jax_reshard
from chainermn_tpu.parallel.sequence import zigzag_permutation
from chainermn_tpu.parallel.tensor import global_objective as jax_objective
from chainermn_tpu.parallel.tensor import (
    vocab_parallel_cross_entropy as jax_vocab_ce,
)
from chainermn_tpu.training import jit_lm_train_step
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import mesh as tmesh
from chainermn_torch.parallel.tensor import reshard_tp_qkv
from chainermn_torch.testing import run_ranks

N = 4
MLP = dict(d_model=16, d_ff=64)
ATTN = dict(d_model=32, n_heads=8)
VOCAB_LOCAL = 5
# the LM of test_tensor.py's TP tests at __graft_entry__.py's width
LM = dict(d_model=16, n_heads=8, n_layers=1, max_len=64)
LM_STEPS, LR, EPS = 3, 1e-2, 1e-5
# name: (dp, sp, tp), the port's attention, the JAX step's attention
TRAIN = {"tp_vocab": ((1, 1, 4), "flash", "full"),
         "dp_sp": ((2, 2, 1), "ring_flash", "ring"),
         "sp_tp": ((1, 2, 2), "zigzag_flash", "zigzag"),
         "sp_tp_ulysses": ((1, 2, 2), "ulysses_flash", "ulysses"),
         "dp_tp": ((2, 1, 2), "flash", "full")}
COMPOSE = ("ring", "zigzag", "ulysses")


def _jax_mesh(shape):
    return JaxMesh(mesh=jax_3d_mesh(devices=jax.devices()[:N], shape=shape))


def _replicated(comm, fn, *args):
    return jax.jit(comm.shard_map(fn, in_specs=tuple(P() for _ in args),
                                  out_specs=P()))(*args)


def _lm_batch(shape):
    ndp, nsp, ntp = shape
    rng = np.random.default_rng(40)
    b, t = 2 * ndp, 8 * nsp
    return rng.integers(0, 8 * ntp, (b, t)).astype(np.int32)


def _jax_lm(shape, attention):
    nsp, ntp = shape[1], shape[2]
    return JaxLM(vocab_size=8 * ntp, **LM, attention=attention,
                 sequence_axis="sp" if nsp > 1 else None, tensor_axis="tp",
                 vocab_parallel_head=True, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Inputs and JAX-initialised weights of every case (numpy)."""
    rng = np.random.default_rng(0)
    flat = _jax_mesh((1, 1, N))
    x = rng.standard_normal((4, 6, MLP["d_model"]), dtype=np.float32)
    y = rng.standard_normal((4, 6, MLP["d_model"]), dtype=np.float32)
    mlp = JaxTPMLP(**MLP, axis_name="tp")
    xa = rng.standard_normal((2, 8, ATTN["d_model"]), dtype=np.float32)
    attn = JaxTPAttention(**ATTN, axis_name="tp", causal=True)
    vocab = N * VOCAB_LOCAL
    logits = (rng.standard_normal((3, 4, vocab)) * 3).astype(np.float32)
    targets = rng.integers(0, vocab, (3, 4))
    targets[0] = [0, vocab - 1, VOCAB_LOCAL - 1, VOCAB_LOCAL]   # shard edges
    out = {"x": x, "y": y, "xa": xa, "logits": logits, "targets": targets,
           "mlp": jax.device_get(_replicated(
               flat, lambda a: mlp.init(jax.random.PRNGKey(1), a), x)),
           "attn": jax.device_get(_replicated(
               flat, lambda a: attn.init(jax.random.PRNGKey(3), a), xa))}
    sp_tp = _jax_mesh((1, 2, 2))
    out["compose"] = {}
    for kind in COMPOSE:
        cat = JaxTPAttention(**ATTN, axis_name="tp", causal=True,
                             attention=kind, sequence_axis="sp")
        out["compose"][kind] = jax.device_get(jax.jit(sp_tp.shard_map(
            lambda a: cat.init(jax.random.PRNGKey(31), a),
            in_specs=P(None, "sp"), out_specs=P()))(xa))
    out["lm"] = {}
    for name, (shape, _, jattn) in TRAIN.items():
        mesh = _jax_mesh(shape)
        tokens = _lm_batch(shape)
        lm = _jax_lm(shape, jattn)
        out["lm"][name] = jax.device_get(jax.jit(mesh.shard_map(
            lambda t: lm.init(jax.random.PRNGKey(41), t),
            in_specs=P("dp", "sp"), out_specs=P()))(tokens))
    return out


_RANKS = """
import numpy as np
import torch
from chainermn_torch import MeshCommunicator, create_communicator
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import mesh as pmesh
from chainermn_torch.parallel import tensor as ptp
from chainermn_torch.parallel.sequence import zigzag_permutation
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
base = create_communicator("naive", device="cpu")   # owns the default group
res = {}

def mesh(shape):
    return MeshCommunicator(pmesh.make_3d_mesh(shape=shape), device="cpu")

def assembled(module, tp):
    # the step's gradient assembly: sliced leaves summed over the axis
    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        if getattr(p, "tensor_parallel_sliced", False):
            g = tp.allreduce(g, "sum")
        out[name] = g
    return out

c = mesh((1, 1, 4))
tp = c.axis("tp")
mlp = ptp.TensorParallelMLP(16, 64, "tp", device="cpu")
mlp.load_state_dict(d["mlp"])
x, y = (torch.from_numpy(a) for a in (d["x"], d["y"]))
o = mlp(x)
((o - y) ** 2).mean().backward()
res["mlp"] = (o.detach(), assembled(mlp, tp))
attn = ptp.TensorParallelAttention(32, 8, "tp", device="cpu")
attn.load_state_dict(d["attn"])
xa = torch.from_numpy(d["xa"])
res["attn"] = attn(xa).detach()
vl = d["vocab_local"]
full = torch.from_numpy(d["logits"])
local = full[..., tp.rank * vl:(tp.rank + 1) * vl].clone().requires_grad_()
ce = ptp.vocab_parallel_cross_entropy(local, torch.from_numpy(d["targets"]),
                                      "tp")
ce.mean().backward()
res["vocab_ce"] = (ce.detach(), local.grad)
c.finalize()

c = mesh((1, 2, 2))
s = c.axis_index("sp")
res["compose"] = {}
for kind in d["compose_kinds"]:
    m = ptp.TensorParallelAttention(32, 8, "tp", attention=kind,
                                    sequence_axis="sp", device="cpu")
    m.load_state_dict(d["compose"][kind])
    t = xa.shape[1]
    layout = zigzag_permutation(t, 2) if kind == "zigzag" else torch.arange(t)
    res["compose"][kind] = m(xa[:, layout[s * (t // 2):(s + 1) * (t // 2)]]
                             ).detach()
c.finalize()

res["lm"] = {}
for name, (shape, attention, _) in d["train"].items():
    c = mesh(shape)
    ndp, nsp, ntp = shape
    model = TransformerLM(8 * ntp, **d["lm_cfg"], attention=attention,
                          sequence_axis="sp" if nsp > 1 else None,
                          tensor_axis="tp", vocab_parallel_head=True,
                          compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(d["lm"][name])
    tokens = d["tokens"][name]
    b, t = tokens.shape
    layout = (zigzag_permutation(t, nsp).numpy() if "zigzag" in attention
              else np.arange(t))
    di, si = c.axis_index("dp"), c.axis_index("sp")
    mine = tokens[di * (b // ndp):(di + 1) * (b // ndp)][
        :, layout[si * (t // nsp):(si + 1) * (t // nsp)]]
    with torch.no_grad():
        logits = model(torch.from_numpy(mine).long()) if nsp == 1 else None
    opt = torch.optim.Adam(model.parameters(), lr=d["lr"], eps=d["eps"])
    step = lm_train_step(model, opt, c, shard_sequence=nsp > 1)
    res["lm"][name] = {
        "logits": logits, "rank": c.axis_index("tp"),
        "losses": [float(step(mine, mine)[0]) for _ in range(d["steps"])],
        "same_params": [float(p.detach().abs().sum()) for p in
                        model.parameters()]}
    c.finalize()
save(res)
base.finalize()
"""


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    js = jax_side
    payload = {
        "mlp": _mlp_sd(js["mlp"]), "attn": _attn_sd(js["attn"]),
        "x": js["x"], "y": js["y"], "xa": js["xa"],
        "logits": js["logits"], "targets": js["targets"],
        "vocab_local": VOCAB_LOCAL, "compose_kinds": COMPOSE,
        "compose": {k: _attn_sd(v) for k, v in js["compose"].items()},
        "train": TRAIN, "lm_cfg": LM, "steps": LM_STEPS, "lr": LR,
        "eps": EPS, "tokens": {n: _lm_batch(s) for n, (s, _, _) in
                               TRAIN.items()},
        "lm": {n: params_from_flax(t) for n, t in js["lm"].items()}}
    path = tmp_path_factory.mktemp("tp") / "cases.pt"
    torch.save(payload, path)
    return run_ranks(_RANKS, N, args=[str(path)], timeout=240)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mlp_sd(tree):
    p = tree["params"]
    c, r = p["ColumnParallelDense_0"], p["RowParallelDense_0"]
    return {"fc1.weight": _t(c["kernel"]).T, "fc1.bias": _t(c["bias"]),
            "fc2.weight": _t(r["kernel"]).T, "fc2.bias": _t(r["bias"])}


def _attn_sd(tree):
    p = tree["params"]
    return {f"{n}.{k}": (_t(p[f][kk]).T if k == "weight" else _t(p[f][kk]))
            for n, f in (("qkv", "qkv_tpcol"), ("proj", "proj_tprow"))
            for k, kk in (("weight", "kernel"), ("bias", "bias"))}


def test_mlp_and_gradients_match_jax(port, jax_side):
    """TP MLP output and the exact global gradient of every leaf against
    the JAX layer under the global-objective pattern
    (``test_tensor.py:46,96``)."""
    js = jax_side
    comm = _jax_mesh((1, 1, N))
    mlp = JaxTPMLP(**MLP, axis_name="tp")
    x, y = jnp.asarray(js["x"]), jnp.asarray(js["y"])

    def grads(p):
        return jax.grad(lambda pp: jax_objective(
            jnp.mean((mlp.apply(pp, x) - y) ** 2), ("dp", "sp", "tp")))(p)

    params = jax.tree_util.tree_map(jnp.asarray, js["mlp"])
    want_out = _replicated(comm, lambda p: mlp.apply(p, x), params)
    want_g = _mlp_sd(jax.device_get(_replicated(comm, grads, params)))
    for r in port:
        out, g = r["mlp"]
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=1e-5, rtol=1e-5)
        for name, w in want_g.items():
            np.testing.assert_allclose(g[name].numpy(), w.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_attention_matches_jax(port, jax_side):
    """Heads over the tensor axis, causal full attention
    (``test_tensor.py:65``)."""
    comm = _jax_mesh((1, 1, N))
    attn = JaxTPAttention(**ATTN, axis_name="tp", causal=True)
    params = jax.tree_util.tree_map(jnp.asarray, jax_side["attn"])
    want = _replicated(comm, lambda p: attn.apply(
        p, jnp.asarray(jax_side["xa"])), params)
    for r in port:
        np.testing.assert_allclose(r["attn"].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_vocab_parallel_cross_entropy_matches_jax(port, jax_side):
    """Per-token CE and its gradient over vocab-sharded logits, targets on
    every shard's edges (``test_tensor.py:172``)."""
    comm = _jax_mesh((1, 1, N))
    full = jnp.asarray(jax_side["logits"])
    targets = jnp.asarray(jax_side["targets"])

    def local_ce(fl):
        r = jax.lax.axis_index("tp")
        loc = jax.lax.dynamic_slice_in_dim(fl, r * VOCAB_LOCAL, VOCAB_LOCAL,
                                           axis=-1)
        return jax_vocab_ce(loc, targets, "tp")

    want = _replicated(comm, local_ce, full)
    want_g = _replicated(comm, lambda fl: jax.grad(lambda f: jax_objective(
        local_ce(f).mean(), "tp"))(fl), full)
    got_g = torch.cat([r["vocab_ce"][1] for r in port], dim=-1)
    for r in port:
        np.testing.assert_allclose(r["vocab_ce"][0].numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", COMPOSE)
def test_attention_composes_with_sequence_parallelism(port, jax_side, kind):
    """Heads over tp, the sequence over sp, on a 2 x 2 mesh
    (``test_tensor.py:250``): the gathered output against the JAX
    composition."""
    comm = _jax_mesh((1, 2, 2))
    attn = JaxTPAttention(**ATTN, axis_name="tp", causal=True,
                          attention=kind, sequence_axis="sp")
    xa = jax_side["xa"]
    t = xa.shape[1]
    layout = (np.asarray(zigzag_permutation(t, 2)) if kind == "zigzag"
              else np.arange(t))
    params = jax.tree_util.tree_map(jnp.asarray, jax_side["compose"][kind])
    want = jax.jit(comm.shard_map(
        lambda p, a: attn.apply(p, a), in_specs=(P(), P(None, "sp")),
        out_specs=P(None, "sp")))(params, jnp.asarray(xa[:, layout]))
    # ranks (sp, tp) = (0, 0), (0, 1), (1, 0), (1, 1); tp ranks agree
    got = torch.cat([port[0]["compose"][kind], port[2]["compose"][kind]],
                    dim=1)
    torch.testing.assert_close(port[1]["compose"][kind],
                               port[0]["compose"][kind], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_lm_train_step_matches_jax(port, jax_side, name):
    """Three Adam steps of the tensor-parallel LM with the vocab-parallel
    head through ``lm_train_step`` against the JAX TP step
    (``training.py:178-305``): pure TP on 4 ranks, and each axis pair
    (dp+sp, sp+tp with zigzag and with Ulysses, dp+tp) on 2 x 2. The port
    runs the flash kinds on the CPU (their plain versions); the JAX step
    refuses Pallas off the TPU, so it runs the same kinds without.
    Losses to 1e-4; every rank ends with the same parameters."""
    shape, _, jattn = TRAIN[name]
    mesh = _jax_mesh(shape)
    lm = _jax_lm(shape, jattn)
    params = jax.tree_util.tree_map(jnp.asarray, jax_side["lm"][name])
    opt = optax.adam(LR, eps=EPS)
    state = opt.init(params)
    step = jit_lm_train_step(lm, opt, mesh, shard_sequence=shape[1] > 1,
                             donate=False, monitored=False)
    tokens = _lm_batch(shape)
    if "zigzag" in jattn:
        tokens = tokens[:, np.asarray(zigzag_permutation(tokens.shape[1],
                                                         shape[1]))]
    want = []
    for _ in range(LM_STEPS):
        params, state, loss, _ = step(params, state, jnp.asarray(tokens),
                                      jnp.asarray(tokens))
        want.append(float(loss))
    for r in port:
        np.testing.assert_allclose(r["lm"][name]["losses"], want, atol=1e-4,
                                   rtol=0)
        assert r["lm"][name]["same_params"] == port[0]["lm"][name][
            "same_params"]


def test_tp_lm_and_dense_lm_from_one_flax_tree(port, jax_side):
    """The tensor-parallel LM (4 ranks, vocab-parallel head) and the dense
    LM built from one flax tree give the same logits: the TP tree's qkv
    columns permuted to the dense order (``reshard_tp_qkv`` to degree 1)
    and its module names mapped to the dense blocks'."""
    sd = reshard_tp_qkv(params_from_flax(jax_side["lm"]["tp_vocab"]),
                        LM["n_heads"], LM["d_model"] // LM["n_heads"], N, 1)
    sd = {k.replace("attn.", "").replace("mlp.", ""): v
          for k, v in sd.items()}
    dense = TransformerLM(8 * N, **LM, compute_dtype=torch.float32,
                          device="cpu")
    dense.load_state_dict(sd)
    tokens = _lm_batch(TRAIN["tp_vocab"][0])
    with torch.no_grad():
        want = dense(torch.from_numpy(tokens).long())
    ranked = sorted(port, key=lambda r: r["lm"]["tp_vocab"]["rank"])
    got = torch.cat([r["lm"]["tp_vocab"]["logits"] for r in ranked], dim=-1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_reshard_tp_qkv_matches_jax():
    """``reshard_tp_qkv`` on the port's state dict against the JAX
    package's on the flax tree (``test_tensor.py:455``), both ways."""
    h, dh, d_in = 8, 4, 16
    rng = np.random.default_rng(0)
    kern = rng.standard_normal((d_in, 3 * h * dh)).astype(np.float32)
    bias = rng.standard_normal((3 * h * dh,)).astype(np.float32)
    tree = {"block_0": {"attn": {"qkv_tpcol": {"kernel": kern,
                                               "bias": bias}}}}
    sd = {"blocks.0.attn.qkv.weight": torch.from_numpy(kern.T.copy()),
          "blocks.0.attn.qkv.bias": torch.from_numpy(bias)}
    for new in (1, 2, 4):
        want = jax_reshard(tree, h, dh, 8, new)["block_0"]["attn"][
            "qkv_tpcol"]
        got = reshard_tp_qkv(sd, h, dh, 8, new)
        np.testing.assert_array_equal(
            got["blocks.0.attn.qkv.weight"].numpy(),
            np.asarray(want["kernel"]).T)
        np.testing.assert_array_equal(got["blocks.0.attn.qkv.bias"].numpy(),
                                      np.asarray(want["bias"]))
        back = reshard_tp_qkv(got, h, dh, new, 8)
        torch.testing.assert_close(back, sd, atol=0, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        reshard_tp_qkv(sd, h, dh, 8, 3)
    with pytest.raises(ValueError, match="no tensor-parallel qkv"):
        reshard_tp_qkv({"w": torch.zeros(3)}, h, dh, 8, 1)


def test_mesh_geometry_matches_jax():
    """``make_3d_mesh``'s balanced factoring and the straddle warning's
    policy, as the reference's."""
    from chainermn_tpu.parallel import mesh as jmesh

    for n in (1, 2, 3, 4, 6, 8):
        want = jax_3d_mesh(devices=jax.devices()[:n]).shape
        assert tmesh.make_3d_mesh(n).shape == dict(want)
    for shape, counts in (((2, 2, 2), {0: 4, 1: 4}), ((1, 2, 3), {0: 3, 1: 3}),
                          ((2, 2, 2), {0: 8}), ((1, 4, 2), {0: 2, 1: 2,
                                                            2: 2, 3: 2})):
        assert (tmesh._straddle_warning(shape, counts, 8) is None) == (
            jmesh._straddle_warning(shape, counts, 8) is None)
    m = tmesh.make_3d_mesh(8, shape=(2, 2, 2))
    assert m.axis_groups("tp")[:2] == [[0, 1], [2, 3]]
    assert m.axis_groups("sp")[:2] == [[0, 2], [1, 3]]
    assert m.axis_groups("dp")[:2] == [[0, 4], [1, 5]]
    g = tmesh.RankGeometry.from_mesh(m, 5, local_world_size=4)
    assert (g.intra_rank, g.inter_rank, g.inter_size) == (1, 1, 2)
    with pytest.raises(ValueError, match="cover"):
        tmesh.make_3d_mesh(8, shape=(2, 2, 3))


def test_model_guards():
    with pytest.raises(ValueError, match="needs tensor_axis"):
        TransformerLM(16, **LM, vocab_parallel_head=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerLM(16, **LM, tensor_axis="tp", moe_experts=2,
                      device="cpu")
    lm = TransformerLM(16, **LM, attention="ring", sequence_axis="sp",
                       device="cpu")
    with pytest.raises(ValueError, match="sequence-sharded"):
        lm(torch.zeros(1, 4, dtype=torch.long), kv_caches=[{}])


def test_tp_step_guards():
    """The JAX TP step's axis checks (``training.py:208-260``), raised
    when the step is built, before any collective."""
    import types

    from chainermn_torch.training import lm_train_step

    mesh = types.SimpleNamespace(axis_name=("dp", "sp", "tp"),
                                 axis_size=lambda name: 2)
    opt = None
    lm = TransformerLM(16, **LM, tensor_axis="nonexistent", device="cpu")
    with pytest.raises(ValueError, match="mesh axes"):
        lm_train_step(lm, opt, mesh)
    lm = TransformerLM(16, **LM, tensor_axis="tp", sequence_axis="sp",
                       device="cpu")
    with pytest.raises(ValueError, match="ring"):
        lm_train_step(lm, opt, mesh, shard_sequence=True)
    lm = TransformerLM(16, **LM, attention="ring", tensor_axis="tp",
                       sequence_axis="sp", device="cpu")
    with pytest.raises(ValueError, match="shard_sequence=True"):
        lm_train_step(lm, opt, mesh, shard_sequence=False)
    lm = TransformerLM(16, **LM, attention="ring", tensor_axis="tp",
                       sequence_axis="tp", device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        lm_train_step(lm, opt, mesh, shard_sequence=True)


_HYBRID = """
import torch
from chainermn_torch import MeshCommunicator
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import mesh as pmesh
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
c = MeshCommunicator(pmesh.make_3d_mesh(), device="cpu")
assert c.mesh.shape == {"dp": 2, "sp": 2, "tp": 2}, c.mesh.shape
model = TransformerLM(16, **d["lm_cfg"], attention="ring_flash",
                      sequence_axis="sp", tensor_axis="tp",
                      vocab_parallel_head=True, compute_dtype=torch.float32,
                      device="cpu")
model.load_state_dict(d["params"])
di, si = c.axis_index("dp"), c.axis_index("sp")
tokens = d["tokens"][2 * di:2 * di + 2, 8 * si:8 * si + 8]
opt = torch.optim.Adam(model.parameters(), lr=d["lr"], eps=d["eps"])
step = lm_train_step(model, opt, c, shard_sequence=True)
save([float(step(tokens, tokens)[0]) for _ in range(5)])
c.finalize()
"""


@pytest.mark.slow  # 8 ranks; each axis pair has its tier-1 case above
def test_3d_dp_sp_tp_lm_matches_jax(tmp_path):
    """The full hybrid dp x sp x tp = 2 x 2 x 2 on 8 ranks
    (``test_tensor.py:309``, ``__graft_entry__.py:278-307``): ring
    attention over sp, Megatron blocks and the vocab-parallel head over
    tp, the batch over dp; five losses against the JAX step's to 1e-4,
    falling."""
    mesh = JaxMesh(mesh=jax_3d_mesh())
    lm = JaxLM(vocab_size=16, **LM, attention="ring", sequence_axis="sp",
               tensor_axis="tp", vocab_parallel_head=True,
               compute_dtype=jnp.float32)
    tokens = np.random.default_rng(41).integers(0, 16, (4, 16)).astype(
        np.int32)
    params = jax.jit(mesh.shard_map(
        lambda t: lm.init(jax.random.PRNGKey(41), t),
        in_specs=P("dp", "sp"), out_specs=P()))(tokens)
    path = tmp_path / "hybrid.pt"
    torch.save({"lm_cfg": LM, "lr": LR, "eps": EPS, "tokens": tokens,
                "params": params_from_flax(jax.device_get(params))}, path)
    got = run_ranks(_HYBRID, 8, local_world_size=4, args=[str(path)],
                    timeout=240)
    opt = optax.adam(LR, eps=EPS)
    state = opt.init(params)
    step = jit_lm_train_step(lm, opt, mesh, shard_sequence=True,
                             donate=False, monitored=False)
    want = []
    for _ in range(5):
        params, state, loss, _ = step(params, state, jnp.asarray(tokens),
                                      jnp.asarray(tokens))
        want.append(float(loss))
    for losses in got:
        np.testing.assert_allclose(losses, want, atol=1e-4, rtol=0)
    assert want[-1] < want[0]
