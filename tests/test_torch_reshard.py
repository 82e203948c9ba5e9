"""The port's elastic resharded restore (``chainermn_torch/deploy/reshard.py``)
against the JAX package's (``chainermn_tpu/deploy/reshard.py``).

In one process: the permutation a TP-degree change applies to a saved
train state — the qkv weight, its bias and Adam's ``exp_avg`` and
``exp_avg_sq`` of both, keyed by parameter name — equals the JAX
package's ``reshard_tp_qkv`` on the same arrays (tp 2 -> 4 and 4 -> 2),
every other leaf restores as saved, and the guards raise as the
reference's do.

On four gloo ranks (started once for the module), the small LM of
``tests/deploy_tests/test_reshard.py``: trained 5 steps at dp x tp =
2 x 2, snapshotted, and continued 5 steps; restored at tp = 4 its
forward equals the dense LM on the snapshot's weights to 1e-5 and its 5
steps' losses follow the continuation (the 10-step parity of
``test_reshard.py:216``, here 5 before the snapshot and 5 after); saved
again at tp = 4 and restored at 2 x 2, the forward matches again. A
ZeRO state restores at its own world size and refuses another.
"""

import numpy as np
import pytest
import torch

from _torch_isolation import fresh_telemetry
from chainermn_tpu.parallel import reshard_tp_qkv as jax_reshard
from chainermn_torch.deploy import (
    elastic_restore,
    restore_train_state,
    snapshot_meta,
    train_state_dict,
)
from chainermn_torch.extensions import ShardedCheckpointer
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel.tensor import reshard_tp_qkv
from chainermn_torch.resilience.cutpoints import DEPLOY_RESHARD
from chainermn_torch.resilience.faults import FaultInjector, InjectedFault
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")

# tests/deploy_tests/test_reshard.py's LM
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=32)
DH = LM["d_model"] // LM["n_heads"]
QKV = ("blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias",
       "blocks.1.attn.qkv.weight", "blocks.1.attn.qkv.bias")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


class _Axis:
    """A stand-in for a mesh communicator: the tensor axis's size."""

    def __init__(self, n):
        self.size = n

    def axis_size(self, name):
        return self.size


def _tp_model(seed):
    return TransformerLM(**LM, tensor_axis="tp", compute_dtype=torch.float32,
                         device="cpu", seed=seed)


def _stepped(seed):
    """A TP model and an Adam that has stepped once on random gradients."""
    model = _tp_model(seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    gen = torch.Generator().manual_seed(seed + 1)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    return model, opt


def _jax_tree(sd, moments):
    """The flax layout of the qkv leaves: ``qkv_tpcol`` kernels ``[in,
    out]``; the moments in trees mirroring the params, as optax's do."""
    def tree(get):
        return {f"block_{i}": {"attn": {"qkv_tpcol": {
            "kernel": get(f"blocks.{i}.attn.qkv.weight").T,
            "bias": get(f"blocks.{i}.attn.qkv.bias")}}}
            for i in range(LM["n_layers"])}

    return {"params": tree(lambda k: sd[k].numpy()),
            "mu": tree(lambda k: moments[k]["exp_avg"].numpy()),
            "nu": tree(lambda k: moments[k]["exp_avg_sq"].numpy())}


@pytest.mark.parametrize("old,new", [(2, 4), (4, 2)])
def test_permuted_train_state_equals_jax(tmp_path, old, new):
    model, opt = _stepped(0)
    saved = train_state_dict(model, opt)
    want_sd = {k: v.clone() for k, v in saved["params"].items()}
    want_opt = {k: {kk: vv.clone() for kk, vv in v.items()}
                for k, v in saved["opt"]["state"].items()}
    cp = ShardedCheckpointer(str(tmp_path / "ck"))
    meta = snapshot_meta(comm=_Axis(old), model=model)
    assert (meta["tp_degree"], meta["n_heads"], meta["d_head"]) == (
        old, LM["n_heads"], DH)
    cp.save(5, saved, meta=meta)

    fresh = _tp_model(9)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    state, step = restore_train_state(cp, model=fresh, optimizer=fresh_opt,
                                      comm=_Axis(new))
    assert step == 5
    want = jax_reshard(_jax_tree(want_sd, want_opt), LM["n_heads"], DH,
                       old, new)
    got_sd = fresh.state_dict()
    got_opt = fresh_opt.state_dict()["state"]
    names = [n for n, _ in fresh.named_parameters()]
    got_mom = {names[i]: s for i, s in got_opt.items()}
    for i in range(LM["n_layers"]):
        w = want["params"][f"block_{i}"]["attn"]["qkv_tpcol"]
        mu = want["mu"][f"block_{i}"]["attn"]["qkv_tpcol"]
        nu = want["nu"][f"block_{i}"]["attn"]["qkv_tpcol"]
        for key, leaf, tr in (("weight", "kernel", True),
                              ("bias", "bias", False)):
            name = f"blocks.{i}.attn.qkv.{key}"

            def flax(x):
                x = np.asarray(x)
                return x.T if tr else x

            np.testing.assert_array_equal(got_sd[name].numpy(),
                                          flax(w[leaf]))
            np.testing.assert_array_equal(got_mom[name]["exp_avg"].numpy(),
                                          flax(mu[leaf]))
            np.testing.assert_array_equal(
                got_mom[name]["exp_avg_sq"].numpy(), flax(nu[leaf]))
    for name, t in want_sd.items():
        if name not in QKV:
            assert torch.equal(got_sd[name], t), name
            for kk, v in want_opt[name].items():
                assert torch.equal(got_mom[name][kk], v), (name, kk)
    # the step counts are not permuted
    assert all(float(s["step"]) == 1.0 for s in got_mom.values())


def test_same_degree_is_the_plain_restore_and_guards_raise(tmp_path):
    model, opt = _stepped(1)
    saved = train_state_dict(model, opt)
    cp = ShardedCheckpointer(str(tmp_path / "ck"))
    cp.save(1, saved, meta={"tp_degree": 2})       # no head geometry
    other = _tp_model(3)
    tmpl = train_state_dict(other, torch.optim.Adam(other.parameters()))
    got, step = elastic_restore(cp, {"params": tmpl["params"]},
                                tp_degree=2)
    assert step == 1
    for k, v in saved["params"].items():
        assert torch.equal(got["params"][k], v)
    with pytest.raises(ValueError, match="head geometry"):
        elastic_restore(cp, {"params": tmpl["params"]}, tp_degree=4)
    assert elastic_restore(ShardedCheckpointer(str(tmp_path / "e")),
                           {"params": tmpl["params"]},
                           tp_degree=4) == (None, None)
    dense = TransformerLM(**LM, compute_dtype=torch.float32, device="cpu",
                          seed=0)
    cp2 = ShardedCheckpointer(str(tmp_path / "d"))
    cp2.save(1, {"params": dense.state_dict()},
             meta=snapshot_meta(model=dense))
    with pytest.raises(ValueError, match="no tensor-parallel qkv"):
        elastic_restore(cp2, {"params": dense.state_dict()}, tp_degree=2)
    with FaultInjector() as inj:
        inj.arm(DEPLOY_RESHARD, times=1)
        with pytest.raises(InjectedFault):
            elastic_restore(cp, {"params": tmpl["params"]}, tp_degree=2)


_RANKS = """
import torch
from chainermn_torch import MeshCommunicator, create_communicator
from chainermn_torch.deploy import (restore_train_state, snapshot_meta,
                                    train_state_dict)
from chainermn_torch.extensions import ShardedCheckpointer
from chainermn_torch.models import TransformerLM
from chainermn_torch.models.transformer import gather_vocab
from chainermn_torch.optimizers import create_zero_optimizer
from chainermn_torch.parallel.mesh import make_3d_mesh
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
lm, root = ARGS[0], ARGS[1]
cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=32)
base = create_communicator("naive", device="cpu")
gen = torch.Generator().manual_seed(0)
tokens = torch.randint(0, 64, (8, 12), generator=gen)
out = {}

def mesh(shape):
    return MeshCommunicator(make_3d_mesh(shape=shape), device="cpu")

def build(seed):
    m = TransformerLM(**cfg, tensor_axis="tp", vocab_parallel_head=True,
                      compute_dtype=torch.float32, device="cpu", seed=seed)
    return m, torch.optim.Adam(m.parameters(), lr=1e-2, eps=1e-5)

def mine(c):
    ndp, di = c.axis_size("dp"), c.axis_index("dp")
    b = tokens.shape[0] // ndp
    return tokens[di * b:(di + 1) * b]

def logits(m, c):
    with torch.no_grad():
        return gather_vocab(m(tokens), c.axis("tp"))

# 2 x 2: train 5, snapshot, continue 5
c = mesh((2, 1, 2))
model, opt = build(1)
step = lm_train_step(model, opt, c)
before = [float(step(mine(c), mine(c))[0]) for _ in range(5)]
cp = ShardedCheckpointer(root + "/a")
cp.save(5, train_state_dict(model, opt),
        meta=snapshot_meta(comm=c, model=model))
out["snapshot"] = {k: v.clone() for k, v in model.state_dict().items()}
out["manifest"] = cp.manifest()
out["losses_a"] = before + [float(step(mine(c), mine(c))[0])
                            for _ in range(5)]
c.finalize()

# restore at tp = 4: forward, 5 steps, snapshot again
c = mesh((1, 1, 4))
model, opt = build(7)
_, got = restore_train_state(cp, model=model, optimizer=opt, comm=c)
out["restored_step"] = got
out["logits_tp4"] = logits(model, c)
step = lm_train_step(model, opt, c)
out["losses_b"] = before + [float(step(tokens, tokens)[0])
                            for _ in range(5)]
cp4 = ShardedCheckpointer(root + "/b")
cp4.save(10, train_state_dict(model, opt),
         meta=snapshot_meta(comm=c, model=model))
out["snapshot_tp4"] = {k: v.clone() for k, v in model.state_dict().items()}
c.finalize()

# and back to 2 x 2
c = mesh((2, 1, 2))
model, opt = build(8)
restore_train_state(cp4, model=model, optimizer=opt, comm=c)
out["logits_back"] = logits(model, c)
c.finalize()

# ZeRO: its own world size only
m = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu", seed=2)
zopt = create_zero_optimizer(torch.optim.Adam(m.parameters(), lr=1e-2), base)
m(tokens).sum().backward()
zopt.step()
cpz = ShardedCheckpointer(root + "/z")
cpz.save(1, train_state_dict(m, zopt), meta=snapshot_meta(comm=base))
m2 = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu", seed=3)
z2 = create_zero_optimizer(torch.optim.Adam(m2.parameters(), lr=1e-2), base)
restore_train_state(cpz, model=m2, optimizer=z2)
inner = lambda z: z.actual_optimizer.state_dict()["state"][0]
out["zero_same"] = all(torch.equal(inner(zopt)[k], inner(z2)[k])
                       for k in ("exp_avg", "exp_avg_sq"))
out["zero_params"] = all(torch.equal(a, b) for a, b in
                         zip(m.parameters(), m2.parameters()))
# a ZeRO snapshot whose manifest records another world size
cpz2 = ShardedCheckpointer(root + "/z2")
cpz2.save(1, train_state_dict(m, zopt),
          meta=dict(snapshot_meta(comm=base), world_size=2))
try:
    restore_train_state(cpz2, model=m2, optimizer=z2)
    out["zero_resize"] = None
except ValueError as e:
    out["zero_resize"] = str(e)
save(out)
base.finalize()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("reshard")
    return run_ranks(_RANKS, 4, args=["lm", str(root)], timeout=300)


def _dense(sd, n_tp):
    sd = reshard_tp_qkv(sd, LM["n_heads"], DH, n_tp, 1)
    dense = TransformerLM(**LM, compute_dtype=torch.float32, device="cpu")
    dense.load_state_dict({k.replace("attn.", "").replace("mlp.", ""): v
                           for k, v in sd.items()})
    return dense


def _tokens():
    return torch.randint(0, 64, (8, 12),
                         generator=torch.Generator().manual_seed(0))


def test_manifest_records_the_save_time_layout(ranks):
    m = ranks[0]["manifest"]
    assert (m["tp_degree"], m["world_size"], m["mesh_shape"],
            m["n_heads"], m["d_head"], m["step"]) == (2, 4, (2, 1, 2), 4,
                                                      DH, 5)
    assert all(r["restored_step"] == 5 for r in ranks)


@pytest.mark.parametrize("which,snapshot,n_tp", [
    ("logits_tp4", "snapshot", 2), ("logits_back", "snapshot_tp4", 4)])
def test_forward_at_the_new_degree_matches_dense(ranks, which, snapshot,
                                                 n_tp):
    """``test_reshard.py:168-215``: the restored tree computes at the new
    degree what the snapshot computes densely."""
    with torch.no_grad():
        want = _dense(ranks[0][snapshot], n_tp)(_tokens())
    for r in ranks:
        torch.testing.assert_close(r[which], want, atol=1e-5, rtol=1e-5)


def test_ten_step_loss_parity_across_the_reshard(ranks):
    """``test_reshard.py:216``: the tp = 4 restore's losses follow the
    tp = 2 continuation's."""
    for r in ranks:
        np.testing.assert_allclose(r["losses_b"], r["losses_a"], rtol=1e-4,
                                   atol=1e-5)
    assert ranks[0]["losses_a"][-1] < ranks[0]["losses_a"][0]


def test_zero_state_restores_only_at_its_world_size(ranks):
    for r in ranks:
        assert r["zero_same"] and r["zero_params"]
        assert "NOT elastically reshardable" in r["zero_resize"]
