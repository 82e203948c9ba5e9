"""Sequence parallelism of the port (``chainermn_torch/parallel/sequence.py``
and ``lm_train_step(shard_sequence=True)``) against the JAX package.

The port runs as four gloo CPU ranks, started once for the module; the JAX
functions run inside ``shard_map`` over a mesh of four of the eight
virtual CPU devices, the Pallas kernels in interpret mode, as
``tests/parallel_tests/test_sequence.py`` runs them. Both sides take the
same seeded numpy inputs (and, for the LM, the same converted weights).
On the CPU the port's ``_flash`` kinds run the flash kernels' plain
versions, wired by the same autograd functions as on the card.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.ops.flash_attention import (
    flash_block_grads as jax_block_grads,
    flash_fwd_with_lse as jax_fwd_with_lse,
)
from chainermn_tpu.parallel import sequence as jsq
from chainermn_tpu.training import jit_lm_train_step
from chainermn_torch.interop import params_from_flax
tfa = importlib.import_module("chainermn_torch.ops.flash_attention")
from chainermn_torch.parallel import sequence as tsq
from chainermn_torch.testing import run_ranks

N = 4
SHAPE = (2, 32, 8, 16)          # B, T, H, D: test_sequence.py's _qkv
KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
         "ulysses_flash")
CASES = ([(kind, causal, "f32") for kind in KINDS for causal in (True, False)]
         + [(kind, True, "bf16") for kind in KINDS if kind.endswith("flash")])
TOL = {"f32": 1e-5, "bf16": 2e-2}
JAX_IMPL = {"ring": jsq.ring_attention,
            "ring_flash": jsq.ring_flash_attention,
            "zigzag": jsq.zigzag_ring_attention,
            "zigzag_flash": jsq.zigzag_flash_attention,
            "ulysses": jsq.ulysses_attention,
            "ulysses_flash": jsq.ulysses_flash_attention}
# the __graft_entry__.py LM (d_model 16, 8 heads, one layer, vocab 32),
# 3 Adam steps with eps 1e-5 (see test_torch_training.py's LM parity)
LM = dict(vocab_size=32, d_model=16, n_heads=8, n_layers=1, max_len=64)
LM_KINDS = ("ring", "zigzag", "ulysses")
LM_STEPS, LR, EPS = 3, 1e-3, 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(4)]


def _layout(kind, causal, t, n):
    """The global index order the shards hold: zigzag's chunk pairs for
    the causal zigzag kinds, the identity otherwise."""
    if kind.startswith("zigzag") and causal:
        return np.asarray(jsq.zigzag_permutation(t, n))
    return np.arange(t)


def _lm_data():
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, LM["vocab_size"], (2, 8 * N)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def lm_init():
    tokens, _ = _lm_data()
    jlm = JaxLM(**LM, compute_dtype=jnp.float32)
    return jax.device_get(jlm.init(jax.random.PRNGKey(13),
                                   jnp.asarray(tokens[:, :8])))


_RANKS = """
import numpy as np
import torch
from chainermn_torch import create_communicator, create_multi_node_optimizer
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel import sequence as sq
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
cases, shape, lm, lm_kinds, steps, lr, eps, params = torch.load(
    ARGS[0], weights_only=False)
comm = create_communicator("naive", device="cpu")
n, r = comm.size, comm.rank
rng = np.random.default_rng(0)
q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for _ in range(4))
t_local = shape[1] // n
out = {}
for kind, causal, dname in cases:
    dt = torch.float32 if dname == "f32" else torch.bfloat16
    if kind.startswith("zigzag") and causal:
        layout = sq.zigzag_permutation(shape[1], n)
    else:
        layout = torch.arange(shape[1])
    mine = layout[r * t_local:(r + 1) * t_local]
    qs, ks, vs = (x[:, mine].to(dt).requires_grad_() for x in (q, k, v))
    o = sq.sequence_parallel_attention(kind, comm, causal=causal)(qs, ks, vs)
    o.backward(do[:, mine].to(dt))
    out[(kind, causal, dname)] = [t.detach().float() for t in
                                  (o, qs.grad, ks.grad, vs.grad)]
rng = np.random.default_rng(13)
tokens = rng.integers(0, lm["vocab_size"], (2, 8 * n))
targets = np.roll(tokens, -1, axis=1)
losses = {}
for kind in lm_kinds:
    model = TransformerLM(**lm, attention=kind, sequence_axis=comm,
                          compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params)
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=lr, eps=eps), comm)
    step = lm_train_step(model, opt, comm, shard_sequence=True)
    layout = (sq.zigzag_permutation(8 * n, n).numpy()
              if kind == "zigzag" else np.arange(8 * n))
    mine = layout[r * 8:(r + 1) * 8]
    losses[kind] = [float(step(tokens[:, mine], targets[:, mine])[0])
                    for _ in range(steps)]
save({"attention": out, "lm_losses": losses})
comm.finalize()
"""


@pytest.fixture(scope="module")
def port(lm_init, tmp_path_factory):
    """Every case on four gloo ranks, one start for the module: per rank,
    its shard of each kind's output and q/k/v gradients, and the three
    losses of each sequence-parallel LM step."""
    path = tmp_path_factory.mktemp("sp") / "cases.pt"
    torch.save((CASES, SHAPE, LM, LM_KINDS, LM_STEPS, LR, EPS,
                params_from_flax(lm_init)), path)
    return run_ranks(_RANKS, N, args=[str(path)], timeout=240)


def _jax_attention(kind, causal, dname):
    """The JAX kind inside shard_map over four devices: the output and the
    q/k/v cotangents of the same ``do``, in the shards' layout."""
    jcomm = chainermn_tpu.create_communicator("tpu",
                                              devices=jax.devices()[:N])
    axis = jcomm.axis_name
    impl = JAX_IMPL[kind]
    spec = P(None, axis)
    f = jax.jit(jcomm.shard_map(
        lambda q, k, v: impl(q, k, v, axis, causal=causal),
        in_specs=(spec,) * 3, out_specs=spec,
        check_vma="flash" not in kind))      # interpret-mode Pallas
    dt = jnp.float32 if dname == "f32" else jnp.bfloat16
    layout = _layout(kind, causal, SHAPE[1], N)
    q, k, v, do = (jnp.asarray(x[:, layout], dt) for x in _inputs())
    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(do))]


@pytest.mark.parametrize("kind,causal,dname", CASES,
                         ids=[f"{k}-{'causal' if c else 'full'}-{d}"
                              for k, c, d in CASES])
def test_kind_matches_jax(port, kind, causal, dname):
    """Each kind's output and q/k/v gradients, gathered over the ranks,
    against the JAX kind: f32 to 1e-5, bf16 (both sides' outputs rounded
    to bf16) to 2e-2."""
    want = _jax_attention(kind, causal, dname)
    tol = TOL[dname]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = torch.cat([r["attention"][(kind, causal, dname)][i]
                         for r in port], dim=1).numpy()
        np.testing.assert_allclose(got, want[i], atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("kind", LM_KINDS)
def test_lm_train_step_shard_sequence_matches_jax(port, lm_init, kind):
    """``lm_train_step(shard_sequence=True)`` over four ranks: three Adam
    steps of the ``__graft_entry__.py`` LM against ``jit_lm_train_step``
    with the same attention kind, weights and batch, losses to 1e-4."""
    tokens, targets = _lm_data()
    jcomm = chainermn_tpu.create_communicator("tpu",
                                              devices=jax.devices()[:N])
    jlm = JaxLM(**LM, attention=kind, sequence_axis=jcomm.axis_name,
                compute_dtype=jnp.float32)
    params = jcomm.bcast_data(jax.tree_util.tree_map(jnp.asarray, lm_init))
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.adam(LR, eps=EPS), jcomm)
    state = jax.device_put(jopt.init(params), jcomm.named_sharding())
    jstep = jit_lm_train_step(jlm, jopt, jcomm, shard_sequence=True,
                              monitored=False)
    layout = _layout(kind, True, tokens.shape[1], N)
    want = []
    for _ in range(LM_STEPS):
        params, state, loss, _ = jstep(params, state,
                                       jnp.asarray(tokens[:, layout]),
                                       jnp.asarray(targets[:, layout]))
        want.append(float(loss))
    for r in port:
        np.testing.assert_allclose(r["lm_losses"][kind], want, atol=1e-4,
                                   rtol=0)


def test_zigzag_layout_matches_jax():
    for t, n in ((16, 4), (32, 2), (48, 3)):
        np.testing.assert_array_equal(
            tsq.zigzag_permutation(t, n).numpy(),
            np.asarray(jsq.zigzag_permutation(t, n)))
        for r in range(n):
            np.testing.assert_array_equal(
                tsq.zigzag_positions(r, n, t // n).numpy(),
                np.asarray(jsq.zigzag_positions(r, n, t // n)))
    with pytest.raises(ValueError, match="chunks"):
        tsq.zigzag_permutation(10, 4)


def test_ulysses_rejects_indivisible_heads():
    """Raised before any transfer, as the reference raises at trace time."""
    axis = types.SimpleNamespace(size=4, rank=0)
    q = torch.zeros(2, 8, 6, 4)
    with pytest.raises(ValueError, match="divisible"):
        tsq.ulysses_attention(q, q, q, axis)


def test_unbound_axis_name_is_full_attention(monkeypatch):
    """As in the reference outside ``shard_map``: a kind over an axis name
    that no live mesh binds (or over no axis) attends over the whole
    (local) sequence — the plain kinds through ``full_attention``, the
    ``_flash`` kinds through ``flash_attention``, which launches the
    kernels on a CUDA tensor and takes its plain version only here."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    want = tsq.full_attention(q, k, v, causal=True)
    for kind in ("ring", "zigzag", "ulysses"):
        for axis in ("no_such_axis", None):
            f = tsq.sequence_parallel_attention(kind, axis, causal=True)
            torch.testing.assert_close(f(q, k, v), want, atol=0, rtol=0)
    calls = []

    def flash(q, k, v, **kw):
        calls.append(kw)
        return tfa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(tsq, "flash_attention", flash)
    for kind in ("ring_flash", "zigzag_flash", "ulysses_flash"):
        for axis in ("no_such_axis", None):
            f = tsq.sequence_parallel_attention(kind, axis, causal=True)
            torch.testing.assert_close(f(q, k, v), want, atol=1e-5,
                                       rtol=1e-5)
    assert calls == [{"causal": True, "scale": None}] * 6
    with pytest.raises(ValueError, match="live mesh binds"):
        tsq.ring_attention(q, k, v, "no_such_axis")


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_fully_masked_block_matches_jax(dname):
    """A K/V block wholly after every query (``k_offset >= q_offset +
    Tq``, every ring step from a later rank under ``causal``): the plain
    versions give out 0, lse -1e30 and exactly zero gradients, as the JAX
    kernels do in interpret mode."""
    dt = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}[dname]
    q, k, v, do = _inputs()
    kw = dict(causal=True, q_offset=0, k_offset=SHAPE[1])
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dt[0]) for x in (q, k, v, do))
    out, lse = tfa.flash_fwd_with_lse(tq, tk, tv, out_dtype=torch.float32,
                                      **kw)
    assert (out == 0).all() and (lse == -1e30).all()
    delta = torch.randn(lse.shape, generator=torch.Generator().manual_seed(1))
    live_lse = torch.zeros_like(lse)       # a row that saw keys elsewhere
    dq, dk, dv = tfa.flash_block_grads(tq, tk, tv, tdo, live_lse, delta, **kw)
    assert not dq.any() and not dk.any() and not dv.any()
    jq, jk, jv = (jnp.asarray(x, dt[1]) for x in (q, k, v))
    jout, jlse = jax_fwd_with_lse(jq, jk, jv, out_dtype=jnp.float32,
                                        **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jlse))
    jg = jax_block_grads(jq, jk, jv, jnp.asarray(do, dt[1]),
                               jnp.asarray(live_lse.numpy()),
                               jnp.asarray(delta.numpy()), **kw)
    for a, b in zip((dq, dk, dv), jg):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
