"""The port's LM training path — communicator, multi-node optimizer,
``TransformerLM(attention='flash')`` and ``lm_train_step`` — against the
JAX package, on the CPU (gloo ranks; the flash kernels' plain versions).

Tolerances: the optimizer comparison is atol 1e-6 (the same AdamW
formulas in another order of operations); LM logits f32 atol 1e-4 (sums
in another order through two layers); the two-step training comparison
atol 1e-5 on losses and parameters.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.training import jit_lm_train_step
from chainermn_torch import create_communicator, create_multi_node_optimizer
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel.sequence import sequence_parallel_attention
from chainermn_torch.training import lm_train_step

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def comm():
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def test_one_rank_collectives_are_identities(comm):
    assert (comm.rank, comm.size) == (0, 1)
    assert (comm.intra_rank, comm.intra_size) == (0, 1)
    assert (comm.inter_rank, comm.inter_size) == (0, 1)
    x = torch.arange(6, dtype=torch.float32).view(2, 3)
    for op in ("sum", "mean", "max", "min", "prod"):
        y = comm.allreduce(x, op)
        assert y is not x
        torch.testing.assert_close(y, x, atol=0, rtol=0)
    grads = [torch.randn(3, 4), None, torch.randn(5),
             torch.randn(2).to(torch.bfloat16)]
    means = comm.multi_node_mean_grad(grads)
    assert means[1] is None
    for g, m in zip(grads, means):
        if g is not None:
            assert m.dtype == g.dtype and m.shape == g.shape
            torch.testing.assert_close(m, g, atol=0, rtol=0)
    alias = comm.allreduce_grad(grads[2:])
    torch.testing.assert_close(alias[0], grads[2], atol=0, rtol=0)


STRATEGY_CLASSES = {
    "pure_nccl": "PureNcclCommunicator", "tpu": "PureNcclCommunicator",
    "pure_ici": "PureNcclCommunicator", "naive": "NaiveCommunicator",
    "flat": "FlatCommunicator", "hierarchical": "HierarchicalCommunicator",
    "non_cuda_aware": "HierarchicalCommunicator",
    "two_dimensional": "TwoDimensionalCommunicator",
    "single_node": "SingleNodeCommunicator"}


@pytest.mark.parametrize("name", list(STRATEGY_CLASSES))
def test_strategy_names(comm, name):
    """Every strategy name of the reference's factory builds its class
    (here over the one-rank group ``comm`` started); only the flat NCCL
    strategy takes ``allreduce_grad_dtype``; an unknown name raises."""
    flat = STRATEGY_CLASSES[name] == "PureNcclCommunicator"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # non_cuda_aware warns
        built = create_communicator(name, device="cpu")
        assert type(built).__name__ == STRATEGY_CLASSES[name]
        assert (built.rank, built.size) == (0, 1)
        built.finalize()
        if flat:
            wired = create_communicator(name, device="cpu",
                                        allreduce_grad_dtype=torch.bfloat16)
            assert wired.allreduce_grad_dtype is torch.bfloat16
            wired.finalize()
        else:
            with pytest.raises(ValueError, match="allreduce_grad_dtype"):
                create_communicator(name, device="cpu",
                                    allreduce_grad_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("mpi", device="cpu")


_WORKER = textwrap.dedent("""
    import json, sys, torch
    sys.path.insert(0, sys.argv[1])
    from chainermn_torch import create_communicator
    comm = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype=sys.argv[2] or None)
    r = comm.rank + 1.0
    grads = [torch.full((3,), r), None, torch.arange(4.0).view(2, 2) * r,
             torch.full((2,), r, dtype=torch.bfloat16)]
    means = comm.multi_node_mean_grad(grads)
    model = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(model.weight, r)
    comm.bcast_data(model)
    print(json.dumps({
        "rank": comm.rank, "size": comm.size,
        "means": [None if m is None else m.float().tolist() for m in means],
        "mean": comm.allreduce(torch.tensor([r]), "mean").item(),
        "max": comm.allreduce(torch.tensor([r]), "max").item(),
        "weight": model.weight.tolist()}))
    comm.finalize()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("wire", ["", "bfloat16"])
def test_two_gloo_ranks_average_gradients(wire):
    """Two processes started from RANK/WORLD_SIZE/MASTER_ADDR: the mean
    of [1, 2]-scaled gradients is 1.5x, with and without a bf16 wire
    (every value here is exact in bf16)."""
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(ROOT), wire],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for r, res in enumerate(outs):
        assert (res["rank"], res["size"]) == (r, 2)
        assert res["means"][0] == [1.5] * 3
        assert res["means"][1] is None
        assert res["means"][2] == [[0.0, 1.5], [3.0, 4.5]]
        assert res["means"][3] == [1.5, 1.5]
        assert (res["mean"], res["max"]) == (1.5, 2.0)
        assert res["weight"] == [[1.0, 1.0], [1.0, 1.0]]


def test_adamw_matches_optax_adamw():
    """``AdamW(lr, weight_decay=1e-4)`` is ``optax.adamw(lr)``: three
    steps on the same gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(3)]
    lr = 3e-2
    opt = optax.adamw(lr, weight_decay=1e-4)
    params = jnp.asarray(p0)
    state = opt.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.AdamW([p], lr=lr, weight_decay=1e-4)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   atol=1e-6, rtol=0)


def test_multi_node_optimizer_wraps_the_inner_step(comm):
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    inner = torch.optim.SGD([p, q], lr=0.5)
    opt = create_multi_node_optimizer(inner, comm)
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert q.grad is None and (q == 1).all()
    opt.zero_grad()
    assert p.grad is None and opt.param_groups is inner.param_groups
    # zero_fill is accepted and ignored, as in the reference
    create_multi_node_optimizer(inner, comm, zero_fill=True).step()
    assert q.grad is None and (q == 1).all()
    # double buffering builds; its first step applies a zero gradient
    buffered = create_multi_node_optimizer(inner, comm, double_buffering=True)
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    buffered.step()
    torch.testing.assert_close(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert buffered.param_groups is inner.param_groups


def test_attention_kinds():
    assert sequence_parallel_attention("full", None, causal=True)
    assert sequence_parallel_attention("flash", None, causal=True)
    with pytest.raises(ValueError, match="local"):
        sequence_parallel_attention("flash", "seq")
    for kind in ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
                 "ulysses_flash"):
        assert callable(sequence_parallel_attention(kind, "seq"))
        assert callable(sequence_parallel_attention(kind, None))
    with pytest.raises(ValueError, match="unknown attention"):
        TransformerLM(vocab_size=11, d_model=8, n_heads=2, n_layers=1,
                      attention="sparse", device="cpu")


LM_CFG = dict(vocab_size=64, d_model=32, n_heads=8, n_layers=2, max_len=256)


def test_flash_lm_logits_match_flax_flash():
    """``TransformerLM(attention='flash')`` against the flax LM with
    ``attention='flash'`` (Pallas interpret mode) on converted weights,
    at ``tests/models_tests/test_transformer.py``'s size."""
    tokens = np.random.default_rng(0).integers(0, 64, (2, 64))
    jlm = JaxLM(**LM_CFG, attention="flash", compute_dtype=jnp.float32)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(1),
                                     jnp.asarray(tokens)))
    want = np.asarray(jax.jit(jlm.apply)(params, jnp.asarray(tokens)))
    tlm = TransformerLM(**LM_CFG, attention="flash",
                        compute_dtype=torch.float32, device="cpu")
    tlm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tlm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_lm_train_step_matches_jit_lm_train_step(comm):
    """Two steps of the port's flash LM step against
    ``jit_lm_train_step`` on a one-device JAX communicator, from the same
    converted init with ``optax.adamw`` / ``AdamW(weight_decay=1e-4)``.
    The JAX side trains ``attention='full'``: its own flash train test is
    kept out of tier-1 for time, and the JAX package pins its flash LM to
    its full LM (``test_flash_attention_lm_matches_full``).

    Both sides use Adam's ``eps = 1e-5`` instead of 1e-8: the key bias's
    gradient is zero in exact arithmetic (a softmax ignores a shift shared
    by a row's scores), so each framework computes it as rounding noise
    near 1e-8, and an eps of 1e-8 would turn that noise into updates of
    up to ``lr`` of either sign."""
    cfg = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
               max_len=64)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 64, (4, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    lr, eps = 1e-3, 1e-5

    jlm = JaxLM(**cfg, attention="full", compute_dtype=jnp.float32)
    jcomm = chainermn_tpu.create_communicator("tpu",
                                              devices=jax.devices()[:1])
    params = jcomm.bcast_data(jlm.init(jax.random.PRNGKey(3),
                                       jnp.asarray(tokens[:1])))
    start = jax.device_get(params)
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.adamw(lr, eps=eps), jcomm)
    opt_state = jax.device_put(jopt.init(params), jcomm.named_sharding())
    jstep = jit_lm_train_step(jlm, jopt, jcomm, monitored=False)

    tlm = TransformerLM(**cfg, attention="flash",
                        compute_dtype=torch.float32, device="cpu")
    tlm.load_state_dict(params_from_flax(start))
    topt = create_multi_node_optimizer(
        torch.optim.AdamW(tlm.parameters(), lr=lr, eps=eps,
                          weight_decay=1e-4), comm)
    tstep = lm_train_step(tlm, topt, comm)

    for _ in range(2):
        params, opt_state, jloss, _ = jstep(params, opt_state,
                                            jnp.asarray(tokens),
                                            jnp.asarray(targets))
        tloss, stats = tstep(tokens, targets)
        assert stats == {} and tloss.dim() == 0
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=0)
    want = params_from_flax(jax.device_get(params))
    got = tlm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_lm_train_step_rejects_what_it_does_not_run(comm):
    tlm = TransformerLM(**LM_CFG, attention="flash", device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(tlm.parameters(), lr=1e-3), comm)
    with pytest.raises(ValueError, match="local"):
        lm_train_step(tlm, opt, comm, shard_sequence=True)
    with pytest.raises(NotImplementedError, match="fused_ce"):
        lm_train_step(tlm, opt, comm, fused_ce=True)
