"""The port's data-parallel classification step against the JAX package:
``train_step`` with ``create_multi_node_optimizer`` (every strategy name,
a bf16 wire, double buffering) and ``create_zero_optimizer`` (with and
without ``clip_by_global_norm_sharded``) on 4 gloo ranks with
``LOCAL_WORLD_SIZE=2``, against ``jit_train_step`` on a 4-device CPU
mesh (2x2 for the two-level strategies), from one converted flax init
and the same per-rank batches; the ln 10 known answer of
``__graft_entry__.py:147-177`` (FSDP and HSDP included);
``scatter_dataset``; and the
classification loss with and without label smoothing.

The 4 ranks start once per module and run every case; the tests
parametrize over the results.

Tolerances: losses and every parameter and running statistic after
each of two SGD-momentum steps agree to atol 2e-5 in float32 (the
cross-rank sums and the BatchNorm reductions add in another order); 2e-3
with a bf16 wire, where each framework rounds its own sums to bf16; the
ranks hold bitwise-equal replicas; the known answer is ln 10 within 1e-3
and every strategy within 1e-5 of the others; the loss and its gradients
on one process to atol 1e-6.
"""

import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.datasets import scatter_dataset as jax_scatter_dataset
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import ResNet as JaxResNet
from chainermn_tpu.optimizers import wait_double_buffering as jax_pending
from chainermn_tpu.training import (
    classification_loss_fn as jax_classification_loss_fn,
)
from chainermn_tpu.training import jit_train_step
from chainermn_torch.interop import (
    mlp_params_from_flax,
    resnet_params_from_flax,
)
from chainermn_torch.models import MLP
from chainermn_torch.testing import run_ranks
from chainermn_torch.training import classification_loss_fn

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

N_RANKS, PER_RANK, LR, CLIP = 4, 2, 0.1, 0.05
CFG = dict(stage_sizes=[1], width=4, num_classes=10)
# name -> (strategy, kind, wire); the JAX side takes the same names
CASES = {
    "naive": ("naive", "plain", None),
    "flat": ("flat", "plain", None),
    "pure_nccl": ("pure_nccl", "plain", None),
    "tpu": ("tpu", "plain", None),
    "pure_ici": ("pure_ici", "plain", None),
    "hierarchical": ("hierarchical", "plain", None),
    "non_cuda_aware": ("non_cuda_aware", "plain", None),
    "two_dimensional": ("two_dimensional", "plain", None),
    "pure_nccl_bf16_wire": ("pure_nccl", "plain", "bfloat16"),
    "double_buffering": ("hierarchical", "double_buffering", None),
    "zero1": ("pure_nccl", "zero", None),
    "zero1_clip": ("pure_nccl", "zero_clip", None),
}
# the known answer on every case: a superset of __graft_entry__'s
# data-parallel paths (hierarchical with double buffering, a bf16 wire,
# two_dimensional, ZeRO-1, FSDP and HSDP over the intra groups)
KNOWN = dict(CASES, fsdp=("pure_nccl", "fsdp", None),
             hsdp=("hierarchical", "hsdp", None))

_WORKER = """
import math
import numpy as np
import torch
from chainermn_torch import (
    clip_by_global_norm_sharded, create_communicator,
    create_multi_node_optimizer, create_zero_optimizer, scatter_dataset,
    scatter_index)
from chainermn_torch.optimizers import wait_double_buffering
from chainermn_torch.interop import images_from_nhwc
from chainermn_torch.models import ResNet
from chainermn_torch.parallel.fsdp import fsdp_shard, fsdp_train_step
from chainermn_torch.training import train_step

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
world = create_communicator("naive", device="cpu")


def build(case, model):
    strategy, kind, wire = case
    comm = create_communicator(strategy, device="cpu",
                               allreduce_grad_dtype=wire)
    sgd = torch.optim.SGD(model.parameters(), lr=spec["lr"], momentum=0.9)
    if kind.startswith("zero"):
        clip = (clip_by_global_norm_sharded(spec["clip"], comm)
                if kind == "zero_clip" else None)
        return comm, create_zero_optimizer(sgd, comm, grad_transform=clip)
    return comm, create_multi_node_optimizer(
        sgd, comm, double_buffering=kind == "double_buffering")


n = spec["per_rank"]
images = images_from_nhwc(spec["images"][RANK * n:(RANK + 1) * n])
labels = torch.from_numpy(spec["labels"][RANK * n:(RANK + 1) * n])
out = {"cases": {}, "known": {}}
for name, case in spec["cases"].items():
    model = ResNet(**spec["cfg"], compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(spec["state"])
    comm, opt = build(case, model)
    step = train_step(model, opt, comm)
    rec = {"losses": [], "states": []}
    for _ in range(2):
        loss = step(images, labels)
        rec["losses"].append(float(loss))
        rec["states"].append({k: v.clone() for k, v
                              in model.state_dict().items()})
    if case[1] == "double_buffering":
        names = [k for k, _ in model.named_parameters()]
        rec["pending"] = dict(zip(names, wait_double_buffering(opt)))
    out["cases"][name] = rec
    comm.finalize()

zeros = torch.zeros(n, 3, 32, 32).to(memory_format=torch.channels_last)
for name, case in spec["known"].items():
    model = ResNet(stage_sizes=[1, 1, 1, 1], width=8, num_classes=10,
                   compute_dtype=torch.float32, device="cpu", seed=0)
    if case[1] in ("fsdp", "hsdp"):
        comm = create_communicator(case[0], device="cpu")
        axis = "intra" if case[1] == "hsdp" else None
        model = fsdp_shard(model, comm, axis=axis)
        sgd = torch.optim.SGD(model.parameters(), lr=spec["lr"],
                              momentum=0.9)
        step = fsdp_train_step(model, sgd, comm, axis=axis)
    else:
        comm, opt = build(case, model)
        step = train_step(model, opt, comm)
    out["known"][name] = float(step(zeros, torch.zeros(n, dtype=torch.long)))
    comm.finalize()

two_level = create_communicator("hierarchical", device="cpu")
sgd = torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=0.1)
try:
    create_zero_optimizer(sgd, two_level)
except ValueError as e:
    out["zero_hierarchical"] = str(e)
two_level.finalize()

sub = world.split(RANK % 2)
try:
    create_zero_optimizer(sgd, sub)
except ValueError as e:
    out["zero_split"] = str(e)
sub.finalize()

shard = scatter_dataset(list(range(10)), world, shuffle=True, seed=3)
moved = scatter_dataset([f"r{i}" for i in range(11)], world,
                        force_transport=True)
out["dataset"] = {"indices": shard.indices.tolist(), "items": list(shard),
                  "moved": list(moved), "index": scatter_index(10, world)}
world.finalize()
save(out)
"""


def _jax_optimizer(kind, comm):
    sgd = optax.sgd(LR, momentum=0.9)
    if kind == "zero":
        return chainermn_tpu.create_zero_optimizer(sgd, comm)
    if kind == "zero_clip":
        return chainermn_tpu.create_zero_optimizer(
            optax.chain(chainermn_tpu.clip_by_global_norm_sharded(CLIP, comm),
                        sgd), comm)
    return chainermn_tpu.create_multi_node_optimizer(
        sgd, comm, double_buffering=kind == "double_buffering")


def _jax_run(model, init, images, labels, case):
    """Two ``jit_train_step`` steps: losses, converted states after each,
    and the pending double-buffered mean."""
    strategy, kind, wire = case
    with warnings.catch_warnings():   # the GPU-era names warn
        warnings.simplefilter("ignore")
        comm = chainermn_tpu.create_communicator(
            strategy, devices=jax.devices()[:N_RANKS],
            allreduce_grad_dtype=wire)
    opt = _jax_optimizer(kind, comm)
    variables = comm.bcast_data(init)
    spec = getattr(opt, "state_spec", ())
    state = jax.device_put(opt.init(variables["params"]),
                           comm.named_sharding(*spec))
    step = jit_train_step(model, opt, comm, donate=False, monitored=False)
    rec = {"losses": [], "states": []}
    for _ in range(2):
        variables, state, loss = step(variables, state, images, labels)
        rec["losses"].append(float(loss))
        rec["states"].append(resnet_params_from_flax(
            jax.device_get(variables)))
    if kind == "double_buffering":
        pending = jax.device_get(jax_pending(state))
        rec["pending"] = resnet_params_from_flax(
            {"params": pending,
             "batch_stats": jax.device_get(variables["batch_stats"])})
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_RANKS * PER_RANK, 16, 16, 3)).astype(
        np.float32)
    labels = rng.integers(0, 10, N_RANKS * PER_RANK).astype(np.int64)
    model = JaxResNet(**CFG, compute_dtype=jnp.float32)
    init = jax.device_get(jax.jit(functools.partial(model.init, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1])))
    want = {name: _jax_run(model, init, jnp.asarray(images),
                           jnp.asarray(labels.astype(np.int32)), case)
            for name, case in CASES.items()}
    spec = tmp_path_factory.mktemp("dp") / "spec.pt"
    start = resnet_params_from_flax(init)
    torch.save({"cfg": CFG, "state": start,
                "images": images, "labels": labels, "per_rank": PER_RANK,
                "lr": LR, "clip": CLIP, "cases": CASES, "known": KNOWN},
               spec)
    got = run_ranks(_WORKER, N_RANKS, local_world_size=2, args=[spec])
    return want, got, start


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jit_train_step(runs, name):
    want, got, _ = runs
    tol = 2e-3 if CASES[name][2] else 2e-5
    w, g = want[name], got[0]["cases"][name]
    np.testing.assert_allclose(g["losses"], w["losses"], atol=tol, rtol=0)
    for step in range(2):
        for key, ref in w["states"][step].items():
            np.testing.assert_allclose(
                g["states"][step][key].numpy(), ref.numpy(), atol=tol,
                rtol=0, err_msg=f"{name} step {step + 1} {key}")
    for r in range(1, N_RANKS):   # replicas, running statistics included
        other = got[r]["cases"][name]["states"][-1]
        for key, v in g["states"][-1].items():
            assert torch.equal(other[key], v), (r, key)


def test_double_buffering_is_one_step_stale(runs):
    """The first step applies a zero gradient (parameters unchanged), the
    second applies the first step's mean, and the pending mean is the
    second step's, as in the reference."""
    want, got, start = runs
    rec = got[0]["cases"]["double_buffering"]
    first = rec["states"][0]
    plain = got[0]["cases"]["hierarchical"]["states"][0]
    params = [k for k in first if "running" not in k]
    for k in params:
        assert torch.equal(first[k], start[k]), k
    assert any(not torch.equal(plain[k], start[k]) for k in params)
    assert set(rec["pending"]) == set(params)
    for k in params:
        ref = want["double_buffering"]["pending"][k]
        np.testing.assert_allclose(rec["pending"][k].numpy(),
                                       ref.numpy(), atol=2e-5, rtol=0,
                                       err_msg=k)


def test_options_change_the_trajectory(runs):
    """The sharded clip engages (the global norm exceeds the limit) and
    the bf16 wire rounds the means; ZeRO-1 without the clip follows the
    unsharded optimizer."""
    cases = runs[1][0]["cases"]
    assert cases["zero1_clip"]["losses"][1] != cases["zero1"]["losses"][1]
    f32, bf16 = (cases[n]["states"][0] for n in ("pure_nccl",
                                                  "pure_nccl_bf16_wire"))
    assert any(not torch.equal(f32[k], bf16[k]) for k in f32)
    np.testing.assert_allclose(cases["zero1"]["losses"],
                               cases["pure_nccl"]["losses"], atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("name", list(KNOWN))
def test_known_answer_ln10(runs, name):
    """Zero images and a zero-initialized head bias give uniform logits:
    the first loss is ln 10 for every strategy, double buffering, ZeRO-1,
    FSDP and HSDP (``__graft_entry__.py:147-177``)."""
    known = runs[1][0]["known"]
    assert abs(known[name] - math.log(10.0)) < 1e-3
    assert max(abs(v - known[name]) for v in known.values()) < 1e-5


def test_zero_rejects_what_the_reference_rejects(runs):
    out = runs[1][0]
    assert "flat single-group" in out["zero_hierarchical"]
    assert "split" in out["zero_split"]


def test_scatter_dataset_matches_the_reference(runs):
    """Shards are disjoint and exhaustive and equal the JAX package's for
    the same seed; ``force_transport`` ships root's records."""
    got = [r["dataset"] for r in runs[1]]
    jcomm = chainermn_tpu.create_communicator("tpu",
                                              devices=jax.devices()[:1])
    seen = []
    for r, d in enumerate(got):
        ref = jax_scatter_dataset(list(range(10)), jcomm, shuffle=True,
                                  seed=3, n_shards=N_RANKS, shard_id=r)
        assert d["indices"] == ref.indices.tolist() == d["items"]
        ref_moved = jax_scatter_dataset(
            [f"r{i}" for i in range(11)], jcomm, n_shards=N_RANKS,
            shard_id=r, force_transport=True)
        assert d["moved"] == list(ref_moved)
        assert tuple(d["index"]) == (r * 2 + min(r, 2),
                                     r * 2 + min(r, 2) + 2 + (r < 2))
        seen += d["indices"]
    assert sorted(seen) == list(range(10))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_loss_matches_the_reference(smoothing):
    """The mean softmax cross entropy, with ``optax.smooth_labels``
    targets when smoothing: value and parameter gradients on an MLP."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 6)
    jm = JaxMLP(n_units=8, n_out=4, compute_dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    loss_fn = jax_classification_loss_fn(
        jm, {}, [], jnp.asarray(x), jnp.asarray(labels.astype(np.int32)), {},
        smoothing)
    (want, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params["params"])
    tm = MLP(n_units=8, n_out=4, compute_dtype=torch.float32, n_in=12,
             device="cpu")
    tm.load_state_dict(mlp_params_from_flax(params))
    got = classification_loss_fn(tm, torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 label_smoothing=smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    want_grads = mlp_params_from_flax(jax.device_get(grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
