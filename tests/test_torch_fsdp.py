"""The port's FSDP (``chainermn_torch.parallel.fsdp``) against the JAX
package's ``chainermn_tpu.parallel.fsdp``, on the CPU.

- The sharding rule: for every parameter of ResNet-50, GoogLeNet and
  VGG16 and shard counts 2, 3, 4 and 8, the torch dim :func:`shard_dim`
  picks is the flax axis ``spec_for_shape`` picks, carried through the
  layout change the weight converters make (HWIO -> OIHW, ``[in, out]``
  -> ``[out, in]``).
- The step: ``fsdp_shard`` + ``fsdp_train_step`` of a small BatchNorm
  ResNet on 2 gloo ranks against ``jit_fsdp_train_step`` on a 2-device
  CPU mesh, and HSDP (``axis="intra"``) on 4 ranks with
  ``LOCAL_WORLD_SIZE=2`` against ``axis=INTRA_AXIS`` on a 2x2 mesh, from
  one converted flax init and one global batch (two images a rank), two
  SGD-momentum steps. Both sides normalise over the global batch.
- The checks the reference makes: ``split()`` communicators, a missing or
  unknown ``axis``, and the warning for an ``allreduce_grad_dtype``.

Tolerance: losses, every parameter and every running statistic after
each step agree to atol 2e-5 in float32 (the cross-rank sums and the
BatchNorm reductions add in another order), as the data-parallel tests
use; the ranks hold equal replicas.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.models import ResNet50 as JaxResNet50
from chainermn_tpu.models import ResNet as JaxResNet
from chainermn_tpu.models.vision import VGG16 as JaxVGG16
from chainermn_tpu.models.vision import GoogLeNet as JaxGoogLeNet
from chainermn_tpu.parallel.fsdp import (
    fsdp_shard as jax_fsdp_shard,
    jit_fsdp_train_step,
    spec_for_shape as jax_spec_for_shape,
)
from chainermn_tpu.parallel.mesh import INTRA_AXIS
from chainermn_torch.interop import resnet_params_from_flax
from chainermn_torch.parallel.fsdp import shard_dim
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

LR, PER_RANK, TOL = 0.1, 2, 2e-5
CFG = dict(stage_sizes=[1], width=4, num_classes=10)
# name: (ranks, LOCAL_WORLD_SIZE, torch strategy and axis, JAX axis)
WORLDS = {"fsdp": (2, 2, "pure_nccl", None, None),
          "hsdp": (4, 2, "hierarchical", "intra", INTRA_AXIS)}

_WORKER = """
import warnings
import torch
from chainermn_torch import create_communicator
from chainermn_torch.interop import images_from_nhwc
from chainermn_torch.models import ResNet
from chainermn_torch.parallel.fsdp import fsdp_shard, fsdp_train_step

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
strategy, axis = spec["strategy"], spec["axis"]
comm = create_communicator(strategy, device="cpu")
model = ResNet(**spec["cfg"], compute_dtype=torch.float32, device="cpu")
model.load_state_dict(spec["state"])
model = fsdp_shard(model, comm, axis=axis)
opt = torch.optim.SGD(model.parameters(), lr=spec["lr"], momentum=0.9)
step = fsdp_train_step(model, opt, comm, axis=axis)
n = spec["per_rank"]
images = images_from_nhwc(spec["images"][RANK * n:(RANK + 1) * n])
labels = torch.from_numpy(spec["labels"][RANK * n:(RANK + 1) * n])


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).clone()


out = {"losses": [], "states": [],
       "replicated": len(model.fsdp_replicated)}
for _ in range(2):
    out["losses"].append(float(step(images, labels)))
    out["states"].append({k: full(v) for k, v in model.state_dict().items()})

errors = {}
if axis is None:
    sub = comm.split(RANK % 2)
    try:
        fsdp_shard(ResNet(**spec["cfg"], device="cpu"), sub)
    except ValueError as e:
        errors["split"] = str(e)
    sub.finalize()
    try:
        fsdp_shard(ResNet(**spec["cfg"], device="cpu"), comm, axis="intra")
    except ValueError as e:
        errors["flat_axis"] = str(e)
    wire = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype=torch.bfloat16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fsdp_train_step(model, opt, wire)
    errors["wire"] = [str(w.message) for w in caught]
    wire.finalize()
else:
    for bad in (None, "nodes"):
        try:
            fsdp_shard(ResNet(**spec["cfg"], device="cpu"), comm, axis=bad)
        except ValueError as e:
            errors[str(bad)] = str(e)
out["errors"] = errors
comm.finalize()
save(out)
"""


def _jax_run(model, init, images, labels, n_ranks, axis):
    """Two ``jit_fsdp_train_step`` steps: losses and converted states."""
    with warnings.catch_warnings():   # the GPU-era names warn
        warnings.simplefilter("ignore")
        comm = chainermn_tpu.create_communicator(
            "hierarchical" if axis else "tpu",
            devices=jax.devices()[:n_ranks])
    opt = optax.sgd(LR, momentum=0.9)
    variables = jax_fsdp_shard(init, comm, axis)
    state = jax_fsdp_shard(jax.jit(opt.init)(variables["params"]), comm,
                           axis)
    step = jit_fsdp_train_step(model, opt, comm, donate=False, axis=axis)
    rec = {"losses": [], "states": []}
    for _ in range(2):
        variables, state, loss = step(variables, state, images, labels)
        rec["losses"].append(float(loss))
        rec["states"].append(resnet_params_from_flax(
            jax.device_get(variables)))
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (n_ranks, local, strategy, axis, jax_axis) in WORLDS.items():
        rng = np.random.default_rng(0)
        images = rng.standard_normal((n_ranks * PER_RANK, 16, 16, 3)).astype(
            np.float32)
        labels = rng.integers(0, 10, n_ranks * PER_RANK).astype(np.int64)
        model = JaxResNet(**CFG, compute_dtype=jnp.float32)
        init = jax.device_get(jax.jit(functools.partial(
            model.init, train=True))(jax.random.PRNGKey(0),
                                     jnp.asarray(images[:1])))
        want = _jax_run(model, init, jnp.asarray(images),
                        jnp.asarray(labels.astype(np.int32)), n_ranks,
                        jax_axis)
        spec = tmp_path_factory.mktemp(name) / "spec.pt"
        torch.save({"cfg": CFG, "state": resnet_params_from_flax(init),
                    "images": images, "labels": labels,
                    "per_rank": PER_RANK, "lr": LR, "strategy": strategy,
                    "axis": axis}, spec)
        got = run_ranks(_WORKER, n_ranks, local_world_size=local,
                        args=[spec])
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", list(WORLDS))
def test_fsdp_step_matches_jit_fsdp_train_step(runs, name):
    want, got = runs[name]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], atol=TOL,
                               rtol=0)
    for step in range(2):
        for key, ref in want["states"][step].items():
            np.testing.assert_allclose(
                got[0]["states"][step][key].numpy(), ref.numpy(), atol=TOL,
                rtol=0, err_msg=f"{name} step {step + 1} {key}")
    for r in range(1, len(got)):
        assert got[r]["losses"] == got[0]["losses"]
        for key, v in got[0]["states"][-1].items():
            np.testing.assert_allclose(got[r]["states"][-1][key].numpy(),
                                       v.numpy(), atol=1e-6, rtol=0,
                                       err_msg=(r, key))


def test_fsdp_rejects_what_the_reference_rejects(runs):
    flat = runs["fsdp"][1][0]["errors"]
    assert "split" in flat["split"]
    assert "flat communicator" in flat["flat_axis"]
    assert any("allreduce_grad_dtype" in w for w in flat["wire"])
    two_level = runs["hsdp"][1][0]["errors"]
    assert "pass axis" in two_level["None"]
    assert "not in communicator axes" in two_level["nodes"]


def _flax_param_shapes(jm, size):
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    return jax.tree_util.tree_leaves(
        jax.eval_shape(functools.partial(jm.init, train=True),
                       jax.random.PRNGKey(0), x)["params"])


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_shard_dim_follows_spec_for_shape(n):
    """The rule on every parameter shape of three full-size models: the
    flax axis the reference shards, moved to where the converters put it
    in torch's layout, is the dim the port shards."""
    to_torch = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}   # torch dim j = axis
    replicated = 0
    for jm, size in ((JaxResNet50(num_classes=1000), 224),
                     (JaxGoogLeNet(num_classes=1000), 224),
                     (JaxVGG16(num_classes=1000), 32)):
        for leaf in _flax_param_shapes(jm, size):
            shape = tuple(leaf.shape)
            spec = tuple(jax_spec_for_shape(shape, n, "d"))
            axis = spec.index("d") if "d" in spec else None
            perm = to_torch[len(shape)]
            torch_shape = tuple(shape[a] for a in perm)
            want = None if axis is None else perm.index(axis)
            assert shard_dim(torch_shape, n) == want, (shape, n)
            replicated += want is None
    # with 3 ranks the 1000-wide head bias divides nowhere: kept whole
    assert replicated > 0 or n != 3
