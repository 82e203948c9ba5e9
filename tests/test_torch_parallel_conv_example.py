"""The port's channel-parallel convolution twin
(``chainermn_torch/examples/parallel_convolution/train_parallel_conv.py``)
against ``examples/parallel_convolution/train_parallel_conv.py``: its
synthetic data draw for draw, and on 2 and on 4 gloo CPU ranks (started
once a size for the module) ``--check`` and two training steps of
``main()``, plus the first loss and every parameter's gradient of the
parallel program, on the JAX example's weights carried across, against
``jax.grad`` of the JAX ``serial_forward`` loss at 1e-5.

A ReLU whose input is within ``TIE`` of zero in the JAX forward is a
near-tie: the parallel program sums in another order and may round it
to the other side, which moves the gradient of that output channel's
kernel and bias by one position's contribution (the weights here have
one, a pre-activation of 6e-8 in ``pconv2``). Those channels are listed
by the fixture and left out of the 1e-5 comparison; every other element
is held to it."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from chainermn_torch.examples.parallel_convolution import (
    train_parallel_conv as twin,
)
from chainermn_torch.interop import parallel_conv_params_from_jax
from chainermn_torch.testing import run_ranks

ROOT = Path(__file__).resolve().parents[1]
BATCH, IMAGE, CLASSES, N_TRAIN = 64, 32, 10, 128
TIE = 1e-6       # float32 rounding of a 3x3xC sum of terms near 1


def _reference():
    spec = importlib.util.spec_from_file_location(
        "jax_train_parallel_conv",
        ROOT / "examples" / "parallel_convolution" / "train_parallel_conv.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX example's weights (saved for the ranks) and, on its first
    batch, the loss and gradients of its serial forward."""
    ref = _reference()
    params = jax.device_get(ref.init_params(jax.random.PRNGKey(0), IMAGE,
                                            CLASSES))
    x, y = ref.synthetic_cifar(N_TRAIN, IMAGE, CLASSES)

    def loss_fn(p):
        logits = ref.serial_forward(p, jnp.asarray(x[:BATCH]))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y[:BATCH])).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    # every ReLU input of the serial forward, for its near-ties
    z1 = ref._conv(jnp.asarray(x[:BATCH]), params["conv1"])
    z2 = ref._conv(ref._pool(jax.nn.relu(z1)), params["pconv2"])
    z3 = ref._conv(jax.nn.relu(z2), params["pconv3"])
    ties = {name: sorted({int(c) for c in np.nonzero(
        np.abs(np.asarray(z)) < TIE)[-1]})
        for name, z in (("conv1", z1), ("pconv2", z2), ("pconv3", z3))}
    path = tmp_path_factory.mktemp("pconv") / "params.npz"
    np.savez(path, **{f"{k}.{kk}": np.asarray(vv)
                      for k, v in params.items() for kk, vv in v.items()})
    grads = {k: v.numpy() for k, v in parallel_conv_params_from_jax(
        jax.device_get(grads)).items()}
    return {"ref": ref, "path": str(path), "loss": float(loss),
            "grads": grads, "ties": ties}


_RANKS = """
import numpy as np
import torch
from chainermn_torch import create_communicator
from chainermn_torch.examples.parallel_convolution import (
    train_parallel_conv as twin)
from chainermn_torch.interop import parallel_conv_params_from_jax

torch.set_float32_matmul_precision("highest")
comm = create_communicator("tpu", device="cpu")     # owns the default group
flat = np.load(ARGS[0])
params = {}
for key in flat.files:
    layer, leaf = key.split(".")
    params.setdefault(layer, {})[leaf] = flat[key]
full = parallel_conv_params_from_jax(params)
local = twin.shard_params(full, comm.rank, comm.size)
x, y = twin.synthetic_cifar(128, 32, 10)
nl = 64 // comm.size
mine = slice(comm.rank * nl, (comm.rank + 1) * nl)
loss = twin.loss_and_grads(local, twin.images_from_nhwc(x[:64][mine]),
                           torch.as_tensor(y[:64][mine]).long(), comm)
out = {"loss": float(comm.allreduce(loss, "mean")),
       "grads": {k: p.grad.numpy() for k, p in local.items()}}
out["main"] = twin.main(["--device", "cpu", "--check", "--epoch", "1",
                         "--n-train", "128"])
save(out)
comm.finalize()
"""


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, reference):
    return request.param, run_ranks(_RANKS, request.param,
                                    args=[reference["path"]], timeout=240)


def test_synthetic_cifar_matches_the_jax_script(reference):
    for got, want in zip(twin.synthetic_cifar(N_TRAIN, IMAGE, CLASSES),
                         reference["ref"].synthetic_cifar(N_TRAIN, IMAGE,
                                                          CLASSES)):
        np.testing.assert_array_equal(got, want)


def test_check_and_two_steps(ranks):
    """``main(["--check", ...])``: the parity check passes on every rank,
    two steps run, and every rank reports the same losses."""
    n, outs = ranks
    for out in outs:
        run = out["main"]
        assert run["ranks"] == n and run["steps"] == 2
        assert run["parity_max_abs_err"] <= 2e-4
        assert run["epoch_losses"] == outs[0]["main"]["epoch_losses"]
        assert np.isfinite(run["epoch_losses"]).all()


def test_first_loss_and_gradients_match_jax_grad(ranks, reference):
    """Every rank's gradients are the global mean loss's: the pconv
    slices through the collective transposes, the replicated leaves
    summed over the ranks."""
    n, outs = ranks
    want, ties = reference["grads"], reference["ties"]
    assert sum(map(len, ties.values())) <= 1, ties
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["loss"], reference["loss"],
                                   atol=1e-5, rtol=0)
        for key, got in out["grads"].items():
            layer = key.split(".")[0]
            w, first = want[key], 0
            if layer in twin.SHARDED:
                step = w.shape[0] // n
                first = rank * step
                w = w[first:first + step]
            keep = np.ones(w.shape[0], bool)
            for c in ties.get(layer, ()):
                if 0 <= c - first < w.shape[0]:
                    keep[c - first] = False     # a near-tie's channel
            np.testing.assert_allclose(got[keep], w[keep], atol=1e-5,
                                       rtol=1e-5,
                                       err_msg=f"rank {rank} {key}")
