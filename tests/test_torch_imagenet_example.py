"""The ImageNet trainer twin
(``chainermn_torch.examples.imagenet.train_imagenet``) on 2 gloo ranks,
on the CPU.

- The slice as a whole against the JAX package: the reference's loop
  (``scatter_dataset`` -> ``SerialIterator`` -> ``collate`` ->
  ``jit_train_step`` with label smoothing 0.1, SGD with momentum) and
  the port's (the same pieces of ``chainermn_torch``: ``scatter_dataset``,
  ``SerialIterator``, the twin's ``collate``, ``train_step``) take 3 steps
  of a tiny float32 ResNet at 32x32 from one flax init converted by
  ``resnet_params_from_flax``. The reference runs both ranks' shards as
  one 2-device program (each device's batch is that rank's), so the
  BatchNorm statistics are per rank on both sides. Losses agree to atol
  2e-5, as the data-parallel tests use.
- The twin's ``main()`` once per flag set of the reference's
  ``test_train_imagenet*`` tests (``tests/examples_tests/
  test_examples.py:475-538``) except ``--train-dir``, asserting what those
  tests assert and the same printed lines, plus ``--device-prefetch``
  over the native loader and the ``--train-dir`` refusal.

The ranks start once for the module and run every case.
"""

import functools
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.datasets import scatter_dataset as jax_scatter_dataset
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.models import ResNet as JaxResNet
from chainermn_tpu.training import jit_train_step
from chainermn_torch.interop import resnet_params_from_flax
from chainermn_torch.testing import run_ranks

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, PER_RANK, STEPS, LR, SMOOTHING = 2, 2, 3, 0.1, 0.1
CFG = dict(stage_sizes=[1, 1], width=8, num_classes=10)
TINY = ["--arch", "resnet18", "--image-size", "32", "--classes", "10"]
# the reference's test_train_imagenet* flag sets (without --train-dir)
# and what each asserts, plus the device prefetcher
FLAGS = {
    "plain": (TINY + ["--batchsize", "2", "--iterations", "2",
                      "--n-synthetic", "64"],
              ["done: 2 iterations"]),
    "recipe": (TINY + ["--batchsize", "4", "--epoch", "2", "--n-synthetic",
                       "256", "--recipe", "--warmup-epochs", "1"],
               ["top-1", "epoch   2", "input pipeline: native C++ prefetch"]),
    "mnbn_double_buffering": (TINY + ["--batchsize", "2", "--iterations",
                                      "2", "--n-synthetic", "64", "--mnbn",
                                      "--double-buffering"],
                              ["done: 2 iterations"]),
    "fsdp": (TINY + ["--batchsize", "2", "--iterations", "2",
                     "--n-synthetic", "64", "--fsdp", "--val-frac", "0.1"],
             ["done: 2 iterations", "top-1"]),
    "native_loader": (TINY + ["--batchsize", "2", "--iterations", "3",
                              "--n-synthetic", "64", "--native-loader"],
                      ["done: 3 iterations"]),
    "device_prefetch": (TINY + ["--batchsize", "2", "--iterations", "3",
                                "--n-synthetic", "64", "--native-loader",
                                "--device-prefetch", "2"],
                        ["done: 3 iterations", "device prefetch: depth 2"]),
}


def _reference_example():
    """``examples/imagenet/train_imagenet.py`` as a module (its dataset
    and ``collate``)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_imagenet",
        ROOT / "examples" / "imagenet" / "train_imagenet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_WORKER = """
import contextlib
import io
import os
import numpy as np
import torch
from chainermn_torch import (
    SerialIterator, create_communicator, create_multi_node_optimizer,
    scatter_dataset)
from chainermn_torch.examples.imagenet import train_imagenet as twin
from chainermn_torch.interop import images_from_nhwc
from chainermn_torch.models import ResNet
from chainermn_torch.training import train_step

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
# owns the process group, so each main() below joins it
world = create_communicator("naive", device="cpu")

# the slice as a whole
comm = create_communicator("pure_nccl", device="cpu")
model = ResNet(**spec["cfg"], compute_dtype=torch.float32, device="cpu")
model.load_state_dict(spec["state"])
opt = create_multi_node_optimizer(torch.optim.SGD(
    model.parameters(), lr=spec["lr"], momentum=0.9), comm)
step = train_step(model, opt, comm, train_kwargs={"train": True},
                  label_smoothing=spec["smoothing"])
data = twin.SyntheticImageNet(64, 32, 10)
train = twin.equal_shards(scatter_dataset(data, comm, shuffle=True, seed=0),
                          comm)
it = SerialIterator(train, spec["per_rank"], shuffle=True, seed=1)
out = {"losses": [], "main": {}}
for _ in range(spec["steps"]):
    x, y = twin.collate(next(it), np.float32)
    out["losses"].append(float(step(images_from_nhwc(torch.from_numpy(x)),
                                    torch.from_numpy(y))))
comm.finalize()

for name, flags in spec["flags"].items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = twin.main(flags + ["--device", "cpu"])
    out["main"][name] = (buf.getvalue(), summary)
# a seeded JPEG tree (the same bytes on both ranks): 2 classes x 8
import tempfile
from PIL import Image

tree = tempfile.mkdtemp()
rs = np.random.RandomState(0)
for cname in ("class_a", "class_b"):
    os.makedirs(os.path.join(tree, cname))
    for i in range(8):
        arr = (np.kron(rs.rand(6, 6, 3), np.ones((8, 8, 1)))[:48, :48]
               * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(tree, cname, f"{i}.jpg"),
                                  "JPEG")
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    summary = twin.main(["--arch", "resnet18", "--batchsize", "2",
                         "--iterations", "2", "--image-size", "32",
                         "--train-dir", tree, "--device-prefetch", "2",
                         "--device", "cpu"])
out["train_dir"] = (buf.getvalue(), summary)
try:
    twin.main(["--train-dir", tree, "--val-frac", "0.1", "--device", "cpu"])
except SystemExit as e:
    out["train_dir_val_frac"] = str(e)
world.finalize()
save(out)
"""


def _reference_losses(ref):
    """The reference loop over the two ranks' shards, each device of a
    2-device mesh taking its rank's batch."""
    data = ref.SyntheticImageNet(64, 32, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        comm = chainermn_tpu.create_communicator(
            "tpu", devices=jax.devices()[:N_RANKS])
    iters = [JaxSerialIterator(
        jax_scatter_dataset(data, comm, shuffle=True, seed=0,
                            n_shards=N_RANKS, shard_id=r),
        PER_RANK, shuffle=True, seed=1) for r in range(N_RANKS)]
    model = JaxResNet(**CFG, compute_dtype=jnp.float32)
    x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    init = jax.device_get(jax.jit(functools.partial(model.init, train=True))(
        jax.random.PRNGKey(0), x0))
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(LR, momentum=0.9), comm)
    variables = comm.bcast_data(init)
    state = jax.device_put(opt.init(variables["params"]),
                           comm.named_sharding())
    step = jit_train_step(model, opt, comm, donate=False, monitored=False,
                          train_kwargs={"train": True},
                          label_smoothing=SMOOTHING)
    losses = []
    for _ in range(STEPS):
        parts = [ref.collate(next(it), np.float32) for it in iters]
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        variables, state, loss = step(variables, state, x, y)
        losses.append(float(loss))
    return init, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init, want = _reference_losses(_reference_example())
    spec = tmp_path_factory.mktemp("imagenet") / "spec.pt"
    torch.save({"cfg": CFG, "state": resnet_params_from_flax(init),
                "per_rank": PER_RANK, "steps": STEPS, "lr": LR,
                "smoothing": SMOOTHING,
                "flags": {k: v[0] for k, v in FLAGS.items()}}, spec)
    got = run_ranks(_WORKER, N_RANKS, args=[spec], timeout=600)
    return want, got


def test_the_slice_matches_the_reference_loop(runs):
    want, got = runs
    assert len(want) == STEPS
    for rank in got:
        np.testing.assert_allclose(rank["losses"], want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", list(FLAGS))
def test_main_prints_what_the_reference_prints(runs, name):
    _, got = runs
    stdout, summary = got[0]["main"][name]
    for needle in FLAGS[name][1]:
        assert needle in stdout, (needle, stdout)
    lines = stdout.splitlines()
    assert lines[0].startswith("arch=resnet18 communicator=tpu")
    assert lines[0].endswith("devices=2")
    assert any(ln.startswith("compiled; first loss ") for ln in lines)
    assert any(ln.endswith("M params, global batch "
                           f"{summary['global_batch']}") for ln in lines)
    assert lines[-1].startswith(f"done: {summary['iterations']} iterations")
    assert summary["losses_finite"]
    assert got[1]["main"][name][0] == ""          # rank 0 prints alone
    assert got[1]["main"][name][1]["losses"] == summary["losses"]


def test_recipe_and_native_loader_paths(runs):
    """The recipe evaluates every epoch through the multi-node evaluator
    and runs the native C++ loader; --native-loader takes it explicitly;
    --train-dir trains from a JPEG tree on the native decoder (each rank
    its shard of the files, through the device prefetcher) and refuses
    --val-frac, as the reference does."""
    _, got = runs
    main = got[0]["main"]
    assert main["recipe"][1]["native_loader"]
    # 251 training records, 126 a rank once the shards are equal
    assert main["recipe"][1]["iterations"] == 2 * (126 // 4)
    assert main["native_loader"][1]["native_loader"]
    assert not main["plain"][1]["native_loader"]
    assert main["fsdp"][1]["top1"] is not None
    stdout, summary = got[0]["train_dir"]
    assert "input pipeline: JPEG directory, native libjpeg, 2 classes" \
        in stdout
    assert "done: 2 iterations" in stdout
    assert summary["jpeg_decoder"] == "native"
    assert summary["failed_decodes"] == 0 and summary["classes"] == 2
    assert summary["iterations"] == 2 and summary["losses_finite"]
    assert "device prefetch: depth 2" in stdout
    assert got[1]["train_dir"][0] == ""            # rank 0 prints alone
    assert got[1]["train_dir"][1]["losses"] == summary["losses"]
    for r in range(2):
        assert "--val-frac" in got[r]["train_dir_val_frac"]
