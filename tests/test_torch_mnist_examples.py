"""The MNIST and seq2seq example twins (``chainermn_torch.examples.mnist``,
``chainermn_torch.examples.seq2seq``) on 4 gloo ranks with
``--device cpu``, started once for the module.

- Each twin's ``main()`` at the JAX example tests' tiny arguments
  (``tests/examples_tests/test_examples.py:43-44,78-79``), asserting the
  lines those tests assert: data-parallel MNIST, crash-and-resume,
  model-parallel MNIST (also ``--fused``), seq2seq (also ``--hybrid``
  on 4 ranks).
- The resumed run's last snapshot equals an uninterrupted run's, leaf
  for leaf.
- The slice as a whole against the JAX package: the model-parallel MNIST
  and seq2seq training steps (the twins' stages in a
  ``MultiNodeChainList`` over ranks 0 and 1, one Adam a stage) and the
  reference examples' own modules in the JAX chain take 3 steps from one
  flax init (``interop.load_chain_from_flax``, the seq2seq GRUs through
  ``gru_params_from_flax``) on the same batches; the losses agree to 1e-5
  and so does the seq2seq token accuracy after them.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_torch.testing import run_ranks

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, STEPS = 4, 3
TINY_MNIST = ["--epoch", "1", "--n-train", "512", "--n-test", "128",
              "--unit", "32", "--batchsize", "32"]
TINY_SEQ2SEQ = ["--epoch", "2", "--n-train", "256", "--n-test", "64",
                "--unit", "24", "--batchsize", "32", "--seq-len", "6"]
CKPT = ["--epoch", "2", "--n-train", "512", "--unit", "32", "--batchsize",
        "32", "--frequency", "2"]


def _reference(relpath: str, name: str):
    """A reference example as a module (its sibling imports resolved)."""
    path = ROOT / "examples" / relpath
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod     # flax's dataclasses look it up
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


_WORKER = """
import contextlib
import io
import os
import numpy as np
import torch
import torch.nn.functional as F
from chainermn_torch import (MultiNodeChainList, SerialIterator,
                             create_communicator,
                             create_component_wise_optimizer)
from chainermn_torch.examples.mnist import (
    train_mnist, train_mnist_checkpoint, train_mnist_model_parallel as mp)
from chainermn_torch.examples.seq2seq import seq2seq
from chainermn_torch.extensions.checkpoint import (
    create_multi_node_checkpointer)
from chainermn_torch.interop import load_chain_from_flax, mlp_params_from_flax

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
out_dir = ARGS[1]
# owns the process group, so each main() below joins it
world = create_communicator("naive", device="cpu")
r = world.rank
out = {}


def run(name, main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            out[name] = main(argv + ["--device", "cpu"])
        except SystemExit as e:
            out[name] = ("exit", e.code)
    out[name + "_printed"] = buf.getvalue()


run("mnist", train_mnist.main, spec["tiny_mnist"])
crash_dir = os.path.join(out_dir, "crash")
run("crash", train_mnist_checkpoint.main,
    spec["ckpt"] + ["--out", crash_dir, "--stop-at", "3"])
run("resume", train_mnist_checkpoint.main, spec["ckpt"] + ["--out", crash_dir])
whole_dir = os.path.join(out_dir, "whole")
run("whole", train_mnist_checkpoint.main, spec["ckpt"] + ["--out", whole_dir])
last = out["whole"]["iteration"] // 2 * 2
out["snapshots"] = [
    create_multi_node_checkpointer("mnist_example", world, path=d)
    ._try_load(last)["state"] for d in (crash_dir, whole_dir)]
run("mp", mp.main, spec["tiny_mnist"])
run("mp_fused", mp.main, spec["tiny_mnist"] + ["--fused"])
run("seq2seq", seq2seq.main, spec["tiny_seq2seq"])
run("seq2seq_hybrid", seq2seq.main, spec["tiny_seq2seq"] + ["--hybrid"])


def chain_steps(links, converters, batches, loss_fn, lr):
    # the twins' stages on ranks 0 -> 1 from the JAX init, STEPS Adam steps
    m = MultiNodeChainList(world)
    m.add_link(links[0], rank=0, rank_in=None, rank_out=1)
    m.add_link(links[1], rank=1, rank_in=0, rank_out=None)
    load_chain_from_flax(m, spec[links[0].__class__.__name__], converters)
    opt = create_component_wise_optimizer(
        lambda ps: torch.optim.Adam(ps, lr=lr), m)
    losses = []
    for xs, target in batches:
        opt.zero_grad()
        y = m(*map(torch.as_tensor, xs))
        if r == 1:
            loss = loss_fn(y, target)
            loss.backward()
            losses.append(float(loss))
        elif y is not None:
            y.backward()
        opt.step()
    return m, losses


(x, y), _ = train_mnist.load_mnist(None, 512, 128)
it = SerialIterator(train_mnist.ArrayDataset(x, y), 32, shuffle=True, seed=1)
batches = []
for _ in range(spec["steps"]):
    images, labels = train_mnist.collate(next(it))
    batches.append(((images,), torch.as_tensor(labels).long()))
_, out["mp_losses"] = chain_steps(
    [mp.MLPHalf0(32), mp.MLPHalf1(32)], mlp_params_from_flax, batches,
    F.cross_entropy, 1e-3)

rng = np.random.RandomState(0)
train = seq2seq.make_reversal_batch(rng, 256, 6, 16)
test = seq2seq.make_reversal_batch(rng, 64, 6, 16)
perm = rng.permutation(256)
batches = []
for i in range(spec["steps"]):
    src, tgt_in, tgt = (a[perm[i * 32:(i + 1) * 32]] for a in train)
    batches.append(((src, tgt_in), tgt))
m, out["seq2seq_losses"] = chain_steps(
    [seq2seq.Encoder(16, 24), seq2seq.Decoder(16, 24)],
    [seq2seq.encoder_params_from_flax, seq2seq.decoder_params_from_flax],
    batches, seq2seq.sequence_loss, 2e-3)
with torch.no_grad():
    logits = m(torch.as_tensor(test[0]), torch.as_tensor(test[1]))
if r == 1:
    out["seq2seq_accuracy"] = float(
        (logits.argmax(-1).numpy() == test[2]).mean())
save(out)
world.finalize()
"""


def _jax_chain_losses(comm, links, xs0, batches, loss_fn, lr):
    """The JAX chain (ranks 0 -> 1) from PRNGKey(0): its flax variables
    and STEPS optax.adam steps' losses."""
    chain = chainermn_tpu.MultiNodeChainList(comm)
    chain.add_link(links[0], rank=0, rank_in=None, rank_out=1)
    chain.add_link(links[1], rank=1, rank_in=0, rank_out=None)
    variables = chain.init(jax.random.PRNGKey(0), *xs0)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    opt = optax.adam(lr)
    states = [opt.init(v) for v in variables]
    losses = []
    for xs, target in batches:
        loss, grads = jax.value_and_grad(
            lambda vs: loss_fn(chain.apply(vs, *xs), target))(variables)
        losses.append(float(loss))
        new_vars = []
        for i, (v, g) in enumerate(zip(variables, grads)):
            updates, states[i] = opt.update(g, states[i], v)
            new_vars.append(optax.apply_updates(v, updates))
        variables = new_vars
    return chain, variables, init, losses


@pytest.fixture(scope="module")
def ref():
    comm = chainermn_tpu.create_communicator("naive")
    ce = lambda logits, t: optax.softmax_cross_entropy_with_integer_labels(  # noqa: E731
        logits, t).mean()
    spec = {"steps": STEPS, "tiny_mnist": TINY_MNIST,
            "tiny_seq2seq": TINY_SEQ2SEQ, "ckpt": CKPT}
    res = {}

    mnist = _reference("mnist/train_mnist.py", "reference_train_mnist")
    mpm = _reference("mnist/train_mnist_model_parallel.py",
                     "reference_train_mnist_model_parallel")
    (x, y), _ = mnist.load_mnist(None, 512, 128)
    it = JaxSerialIterator(mnist.ArrayDataset(x, y), 32, shuffle=True, seed=1)
    batches = [mnist.collate(next(it)) for _ in range(STEPS)]
    _, _, spec["MLPHalf0"], res["mp_losses"] = _jax_chain_losses(
        comm, [mpm.MLPHalf0(32), mpm.MLPHalf1(32)],
        (jnp.zeros((1, 28, 28)),), [((b[0],), b[1]) for b in batches],
        ce, 1e-3)

    s2s = _reference("seq2seq/seq2seq.py", "reference_seq2seq")
    rng = np.random.RandomState(0)
    train = s2s.make_reversal_batch(rng, 256, 6, 16)
    test = s2s.make_reversal_batch(rng, 64, 6, 16)
    perm = rng.permutation(256)
    batches = []
    for i in range(STEPS):
        src, tgt_in, tgt = (a[perm[i * 32:(i + 1) * 32]] for a in train)
        batches.append(((src, tgt_in), tgt))
    chain, variables, spec["Encoder"], res["seq2seq_losses"] = \
        _jax_chain_losses(comm, [s2s.Encoder(16, 24), s2s.Decoder(16, 24)],
                          (train[0][:1], train[1][:1]), batches, ce, 2e-3)
    res["seq2seq_accuracy"] = s2s.token_accuracy(chain, variables, *test)
    return spec, res


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    torch.save(ref[0], d / "spec.pt")
    return run_ranks(_WORKER, N_RANKS, args=[str(d / "spec.pt"), str(d)],
                     timeout=240)


def test_train_mnist(ranks):
    assert "epoch   1" in ranks[0]["mnist_printed"]
    assert "size: 4" in ranks[0]["mnist_printed"]
    summary = ranks[0]["mnist"]
    assert summary["global_batch"] == 128 and summary["steps"] >= 1
    assert np.isfinite(summary["epochs"][-1]["loss"])


def test_train_mnist_checkpoint_crash_resume(ranks):
    assert ranks[0]["crash"] == ("exit", 1)
    assert "simulated crash at iteration 3" in ranks[0]["crash_printed"]
    assert "resumed from iteration 2" in ranks[0]["resume_printed"]
    assert ranks[0]["resume"]["resumed_from"] == 2
    assert ranks[0]["resume"]["iteration"] == ranks[0]["whole"]["iteration"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_resumed_run_equals_uninterrupted(ranks):
    for out in ranks:
        resumed, whole = out["snapshots"]
        a, b = list(_leaves(resumed)), list(_leaves(whole))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=path)


@pytest.mark.parametrize("name", ["mp", "mp_fused"])
def test_train_mnist_model_parallel(ranks, name):
    assert "epoch   1" in ranks[0][f"{name}_printed"]
    stage1 = ranks[1][name]
    assert stage1["steps"] == 16 and len(stage1["losses"]) == 16
    assert all(np.isfinite(stage1["losses"]))
    if name == "mp":
        # one transfer each way a step on the two stage ranks, none on
        # the others; rank 0 holds stage 0 only
        for r in (0, 1):
            t = ranks[r][name]["transfers"]
            assert (t["forward"], t["backward"]) == (16, 16)
            assert t["bytes"] == 2 * 16 * 32 * 32 * 4
        assert ranks[2][name]["transfers"]["forward"] == 0
        assert ranks[0][name]["n_params"] == 784 * 32 + 32 + 32 * 32 + 32
    else:
        assert ranks[0][name]["transfers"]["forward"] == 0
        np.testing.assert_allclose(stage1["losses"],
                                   ranks[1]["mp"]["losses"], rtol=1e-5,
                                   atol=1e-6)


def test_seq2seq_model_parallel(ranks):
    assert "epoch   2" in ranks[0]["seq2seq_printed"]
    assert "(pairs=1, hybrid=False)" in ranks[0]["seq2seq_printed"]


def test_seq2seq_hybrid_dp_mp(ranks):
    assert "pairs=2, hybrid=True" in ranks[0]["seq2seq_hybrid_printed"]
    # two pairs on half batches with their gradients averaged take the
    # steps one pair takes on whole batches
    for a, b in zip(ranks[0]["seq2seq_hybrid"]["epochs"],
                    ranks[0]["seq2seq"]["epochs"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


@pytest.mark.parametrize("name", ["mp", "seq2seq"])
def test_training_steps_match_jax(ref, ranks, name):
    np.testing.assert_allclose(ranks[1][f"{name}_losses"],
                               ref[1][f"{name}_losses"], rtol=1e-5,
                               atol=1e-5)
    assert ranks[0][f"{name}_losses"] == []


def test_seq2seq_token_accuracy_matches_jax(ref, ranks):
    assert ranks[1]["seq2seq_accuracy"] == pytest.approx(
        ref[1]["seq2seq_accuracy"], abs=1e-9)
