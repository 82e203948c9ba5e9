"""The port's ResNet family, AlexNet and MLP against the flax models on
converted weights (``chainermn_torch.interop``), on the CPU: a tiny
ResNet (``stage_sizes=[1, 1]``, width 8, float32, 32x32 images) with
Bottleneck and Basic blocks and both stems, in train and eval BatchNorm
modes — logits, input gradients and parameter gradients, and the
running statistics after one train-mode forward — plus the ResNet-50
parameter count, AlexNet and the MLP.

Tolerances (float32, ``highest`` matmul precision on both sides): logits
and gradients atol 2e-5 (the convolutions and BatchNorm reductions sum
in another order); running statistics atol 1e-6; AlexNet's logits atol
1e-4 (two 4096-wide layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import AlexNet as JaxAlexNet
from chainermn_tpu.models import ResNet as JaxResNet
from chainermn_tpu.models import ResNet50 as JaxResNet50
from chainermn_tpu.models.resnet import BasicBlock as JaxBasic
from chainermn_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from chainermn_torch.interop import (
    alexnet_params_from_flax,
    images_from_nhwc,
    mlp_params_from_flax,
    resnet_params_from_flax,
)
from chainermn_torch.models import (
    MLP,
    AlexNet,
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet50,
)
from chainermn_torch.models.resnet import same_pads

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

TOL = 2e-5
BLOCKS = {"bottleneck": (JaxBottleneck, BottleneckBlock),
          "basic": (JaxBasic, BasicBlock)}


def _perturbed(variables, rng):
    """Random BatchNorm scales/biases and running statistics, so the
    comparison sees more than the init's ones and zeros."""
    def bump(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        return a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
    out = jax.tree_util.tree_map(bump, variables)
    out["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, out["batch_stats"])
    return out


_INITS = {}


def _flax_init(block, stem, x):
    """The flax variables of the tiny ResNet, shared by its train and
    eval cases (the input is the same seeded batch for both)."""
    if (block, stem) not in _INITS:
        jm = JaxResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       stem=stem, block=BLOCKS[block][0],
                       compute_dtype=jnp.float32)
        _INITS[block, stem] = jax.device_get(jax.jit(
            functools.partial(jm.init, train=True))(jax.random.PRNGKey(1), x))
    return _INITS[block, stem]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_resnet_matches_flax(block, stem, train):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    kw = dict(stage_sizes=[1, 1], width=8, num_classes=10, stem=stem)
    jblock, tblock = BLOCKS[block]
    jm = JaxResNet(**kw, block=jblock, compute_dtype=jnp.float32)
    variables = _perturbed(_flax_init(block, stem, jnp.asarray(x)), rng)
    stats = variables["batch_stats"]

    def loss(params, xx):
        out = jm.apply({"params": params, "batch_stats": stats}, xx,
                       train=train,
                       mutable=["batch_stats"] if train else False)
        logits, new = out if train else (out, {})
        return jnp.sum(logits * w), (logits, new)

    (_, (logits, new)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                            jnp.asarray(x))

    tm = ResNet(**kw, block=tblock, compute_dtype=torch.float32,
                device="cpu")
    tm.load_state_dict(resnet_params_from_flax(variables))
    tx = images_from_nhwc(x).clone().requires_grad_()
    tl = tm(tx, train=train)
    (tl * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(logits),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(g_x), atol=TOL, rtol=0)
    want = resnet_params_from_flax(jax.device_get(
        {"params": g_params, "batch_stats": stats}))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=TOL, rtol=0, err_msg=name)
    # running statistics: moved toward the batch's in train mode only
    after = resnet_params_from_flax(jax.device_get(
        {"params": variables["params"],
         "batch_stats": new["batch_stats"] if train else stats}))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), after[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_resnet50_has_the_flax_parameter_count():
    model = ResNet50(num_classes=1000, device="cpu")
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: JaxResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == 25_557_032
    assert len(model.blocks) == 16


def test_same_padding_is_flax_s():
    """flax pads strided windows after: 3x3/2 on 32 pads (0, 1); the 7x7/2
    stem on 224 pads (2, 3); a 1x1/2 pads nothing."""
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(33, 3, 2) == (1, 1)
    assert same_pads(16, 4, 1) == (1, 2)


def test_mlp_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 7, 4)).astype(np.float32)
    jm = JaxMLP(n_units=16, n_out=4, compute_dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = MLP(n_units=16, n_out=4, compute_dtype=torch.float32, n_in=28,
             device="cpu")
    tm.load_state_dict(mlp_params_from_flax(params))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


def test_alexnet_matches_flax():
    """At 67x67 (the smallest side its three VALID pools take): the
    NHWC flatten order must line up with the converted dense kernel."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 67, 67, 3)).astype(np.float32)
    jm = JaxAlexNet(num_classes=10, compute_dtype=jnp.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = AlexNet(num_classes=10, compute_dtype=torch.float32, spatial=1,
                 device="cpu")
    tm.load_state_dict(alexnet_params_from_flax(params))
    got = tm(images_from_nhwc(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)
