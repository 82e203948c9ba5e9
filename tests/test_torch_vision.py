"""The port's GoogLeNet and VGG16 (``chainermn_torch.models.vision``)
against the flax models on converted weights
(``googlenet_params_from_flax``, ``vgg16_params_from_flax``), on the CPU
at 32x32 in float32: logits, input gradients and every parameter
gradient, plus the parameter counts at 224x224 and 1000 classes.

GoogLeNet exercises flax's uneven ``'SAME'`` padding of its strided 7x7
stem and 3x3/2 pools and the -inf padding of every max pool, the stride-1
pool of each Inception branch included; VGG16 the NHWC flatten before
its first dense layer.

Tolerance: atol 2e-5 (``highest`` matmul precision on both sides; the
convolutions sum in another order), as ``test_torch_resnet.py`` uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.vision import VGG16 as JaxVGG16
from chainermn_tpu.models.vision import GoogLeNet as JaxGoogLeNet
from chainermn_torch.interop import (
    googlenet_params_from_flax,
    images_from_nhwc,
    vgg16_params_from_flax,
)
from chainermn_torch.models import VGG16, GoogLeNet

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

TOL = 2e-5
SIZE, CLASSES = 32, 10
MODELS = {
    "googlenet": (JaxGoogLeNet, GoogLeNet, googlenet_params_from_flax, {}),
    "vgg16": (JaxVGG16, VGG16, vgg16_params_from_flax,
              {"spatial": SIZE // 32}),
}


def _random_params(jm, x, rng):
    """Seeded weights of the flax parameter shapes (traced, never
    compiled, by ``eval_shape``): kernels scaled by 1 / sqrt(fan_in) and
    small nonzero biases, so the bias mapping shows too."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]

    def draw(s):
        if len(s.shape) == 1:
            return 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return {"params": jax.tree_util.tree_map(draw, shapes)}


def _flax_value_and_grads(jm, variables, x, g):
    def loss(params, x):
        logits = jm.apply({"params": params}, x)
        return jnp.sum(logits * g), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], x)
    return logits, grads


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_gradients_match_flax(name):
    jcls, tcls, convert, kw = MODELS[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    g = rng.standard_normal((2, CLASSES)).astype(np.float32)
    jm = jcls(num_classes=CLASSES, compute_dtype=jnp.float32)
    variables = _random_params(jm, jnp.asarray(x), rng)
    logits, (grads, x_grad) = jax.device_get(_flax_value_and_grads(
        jm, variables, jnp.asarray(x), jnp.asarray(g)))
    tm = tcls(num_classes=CLASSES, compute_dtype=torch.float32,
              device="cpu", **kw)
    tm.load_state_dict(convert(variables))
    tx = images_from_nhwc(torch.from_numpy(x)).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out = tm(tx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), x_grad,
                               atol=TOL, rtol=0)
    want = convert({"params": grads})
    assert set(want) == {k for k, _ in tm.named_parameters()}
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(),
                                   atol=TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name,count", [("googlenet", 6_998_552),
                                        ("vgg16", 138_357_544)])
def test_parameter_count_at_full_size(name, count):
    """The full-size models (224x224, 1000 classes) hold the published
    GoogLeNet main tower's and VGG-16's parameter counts, built on the
    meta device."""
    _, tcls, _, _ = MODELS[name]
    with torch.device("meta"):
        model = tcls(num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count
