"""The port's chunked softmax cross entropy
(``chainermn_torch/ops/losses.py``) against the JAX package's
(``chainermn_tpu/ops/losses.py``) on the same seeded inputs: values and
gradients at chunk sizes that divide N, do not, equal it and exceed it
(f32 to 2e-5, as the JAX package holds its own to its oracle), bf16
operands, per-token cotangents, and the last chunk at its own length
where the reference's zero padding turns a large bias into NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chainermn_tpu.ops.losses import (
    chunked_softmax_cross_entropy as jax_chunked_ce,
)
from chainermn_torch.ops.losses import chunked_softmax_cross_entropy

torch.set_float32_matmul_precision("highest")


def _inputs(seed, n=24, d=8, v=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, v)) * 0.3).astype(np.float32),
            (rng.standard_normal(v) * 0.1).astype(np.float32),
            rng.integers(0, v, n))


def _port(hidden, kernel, bias, targets, chunk, weights=None):
    """Losses and hidden/weight/bias gradients of the port (the weight in
    its ``[vocab, d]`` layout, the gradient back in the kernel's)."""
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(kernel.T.copy()).requires_grad_()
    b = None if bias is None else torch.from_numpy(bias).requires_grad_()
    out = chunked_softmax_cross_entropy(h, w, b, torch.from_numpy(targets),
                                        chunk_size=chunk)
    cot = (torch.full_like(out, 1.0 / out.numel()) if weights is None
           else torch.from_numpy(weights))
    (out * cot).sum().backward()
    grads = [h.grad.numpy(), w.grad.numpy().T]
    if b is not None:
        grads.append(b.grad.numpy())
    return out.detach().numpy(), grads


def _jax(hidden, kernel, bias, targets, chunk, weights=None):
    def loss(h, k, b):
        out = jax_chunked_ce(h, k, b, jnp.asarray(targets), chunk_size=chunk)
        cot = (1.0 / out.size if weights is None else jnp.asarray(weights))
        return jnp.sum(out * cot), out

    wrt = (0, 1) if bias is None else (0, 1, 2)
    (_, out), grads = jax.value_and_grad(loss, argnums=wrt, has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(kernel),
        None if bias is None else jnp.asarray(bias))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("chunk", [8, 7, 24, 100])
def test_values_and_grads_match_jax(chunk):
    """``losses.py:139`` values and custom-VJP gradients at every chunk
    regime (the port runs the last chunk at its own length)."""
    args = _inputs(0)
    got, got_g = _port(*args, chunk)
    want, want_g = _jax(*args, chunk)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b, name in zip(got_g, want_g, ("hidden", "kernel", "bias")):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=name)


def test_no_bias_and_weighted_cotangent():
    hidden, kernel, _, targets = _inputs(1)
    weights = np.linspace(0.0, 1.0, targets.shape[0]).astype(np.float32)
    got, got_g = _port(hidden, kernel, None, targets, 7, weights)
    want, want_g = _jax(hidden, kernel, None, targets, 7, weights)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_leading_shape_and_bfloat16():
    """``[B, T]`` leading shape; bf16 hidden and weight give float32
    losses within 2e-2 of the f32 plain CE (``test_losses.py:63``)."""
    hidden, kernel, bias, targets = _inputs(2, n=32)
    h = torch.from_numpy(hidden).to(torch.bfloat16).view(4, 8, -1)
    w = torch.from_numpy(kernel.T.copy()).to(torch.bfloat16)
    got = chunked_softmax_cross_entropy(
        h, w, torch.from_numpy(bias), torch.from_numpy(targets).view(4, 8),
        chunk_size=8)
    assert got.shape == (4, 8) and got.dtype == torch.float32
    want = F.cross_entropy(
        torch.from_numpy(hidden @ kernel + bias), torch.from_numpy(targets),
        reduction="none").view(4, 8)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_large_bias_with_a_ragged_last_chunk_stays_finite():
    """Reference fault, not copied (ROADMAP Queue C): with ``n % chunk !=
    0`` the reference pads the last chunk's lse with zeros, so its
    backward takes ``exp(bias - 0)`` on the padded rows; a bias of 100
    overflows to inf and ``inf * 0`` puts NaN in the kernel and bias
    gradients. The port runs the last chunk at its own length: its values
    and gradients stay finite and equal plain cross entropy's."""
    hidden, kernel, bias, targets = _inputs(3, n=10)
    bias[5] = 100.0
    got, got_g = _port(hidden, kernel, bias, targets, 4)
    h = torch.from_numpy(hidden).requires_grad_()
    k = torch.from_numpy(kernel).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    ref = F.cross_entropy(h @ k + b, torch.from_numpy(targets),
                          reduction="none")
    ref.mean().backward()
    np.testing.assert_allclose(got, ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, want in zip(got_g, (h.grad, k.grad, b.grad)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, want.numpy(), rtol=2e-5, atol=2e-5)
    _, jax_g = _jax(hidden, kernel, bias, targets, 4)
    assert not np.isfinite(jax_g[2]).all()     # the reference's NaN
