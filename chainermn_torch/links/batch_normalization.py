"""BatchNorm with flax's semantics, and multi-node (cross-rank)
BatchNorm (the port of ``chainermn_tpu/links/batch_normalization.py``).

The port's activations are NCHW (``channels_last`` in memory), so the
feature axis is 1, as in ``torch.nn.functional.batch_norm``; a ``[N, C]``
input is the same layout. flax and torch differ in what they call the
same things, and :class:`BatchNorm` follows flax:

- ``momentum`` is the weight of the *old* running statistic
  (``ra = m * ra + (1 - m) * new``; torch's ``momentum`` is ``1 - m``);
- the running variance takes the *biased* batch variance (torch's takes
  the unbiased one);
- the statistics are float32 whatever the input's dtype, and the
  output is cast to ``dtype`` (the input's when ``None``).

``use_running_average`` is taken from the call, else from the
constructor, else ``not self.training`` (the reference's default, batch
statistics, is a module in training mode).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from chainermn_torch._device import resolve_device
from chainermn_torch.functions.collective_communication import allreduce


def _feature_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view([1, -1] + [1] * (ndim - 2))


def multi_node_batch_normalization(x, gamma, beta, communicator,
                                   eps: float = 2e-5):
    """Normalize ``x`` (feature axis 1) with batch statistics pooled over
    the communicator's ranks. Returns ``(y, mean, var)``, ``y`` in float32
    (or wider), the statistics the global ones for the running averages.

    The local mean and square-mean are averaged over ranks by one
    differentiable all-reduce, whose backward all-reduces their two
    cotangents (``batch_normalization.py:42-46``); the variance is
    ``sqmean - mean**2``, clipped at 0 as flax does (the reference does
    not clip, and gives NaN where rounding makes it negative by more than
    ``eps``). ``gamma`` and ``beta`` may be ``None``."""
    dims = [d for d in range(x.dim()) if d != 1]
    x32 = x.float()
    local = torch.cat([x32.mean(dims), x32.square().mean(dims)])
    mean, sqmean = allreduce(local, communicator, "mean").chunk(2)
    var = (sqmean - mean.square()).clamp_min(0.0)
    y = ((x32 - _feature_view(mean, x.dim()))
         * _feature_view(torch.rsqrt(var + eps), x.dim()))
    if gamma is not None:
        y = y * _feature_view(gamma, x.dim())
    if beta is not None:
        y = y + _feature_view(beta, x.dim())
    return y, mean, var


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the feature axis ``axis`` (1 by
    default): float32 parameters ``weight`` (flax's ``scale``) and
    ``bias``, float32 buffers ``running_mean`` and ``running_var``, on
    ``device`` (the current CUDA card when ``None``; raises when there is
    none — pass ``device="cpu"``)."""

    def __init__(self, num_features: int, *,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, use_scale: bool = True,
                 use_bias: bool = True, scale_init: float = 1.0,
                 axis: int = 1, device=None) -> None:
        super().__init__()
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.axis = axis
        f32 = dict(dtype=torch.float32, device=resolve_device(device))
        self.weight = (nn.Parameter(torch.full((num_features,), scale_init,
                                               **f32))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **f32))
                     if use_bias else None)
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"eps={self.eps}, dtype={self.dtype}, axis={self.axis}")

    def _use_ra(self, use_running_average: Optional[bool]) -> bool:
        for v in (use_running_average, self.use_running_average):
            if v is not None:
                return bool(v)
        return not self.training

    def _batch_forward(self, x):
        """``(y, mean, var)`` from this batch's statistics (feature axis
        1). torch's fused kernel normalizes with the biased variance, as
        flax does, and returns the mean and ``1/sqrt(var + eps)``."""
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        return y, mean, invstd.detach().float().pow(-2) - self.eps

    def forward(self, x, use_running_average: Optional[bool] = None):
        out_dtype = self.dtype or x.dtype
        if self.axis != 1:
            x = x.movedim(self.axis, 1)
        if self._use_ra(use_running_average):
            y = nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=self.eps)
        else:
            y, mean, var = self._batch_forward(x)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        y = y.to(out_dtype)
        return y.movedim(1, self.axis) if self.axis != 1 else y


class MultiNodeBatchNormalization(BatchNorm):
    """BatchNorm whose batch statistics — and so its running statistics —
    are those of the global batch over ``communicator``'s ranks (eps
    2e-5 by default, as in the reference)."""

    def __init__(self, num_features: int, communicator, *,
                 eps: float = 2e-5, **kwargs) -> None:
        if kwargs.get("axis", 1) != 1:
            raise ValueError("MultiNodeBatchNormalization normalizes the "
                             "feature axis 1")
        super().__init__(num_features, eps=eps, **kwargs)
        self.communicator = communicator

    def _batch_forward(self, x):
        return multi_node_batch_normalization(
            x, self.weight, self.bias, self.communicator, self.eps)


__all__ = ["BatchNorm", "MultiNodeBatchNormalization",
           "multi_node_batch_normalization"]
