"""Swap every :class:`~chainermn_torch.links.BatchNorm` of a model for a
:class:`~chainermn_torch.links.MultiNodeBatchNormalization` (the port of
``chainermn_tpu/links/create_mnbn_model.py``)."""

from __future__ import annotations

import copy

from torch import nn

from chainermn_torch.links.batch_normalization import (
    BatchNorm,
    MultiNodeBatchNormalization,
)


def _convert(bn: BatchNorm, communicator) -> MultiNodeBatchNormalization:
    # refuse what MNBN cannot represent rather than change the math
    if bn.axis != 1:
        raise ValueError(f"create_mnbn_model: BatchNorm(axis={bn.axis}) "
                         "unsupported; MultiNodeBatchNormalization "
                         "normalizes the feature axis 1")
    new = MultiNodeBatchNormalization(
        bn.num_features, communicator,
        use_running_average=bn.use_running_average, momentum=bn.momentum,
        eps=bn.eps, dtype=bn.dtype, use_scale=bn.weight is not None,
        use_bias=bn.bias is not None, device=bn.running_mean.device)
    new.load_state_dict(bn.state_dict())
    new.train(bn.training)
    return new


def _walk(module: nn.Module, communicator) -> None:
    for name, child in module.named_children():
        if isinstance(child, MultiNodeBatchNormalization):
            continue
        if isinstance(child, nn.SyncBatchNorm):
            raise ValueError(
                f"create_mnbn_model: {name} is a SyncBatchNorm, which "
                "reduces across ranks already; converting would "
                "double-reduce")
        if isinstance(child, nn.modules.batchnorm._BatchNorm):
            raise ValueError(
                f"create_mnbn_model: {name} is a torch {type(child).__name__}"
                ", whose running statistics follow torch's conventions; use "
                "chainermn_torch.links.BatchNorm")
        if isinstance(child, BatchNorm):
            setattr(module, name, _convert(child, communicator))
        else:
            _walk(child, communicator)


def create_mnbn_model(model: nn.Module, communicator) -> nn.Module:
    """A copy of ``model`` with every BatchNorm made multi-node over
    ``communicator``, hyperparameters and parameters kept (the reference
    name). Raises for a BatchNorm on another feature axis than 1 and for
    one that already reduces across ranks."""
    model = copy.deepcopy(model)
    if isinstance(model, BatchNorm) and not isinstance(
            model, MultiNodeBatchNormalization):
        return _convert(model, communicator)
    _walk(model, communicator)
    return model


__all__ = ["create_mnbn_model"]
