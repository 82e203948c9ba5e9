"""GoogLeNet (Inception v1) and VGG16 (the port of
``chainermn_tpu/models/vision.py``), the rest of the ImageNet example's
model zoo, with the reference's numerics: float32 parameters,
convolutions and hidden dense layers in ``compute_dtype`` (bf16 by
default), a float32 head; flax's ``'SAME'`` padding (uneven on strided
windows, -inf for max pooling, :func:`~chainermn_torch.models.resnet.
same_pads`); lecun-normal kernels and zero biases.

Activations are NCHW tensors, ``channels_last`` in memory. VGG16 flattens
in NHWC order before its first dense layer, as the reference does, so
converted flax weights line up (:mod:`chainermn_torch.interop`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch._device import resolve_device
from chainermn_torch.models.resnet import (
    Conv,
    _dense,
    _lecun_normal_,
    max_pool_same,
)

# (b1, b3_reduce, b3, b5_reduce, b5, pool_proj) per block, grouped by stage
_INCEPTION_CFG = [
    [(64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64)],            # 3a-3b
    [(192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),            # 4a-4e
     (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
     (256, 160, 320, 32, 128, 128)],
    [(256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)],      # 5a-5b
]
# the blocks a stride-2 max pool precedes (the first of stages 4 and 5)
_STAGE_STARTS = (len(_INCEPTION_CFG[0]),
                 len(_INCEPTION_CFG[0]) + len(_INCEPTION_CFG[1]))


class InceptionBlock(nn.Module):
    """Four-branch Inception v1 block: 1x1 / 1x1->3x3 / 1x1->5x5 /
    3x3 max pool->1x1, concatenated on the channel axis."""

    def __init__(self, in_channels: int, b1: int, b3_reduce: int, b3: int,
                 b5_reduce: int, b5: int, pool_proj: int, conv) -> None:
        super().__init__()
        self.b1 = conv(in_channels, b1, 1)
        self.b3_reduce = conv(in_channels, b3_reduce, 1)
        self.b3 = conv(b3_reduce, b3, 3)
        self.b5_reduce = conv(in_channels, b5_reduce, 1)
        self.b5 = conv(b5_reduce, b5, 5)
        self.pool_proj = conv(in_channels, pool_proj, 1)
        self.out_channels = b1 + b3 + b5 + pool_proj

    def forward(self, x):
        y1 = F.relu(self.b1(x))
        y3 = F.relu(self.b3(F.relu(self.b3_reduce(x))))
        y5 = F.relu(self.b5(F.relu(self.b5_reduce(x))))
        yp = F.relu(self.pool_proj(max_pool_same(x, 3, 1)))
        return torch.cat([y1, y3, y5, yp], 1)


def _init(module: nn.Module, seed: int) -> None:
    """flax's initialisers from ``seed``: lecun-normal convolution and
    dense kernels, zero biases."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, gen)
                m.bias.zero_()


class GoogLeNet(nn.Module):
    """Inception v1's main tower (no auxiliary classifiers, as in the
    reference). Call as ``model(images, train=None)``; ``train`` is
    accepted and unused (no normalization layers)."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        conv = functools.partial(Conv, bias=True, compute_dtype=compute_dtype,
                                 device=device)
        self.stem1 = conv(3, 64, 7, 2)
        self.stem2_reduce = conv(64, 64, 1)
        self.stem2 = conv(64, 192, 3)
        blocks, cin = [], 192
        for stage in _INCEPTION_CFG:
            for cfg in stage:
                blocks.append(InceptionBlock(cin, *cfg, conv=conv))
                cin = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        _init(self, seed)

    def forward(self, x, train: Optional[bool] = None):
        del train
        x = F.relu(self.stem1(x.to(self.compute_dtype)))
        x = max_pool_same(x, 3, 2)
        x = F.relu(self.stem2(F.relu(self.stem2_reduce(x))))
        x = max_pool_same(x, 3, 2)
        for i, blk in enumerate(self.blocks):
            if i in _STAGE_STARTS:
                x = max_pool_same(x, 3, 2)
            x = blk(x)
        return self.head(x.mean((2, 3)).float())


_VGG16_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


class VGG16(nn.Module):
    """VGG-16 (configuration D): thirteen biased 3x3 SAME convolutions in
    five stages, each closed by a VALID 2x2/2 max pool, two 4096-wide
    layers and a float32 head. ``spatial`` is the side after the last
    pool (7 for 224x224 inputs, ``image_size // 32`` in general); the
    flatten takes NHWC order. Call as ``model(images, train=None)``."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 spatial: int = 7, device=None, seed: int = 0) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        conv = functools.partial(Conv, bias=True, compute_dtype=compute_dtype,
                                 device=device)
        convs, cin = [], 3
        for filters, reps in _VGG16_STAGES:
            for _ in range(reps):
                convs.append(conv(cin, filters, 3))
                cin = filters
        self.convs = nn.ModuleList(convs)
        self.fcs = nn.ModuleList([
            nn.Linear(512 * spatial * spatial, 4096, device=device),
            nn.Linear(4096, 4096, device=device),
            nn.Linear(4096, num_classes, device=device)])
        _init(self, seed)

    def forward(self, x, train: Optional[bool] = None):
        del train
        dt = self.compute_dtype
        x = x.to(dt)
        convs = iter(self.convs)
        for _, reps in _VGG16_STAGES:
            for _ in range(reps):
                x = F.relu(next(convs)(x))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(self.fcs[0], x, dt))
        x = F.relu(_dense(self.fcs[1], x, dt))
        return self.fcs[2](x.float())


__all__ = ["GoogLeNet", "InceptionBlock", "VGG16"]
