"""ResNet family and AlexNet (the port of
``chainermn_tpu/models/resnet.py``), with the reference's numerics:

- float32 parameters, convolutions in ``compute_dtype`` (bf16 by
  default), BatchNorm statistics in float32, a float32 head over the
  spatial mean;
- flax's ``padding='SAME'``, which pads strided windows asymmetrically
  (``lo = total // 2``, the rest after), with -inf for max pooling;
- v1.5 downsampling (the stride on the 3x3 convolution) and the last
  BatchNorm scale of every block initialised to zero;
- flax's initialisers: truncated-normal ``lecun_normal`` kernels, zero
  biases.

Activations are NCHW tensors; feed them ``channels_last`` in memory
(:func:`chainermn_torch.interop.images_from_nhwc` makes that view of
NHWC images without a copy) so cuDNN runs its NHWC tensor-core
convolutions. ``norm`` is a factory ``norm(num_features, **kw)``; the
multi-node one is ``functools.partial(MultiNodeBatchNormalization,
communicator=comm)``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch._device import resolve_device
from chainermn_torch.links.batch_normalization import BatchNorm

# flax lecun_normal: a normal truncated at 2 std, scaled back to unit
# variance by the truncated distribution's std
_TRUNC_STD = 0.87962566103423978


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one spatial axis: the output has
    ``ceil(n / s)`` positions; the extra row goes after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    w.copy_(t * std)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=s, padding='SAME',
    dtype=compute_dtype)``; weight ``[out, in, k, k]`` (OIHW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, *, bias: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.compute_dtype = compute_dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel, **f32))
        self.bias = (nn.Parameter(torch.zeros(out_channels, **f32))
                     if bias else None)

    def forward(self, x):
        (th, bh), (lw, rw) = (same_pads(n, self.kernel, self.stride)
                              for n in x.shape[2:])
        dt = self.compute_dtype
        # the cast writes the layout cuDNN's NHWC convolutions read
        w = self.weight.to(dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        if th != bh or lw != rw:
            x = F.pad(x, (lw, rw, th, bh))
            th = lw = 0
        return F.conv2d(x.to(dt), w, b, self.stride, (th, lw))


def max_pool_same(x, k: int, s: int):
    """flax ``nn.max_pool(x, (k, k), strides=(s, s), padding='SAME')``:
    the padding is -inf, so it never wins."""
    (th, bh), (lw, rw) = (same_pads(n, k, s) for n in x.shape[2:])
    if th or bh or lw or rw:
        x = F.pad(x, (lw, rw, th, bh), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), projection shortcut when the
    shape changes (``resnet.py:28-49``)."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int,
                 conv: Callable, norm: Callable) -> None:
        super().__init__()
        out = filters * 4
        self.conv0, self.norm0 = conv(in_channels, filters, 1), norm(filters)
        self.conv1 = conv(filters, filters, 3, strides)
        self.norm1 = norm(filters)
        self.conv2, self.norm2 = conv(filters, out, 1), norm(out,
                                                             scale_init=0.0)
        self.downsample = self.downsample_norm = None
        if in_channels != out or strides != 1:
            self.downsample = conv(in_channels, out, 1, strides)
            self.downsample_norm = norm(out)

    def forward(self, x, train: bool = True):
        ra = not train
        y = F.relu(self.norm0(self.conv0(x), ra))
        y = F.relu(self.norm1(self.conv1(y), ra))
        y = self.norm2(self.conv2(y), ra)
        if self.downsample is not None:
            x = self.downsample_norm(self.downsample(x), ra)
        return F.relu(y + x)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3, projection shortcut when the shape changes
    (``resnet.py:52-71``)."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int,
                 conv: Callable, norm: Callable) -> None:
        super().__init__()
        self.conv0 = conv(in_channels, filters, 3, strides)
        self.norm0 = norm(filters)
        self.conv1 = conv(filters, filters, 3)
        self.norm1 = norm(filters, scale_init=0.0)
        self.downsample = self.downsample_norm = None
        if in_channels != filters or strides != 1:
            self.downsample = conv(in_channels, filters, 1, strides)
            self.downsample_norm = norm(filters)

    def forward(self, x, train: bool = True):
        ra = not train
        y = F.relu(self.norm0(self.conv0(x), ra))
        y = self.norm1(self.conv1(y), ra)
        if self.downsample is not None:
            x = self.downsample_norm(self.downsample(x), ra)
        return F.relu(y + x)


class ResNet(nn.Module):
    """The reference's ``ResNet`` (``resnet.py:74-127``). Call as
    ``model(images, train=None)`` with ``[N, 3, H, W]`` images; ``train``
    defaults to ``self.training`` and picks batch statistics (True) or
    the running averages. ``stem``: ``'conv7'`` (7x7/2) or
    ``'space_to_depth'`` (2x2 space-to-depth, then 4x4/1).

    Parameters are created on ``device`` (the current CUDA card when
    ``None``; raises when there is none — pass ``device="cpu"``) from
    ``torch.Generator().manual_seed(seed)``, drawn on the CPU so a seed
    gives the same weights on every device."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: type = BottleneckBlock, num_classes: int = 1000,
                 width: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm: Optional[Callable] = None, stem: str = "conv7", *,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        device = resolve_device(device)
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stem, self.compute_dtype = stem, compute_dtype
        if norm is None:
            norm = functools.partial(BatchNorm, momentum=0.9, eps=1e-5,
                                     dtype=compute_dtype)
        conv = functools.partial(Conv, compute_dtype=compute_dtype,
                                 device=device)
        norm = functools.partial(norm, device=device)
        if stem == "conv7":
            self.stem_conv = conv(3, width, 7, 2)
        else:
            self.stem_conv = conv(12, width, 4, 1)
        self.stem_norm = norm(width)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = width * 2 ** i
                blocks.append(block(cin, filters, 2 if i > 0 and j == 0
                                    else 1, conv, norm))
                cin = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initialisers from ``seed``: lecun-normal convolution and
        head kernels, zero head bias; BatchNorm keeps its own init."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, Conv):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        _lecun_normal_(self.head.weight, self.head.in_features, gen)
        self.head.bias.zero_()

    def forward(self, x, train: Optional[bool] = None):
        train = self.training if train is None else train
        x = x.to(self.compute_dtype)
        if self.stem == "space_to_depth":
            n, c, h, w = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"space_to_depth stem needs even H/W, got "
                                 f"{(h, w)}")
            # channel (dy * 2 + dx) * C + c, as the reference's NHWC
            # reshape orders it
            x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
            x = x.reshape(n, 4 * c, h // 2, w // 2).contiguous(
                memory_format=torch.channels_last)
        x = F.relu(self.stem_norm(self.stem_conv(x), not train))
        x = max_pool_same(x, 3, 2)
        for blk in self.blocks:
            x = blk(x, train)
        return self.head(x.mean((2, 3)).float())


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block=BottleneckBlock)


def _dense(lin: nn.Linear, x, dt):
    """flax ``Dense(dtype=dt)``: input, kernel and bias cast to ``dt``."""
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


class AlexNet(nn.Module):
    """The reference's ``AlexNet`` (``resnet.py:137-159``): five biased
    SAME convolutions, VALID 3x3/2 max pools, two 4096-wide layers and a
    float32 head. The flatten before the first dense layer takes NHWC
    order, so converted flax weights line up. Sized for 224x224
    inputs; ``in_features`` of ``fc0`` is ``256 * 6 * 6``, give
    ``spatial`` for other sizes (the side after the last pool)."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 spatial: int = 6, device=None, seed: int = 0) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        conv = functools.partial(Conv, bias=True, compute_dtype=compute_dtype,
                                 device=device)
        self.convs = nn.ModuleList([
            conv(3, 64, 11, 4), conv(64, 192, 5), conv(192, 384, 3),
            conv(384, 256, 3), conv(256, 256, 3)])
        self.fcs = nn.ModuleList([
            nn.Linear(256 * spatial * spatial, 4096, device=device),
            nn.Linear(4096, 4096, device=device),
            nn.Linear(4096, num_classes, device=device)])
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for c in self.convs:
                _lecun_normal_(c.weight, c.weight[0].numel(), gen)
            for fc in self.fcs:
                _lecun_normal_(fc.weight, fc.in_features, gen)
                fc.bias.zero_()

    def forward(self, x, train: Optional[bool] = None):
        del train   # no BatchNorm, no dropout
        dt = self.compute_dtype
        x = x.to(dt)
        for i, c in enumerate(self.convs):
            x = F.relu(c(x))
            if i in (0, 1, 4):
                x = F.max_pool2d(x, 3, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(self.fcs[0], x, dt))
        x = F.relu(_dense(self.fcs[1], x, dt))
        return self.fcs[2](x.float())


__all__ = ["Conv", "BottleneckBlock", "BasicBlock", "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet101", "ResNet152", "AlexNet",
           "same_pads", "max_pool_same"]
