"""ResNet v1.5 — the port of ``horovod_tpu/models/resnet.py``.

Same function as the flax model, on NCHW tensors (``channels_last``
memory works too): bottleneck blocks with the stride in the 3x3 conv,
flax's SAME padding (a stride-2 3x3 conv on an even size pads 0 before
and 1 after: :class:`~._layers.Conv2d`), bias-free convs, the flax
BatchNorm (:class:`~._layers.BatchNorm`: running statistics ``0.9 * old
+ 0.1 * batch`` from the biased batch variance, eps 1e-5, the last norm
of each block starting at scale 0), bf16 compute over fp32 parameters
and statistics, an fp32 output. Training mode (``model.train()``)
normalizes with the batch statistics and updates the running ones; eval
mode uses the running ones. The norm is local to each rank, as in the
JAX model; :class:`~..sync_batch_norm.SyncBatchNorm` is the cross-rank
one.

``space_to_depth=True`` is the JAX package's benchmark stem: the image
is rearranged 2x2 into 12 channels and a 4x4 stride-1 conv padded
``[(1, 2), (1, 2)]`` replaces the 7x7 stride-2 conv (even H, W only).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv2d, dense, init_weights


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        conv = partial(Conv2d, bias=False, dtype=dtype)
        self.conv1 = conv(in_channels, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, zero_init=True)
        self.conv_proj = self.norm_proj = None
        if in_channels != filters * 4 or stride != 1:
            self.conv_proj = conv(in_channels, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 space_to_depth: bool = False, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv_init = Conv2d(4 * in_channels, num_filters, 4, 1,
                                    ((1, 2), (1, 2)), bias=False,
                                    dtype=dtype)
        else:
            self.conv_init = Conv2d(in_channels, num_filters, 7, 2,
                                    ((3, 3), (3, 3)), bias=False,
                                    dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks, width = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(width, filters, stride, dtype))
                width = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(width, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """Seeded random weights in flax's initializer scales."""
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.space_to_depth:
            b, c, h, w = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem requires even H, W; got {h}x{w} "
                    "(pass space_to_depth=False for odd sizes)")
            # Channel order (row offset, column offset, channel), as the
            # JAX model's NHWC reshape makes it.
            x = x.reshape(b, c, h // 2, 2, w // 2, 2)
            x = x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return dense(self.head, x, self.dtype).to(torch.float32)


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
