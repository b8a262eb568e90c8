"""Small classifiers — the port of ``horovod_tpu/models/mlp.py`` (the
keras_mnist-equivalent workload): :class:`MLP` and the MNIST
:class:`ConvNet`. Images are NCHW (the JAX models take NHWC); the
ConvNet flattens in the JAX model's (H, W, C) order, so its dense layer
holds the same kernel. Input sizes are given at construction, since
flax infers them at init."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import Conv2d, dense, init_weights


class MLP(nn.Module):
    def __init__(self, in_features: int = 784,
                 features: Sequence[int] = (128, 64), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [in_features, *features, num_classes]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MLP":
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.layers[:-1]:
            x = F.relu(dense(layer, x, self.dtype))
        return dense(self.layers[-1], x, self.dtype)


class ConvNet(nn.Module):
    """Two 3x3 SAME convs (32, 64), a 2x2 max pool, dense 128, dense
    ``num_classes``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, image_size: int = 28,
                 in_channels: int = 1):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([Conv2d(in_channels, 32, 3, dtype=dtype),
                                    Conv2d(32, 64, 3, dtype=dtype)])
        side = image_size // 2
        self.layers = nn.ModuleList([nn.Linear(side * side * 64, 128),
                                     nn.Linear(128, num_classes)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ConvNet":
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(dense(self.layers[0], x, self.dtype))
        return dense(self.layers[1], x, self.dtype)
