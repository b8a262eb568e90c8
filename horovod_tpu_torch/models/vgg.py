"""VGG — the port of ``horovod_tpu/models/vgg.py``: 3x3 SAME convs in
five stages (widths 64 to 512), each stage closed by a 2x2 max pool,
optional BatchNorm after each conv (the flax one,
:class:`~._layers.BatchNorm`), two dense 4096 layers with ReLU and
dropout 0.5 in training mode, and the head, cast to fp32. bf16 compute
over fp32 parameters. Images are NCHW (the JAX model takes NHWC); the
features are flattened in the JAX model's (H, W, C) order, so ``fc0``
holds the same kernel. ``image_size`` is given at construction, since
``fc0``'s width depends on it."""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv2d, dense, init_weights

# The number of 3x3 convs in each stage (VGG-16: 13 convs + 3 dense).
_CFG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}


class VGG(nn.Module):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = False,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.stages = []
        width_in = in_channels
        for stage, n_convs in enumerate(_CFG[depth]):
            width = min(64 * 2 ** stage, 512)
            names = []
            for i in range(n_convs):
                self.add_module(f"conv{stage}_{i}",
                                Conv2d(width_in, width, 3, dtype=dtype))
                if batch_norm:
                    self.add_module(f"bn{stage}_{i}", BatchNorm(width))
                names.append((f"conv{stage}_{i}",
                              f"bn{stage}_{i}" if batch_norm else None))
                width_in = width
            self.stages.append(names)
        side = image_size // 2 ** len(_CFG[depth])
        self.fc0 = nn.Linear(side * side * width_in, 4096)
        self.fc1 = nn.Linear(4096, 4096)
        self.head = nn.Linear(4096, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VGG":
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for names in self.stages:
            for conv, bn in names:
                x = getattr(self, conv)(x)
                if bn is not None:
                    x = getattr(self, bn)(x)
                x = F.relu(x)
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for fc in (self.fc0, self.fc1):
            x = F.dropout(F.relu(dense(fc, x, self.dtype)), 0.5,
                          self.training)
        return dense(self.head, x, self.dtype).to(torch.float32)


VGG11 = partial(VGG, depth=11)
VGG13 = partial(VGG, depth=13)
VGG16 = partial(VGG, depth=16)
VGG19 = partial(VGG, depth=19)
