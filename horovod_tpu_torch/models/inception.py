"""Inception V3 — the port of ``horovod_tpu/models/inception.py``
(Szegedy et al., 299x299 input; 75x75 is the smallest that reaches the
last block with a 1x1 grid).

Same function as the flax model, on NCHW tensors: every conv is followed
by the flax BatchNorm (eps 1e-3) and a ReLU (:class:`ConvBN`); SAME convs
pad as flax does (:class:`~._layers.Conv2d`); the 3x3 average pools pad
by one and count the padding, as flax's ``avg_pool(padding="SAME")``
does; the max pools and the stride-2 convs are VALID. bf16 compute over
fp32 parameters and statistics, an fp32 output. Each block keeps its
ConvBNs in ``convs`` in the order flax names them (``ConvBN_0``, ...:
the order the modules are built, outer before inner).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv2d, dense, init_weights


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU, the basic Inception cell."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=1, padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, stride,
                           padding, bias=False, dtype=dtype)
        self.bn = BatchNorm(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _convs(specs, dtype) -> nn.ModuleList:
    """ConvBNs from ``(in, out, kernel[, stride[, padding]])`` tuples."""
    return nn.ModuleList(ConvBN(*s, dtype=dtype) for s in specs)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype):
        super().__init__()
        self.convs = _convs(
            [(cin, 64, 1), (48, 64, 5), (cin, 48, 1), (96, 96, 3),
             (64, 96, 3), (cin, 64, 1), (cin, pool_features, 1)], dtype)

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[1](c[2](x)), c[3](c[4](c[5](x))),
                          c[6](_avg_pool_same(x))], dim=1)


class InceptionB(nn.Module):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, cin: int, dtype):
        super().__init__()
        self.convs = _convs(
            [(cin, 384, 3, 2, "VALID"), (96, 96, 3, 2, "VALID"),
             (64, 96, 3), (cin, 64, 1)], dtype)

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[1](c[2](c[3](x))),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    """17x17 blocks with factorised 7x7 (1x7 then 7x1) convolutions."""

    def __init__(self, cin: int, c7: int, dtype):
        super().__init__()
        self.convs = _convs(
            [(cin, 192, 1),
             (cin, c7, 1), (c7, c7, (1, 7)), (c7, 192, (7, 1)),
             (cin, c7, 1), (c7, c7, (7, 1)), (c7, c7, (1, 7)),
             (c7, c7, (7, 1)), (c7, 192, (1, 7)),
             (cin, 192, 1)], dtype)

    def forward(self, x):
        c = self.convs
        b2 = c[3](c[2](c[1](x)))
        b3 = c[8](c[7](c[6](c[5](c[4](x)))))
        return torch.cat([c[0](x), b2, b3, c[9](_avg_pool_same(x))], dim=1)


class InceptionD(nn.Module):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, cin: int, dtype):
        super().__init__()
        self.convs = _convs(
            [(192, 320, 3, 2, "VALID"), (cin, 192, 1),
             (cin, 192, 1), (192, 192, (1, 7)), (192, 192, (7, 1)),
             (192, 192, 3, 2, "VALID")], dtype)

    def forward(self, x):
        c = self.convs
        b2 = c[5](c[4](c[3](c[2](x))))
        return torch.cat([c[0](c[1](x)), b2, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """8x8 blocks with split 1x3/3x1 branches."""

    def __init__(self, cin: int, dtype):
        super().__init__()
        self.convs = _convs(
            [(cin, 320, 1),
             (cin, 384, 1), (384, 384, (1, 3)), (384, 384, (3, 1)),
             (cin, 448, 1), (448, 384, 3), (384, 384, (1, 3)),
             (384, 384, (3, 1)),
             (cin, 192, 1)], dtype)

    def forward(self, x):
        c = self.convs
        y = c[1](x)
        b2 = torch.cat([c[2](y), c[3](y)], dim=1)
        y = c[5](c[4](x))
        b3 = torch.cat([c[6](y), c[7](y)], dim=1)
        return torch.cat([c[0](x), b2, b3, c[8](_avg_pool_same(x))], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.convs = _convs(
            [(in_channels, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
             (32, 64, 3), (64, 80, 1, 1, "VALID"),
             (80, 192, 3, 1, "VALID")], dtype)
        # Block input widths: 192 after the stem, 256/288 after the
        # A blocks, 768 after B and each C, 1280 after D, 2048 after E.
        self.inception_a = nn.ModuleList([InceptionA(192, 32, dtype),
                                          InceptionA(256, 64, dtype),
                                          InceptionA(288, 64, dtype)])
        self.inception_b = nn.ModuleList([InceptionB(288, dtype)])
        self.inception_c = nn.ModuleList(InceptionC(768, c7, dtype)
                                         for c7 in (128, 160, 160, 192))
        self.inception_d = nn.ModuleList([InceptionD(768, dtype)])
        self.inception_e = nn.ModuleList([InceptionE(1280, dtype),
                                          InceptionE(2048, dtype)])
        self.head = nn.Linear(2048, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "InceptionV3":
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = x.to(self.dtype)
        x = c[2](c[1](c[0](x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(c[4](c[3](x)), 3, 2)
        for stage in (self.inception_a, self.inception_b, self.inception_c,
                      self.inception_d, self.inception_e):
            for block in stage:
                x = block(x)
        x = x.mean(dim=(2, 3))
        return dense(self.head, x, self.dtype).to(torch.float32)
