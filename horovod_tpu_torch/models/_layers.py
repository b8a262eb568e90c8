"""Layers shared by the port's models, with the numerics of the flax
layers the JAX package's models use.

* :func:`dense` and :func:`layer_norm` — ``nn.Dense(dtype=,
  param_dtype=float32)`` and ``nn.LayerNorm`` (eps 1e-6, statistics in
  fp32);
* :class:`Conv2d` — ``nn.Conv`` on NCHW tensors, with flax's padding
  rules: ``"SAME"`` pads ``max((out - 1) * stride + k - in, 0)`` with the
  smaller half before, so a stride-2 SAME conv on an even size pads 0
  before and 1 after (PyTorch's symmetric ``padding=1`` would sample
  windows shifted by one pixel and still run);
* :class:`BatchNorm` — ``nn.BatchNorm(momentum=0.9)``: batch statistics
  in training mode with the running ones updated ``0.9 * old + 0.1 *
  batch`` from the BIASED batch variance, running statistics in eval
  mode (``nn.BatchNorm2d`` keeps the unbiased variance, so its eval
  outputs differ);
* :func:`init_weights` — seeded random weights in flax's initializer
  scales.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6               # flax nn.LayerNorm's default epsilon

Padding = Union[str, Sequence[Tuple[int, int]]]


def dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: statistics and scale in fp32,
    output in the compute dtype."""
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape,
                        ln.weight, ln.bias, ln.eps).to(dtype)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dimension: the output
    has ``ceil(size / stride)`` positions and the padding's smaller half
    goes before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW tensors: ``padding`` is ``"SAME"``,
    ``"VALID"`` or explicit ``((top, bottom), (left, right))``; input,
    kernel and bias are cast to ``dtype`` (None: the input's dtype)."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=1, padding: Padding = "SAME", bias: bool = True,
                 dtype=None):
        super().__init__(in_channels, out_channels, kernel, stride,
                         padding=0, bias=bias)
        self.flax_padding = padding
        self.dtype = dtype

    def pads(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        if self.flax_padding == "VALID":
            return (0, 0), (0, 0)
        if self.flax_padding == "SAME":
            return tuple(same_padding(n, k, s) for n, k, s in zip(
                (h, w), self.kernel_size, self.stride))
        return tuple(tuple(p) for p in self.flax_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        (top, bottom), (left, right) = self.pads(*x.shape[-2:])
        padding = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                        self.stride, padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=eps)`` over dim 1 of an
    (N, C, ...) tensor: statistics in fp32, output in the input's dtype.
    ``zero_init`` marks a norm whose scale flax initialises to zero."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9, zero_init: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        # One fused pass: with momentum 1 the scratch buffers receive the
        # batch mean and the UNBIASED batch variance; the output is
        # normalized by the biased one, as flax's is.
        c = x.shape[1]
        mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        var = torch.zeros(c, dtype=torch.float32, device=x.device)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // c
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var * ((n - 1) / n),
                                          alpha=1 - m)
        return y


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in flax's initializer scales: dense and conv
    kernels N(0, 1/fan_in), embeddings N(0, 1/width), zero biases, unit
    norm scales (zero where a :class:`BatchNorm` says ``zero_init``).
    ``generator`` must live on the parameters' device."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.embedding_dim ** -0.5,
                                  generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(0.0 if module.zero_init else 1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
