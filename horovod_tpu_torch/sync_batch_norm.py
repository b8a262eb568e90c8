"""SyncBatchNorm — the port of ``horovod_tpu/torch/sync_batch_norm.py``:
batch normalization whose training-mode statistics are those of the
GLOBAL batch, every rank's shard together.

PyTorch's BatchNorm semantics (``momentum`` 0.1 on the new value, the
running variance unbiased with the global count). The forward packs
each rank's per-channel sums, sums of squares and element count into one
Sum allreduce (``sync_batch_norm.moments``), the backward its sums of
``dy`` and ``dy * (x - mean)`` into another
(``sync_batch_norm.grad_moments``); both go through the eager engine
(``hvd.allreduce``: NCCL or gloo), uncompressed so that the moments are
exact sums whatever ``init(compression=)`` says. Eval mode uses the
running statistics and no collective; a world of one rank reduces
nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import Function
from torch.nn.modules.batchnorm import _BatchNorm

from .common import basics
from .ops.collectives import Sum
from .ops.compression import Compression


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1, ...) for broadcasting over an ndim input."""
    return t.view(1, -1, *([1] * (ndim - 2)))


def _sum_over_ranks(t: torch.Tensor, name: str) -> torch.Tensor:
    if basics.size() == 1:
        return t
    from . import allreduce

    return allreduce(t, op=Sum, name=name, compression=Compression.none)


class SyncBatchNorm(_BatchNorm):
    """Applies synchronized batch normalization: statistics are computed
    over the global batch (all ranks), not the per-rank shard."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        self._check_input_dim(input)
        if self.training and self.track_running_stats:
            self.num_batches_tracked = self.num_batches_tracked + 1
        if not self.training and self.track_running_stats:
            return F.batch_norm(input, self.running_mean, self.running_var,
                                self.weight, self.bias, False, self.momentum,
                                self.eps)
        return _SyncBatchNorm.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, self.momentum)


class _SyncBatchNorm(Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var,
                eps, momentum):
        input = input.contiguous()
        dims = [0] + list(range(2, input.dim()))
        n_local = float(input.numel() // input.size(1))
        local = torch.cat([input.sum(dim=dims),
                           (input * input).sum(dim=dims),
                           torch.tensor([n_local], dtype=input.dtype,
                                        device=input.device)])
        total = _sum_over_ranks(local, "sync_batch_norm.moments")
        c = input.size(1)
        count = total[-1]
        mean = total[:c] / count
        var = total[c:2 * c] / count - mean * mean
        invstd = torch.rsqrt(var + eps)

        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * (count / (count - 1.0).clamp_min(1.0))
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)

        ctx.save_for_backward(input, weight, mean, invstd, count.reshape(1))
        nd = input.dim()
        out = (input - _channel_view(mean, nd)) * _channel_view(invstd, nd)
        if weight is not None:
            out = out * _channel_view(weight, nd) + _channel_view(bias, nd)
        return out

    @staticmethod
    def backward(ctx, grad_output):
        grad_output = grad_output.contiguous()
        saved_input, weight, mean, invstd, count = ctx.saved_tensors
        need_input, need_weight, need_bias = ctx.needs_input_grad[0:3]
        nd = saved_input.dim()
        dims = [0] + list(range(2, nd))
        xmu = saved_input - _channel_view(mean, nd)
        sum_dy = grad_output.sum(dim=dims)
        sum_dy_xmu = (grad_output * xmu).sum(dim=dims)
        grad_weight = sum_dy_xmu * invstd if need_weight else None
        grad_bias = sum_dy.clone() if need_bias else None

        grad_input = None
        if need_input:
            c = sum_dy.numel()
            packed = _sum_over_ranks(torch.cat([sum_dy, sum_dy_xmu]),
                                     "sync_batch_norm.grad_moments")
            g_dy = packed[:c] / count
            g_dy_xmu = packed[c:] / count
            scale = invstd if weight is None else invstd * weight
            grad_input = (
                grad_output - _channel_view(g_dy, nd)
                - xmu * _channel_view(invstd * invstd * g_dy_xmu, nd)
            ) * _channel_view(scale, nd)

        if weight is None:
            grad_weight = grad_bias = None
        return grad_input, grad_weight, grad_bias, None, None, None, None
