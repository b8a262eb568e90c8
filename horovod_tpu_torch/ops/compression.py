"""Gradient compression — the port of ``horovod_tpu/ops/compression.py``.

``Compression.fp16``/``bf16`` cast float32/float64 tensors to the wire
dtype before the allreduce and back after it; other dtypes ride as they
are. ``Compression.int8`` is the block-scaled int8 wire format (K2/K4),
which cannot ride a sum; ``Compression.int8_ef`` declares the quantized
reduction with error feedback (``collectives.quantized_allreduce`` on
K3), which ``DistributedOptimizer`` dispatches on by its class
attributes.
"""

from __future__ import annotations

import torch

from . import kernels


class Compressor:
    """``compress(t) -> (wire, ctx)``; ``decompress(wire, ctx) -> t``."""

    reduce_safe = True

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype in (torch.float32, torch.float64):
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """Block-scaled int8 wire format (K2/K4): ``compress`` gives
    ``((q, scales), (n, shape, dtype))``. Not reduce-safe: per-block
    scales do not commute with summation, so it serves broadcast and
    gather wires; on the reduce path use :class:`Int8EFCompressor`."""

    reduce_safe = False

    @staticmethod
    def compress(tensor):
        q, scales, n = kernels.quantize_int8(tensor.contiguous())
        return (q, scales), (n, tuple(tensor.shape), tensor.dtype)

    @staticmethod
    def decompress(tensor, ctx):
        q, scales = tensor
        n, shape, dtype = ctx
        return kernels.dequantize_int8(q, scales, n, shape, dtype)


class Int8EFCompressor(Int8Compressor):
    """Reduce-safe int8 with error feedback. The reduction itself becomes
    ``collectives.quantized_allreduce`` (stochastically rounded int8
    chunks through K3, reduce-scatter, fp32 accumulate, requantize,
    all-gather), and the local quantization error is carried by the
    optimizer and added to the next step's gradient. ``compress`` /
    ``decompress`` stay the plain wire format; the reduce path dispatches
    on the attributes below instead."""

    reduce_safe = True
    quantized_reduce = True
    error_feedback = True


def _check_reduce_safe(compression) -> None:
    """Raise for a compressor whose wire cannot ride a sum."""
    if not getattr(compression, "reduce_safe", True):
        raise ValueError(
            f"{compression.__name__} is a wire-format compressor (per-block "
            "scales don't commute with summation) and cannot ride the "
            "gradient reduction directly; use a reduce-safe compression "
            "instead — Compression.int8_ef (quantized allreduce with error "
            "feedback, same 4x wire win) or Compression.fp16 / bf16 (cast)")


class Compression:
    """Namespace mirroring ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int8_ef = Int8EFCompressor

    @staticmethod
    def by_name(name):
        if name in (None, "none"):
            return NoneCompressor
        if name in ("fp16", "float16"):
            return FP16Compressor
        if name in ("bf16", "bfloat16"):
            return BF16Compressor
        if name == "int8":
            return Int8Compressor
        if name in ("int8_ef", "int8ef"):
            return Int8EFCompressor
        raise ValueError(f"unknown compression: {name}")
