"""Gradient compression on the reduce path — the port of
``horovod_tpu/ops/compression.py``'s cast compressors.

``Compression.fp16``/``bf16`` cast float32/float64 tensors to the wire
dtype before the allreduce and back after it; other dtypes ride as they
are. The int8 wire formats (``int8``, ``int8_ef``, with the stochastic
quantizer K3) come with the multi-rank slice of the port.
"""

from __future__ import annotations

import torch

_INT8_SLICE = ("int8 gradient compression is not ported yet; it comes "
               "with the multi-rank int8_ef slice of the port (kernel K3)")


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


class Compression:
    """Namespace mirroring ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @staticmethod
    def by_name(name):
        if name in (None, "none"):
            return NoneCompressor
        if name in ("fp16", "float16"):
            return FP16Compressor
        if name in ("bf16", "bfloat16"):
            return BF16Compressor
        if name in ("int8", "int8_ef", "int8ef"):
            raise NotImplementedError(_INT8_SLICE)
        raise ValueError(f"unknown compression: {name}")
