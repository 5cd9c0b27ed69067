"""Gradient compression by casting — counterpart of
``horovod_tpu/ops/compression.py``.

``Compression.none`` / ``fp16`` / ``bf16``: a floating tensor is cast to the
wire dtype before the collective and back after.  ``Compression.int8`` is
a wire format, not a cast: the collectives route it to
``collective_ops.quantized_grouped_allreduce`` (per-tensor scales, error
feedback in ``DistributedOptimizer``), and its ``compress`` raises.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress(tensor) -> (tensor, ctx)``;
    ``decompress(tensor, ctx)``."""

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
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if ctx.is_floating_point and ctx != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """float16 wire format."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 wire format."""

    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """int8 wire marker: the collectives quantize with per-tensor scales
    (``core/qwire.py``); it is not a cast."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError(
            "Compression.int8 is a quantized wire format: pass it to "
            "allreduce / DistributedOptimizer, which route it to "
            "quantized_grouped_allreduce")

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError("Compression.int8 is a quantized wire "
                                  "format, not a cast")


class Compression:
    """Registry of the compressors."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
