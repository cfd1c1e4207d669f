"""Gradient compression applied around allreduce.

Port of ``horovod_tpu/compression.py`` (the reference's
``torch/compression.py:20-74``): ``Compression.none``, ``Compression.fp16``
(floating tensors cross the wire in half precision) and
``Compression.bf16`` (bfloat16 keeps the f32 exponent).  ``decompress``
casts back to the dtype ``compress`` saw.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface (``torch/compression.py:20``)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default: no-op."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point() and tensor.dtype != cls.wire:
            tensor = tensor.to(cls.wire)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            tensor = tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Floating tensors cross the wire as fp16."""
    wire = torch.float16


class BF16Compressor(_CastCompressor):
    """Floating tensors cross the wire as bfloat16."""
    wire = torch.bfloat16


class Compression:
    """Option holder (``torch/compression.py:70-74``)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
