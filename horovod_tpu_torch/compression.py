"""Gradient compression around the allreduce: ``Compression.none``,
``fp16`` and ``bf16``.

Counterpart of ``horovod_tpu/jax/compression.py`` (``Compressor``,
``check_reduce_safe``, ``NoneCompressor``, the cast compressors and the
``Compression`` namespace) in the torch idiom of Horovod's
``torch/compression.py``.  ``compress`` returns ``(wire, ctx)`` and
``decompress(wire, ctx)`` undoes it.  A floating tensor rides the wire in
the compressor's dtype and comes back in its own; any other tensor rides
untouched with ``ctx`` None, and decompress is then the identity (the
JAX semantics: a dtype ctx would re-cast it on the way out).

The quantizing codecs (int8, fp8, error feedback) are not ported yet.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress(tensor) -> (compressed, ctx)``;
    ``decompress(compressed, ctx)`` undoes it."""

    #: True when the wire tensor may be handed to a plain summing
    #: collective (compress -> allreduce -> decompress).  A quantizing
    #: codec is not: its wire values do not add.
    reduce_safe = True

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


def check_reduce_safe(compression, where: str):
    """Reject, before any collective runs, a codec whose wire tensors
    must not be summed across ranks."""
    if not getattr(compression, "reduce_safe", True):
        label = getattr(compression, "__name__", type(compression).__name__)
        raise ValueError(
            "%s cannot use %s: the %s bracket allreduces the wire tensor, "
            "and quantized wire tensors must never meet reduction "
            "arithmetic; pass Compression.fp16 or Compression.bf16 here"
            % (where, label, where))


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating_point:
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
    """``Compression.none``, ``Compression.fp16``, ``Compression.bf16``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
