"""Gradient compression: ``Compression.none``, ``fp16``, ``bf16``, and the
quantizing wire codecs ``int8`` and ``fp8`` with ``ErrorFeedback``.

Counterpart of ``horovod_tpu/jax/compression.py`` in the torch idiom of
Horovod's ``torch/compression.py``.  ``compress`` returns ``(wire, ctx)``
and ``decompress(wire, ctx)`` undoes it.  A floating tensor rides the
wire in the compressor's dtype and comes back in its own; any other
tensor rides untouched with ``ctx`` None, and decompress is then the
identity (the JAX semantics: a dtype ctx would re-cast it on the way
out).  Every function runs on the tensor's own device and never reads a
value back to the host.

The quantizing codecs (``reduce_safe = False``) belong on the
hierarchical cross-node leg (``HOROVOD_CROSS_HOST_COMPRESSION``,
``ops/multihost.py``), which dequantizes before any arithmetic; a
bracket that sums wire tensors (``DistributedOptimizer``) refuses them.
``Int8Quantizer`` and ``ScaledFP8Quantizer`` take one absmax scale per
row of the leading axis (one for a 1-D tensor); ``FP8Compressor`` is a
plain e4m3 cast that, as the reference's ``astype`` does, gives NaN past
e4m3's range on every device (torch's vectorised CPU cast saturates at
448 there; its CUDA cast gives NaN).
"""

from __future__ import annotations

import collections

import torch

FP8_WIRE_DTYPE = torch.float8_e4m3fn
# Largest finite e4m3 value; a cast rounds up to NaN past E4M3_NAN_ABOVE
# (the midpoint between 448 and the NaN encoding's 480).
E4M3_MAX = 448.0
E4M3_NAN_ABOVE = 464.0


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
            "arithmetic (int8 wraps, per-rank scales differ).  Set "
            "HOROVOD_CROSS_HOST_COMPRESSION=%s for quantized reductions "
            "(dequantized before any arithmetic, with error feedback), or "
            "pass Compression.fp16 or Compression.bf16 here"
            % (where, label, where,
               getattr(compression, "codec_name", "int8")))


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


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to e4m3, NaN (0x7F, 0xFF with the sign) where the cast
    overflows: past ``E4M3_NAN_ABOVE``, an infinity or a NaN, as the
    reference's ``astype`` gives.  torch's vectorised CPU cast saturates
    those at +-448."""
    wire = x.to(FP8_WIRE_DTYPE).view(torch.uint8)
    nan = torch.signbit(x).to(torch.uint8).bitwise_left_shift(7) \
        .bitwise_or_(0x7F)
    overflow = ~(x.abs() <= E4M3_NAN_ABOVE)  # NaN compares False
    return torch.where(overflow, nan, wire).view(FP8_WIRE_DTYPE)


def _absmax_scale(xf: torch.Tensor, top: float) -> torch.Tensor:
    """Per-row absmax over ``top`` (one scalar for a 1-D tensor), f32;
    an all-zero row keeps scale 1/top so that 0 round-trips."""
    amax = (xf.abs().amax(dim=tuple(range(1, xf.dim())), keepdim=True)
            if xf.dim() > 1 else xf.abs().max())
    # A divisor on the tensor's device: CUDA divides by a Python scalar
    # through its reciprocal, which rounds differently from the division
    # the reference (and the CPU) computes.
    return (torch.where(amax > 0, amax, torch.ones_like(amax))
            / torch.full_like(amax, top))


class _AbsmaxQuantizer(Compressor):
    """Symmetric absmax quantization per row of the leading axis onto
    ``[-top, top]``: ``ctx`` is ``(scale, dtype)``, the math in f32
    whatever the payload dtype.  A subclass sets ``top`` and
    ``quantize(xf, scale)``, the step after the scale, which a caller
    that computes the scale itself also uses."""

    reduce_safe = False
    top: float = None

    @staticmethod
    def quantize(xf, scale):
        raise NotImplementedError

    @classmethod
    def compress(cls, tensor):
        if not tensor.dtype.is_floating_point:
            return tensor, None
        xf = tensor.float()
        scale = _absmax_scale(xf, cls.top)
        return cls.quantize(xf, scale), (scale, tensor.dtype)

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        scale, dtype = ctx
        return (tensor.float() * scale).to(dtype)


class Int8Quantizer(_AbsmaxQuantizer):
    """int8: ``rint``, clipped at +-127."""

    codec_name = "int8"
    top = 127.0

    @staticmethod
    def quantize(xf, scale):
        return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)


class FP8Compressor(Compressor):
    """The plain e4m3 cast (``to_e4m3``): NaN past +-464, as in the
    reference; the engine's wire uses ``ScaledFP8Quantizer``."""

    reduce_safe = False
    codec_name = "fp8"

    @staticmethod
    def compress(tensor):
        if not tensor.dtype.is_floating_point:
            return tensor, None
        return to_e4m3(tensor), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class ScaledFP8Quantizer(_AbsmaxQuantizer):
    """e4m3 with each row's absmax scaled onto ``E4M3_MAX``: in range for
    any finite payload."""

    codec_name = "fp8"
    top = E4M3_MAX

    @staticmethod
    def quantize(xf, scale):
        return to_e4m3(xf / scale)


class ResidualLRU(collections.OrderedDict):
    """f32 residuals by key; past ``cap`` entries the least recently used
    goes."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = max(int(cap), 1)

    def take(self, key, shape):
        """The residual of ``key`` if it has ``shape`` (it becomes the
        most recent), else None."""
        res = self.get(key)
        if res is None or tuple(res.shape) != tuple(shape):
            return None
        self.move_to_end(key)
        return res

    def put(self, key, res):
        self[key] = res
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


class ErrorFeedback:
    """Compress ``tensor + residual[bucket]`` and keep ``residual =
    compensated - dequantized(sent)`` for the bucket's next step (EF-SGD):
    quantization error is delayed, never lost.  Residuals are f32 on the
    tensor's device, in an LRU of ``max_buckets``; ``ctx`` names the
    caller's dtype, so decompress round-trips bf16 to bf16."""

    def __init__(self, compressor, max_buckets: int = 64):
        self.compressor = compressor
        # As safe in a summing bracket as the wire it wraps.
        self.reduce_safe = getattr(compressor, "reduce_safe", True)
        self.codec_name = getattr(compressor, "codec_name", "int8")
        self._residuals = ResidualLRU(max_buckets)

    def compress(self, tensor, bucket=None):
        if not tensor.dtype.is_floating_point:
            # A discrete payload rides untouched and keeps no residual.
            return self.compressor.compress(tensor)
        key = bucket if bucket is not None else (
            tuple(tensor.shape), str(tensor.dtype))
        comp = tensor.float()
        res = self._residuals.take(key, comp.shape)
        if res is not None:
            comp = comp + res
        wire, ctx = self.compressor.compress(comp)
        if ctx is None:
            return wire, ctx
        ctx = ((ctx[0], tensor.dtype) if isinstance(ctx, tuple)
               else tensor.dtype)
        sent = self.compressor.decompress(wire, ctx)
        self._residuals.put(key, comp - sent.float())
        return wire, ctx

    def decompress(self, tensor, ctx):
        return self.compressor.decompress(tensor, ctx)

    def reset(self):
        self._residuals.clear()


class Compression:
    """``Compression.none``, ``fp16``, ``bf16``, and the quantizing
    ``int8`` and ``fp8``, which only the hierarchical wire takes."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Quantizer
    fp8 = FP8Compressor
