"""Fused scale and sum, ``alpha * a + beta * b``: the hand-written CUDA
kernel, its plain version and the dispatcher.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py`` ``fused_scale_sum``
(``_scale_sum_kernel``): both operands widened to f32, two multiplies and
one add, the result cast to ``a``'s dtype, for f32, bf16 and f16.  The
reference pads the flat buffer to 4096 x 128 tiles; the kernel takes any
length and pads nothing.  A Python ``alpha`` or ``beta`` is rounded to
f32 first, as JAX rounds a weakly typed scalar; either may instead be an
f32 tensor of one element on ``a``'s device (Adasum's coefficients), which
the kernel reads on the device, so nothing crosses to the host.

``scale_sum_kernel`` launches ``csrc/scale_sum.cu`` and counts its
launches in ``.launches``; it raises on a tensor that is not on CUDA, not
contiguous, or not of one of the three dtypes.  ``scale_sum_plain`` is
the plain PyTorch version in the kernel's order of rounded f32
operations, so the two agree bit for bit.  ``fused_scale_sum`` takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"hvd_scale_sum": [_P, _P, _P, ctypes.c_longlong, _I, _F, _F,
                                 _P, _P, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    return _build.load("scale_sum", _SIGNATURES)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32."""
    return torch.tensor(float(x), dtype=torch.float32).item()


def _check_operands(name: str, a, b):
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError("%s takes two f32, bf16 or f16 tensors of one dtype, "
                         "got %s and %s" % (name, a.dtype, b.dtype))
    if a.numel() != b.numel():
        raise ValueError("%s takes two tensors of one size, got %d and %d "
                         "elements" % (name, a.numel(), b.numel()))


def _coefficients(name: str, a, alpha, beta):
    """-> (alpha, beta) as f32-rounded floats, or as one-element f32
    tensors on a's device (both or neither)."""
    tensors = [isinstance(c, torch.Tensor) for c in (alpha, beta)]
    if not any(tensors):
        return _f32(alpha), _f32(beta)
    if not all(tensors):
        raise ValueError("%s takes alpha and beta both as floats or both as "
                         "tensors" % name)
    for c in (alpha, beta):
        if c.dtype != torch.float32 or c.numel() != 1 \
                or c.device != a.device:
            raise ValueError("%s takes tensor coefficients as one f32 value "
                             "on the operands' device, got %s %s on %s"
                             % (name, c.dtype, tuple(c.shape), c.device))
    return alpha, beta


def scale_sum_plain(a, b, alpha=1.0, beta=1.0):
    """``(alpha * f32(a) + beta * f32(b))`` cast to a's dtype, in a's
    shape: two rounded f32 multiplies, then one rounded f32 add."""
    _check_operands("scale_sum_plain", a, b)
    alpha, beta = _coefficients("scale_sum_plain", a, alpha, beta)
    if isinstance(alpha, torch.Tensor):
        alpha, beta = alpha.reshape(()), beta.reshape(())
    out = a.float() * alpha + b.reshape(a.shape).float() * beta
    return out.to(a.dtype)


def scale_sum_kernel(a, b, alpha=1.0, beta=1.0):
    """CUDA ``alpha * a + beta * b`` (``csrc/scale_sum.cu``), in a's dtype
    and shape."""
    _check_operands("scale_sum_kernel", a, b)
    for t in (a, b):
        if not t.is_cuda:
            raise ValueError("scale_sum_kernel launches a CUDA kernel; got a "
                             "tensor on %s" % t.device)
        if not t.is_contiguous():
            raise ValueError("scale_sum_kernel takes contiguous tensors")
    if b.device != a.device:
        raise ValueError("scale_sum_kernel takes tensors on one device")
    alpha, beta = _coefficients("scale_sum_kernel", a, alpha, beta)
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    if a.numel() == 0:
        return out
    if isinstance(alpha, torch.Tensor):
        scalars, ptrs = (1.0, 1.0), (alpha.data_ptr(), beta.data_ptr())
    else:
        scalars, ptrs = (alpha, beta), (None, None)
    _build.check(_lib().hvd_scale_sum(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), _DTYPES[a.dtype],
        *scalars, *ptrs,
        torch.cuda.current_stream(a.device).cuda_stream), "scale_sum_kernel")
    scale_sum_kernel.launches += 1
    return out


KERNELS = (scale_sum_kernel,)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for kern in KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def fused_scale_sum(a, b, alpha=1.0, beta=1.0):
    """``alpha * a + beta * b`` in a's dtype: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if a.device.type == "cpu":
        return scale_sum_plain(a, b, alpha, beta)
    return scale_sum_kernel(a, b, alpha, beta)
