"""Adasum: scale-insensitive merging of gradients.

Counterpart of ``horovod_tpu/utils/adasum.py``.  A pair merges as

    adasum(a, b) = (1 - <a,b> / (2 |a|^2)) a + (1 - <a,b> / (2 |b|^2)) b

with the three dot products in f32, each denominator floored at 1e-30 (so
all-zero inputs give a zero result, not NaN), and the combine done by
``fused_scale_sum`` (the CUDA kernel for CUDA tensors) with the two
coefficients left on the device, then cast to a's dtype.  A world of
ranks merges in a recursive-halving tree, which needs a power-of-two
count.  On the card a merge makes no host synchronisation.
"""

from __future__ import annotations

import torch

from ..ops.scale_sum import fused_scale_sum


def adasum_pair(a: torch.Tensor, b: torch.Tensor,
                scale_sum=fused_scale_sum) -> torch.Tensor:
    """Merge two tensors of one shape with the Adasum rule; the result is
    in a's dtype and shape.  Symmetric bit for bit: ``adasum_pair(a, b)``
    equals ``adasum_pair(b, a)`` for tensors of one dtype.  ``scale_sum``
    computes ``alpha * a + beta * b`` (``scale_sum_plain`` to hold the
    kernel against its plain version)."""
    af, bf = a.reshape(-1).float(), b.reshape(-1).float()
    dot = torch.dot(af, bf)
    norms = torch.stack([torch.dot(af, af), torch.dot(bf, bf)])
    coef = 1.0 - dot / torch.clamp_min(2.0 * norms, 1e-30)
    return scale_sum(a, b, coef[0], coef[1])


def check_power_of_two(n: int):
    if n < 1 or n & (n - 1):
        raise ValueError(
            "Adasum requires a power-of-two number of ranks (got %d), as "
            "in the reference's recursive-halving implementation" % n)


def adasum_reduce_stacked(stacked: torch.Tensor,
                          scale_sum=fused_scale_sum) -> torch.Tensor:
    """Reduce a rank-major stacked ``[size, ...]`` tensor with Adasum: the
    halving tree, row i merged with row i + size/2 at each level."""
    check_power_of_two(stacked.shape[0])
    rows = list(stacked.unbind(0))
    while len(rows) > 1:
        half = len(rows) // 2
        rows = [adasum_pair(rows[i], rows[i + half], scale_sum)
                for i in range(half)]
    return rows[0]
