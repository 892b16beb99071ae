"""The flat Average (``ops/collectives.py average``) against the
reference's arithmetic, bit for bit.

The reference averages a floating sum as ``r / size`` inside a jitted
program (``horovod_tpu/ops/xla_ops.py``), which XLA compiles to a
multiplication by the f32 reciprocal of ``size``; the port's hierarchical
legs multiply by ``1.0 / size`` (``multihost._axis0_reduce``).  A torch
division by the int rounds otherwise on the CPU (a third of f32 values
differ at ``n = 3``), so the flat Average multiplies too, and then all
three agree on every device.  Integer sums floor-divide, as the
reference's ``r // size``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import multihost as mh
from horovod_tpu_torch.ops.collectives import AVERAGE, average

N_RANKS = (3, 5, 6, 7)


def _sums(seed=0, n=100_000):
    """f32 sums of two contributions, spread over many binades."""
    rng = np.random.RandomState(seed)
    a, b = (rng.randn(n).astype(np.float32)
            * np.float32(2.0) ** rng.randint(-20, 20, n).astype(np.float32)
            for _ in range(2))
    return a, b


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("n", N_RANKS)
def test_flat_average_is_the_reference_division_bit_for_bit(n):
    a, b = _sums(n)
    total = a + b
    want = np.asarray(jax.jit(lambda r: r / n)(jnp.asarray(total)))
    got = average(torch.from_numpy(total), n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    legs = mh._axis0_reduce(torch.from_numpy(np.stack([a, b])), AVERAGE, n)
    np.testing.assert_array_equal(_bits(legs.numpy()), _bits(want))
    # the division it replaces rounds some of these sums otherwise
    divided = (torch.from_numpy(total) / n).numpy()
    assert (_bits(divided) != _bits(want)).any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_flat_average_floor_divides_integers(dtype):
    x = torch.tensor([-7, -6, -1, 0, 1, 5, 6, 7, 2 ** 30], dtype=dtype)
    for n in N_RANKS:
        got = average(x, n)
        assert got.dtype == dtype
        want = np.asarray(jax.jit(lambda r: r // n)(jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(got.numpy(), want)


def test_low_precision_sums_average_in_f32():
    """f16 and bf16 sums: the f32 product rounded once to their dtype."""
    a, b = _sums(1, 4096)
    for dtype in (torch.float16, torch.bfloat16):
        total = torch.from_numpy(a + b).to(dtype)
        got = average(total, 3)
        assert got.dtype == dtype
        assert torch.equal(got, (total.float() * np.float32(1 / 3)).to(dtype))
