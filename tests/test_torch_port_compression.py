"""The port's ``Compression`` against ``horovod_tpu.jax.compression``.

Same inputs from a numpy seed through both: the cast compressors give
the same wire values bit for bit, bring floating tensors back in their
own dtype, and pass integer tensors through untouched with ``ctx`` None
(the JAX semantics); ``check_reduce_safe`` rejects a codec whose wire
tensors must not be summed, before any collective runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.jax import compression as jc
from horovod_tpu_torch import compression as pc


def _floats(dtype):
    rng = np.random.RandomState(0)
    # Spread over fp16's range and past it: tiny values go subnormal or
    # to zero, values past 65504 to inf, on both sides alike.
    x = rng.randn(4096).astype(np.float32) * np.float32(2.0) ** rng.randint(
        -30, 18, 4096)
    return torch.from_numpy(x).to(dtype), x


@pytest.mark.parametrize("name", ["fp16", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cast_compressors_match_jax(name, dtype):
    t, x = _floats(dtype)
    comp = getattr(pc.Compression, name)
    wire, ctx = comp.compress(t)
    jcomp = getattr(jc.Compression, name)
    jwire, jctx = jcomp.compress(
        jnp.asarray(t.float().numpy()).astype(
            {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}[dtype]))
    assert wire.dtype == comp.wire_dtype and ctx == dtype
    np.testing.assert_array_equal(wire.float().numpy(),
                                  np.asarray(jwire, np.float32))
    back = comp.decompress(wire, ctx)
    assert back.dtype == dtype
    np.testing.assert_array_equal(
        back.float().numpy(),
        np.asarray(jcomp.decompress(jwire, jctx), np.float32))


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.bool])
def test_non_float_tensors_ride_untouched(name, dtype):
    t = torch.arange(7).to(dtype)
    comp = getattr(pc.Compression, name)
    wire, ctx = comp.compress(t)
    assert wire is t and ctx is None
    assert comp.decompress(wire, ctx) is t
    _, jctx = getattr(jc.Compression, name).compress(jnp.arange(7))
    assert jctx is None


def test_none_is_the_identity():
    t, _ = _floats(torch.float32)
    wire, ctx = pc.Compression.none.compress(t)
    assert wire is t and ctx is None
    assert pc.Compression.none.decompress(wire, ctx) is t


def test_check_reduce_safe():
    for comp in (pc.Compression.none, pc.Compression.fp16,
                 pc.Compression.bf16):
        assert comp.reduce_safe is jc.Compression.none.reduce_safe is True
        pc.check_reduce_safe(comp, "allreduce")
    # The JAX package's int8 codec is the kind the bracket must refuse.
    assert jc.Compression.int8.reduce_safe is False
    with pytest.raises(ValueError, match="Int8Quantizer"):
        pc.check_reduce_safe(jc.Compression.int8, "DistributedOptimizer")


def test_distributed_optimizer_checks_its_codec_at_construction():
    import horovod_tpu_torch as hvd
    p = torch.nn.Parameter(torch.zeros(3))

    class Quantized(pc.Compressor):
        reduce_safe = False

    with pytest.raises(ValueError, match="Quantized"):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                 compression=Quantized)
    assert hvd.Compression is pc.Compression
