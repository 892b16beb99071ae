"""The Hopper dq and dk/dv past head dim 256: what their wrappers refuse
before the device, the kernels ``chip_smoke.py`` holds there, and the
function they compute in f16 and bf16 against the JAX package's Pallas
backward.  Their widths and the route table are held with the other
kernels' (``test_torch_port_hopper_wide_fwd.py``,
``test_torch_port_f16_bwd.py``, ``test_torch_port_wider_heads.py``).

``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` (``csrc/flash_bwd.cu``)
take bf16 and f16 at every padded width: past 256 one block per panel of
the outputs' columns (256, and a last 128 at an odd multiple of 128), the
scores summed over every 64-column chunk in one order in every panel
block.  So on the card bf16 and f16 past 256 run the forward, dq and
dk/dv on Hopper, and the one-pass too
(``test_torch_port_hopper_wider_onepass.py``).  Here, on the CPU, the
wrappers raise on what they do not take before they look at the device,
and the plain versions run.

The plain dq, dk and dv at D 384 and 640 in f16 and bf16 (what the
kernels compute, and what ``chip_smoke.py`` holds them to on the card)
are held against ``horovod_tpu.ops.pallas_kernels._flash_attention_bwd_flat``
in Pallas interpret mode, jitted once per case, on the same inputs, lse
and delta: a ragged causal shape for the kernels (S 130: a last 64-row
tile of 2 rows; the JAX blocks 65 rows, which divide it) and a full one
(S 64).  Both sides cast P and dS to the inputs' dtype at the same values
and differ by f32 summation order, except that the JAX dq leaves in the
inputs' dtype where the plain version keeps f32 (the caller casts after
its scale).  Readings of |plain - JAX| / (1 + |JAX|) over both shapes and
widths: dk and dv at most 4.8e-4 (f16) and 2.5e-3 (bf16), about one
rounding of the outputs; dq at most 3.1e-3 (f16) and 4.7e-3 (bf16), at
rows where dS = P (dP - delta) cancels and each side keeps the noise of
its own f32 summation order of dP.  The limits, 1.2e-2 (f16) and 2e-2
(bf16), are about 4x the largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.ops.pallas_kernels import _flash_attention_bwd_flat
from horovod_tpu_torch.ops import flash_attention as fa

TOL = {"float16": 1.2e-2, "bfloat16": 2e-2}
BWD_KERNELS = (fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bwd_args(width, dtype, s=64, bh=2):
    x = torch.zeros(bh, s, width, dtype=dtype)
    rows = torch.zeros(bh, s)
    return (x, x, x, x, rows, rows, True)


@pytest.mark.parametrize("kern", BWD_KERNELS, ids=lambda k: k.__name__)
def test_wrappers_past_256_refuse_f32_and_unpadded_widths(kern):
    """Past 256 f32 raises for its dtype, 300 and 385 for their widths,
    all before the device is looked at; bf16 and f16 at 384 and 640 pass
    those checks and raise only because their tensors lie on the CPU."""
    with pytest.raises(ValueError, match="one dtype of"):
        kern(*_bwd_args(384, torch.float32))
    for width in (300, 385):
        with pytest.raises(ValueError, match="head_dim in"):
            kern(*_bwd_args(width, torch.bfloat16))
    for dtype in (torch.bfloat16, torch.float16):
        for width in (384, 640):
            with pytest.raises(ValueError, match="CUDA kernel"):
                kern(*_bwd_args(width, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chip_smoke_holds_the_hopper_backward_past_256(dtype):
    """``chip_smoke.flash_kernels`` names the Hopper forward, dq and dk/dv
    (and, since the one-pass past 256 is on Hopper too, the one-pass) at
    384 in bf16 and f16: the kernels its phase 2 holds at
    WIDER_HEAD_SHAPES."""
    kern = chip_smoke.flash_kernels(fa, dtype, "hopper", 384)
    assert kern == {"flash_fwd": fa.flash_fwd_kernel,
                    "flash_bwd_dq": fa.flash_bwd_dq_kernel,
                    "flash_bwd_dkv": fa.flash_bwd_dkv_kernel,
                    "flash_bwd_onepass": fa.flash_bwd_onepass_kernel}


@functools.lru_cache(maxsize=None)
def _pallas_backward(causal, block):
    """The JAX two-pass backward (its Pallas dq and dk/dv kernels in
    interpret mode), jitted once per (causal, block)."""
    return jax.jit(functools.partial(
        _flash_attention_bwd_flat, causal=causal, block_q=block,
        block_k=block, interpret=True))


# (S, causal, JAX block): ragged causal for the kernels' 64-row tiles,
# and full
SHAPES = ((130, True, 65), (64, False, 64))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("d", [384, 640])
@pytest.mark.parametrize("s,causal,block", SHAPES)
def test_plain_backward_past_256_matches_pallas(s, causal, block, d, dtype):
    """dq, dk and dv of the plain version at BH 2, D 384 or 640 in f16 or
    bf16 against the JAX two-pass backward on the same inputs, lse and
    delta."""
    bh = 2
    rng = np.random.RandomState(s + d + causal)
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32)
                  * (1 / np.sqrt(d) if i == 0 else 1.0) for i in range(4))
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_bwd_reference(q, k, v, g, lse, delta, causal)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32, tdt, tdt)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            getattr(jnp, dtype) if t.dtype == tdt else jnp.float32)

    want = _pallas_backward(causal, block)(
        jx(q), jx(k), jx(v), jx(g), jx(lse)[..., None], jx(delta)[..., None])
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert ref.dtype == getattr(jnp, dtype), name
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1, name
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)
