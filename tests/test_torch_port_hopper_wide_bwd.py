"""The Hopper dq and dk/dv at head dim 256: what their wrappers refuse
before the device, and the function they compute in f16 against the JAX
package's Pallas backward.  Their widths and the route table are held
with the other kernels' (``test_torch_port_hopper_wide_fwd.py``,
``test_torch_port_f16_bwd.py``, ``test_torch_port_wide_heads.py``).

``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` (``csrc/flash_bwd.cu``)
take bf16 and f16 at 32, 64, 128 and 256 (at 256 the dq kernel's wide
plan, 64-row K and V tiles in three ring slots, and a dk/dv kernel of
64-row k blocks whose two consumers own dV and dK); the Hopper one-pass
takes the same widths (``test_torch_port_hopper_wide_onepass.py``).
So on the card bf16 and f16 at 256 run all four on Hopper; past 256 the
forward on Hopper and the backward on the CUDA cores; f32 all four on the
CUDA cores.  Here, on the CPU, the wrappers raise on what they do not take
before they look at the device, and the plain versions run.

The plain dq, dk and dv at D 256 in f16 (what the kernels compute, and
what ``chip_smoke.py`` holds them to on the card) are held against
``horovod_tpu.ops.pallas_kernels._flash_attention_bwd_flat`` in Pallas
interpret mode on the same f16 inputs, lse and delta: a ragged causal
shape for the kernels (S 192: the dq kernel's second 128-row q tile half
past S) and a full one (S 128).  Both sides cast P to f16 and dS to f16 at
the same values and differ by f32 summation order, except that the JAX dq
leaves in f16 where the plain version keeps f32 (the caller casts after
its scale).  Readings of |plain - JAX| / (1 + |JAX|) over both shapes:
at most 4.5e-4 (dq), 3.0e-4 (dk) and 4.1e-4 (dv), about one f16 rounding
of the outputs; the limit 2e-3 is about 4x the largest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import _flash_attention_bwd_flat
from horovod_tpu_torch.ops import flash_attention as fa

TOL = 2e-3
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
def test_d256_wrappers_refuse_f32_and_257(kern):
    """At 256 f32 raises for its dtype and 257 for its width, both before
    the device is looked at; bf16 at 256 passes those checks and raises
    only because its tensors lie on the CPU."""
    with pytest.raises(ValueError, match="one dtype of"):
        kern(*_bwd_args(256, torch.float32))
    with pytest.raises(ValueError, match="head_dim in"):
        kern(*_bwd_args(257, torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA kernel"):
        kern(*_bwd_args(256, torch.bfloat16))


# (S, causal): ragged for the kernels' 128-row dq tiles, and full
SHAPES = ((192, True), (128, False))


@pytest.mark.parametrize("s,causal", SHAPES)
def test_plain_d256_f16_backward_matches_pallas(s, causal):
    """dq, dk and dv of the plain version at BH 2, D 256 in f16 against
    the JAX two-pass backward (its Pallas dq and dk/dv kernels in
    interpret mode, 64-row blocks) on the same inputs, lse and delta."""
    bh, d = 2, 256
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32)
                  * (1 / np.sqrt(d) if i == 0 else 1.0) for i in range(4))
    q, k, v, g = (torch.from_numpy(x).to(torch.float16) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_bwd_reference(q, k, v, g, lse, delta, causal)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32, torch.float16,
                                              torch.float16)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.float16 if t.dtype == torch.float16 else jnp.float32)

    want = _flash_attention_bwd_flat(
        jx(q), jx(k), jx(v), jx(g), jx(lse)[..., None], jx(delta)[..., None],
        causal=causal, block_q=64, block_k=64, interpret=True)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert ref.dtype == jnp.float16, name
        ref = np.asarray(ref, np.float32)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1, name
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL,
                                   atol=TOL, err_msg=name)
