"""The port's flash attention against the JAX package's.

On the CPU the port runs the plain versions of its kernels
(``flash_fwd_reference``/``flash_bwd_reference``) inside the same
autograd function that launches the CUDA kernels on a GPU; the JAX side
runs ``horovod_tpu.ops.pallas_kernels.flash_attention``, whose Pallas
kernels run in interpret mode here (as in ``test_pallas_kernels.py``).
The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

# f32 on both sides: the JAX package holds its own kernels to its
# reference at 2e-4 (test_pallas_kernels.py); the two implementations
# differ only in summation order.
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, h, kvh, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, s, h, d).astype(np.float32)
    k = rng.randn(1, s, kvh, d).astype(np.float32)
    v = rng.randn(1, s, kvh, d).astype(np.float32)
    g = rng.randn(1, s, h, d).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("s,h,kvh,causal", [
    (128, 1, 1, True), (128, 1, 1, False),
    (192, 1, 1, True), (192, 1, 1, False),
    (128, 2, 1, True),          # GQA: two q heads per KV head
])
def test_forward_and_grads_match_jax(s, h, kvh, causal):
    q, k, v, g = _inputs(s, h, kvh, 32, seed=s + 10 * h + kvh + causal)

    @jax.jit
    def jax_fwd_bwd(q_, k_, v_):
        o_, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), q_, k_, v_)
        return o_, vjp(jnp.asarray(g))

    o_jax, grads_jax = jax_fwd_bwd(q, k, v)

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(torch.from_numpy(g))

    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_jax),
                               atol=TOL, rtol=TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,causal", [(128, True), (200, False), (67, True)])
def test_bwd_reference_matches_autograd_of_fwd_reference(s, causal):
    """The plain backward is the derivative of the plain forward (in f32
    the casts are identities): 2e-5 covers f32 summation order over rows
    of up to 200 terms."""
    rng = np.random.RandomState(s)
    q, k, v, g = (torch.from_numpy(rng.randn(3, s, 32).astype(np.float32))
                  for _ in range(4))
    q = q / 32 ** 0.5  # pre-scaled, as the autograd function passes it
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    want = torch.autograd.grad(o, (q, k, v), g)
    delta = (g * o.detach()).sum(-1)
    got = fa.flash_bwd_reference(q.detach(), k.detach(), v.detach(), g,
                                 lse.detach(), delta, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_fwd_reference_matches_softmax_attention():
    """o and lse of the plain forward are softmax attention and the row
    log-sum-exp of the (masked) scores."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 90, 64).astype(np.float32))
               for _ in range(3))
    o, lse = fa.flash_fwd_reference(q, k, v, causal=True)
    s = q @ k.transpose(-1, -2)
    s = s.masked_fill(torch.ones(90, 90).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(o.numpy(), (s.softmax(-1) @ v).numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_bf16_inputs_keep_their_dtype():
    """On bf16 inputs the port returns bf16 outputs and gradients, and
    agrees with the f32 computation to bf16 precision (2^-8 relative per
    rounding, a few roundings deep: 3e-2)."""
    q, k, v, g = _inputs(128, 2, 2, 32, seed=3)
    qb, kb, vb = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    o = fa.flash_attention(qb, kb, vb, causal=True)
    o.backward(torch.from_numpy(g).bfloat16())
    assert o.dtype == qb.grad.dtype == kb.grad.dtype == torch.bfloat16
    q32, k32, v32 = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o32 = fa.flash_attention(q32, k32, v32, causal=True)
    o32.backward(torch.from_numpy(g))
    for a, b in ((o, o32), (qb.grad, q32.grad), (kb.grad, k32.grad),
                 (vb.grad, v32.grad)):
        err = (a.float() - b).abs().max().item()
        assert err <= 3e-2 * b.abs().max().item(), err
