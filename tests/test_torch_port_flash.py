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


# -- the backward choice: HVD_TPU_FLASH_BWD -----------------------------------

@pytest.mark.parametrize("choice", ["pallas", "pallas_onepass"])
@pytest.mark.parametrize("s,causal", [(128, True), (128, False),
                                      (192, True), (192, False),
                                      (200, True), (200, False),
                                      (256, True), (256, False),
                                      (384, True), (384, False)])
def test_grads_match_jax_under_each_backward(monkeypatch, choice, s, causal):
    """Both packages read HVD_TPU_FLASH_BWD when the backward runs: the
    JAX side runs its two-pass or one-pass Pallas kernels (interpret
    mode), the port the plain versions of its dq and dk/dv kernels or of
    its one-pass kernel, whose partials it sums.  Where BLOCK_K divides S
    (128, 256, 384: one, two and three of the port's k tiles) the JAX
    one-pass kernel runs at the same k block (HVD_TPU_FLASH_BLOCK_K), as
    its own plan does at S 384; at S 192 it keeps its plan.  At S 200 the
    port's last tiles are ragged and the JAX package falls back to plain
    attention (64 does not divide S).  f32, TOL."""
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", choice)
    if choice == "pallas_onepass" and s % fa.BLOCK_K == 0:
        monkeypatch.setenv("HVD_TPU_FLASH_BLOCK_K", str(fa.BLOCK_K))
    q, k, v, g = _inputs(s, 1, 1, 32, seed=s + causal)

    @jax.jit
    def jax_grads(q_, k_, v_):
        _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), q_, k_, v_)
        return vjp(jnp.asarray(g))

    grads_jax = jax_grads(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention(qt, kt, vt, causal=causal).backward(torch.from_numpy(g))
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def _flat_bwd_inputs(bh, s, d, causal, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                  .to(dtype) for _ in range(4))
    q = (q.float() / d ** 0.5).to(dtype)
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g.float() * o.float()).sum(-1)
    return q, k, v, g, lse, delta


@pytest.mark.parametrize("s,causal", [(192, True), (200, False), (200, True),
                                      (67, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onepass_partials_sum_to_the_two_pass_dq(s, causal, dtype):
    """The one-pass plain version has nk = ceil(S/BLOCK_K) partials whose sum
    is the two-pass plain dq, and the same dk and dv bit for bit (same
    casts, same products).  The sum adds the tiles in another order than
    one product over all keys: 2e-5 of the largest |dq| in f32, bf16
    inputs included (the casts are the same on both sides)."""
    args = _flat_bwd_inputs(2, s, 32, causal, seed=s, dtype=dtype)
    partials, dk1, dv1 = fa.flash_bwd_onepass_reference(*args, causal)
    dq, dk, dv = fa.flash_bwd_reference(*args, causal)
    assert partials.dtype == torch.float32
    assert tuple(partials.shape) == (2, -(-s // fa.BLOCK_K), s, 32)
    assert dk1.dtype == dk.dtype == dtype
    scale = dq.abs().max().item()
    np.testing.assert_allclose(partials.sum(1).numpy(), dq.numpy(),
                               atol=2e-5 * scale, rtol=0)
    np.testing.assert_array_equal(dk1.float().numpy(), dk.float().numpy())
    np.testing.assert_array_equal(dv1.float().numpy(), dv.float().numpy())


def test_onepass_dead_causal_tiles_are_exactly_zero():
    """Under the causal mask, partial t (keys [B t, B t + B), B =
    BLOCK_K) of the q rows before B t is 0 exactly, and a live partial is
    not."""
    args = _flat_bwd_inputs(2, 200, 32, True, seed=5)
    partials, _, _ = fa.flash_bwd_onepass_reference(*args, True)
    assert partials.shape[1] == -(-200 // fa.BLOCK_K) > 1
    for t in range(partials.shape[1]):
        assert torch.count_nonzero(partials[:, t, :fa.BLOCK_K * t]) == 0
        assert torch.count_nonzero(partials[:, t, fa.BLOCK_K * t:]) > 0


def test_backward_choice_is_checked_when_the_backward_runs(monkeypatch):
    """As in the JAX package: an unknown value raises ValueError; the
    XLA-only "chunked" mode is not ported and raises NotImplementedError
    naming its ROADMAP entry; the forward reads nothing."""
    q = torch.randn(1, 64, 1, 32, requires_grad=True)
    for value, err, match in (("pallas_fused", ValueError, "HVD_TPU_FLASH_BWD"),
                              ("chunked", NotImplementedError, "ROADMAP")):
        monkeypatch.setenv("HVD_TPU_FLASH_BWD", value)
        o = fa.flash_attention(q, q, q, causal=False)
        with pytest.raises(err, match=match):
            o.sum().backward()
    monkeypatch.delenv("HVD_TPU_FLASH_BWD")
    assert fa.bwd_choice() == "pallas"
