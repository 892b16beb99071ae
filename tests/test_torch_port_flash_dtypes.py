"""The port's flash attention at float32 and float16 against the JAX
package's, which computes in any float dtype.

On the card, bf16 and f16 run the Hopper kernels, and f32 the Hopper f32
forward (``csrc/flash_fwd_f32.cu``), dq and dk/dv
(``csrc/flash_bwd_f32.cu``) and the CUDA-core one-pass
(``csrc/flash_simt.cu``), chosen by dtype and width alone; here on
the CPU the same autograd function runs the kernels' plain versions,
which cast as those kernels do (P to V's dtype before PV, dS to K's and
Q's before its products).  The JAX side runs
``horovod_tpu.ops.pallas_kernels.flash_attention`` with its Pallas
kernels in interpret mode, under both backward choices
(``HVD_TPU_FLASH_BWD``, read by both packages).  The kernels themselves
are held to the plain versions on the card by ``chip_smoke.py``.

Tolerances, per dtype: f32 as ``test_torch_port_flash.py`` holds it
(2e-4, summation order only); f16 at half-precision rounding: both sides
round P (and dS) to f16, but the JAX kernel does so at a running row max
and the plain version at the final one, and every output is rounded to
f16 (2^-10 relative a rounding), so 4e-3 relative and absolute, two f16
ulps at unit scale.  Readings of |port - JAX| / (1 + |JAX|) over these
cases: at most 5.0e-7 in f32 and 4.8e-4 in f16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_transformer as tt

TOL = {"float32": 2e-4, "float16": 4e-3}
BWD = ("pallas", "pallas_onepass")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, h, kvh, d, dtype, seed):
    rng = np.random.RandomState(seed)
    shapes = ((1, s, h, d), (1, s, kvh, d), (1, s, kvh, d), (1, s, h, d))
    return [rng.randn(*shape).astype(dtype) for shape in shapes]


@pytest.mark.parametrize("bwd", BWD)
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("s,h,kvh,d,causal", [
    (128, 1, 1, 32, True), (192, 1, 1, 64, False),
    (128, 2, 1, 32, True),  # GQA: two q heads per KV head
])
def test_forward_and_grads_match_jax(monkeypatch, s, h, kvh, d, causal,
                                     dtype, bwd):
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", bwd)
    q, k, v, g = _inputs(s, h, kvh, d, dtype, seed=s + h + d + causal)

    def jax_fwd_bwd(q_, k_, v_):
        o_, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), q_, k_, v_)
        return o_, vjp(jnp.asarray(g))

    o_jax, grads_jax = jax.jit(jax_fwd_bwd)(q, k, v)

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(torch.from_numpy(g))
    assert o.dtype == qt.grad.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(o_jax, np.float32),
                               atol=tol, rtol=tol)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax):
        assert got.dtype == getattr(torch, dtype)
        assert np.asarray(want).dtype == np.dtype(dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_plain_versions_cast_as_the_kernels(dtype):
    """In f32 every cast is the identity; in f16 P and dS are rounded
    before their products: the plain forward equals PV of the rounded P,
    and its dq and the one-pass partials' sum agree."""
    rng = np.random.RandomState(7)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 130, 32).astype(dtype))
                  for _ in range(4))
    q = q / 32 ** 0.5
    o, lse = fa.flash_fwd_reference(q, k, v, True)
    s = q.float() @ k.float().transpose(-1, -2)
    s = s.masked_fill(~fa._causal_keep(130, "cpu"), fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    want = (p.to(v.dtype).float() @ v.float()) / p.sum(-1, keepdim=True)
    np.testing.assert_allclose(o.float().numpy(), want.to(o.dtype).float()
                               .numpy(), rtol=TOL[dtype], atol=TOL[dtype])
    delta = (g.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_bwd_reference(q, k, v, g, lse, delta, True)
    partials, dk1, dv1 = fa.flash_bwd_onepass_reference(q, k, v, g, lse,
                                                        delta, True)
    assert dk.dtype == dv.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(partials.sum(1).numpy(), dq.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(dk, dk1) and torch.equal(dv, dv1)


def test_kernels_chosen_by_dtype():
    """At head dims up to 128: bf16 and f16 -> the Hopper kernels, f32 ->
    the Hopper f32 forward, dq and dk/dv and the CUDA-core one-pass;
    anything else raises; the wrappers take CUDA tensors only."""
    for width in (32, 64, 128):
        assert fa._kernels_for(torch.bfloat16, width) == fa.HOPPER_KERNELS
        assert fa._kernels_for(torch.float32, width) == \
            fa.F32_KERNELS + (fa.flash_bwd_onepass_simt_kernel,)
        assert fa._kernels_for(torch.float16, width) == fa.HOPPER_KERNELS
    with pytest.raises(ValueError, match="f32, f16 or bf16"):
        fa._kernels_for(torch.float64, 64)
    assert set(fa.KERNELS) == set(fa.HOPPER_KERNELS + fa.SIMT_KERNELS
                                  + fa.F32_KERNELS)
    x = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_fwd_simt_kernel(x, x, x, True)


@pytest.fixture(scope="module")
def decoder_params():
    jcfg, _ = tt._cfgs()
    return tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("bwd", BWD)
def test_f32_decoder_with_flash_matches_jax(monkeypatch, decoder_params, bwd):
    """The small decoder at ``dtype="float32"`` with flash on, both
    sides (the JAX decoder's Pallas flash in interpret mode): logits and
    loss at 1e-5, gradients at 1e-4 relative, as
    ``test_torch_port_transformer.py`` holds f32."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", bwd)
    jcfg, pcfg = tt._cfgs(dtype="float32")
    batch = tt._batch()
    loss_jax, grads_jax, logits_jax = tt._jax_loss_and_grads(
        jcfg, decoder_params, batch)
    model = params_from_jax(decoder_params, pcfg, device="cpu")
    tbatch = tt._torch_batch(batch)
    seen = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: seen.append(a[0].dtype) or fwd(*a))
    logits = model(tbatch["tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), logits_jax,
                               rtol=1e-5, atol=1e-5)
    loss = pt.loss_fn(model, tbatch)
    loss.backward()
    assert seen and set(seen) == {torch.float32}
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
    tt._assert_trees_close(tree_from_module(model, grads=True), grads_jax,
                           rtol=1e-4, atol=1e-6)
