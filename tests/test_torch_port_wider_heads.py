"""Head dims past 256: the port's flash attention against the JAX package's,
and the route each (dtype, width) takes on the card.

Past 256, ``flash_attention`` zero-pads a head dim to the next multiple
of 128, as the JAX package's ``_d_pad`` pads every head dim (zero columns
add 0 to every product), and slices the outputs back; on the card the
bf16 and f16 backward and the f32 one-pass there run the CUDA-core
kernels (``csrc/flash_simt.cu``), which split the width into 128-column
panels, one block each, and cast as the plain versions run here do; the
forward runs on Hopper in bf16 and f16 (``csrc/flash_fwd.cu``: o in
panels of 256 columns and a last one of 128) and in f32
(``csrc/flash_fwd_f32.cu``, split TF32: o in panels of 128 columns), and
so do the f32 dq and dk/dv (``csrc/flash_bwd_f32.cu``).  The
JAX side runs ``horovod_tpu.ops.pallas_kernels.flash_attention`` with its
Pallas kernels in interpret mode, under both backward choices
(``HVD_TPU_FLASH_BWD``, read by both packages).

Tolerances as ``test_torch_port_wide_heads.py`` holds D 192 and 256, per
dtype: f32 2e-4 (summation order only); bf16 1.6e-2 relative and
absolute, four bf16 ulps at unit scale (both sides round q's scale, P and
dS to bf16, the JAX kernel at a running row max, the plain version at the
final one, and every output to bf16).  Readings of |port - JAX| / (1 +
|JAX|) over these cases: at most 1.8e-6 in f32 and 3.9e-3 in bf16.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import _d_pad
from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_transformer as tt

TOL = {"float32": 2e-4, "bfloat16": 1.6e-2}
BWD = ("pallas", "pallas_onepass")
S = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [257, 300, 320, 384, 385, 512, 640, 1000])
def test_padded_head_dim_is_the_references_past_256(d):
    """Past 256 the port pads as the JAX package does."""
    assert fa.padded_head_dim(d) == _d_pad(d)
    assert fa.padded_head_dim(d) in fa.PADDED_WIDTHS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("width", [384, 512, 640, 1024])
def test_route_past_256(dtype, width):
    """Every dtype at a multiple of 128 past 256: bf16 and f16 the forward
    on Hopper (``flash_fwd_kernel``) and dq, dk/dv and the one-pass on the
    CUDA cores; f32 all four on Hopper (split TF32, ``F32_KERNELS``); each
    kernel taking the dtype and the width."""
    route = fa._kernels_for(dtype, width)
    if dtype == torch.float32:
        assert route == fa.F32_KERNELS
    else:
        assert route == (fa.flash_fwd_kernel,) + fa.SIMT_KERNELS[1:]
    for kern in route:
        assert dtype in kern.dtypes and width in kern.widths


def _as_np(x, dtype):
    """f32 numpy ``x`` in ``dtype`` (bf16 through jnp: numpy has none)."""
    return np.asarray(jnp.asarray(x, getattr(jnp, dtype)))


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


CASES = ((320, True), (320, False), (640, True), (640, False))


@functools.lru_cache(maxsize=None)
def _jax_references(dtype):
    """{(d, causal): (inputs, JAX output, {backward choice: gradients})}
    over CASES in ``dtype``, inputs B 1, S 64, H 1 from a seed, in one
    jitted program (the backward choice is read when the backward is
    traced, so it is set in turn between the ``vjp`` calls)."""
    inputs = []
    for d, causal in CASES:
        rng = np.random.RandomState(d + causal)
        inputs.append(tuple(
            _as_np(rng.randn(1, S, 1, d).astype(np.float32), dtype)
            for _ in range(4)))

    def program(all_inputs):
        out = []
        for (d, causal), (q_, k_, v_, g_) in zip(CASES, all_inputs):
            o_, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal),
                              q_, k_, v_)
            grads = {}
            old = os.environ.get("HVD_TPU_FLASH_BWD")
            try:
                for bwd in BWD:
                    os.environ["HVD_TPU_FLASH_BWD"] = bwd
                    grads[bwd] = vjp(g_)
            finally:
                if old is None:
                    os.environ.pop("HVD_TPU_FLASH_BWD", None)
                else:
                    os.environ["HVD_TPU_FLASH_BWD"] = old
            out.append((o_, grads))
        return out

    results = jax.jit(program)(inputs)
    return {case: (inp, o, grads)
            for case, inp, (o, grads) in zip(CASES, inputs, results)}


@pytest.mark.parametrize("bwd", BWD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal", CASES)
def test_wider_heads_match_jax(monkeypatch, d, causal, dtype, bwd):
    """Forward and gradients at B 1, S 64, H 1 against the JAX package,
    whose Pallas kernels run lane-padded in interpret mode; the port's
    plain versions see the width its kernels take (384 for 320, 640)."""
    (q, k, v, g), o_jax, grads_jax = _jax_references(dtype)[d, causal]
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", bwd)
    widths = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: widths.append(a[0].shape[-1]) or fwd(*a))
    qt, kt, vt = (_to_torch(x, dtype).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(_to_torch(g, dtype))
    assert widths == [_d_pad(d)]
    tol = TOL[dtype]
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(o_jax, np.float32),
                               atol=tol, rtol=tol)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax[bwd]):
        assert got.shape == (1, S, 1, d)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_decoder_at_head_dim_320_matches_jax(monkeypatch):
    """A small decoder whose heads are 320 wide (d_model 640, 2 heads, 1
    layer, seq 64), f32, flash on both sides (the JAX decoder's Pallas
    flash in interpret mode): logits and loss at 1e-5, gradients at 1e-4
    relative, as ``test_torch_port_transformer.py`` holds f32."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    sizes = dict(d_model=640, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=256,
                 max_seq=S)
    monkeypatch.setattr(tt, "SIZES", {**tt.SIZES, **sizes})
    jcfg, pcfg = tt._cfgs()
    assert pcfg.head_dim == 320
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(4), jcfg))
    batch = tt._batch()
    loss_jax, grads_jax, logits_jax = tt._jax_loss_and_grads(jcfg, params,
                                                             batch)
    model = params_from_jax(params, pcfg, device="cpu")
    tbatch = tt._torch_batch(batch)
    widths = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: widths.append(a[0].shape[-1]) or fwd(*a))
    logits = model(tbatch["tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), logits_jax,
                               rtol=1e-5, atol=1e-5)
    loss = pt.loss_fn(model, tbatch)
    loss.backward()
    assert widths and set(widths) == {384}
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
    tt._assert_trees_close(tree_from_module(model, grads=True), grads_jax,
                           rtol=1e-4, atol=1e-6)
