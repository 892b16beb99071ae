"""Head dims 129-256: the port's flash attention against the JAX package's,
and the route each (dtype, width) takes on the card.

``flash_attention`` zero-pads a head dim in 129-255 to 256 (the JAX
package pads any to a multiple of 128: zero columns add 0 to every
product) and slices the outputs back; on the card, bf16 and f16 at 256
run the Hopper forward, dq, dk/dv and one-pass backward
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/flash_bwd_onepass.cu``), f32 the Hopper f32 forward, dq, dk/dv
and one-pass (``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_f32.cu``);
here the plain versions run.  The JAX side runs
``horovod_tpu.ops.pallas_kernels.flash_attention`` with its Pallas kernels
in interpret mode, under both backward choices (``HVD_TPU_FLASH_BWD``,
read by both packages).

Tolerances, per dtype: f32 as ``test_torch_port_flash.py`` holds it
(2e-4, summation order only).  bf16: both sides round q's scale, P and dS
to bf16, but the JAX kernel rounds P at a running row max and the plain
version at the final one, and every output is rounded to bf16 (2^-8
relative a rounding); 1.6e-2 relative and absolute is four bf16 ulps at
unit scale.  Readings of |port - JAX| / (1 + |JAX|) over these cases: at
most 7.8e-7 in f32 and 3.9e-3 in bf16.
"""

import functools
import os

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

TOL = {"float32": 2e-4, "bfloat16": 1.6e-2}
BWD = ("pallas", "pallas_onepass")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_np(x, dtype):
    """f32 numpy ``x`` in ``dtype`` (bf16 through jnp: numpy has none)."""
    return np.asarray(jnp.asarray(x, getattr(jnp, dtype)))


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


CASES = ((192, True), (192, False), (256, True), (256, False))


@functools.lru_cache(maxsize=None)
def _jax_references(dtype):
    """{(d, causal): (inputs, JAX output, {backward choice: gradients})}
    over CASES in ``dtype``, inputs B 1, S 128, H 2 from a seed.  One
    jitted program a dtype (a third of the compile time of one a case):
    the backward choice is read when the backward is traced, so it is set
    in turn between the ``vjp`` calls."""
    inputs = []
    for d, causal in CASES:
        rng = np.random.RandomState(d + causal)
        inputs.append(tuple(
            _as_np(rng.randn(1, 128, 2, d).astype(np.float32), dtype)
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
def test_wide_heads_match_jax(monkeypatch, d, causal, dtype, bwd):
    """Forward and gradients at B 1, S 128, H 2 against the JAX package,
    whose Pallas kernels run lane-padded to 256 in interpret mode; the
    port's plain versions see the width its kernels take, 256."""
    (q, k, v, g), o_jax, grads_jax = _jax_references(dtype)[d, causal]
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", bwd)
    widths = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: widths.append(a[0].shape[-1]) or fwd(*a))
    qt, kt, vt = (_to_torch(x, dtype).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(_to_torch(g, dtype))
    assert widths == [256]
    tol = TOL[dtype]
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(o_jax, np.float32),
                               atol=tol, rtol=tol)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax[bwd]):
        assert got.shape == (1, 128, 2, d)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_decoder_at_head_dim_256_matches_jax(monkeypatch):
    """A small decoder whose heads are 256 wide (d_model 512, 2 heads, 1
    layer, seq 128), f32, flash on both sides (the JAX decoder's Pallas
    flash in interpret mode): logits and loss at 1e-5, gradients at 1e-4
    relative, as ``test_torch_port_transformer.py`` holds f32."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    sizes = dict(d_model=512, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=512)
    monkeypatch.setattr(tt, "SIZES", {**tt.SIZES, **sizes})
    jcfg, pcfg = tt._cfgs()
    assert pcfg.head_dim == 256
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(3), jcfg))
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
    assert widths and set(widths) == {256}
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
    tt._assert_trees_close(tree_from_module(model, grads=True), grads_jax,
                           rtol=1e-4, atol=1e-6)


HOPPER = dict(zip(("fwd", "dq", "dkv", "onepass"), fa.HOPPER_KERNELS))
# f32: the Hopper forward, dq, dk/dv and one-pass in split TF32
F32 = dict(zip(("fwd", "dq", "dkv", "onepass"), fa.F32_KERNELS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("width", [32, 64, 128, 256])
def test_route_by_dtype_and_width(dtype, width):
    """bf16 and f16 at up to 256: the four Hopper kernels (at 256 the
    one-pass with 64-row dq partial slots); f32: the Hopper f32 forward,
    dq, dk/dv and one-pass.  Each kernel routed to takes
    the dtype and width."""
    route = dict(zip(("fwd", "dq", "dkv", "onepass"),
                     fa._kernels_for(dtype, width)))
    want = F32 if dtype == torch.float32 else HOPPER
    assert route == want
    for kern in route.values():
        assert dtype in kern.dtypes and width in kern.widths


@pytest.mark.parametrize("width", [96, 160, 257, 300])
def test_route_refuses_widths_no_kernel_takes(width):
    """A width is routed only after ``padded_head_dim``; one that is not a
    padded width (below 256 not a power of two from 32, past 256 not a
    multiple of 128) raises with a message that names the padded widths,
    in every dtype."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="multiple of 128 past 256"):
            fa._kernels_for(dtype, width)
    with pytest.raises(ValueError, match="f32, f16 or bf16"):
        fa._kernels_for(torch.float64, 256)


def test_padded_head_dims_past_128():
    """129-256 pad to 256; past 256 a head dim pads to the next multiple
    of 128, as the JAX package's ``_d_pad`` does."""
    assert [fa.padded_head_dim(d) for d in (129, 192, 255, 256, 257, 384)] \
        == [256, 256, 256, 256, 384, 384]


def test_kernel_wrappers_check_their_family():
    """Each wrapper refuses a dtype or width outside its family's before it
    looks at the device: the Hopper dq takes no f32, the Hopper f32
    forward, dq and dk/dv no f16, the Hopper forwards, the Hopper f32 dq
    and dk/dv and the CUDA-core forward no width that is not a padded one
    (320); what they take then raises here for lying on the CPU."""
    x = {(dt, w): torch.zeros(2, 64, w, dtype=dt)
         for dt in (torch.float16, torch.float32) for w in (64, 256, 320)}
    rows = torch.zeros(2, 64)
    cases = ((fa.flash_bwd_dq_kernel, torch.float32, 64, "one dtype of"),
             (fa.flash_fwd_kernel, torch.float16, 320, "head_dim in"),
             (fa.flash_fwd_simt_kernel, torch.float32, 320, "head_dim in"),
             (fa.flash_fwd_simt_kernel, torch.float16, 256, "CUDA kernel"),
             (fa.flash_bwd_onepass_kernel, torch.float16, 64, "CUDA kernel"),
             (fa.flash_fwd_f32_kernel, torch.float16, 64, "one dtype of"),
             (fa.flash_fwd_f32_kernel, torch.float32, 320, "head_dim in"),
             (fa.flash_fwd_f32_kernel, torch.float32, 256, "CUDA kernel"),
             (fa.flash_bwd_dq_f32_kernel, torch.float16, 64, "one dtype of"),
             (fa.flash_bwd_dq_f32_kernel, torch.float32, 320, "head_dim in"),
             (fa.flash_bwd_dkv_f32_kernel, torch.float16, 256,
              "one dtype of"),
             (fa.flash_bwd_dkv_f32_kernel, torch.float32, 320, "head_dim in"),
             (fa.flash_bwd_dkv_f32_kernel, torch.float32, 64, "CUDA kernel"))
    for kern, dtype, width, msg in cases:
        t = x[dtype, width]
        args = ((t, t, t, True) if "fwd" in kern.__name__
                else (t, t, t, t, rows, rows, True))
        with pytest.raises(ValueError, match=msg):
            kern(*args)
