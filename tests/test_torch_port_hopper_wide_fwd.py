"""The Hopper forward from head dim 256 on: the widths and dtypes its
wrapper takes, the route table it changes, and the decoder with 256-wide
heads against the JAX package's.

``flash_fwd_kernel`` (``csrc/flash_fwd.cu``) takes bf16 and f16 at every
width ``padded_head_dim`` gives: 32, 64, 128, 256 and each multiple of 128
past 256.  So on the card bf16 and f16 run the forward on Hopper at every
width, and so do dq, dk/dv (``csrc/flash_bwd.cu``) and the one-pass
backward (``csrc/flash_bwd_onepass.cu``); f32 runs all four on Hopper
(``F32_KERNELS``, split TF32).  Here, on the CPU, the
wrappers raise on what they do not take before they look at the device,
and the decoder runs the plain versions.

The decoder is the configuration of ``chip_smoke.py``'s step with 256-wide
heads (n_heads = n_kv_heads = d_model // 256) at 2 layers and narrow
widths (d_model 512, d_ff 256, vocab 256, seq 64, batch 2), its weights
from the JAX ``init_params``; the JAX side runs
``horovod_tpu.models.transformer`` on a one-device mesh with its plain
attention (``HOROVOD_FLASH_ATTENTION=0``), the port its flash path.  In
f32 both compute exact attention and differ by summation order: logits
and loss at 1e-5, gradients at 1e-4 relative, as
``test_torch_port_transformer.py`` holds f32.  In bf16 (logits from bf16
operands on both sides) the port's flash rounds P and dS to bf16 where the
plain attention keeps them in f32: loss at 1e-3 relative and each
gradient's relative norm error at 5e-2, the limits ``chip_smoke.py`` holds
the full-width step to against its plain attention path.  Readings: f32
loss 7.8e-8, every gradient within 0.22 of its limit; bf16 loss 1.6e-4,
worst gradient 1.8e-2 (ln1).
"""

import jax
import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_transformer as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", [32, 64, 128, 256, 384, 512, 640, 1024])
def test_forward_takes_every_padded_width(width):
    """The Hopper forward's widths are ``PADDED_WIDTHS``, and so are its
    dq's, dk/dv's and the one-pass's."""
    assert fa.flash_fwd_kernel.widths is fa.PADDED_WIDTHS
    assert width in fa.flash_fwd_kernel.widths
    for kern in fa.HOPPER_KERNELS[1:]:
        assert kern.widths is fa.PADDED_WIDTHS
        assert width in kern.widths


@pytest.mark.parametrize("width", [257, 300])
def test_forward_refuses_unpadded_widths(width):
    """A width no padding gives raises before the device is looked at."""
    assert width not in fa.flash_fwd_kernel.widths
    x = torch.zeros(2, 64, width, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in"):
        fa.flash_fwd_kernel(x, x, x, True)


def test_forward_refuses_f32_before_the_device():
    """f32 at 256 raises for its dtype, not for lying on the CPU: the
    Hopper forward takes bf16 and f16 only."""
    x = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError, match="one dtype of"):
        fa.flash_fwd_kernel(x, x, x, True)
    y = x.to(torch.float16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_fwd_kernel(y, y, y, True)


@pytest.mark.parametrize("width", [128, 256, 384, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_route_table(dtype, width):
    """(fwd, dq, dk/dv, one-pass) by dtype and padded width: f32 the
    forward, dq, dk/dv and the one-pass on Hopper (``F32_KERNELS``); bf16
    and f16 all four on Hopper (``HOPPER_KERNELS``) at every width."""
    route = fa._kernels_for(dtype, width)
    want = fa.F32_KERNELS if dtype == torch.float32 else fa.HOPPER_KERNELS
    assert route == want
    for kern in route:
        assert dtype in kern.dtypes and width in kern.widths


SIZES = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2,
             n_kv_heads=2, d_ff=256, max_seq=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd256_decoder_matches_jax(monkeypatch, dtype):
    """The decoder with 256-wide heads: the JAX parameters convert, and the
    port's flash path (at width 256) gives the JAX plain attention path's
    logits, loss and gradients within the module's stated tolerances."""
    monkeypatch.setattr(tt, "SIZES", SIZES)
    kw = dict(dtype=dtype, logits_dtype="bf16" if dtype == "bfloat16"
              else "f32")
    jcfg, pcfg = tt._cfgs(**kw)
    assert pcfg.head_dim == 256 and pcfg.n_heads == pcfg.d_model // 256
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(5), jcfg))
    batch = tt._batch()
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    loss_jax, grads_jax, logits_jax = tt._jax_loss_and_grads(jcfg, params,
                                                             batch)
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    model = params_from_jax(params, pcfg, device="cpu")
    tt._assert_trees_close(tree_from_module(model), params, rtol=0, atol=0)
    widths = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: widths.append(a[0].shape[-1]) or fwd(*a))
    tbatch = tt._torch_batch(batch)
    loss = pt.loss_fn(model, tbatch)
    loss.backward()
    assert widths == [256] * SIZES["n_layers"]
    grads = tree_from_module(model, grads=True)
    if dtype == "float32":
        logits = model(tbatch["tokens"])
        np.testing.assert_allclose(logits.detach().numpy(), logits_jax,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
        tt._assert_trees_close(grads, grads_jax, rtol=1e-4, atol=1e-6)
        return
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-3)
    flat = {"embed": grads["embed"], "ln_f": grads["ln_f"], **grads["layers"]}
    flat_jax = {"embed": grads_jax["embed"], "ln_f": grads_jax["ln_f"],
                **grads_jax["layers"]}
    for key, got in flat.items():
        want = np.asarray(flat_jax[key], np.float32)
        err = np.linalg.norm(np.asarray(got, np.float32) - want)
        assert err <= 5e-2 * np.linalg.norm(want), key
