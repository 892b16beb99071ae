"""f16 on the Hopper dq and dk/dv kernels, and the loss-scaled decoder step.

On the card, f16 at every padded head dim runs all four Hopper flash
kernels (``csrc/flash_fwd.cu``, ``flash_bwd.cu``, ``flash_bwd_onepass.cu``,
each templated on bf16 and f16, the element type passed to the C entry as
a dtype code).  Here on the CPU: the route, the wrappers' dtypes and the
code each passes to its entry (through a stand-in library),
``make_train_step(grad_scaler=)`` on a tiny f32 decoder (a power-of-two
scale leaves the steps bit for bit, an overflowing one skips them and
backs off), and a small f16 decoder on the port's plain path (the
functions the f16 kernels compute) against the JAX decoder at float16,
whose Pallas flash runs in interpret mode, under the default ``pallas``
backward.

Tolerances of the f16 decoder: both sides round activations, P and dS to
f16 (2^-11 relative a rounding), but at other places (the JAX kernel
casts P at a running row max, the port at the final one; the two
frameworks round their matmuls' and norms' outputs in their own order);
over 2 layers the loss is held at 1e-4 relative and each gradient leaf's
norm error at 1e-2 of its norm, about 8x and 4x the readings (loss
1.21e-5, worst leaf 2.47e-3, ``layers.ln1``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              tree_from_module)
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.train import make_train_step, synthetic_batch
from tests import test_torch_port_transformer as tt

F16_LOSS_TOL, F16_LEAF_TOL = 1e-4, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", [32, 64, 128, 256, 384])
def test_f16_route(width):
    """f16 at every padded width: the four Hopper kernels, as bf16 goes
    (past 256 the one-pass too)."""
    assert fa._kernels_for(torch.float16, width) == fa.HOPPER_KERNELS
    assert fa._kernels_for(torch.bfloat16, width) == fa.HOPPER_KERNELS


def test_hopper_backward_takes_f16():
    """The Hopper dq and dk/dv wrappers take f16 and bf16 (the check
    before the device passes them) and no f32, at every padded width (32,
    64, 128, 256 and each multiple of 128 past 256), as the forward."""
    for kern in (fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel):
        assert set(kern.dtypes) == {torch.float16, torch.bfloat16}
        assert kern.widths is fa.PADDED_WIDTHS
        assert all(w in kern.widths for w in (32, 64, 128, 256, 384, 640))
        assert not any(w in kern.widths for w in (16, 300, 385))


def test_signatures_carry_the_dtype_code():
    """Each C entry of ``flash_bwd.cu`` takes the dtype code after
    ``causal``: seven pointers (dq) or eight (dk/dv), then bh, s, d,
    causal and the code, then the stream, as the one-pass entry does."""
    sig = fa._SIGNATURES["flash_bwd"]
    ptr, num = fa._P, fa._I
    assert sig["hvd_flash_bwd_dq"] == [ptr] * 7 + [num] * 5 + [ptr]
    assert sig["hvd_flash_bwd_dkv"] == [ptr] * 8 + [num] * 5 + [ptr]
    onepass = fa._SIGNATURES["flash_bwd_onepass"]["hvd_flash_bwd_onepass"]
    assert onepass[-2:] == [num, ptr]


class _Entry:
    """A stand-in C library: records each call's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_wrappers_pass_the_dtype_code(monkeypatch, dtype, which):
    """The dq and dk/dv wrappers pass ``DTYPE_CODES[q.dtype]`` (1 f16, 2
    bf16) as the entry's argument after ``causal``, count one launch, and
    return outputs of the kernel's types (dq f32; dk, dv in k's dtype)."""
    lib = _Entry()
    monkeypatch.setattr(fa, "_lib", lambda name: lib)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_check_kernel_args",
                        lambda kern, flat, rows=(): tuple(flat[0].shape))
    kern = {"dq": fa.flash_bwd_dq_kernel, "dkv": fa.flash_bwd_dkv_kernel}[
        which]
    monkeypatch.setattr(kern, "launches", 0)
    x = torch.zeros(2, 64, 32, dtype=dtype)
    rows = torch.zeros(2, 64)
    out = kern(x, x, x, x, rows, rows, True)
    (name, args), = lib.calls
    assert name == "hvd_flash_bwd_" + which
    code = {torch.float16: 1, torch.bfloat16: 2}[dtype]
    assert args[-6:] == (2, 64, 32, 1, code, 0)  # bh, s, d, causal, code
    assert kern.launches == 1
    if which == "dq":
        assert out.dtype == torch.float32 and out.shape == (2, 64, 32)
    else:
        assert all(t.dtype == dtype and t.shape == (2, 64, 32) for t in out)


TINY = pt.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                            n_kv_heads=2, d_ff=64, max_seq=32,
                            dtype="float32", logits_dtype="f32")


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _steps(scaler, n=2, cfg=TINY):
    """``n`` Adam steps of the tiny decoder from the same weights and
    data -> (losses, parameters after them)."""
    build, shard_batch = make_train_step(
        cfg, lambda ps: torch.optim.Adam(ps, 1e-3), device="cpu",
        grad_scaler=scaler)
    step, model, _ = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_batch(cfg, 4, seed=0))
    losses = [step(data).item() for _ in range(n)]
    return losses, {k: p.detach().clone()
                    for k, p in model.named_parameters()}


def test_decoder_scaled_step_is_the_plain_step(world):
    """A power-of-two scale multiplies every gradient exactly and
    ``unscale_`` divides it back exactly, so two scaled steps are the
    plain steps bit for bit, and the scale stays (it grows only after its
    growth interval)."""
    want_losses, want = _steps(None)
    scaler = torch.amp.GradScaler("cpu", init_scale=2.0 ** 10)
    losses, got = _steps(scaler)
    assert losses == want_losses
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    assert scaler.get_scale() == 2.0 ** 10


def test_decoder_overflowing_scale_skips_the_step(world):
    """With f16 activations, a scale of 2^40 takes the activations'
    gradients past f16's range in the backward: the parameters' gradients
    are not finite, so the scaler skips both optimizer steps (the weights
    stay the initial ones) and halves the scale each time."""
    f16 = dataclasses.replace(TINY, dtype="float16")
    scaler = torch.amp.GradScaler("cpu", init_scale=2.0 ** 40)
    _, got = _steps(scaler, cfg=f16)
    assert scaler.get_scale() == 2.0 ** 38
    _, start = _steps(None, n=0, cfg=f16)
    for name, p in start.items():
        assert torch.equal(got[name], p), name


def test_f16_decoder_matches_jax(monkeypatch):
    """2 layers, d_model 256, two heads of 128, seq 128, f16 activations
    and f32 logits on both sides, flash on under ``pallas``: the port's
    attention is the plain versions in f16 (what the f16 Hopper kernels
    compute), the JAX decoder's its Pallas flash in interpret mode."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", "pallas")
    sizes = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=128)
    monkeypatch.setattr(tt, "SIZES", {**tt.SIZES, **sizes})
    jcfg, pcfg = tt._cfgs(dtype="float16")
    assert pcfg.head_dim == 128
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(5), jcfg))
    batch = tt._batch()
    loss_jax, grads_jax, _ = tt._jax_loss_and_grads(jcfg, params, batch)
    model = params_from_jax(params, pcfg, device="cpu")
    seen = []
    bwd = fa.flash_bwd
    monkeypatch.setattr(fa, "flash_bwd",
                        lambda *a: seen.append(a[0].dtype) or bwd(*a))
    loss = pt.loss_fn(model, tt._torch_batch(batch))
    loss.backward()
    assert seen == [torch.float16] * 2
    assert abs(loss.item() - loss_jax) <= F16_LOSS_TOL * abs(loss_jax)
    got = tree_from_module(model, grads=True)
    pairs = {k: (got[k], grads_jax[k]) for k in ("embed", "ln_f")}
    pairs.update({k: (got["layers"][k], grads_jax["layers"][k])
                  for k in tt.LAYER_KEYS})
    for name, (g, w) in pairs.items():
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= F16_LEAF_TOL * np.linalg.norm(w), \
            name
