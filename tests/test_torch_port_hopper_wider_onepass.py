"""The Hopper one-pass backward past head dim 256: the route it joins, what
its wrapper refuses before the device and the slots it allocates, the
function it computes slot by slot against the JAX package's Pallas
one-pass, the kernels ``chip_smoke.py`` holds there, the launches its
hd512 decoder step must count, and a decoder with 512-wide heads under
``HVD_TPU_FLASH_BWD=pallas_onepass`` against the JAX decoder.

``flash_bwd_onepass_kernel`` (``csrc/flash_bwd_onepass.cu``) takes bf16 and
f16 at every padded width; past 256 it is dk/dv's panel kernel
(``flash_bwd_kv.cuh``'s ``wide::kv_body``) with one block per 128-row dq
slot and panel, which walks the slot's two 64-row k blocks, so its
partials come one slot per 128 rows of k (``onepass_block_k``), as the
CUDA-core twin's, the f32 one-pass's and the plain version's do.  So on
the card bf16 and f16 run all four flash kernels on Hopper at every
width, and no route takes a CUDA-core kernel.  Here, on the CPU, the
wrapper raises on what it does not take before it looks at the device,
and the plain versions run.

The plain one-pass at D 384 (what the kernel computes, and what
``chip_smoke.py`` holds it to on the card, slot by slot) is held slot by
slot against the JAX package's ``_flash_bwd_onepass_kernel`` in Pallas
interpret mode, launched as ``_flash_attention_bwd_onepass_flat``
launches it with 128-row blocks but with its per-slot partials returned
before the sum, on the same inputs, lse and delta, in f16 and bf16: a
ragged causal shape (S 130: two slots, the second's first 128 rows dead,
its last 2 live) and a full one (S 256).  The JAX kernel takes no ragged
S, so at S 130 it runs on the inputs zero-padded to 256 rows with delta
0 there: padded k rows lie past every real q row's diagonal, and padded
q rows have g 0, so dS and P^T g are 0 there and the real rows' partials,
dk and dv are those of S 130 exactly.  Both sides take P from the final
lse and sum f32 partials; P and dS are cast at values that differ in
their last f32 bits (another exp, another order), so a cast now and then
lands one unit of the working type apart, and dk and dv are rounded to
it.  Readings of |plain - JAX| / (1 + |JAX|) over both shapes: at most
3.5e-4 (the partials), 1.8e-4 (dk) and 1.8e-4 (dv) in f16, 3.9e-3,
1.5e-3 and 1.4e-3 in bf16.  Limits as the D-256 one-pass's: f16 2e-3,
bf16 1.6e-2 (four bf16 units at unit scale), about 4x the largest.

The decoder: 1 layer, 2 heads of 512 (d_model 1024, the hd512 flagship's
heads), d_ff 256, vocab 256, seq 256 (two 128-row slots a head), batch 2,
flash on both sides under ``pallas_onepass``, the JAX side with
``HVD_TPU_FLASH_BLOCK_K=128`` (its Pallas flash in interpret mode).  f32:
logits and loss at 1e-5, gradients at 1e-4 relative, as
``test_torch_port_transformer.py`` holds f32; bf16 (logits from bf16
operands on both sides): loss at 1e-3 relative and each gradient's
relative norm error at 5e-2, the limits ``chip_smoke.py`` holds the
hd512 step to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from horovod_tpu.ops.pallas_kernels import _flash_bwd_onepass_kernel
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_transformer as tt

TOL = {torch.float16: 2e-3, torch.bfloat16: 1.6e-2}
WIDTHS = (384, 512, 640, 1024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("width", WIDTHS)
def test_route_past_256_is_hopper(dtype, width):
    """bf16 and f16 at each multiple of 128 past 256: the four Hopper
    kernels, the one-pass among them; f32 the four f32 ones as before;
    no CUDA-core kernel in any dtype.  Each kernel takes the dtype and
    the width."""
    route = fa._kernels_for(dtype, width)
    if dtype == torch.float32:
        assert route == fa.F32_KERNELS
    else:
        assert route == fa.HOPPER_KERNELS
        assert route[3] is fa.flash_bwd_onepass_kernel
    assert not set(route) & set(fa.SIMT_KERNELS)
    for kern in route:
        assert dtype in kern.dtypes and width in kern.widths


def _bwd_args(width, dtype, s=64, bh=2):
    x = torch.zeros(bh, s, width, dtype=dtype)
    rows = torch.zeros(bh, s)
    return (x, x, x, x, rows, rows, True)


def test_wrapper_refuses_f32_and_unpadded_widths():
    """Past 256 f32 raises for its dtype, 300 and 385 for their widths,
    all before the device is looked at; bf16 and f16 at 384 and 640 pass
    those checks and raise only because their tensors lie on the CPU."""
    kern = fa.flash_bwd_onepass_kernel
    with pytest.raises(ValueError, match="one dtype of"):
        kern(*_bwd_args(384, torch.float32))
    for width in (300, 385):
        with pytest.raises(ValueError, match="head_dim in"):
            kern(*_bwd_args(width, torch.bfloat16))
    for dtype in (torch.bfloat16, torch.float16):
        for width in (384, 640):
            with pytest.raises(ValueError, match="CUDA kernel"):
                kern(*_bwd_args(width, dtype))


class _Entry:
    """A stand-in C library: records each call's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("width", [384, 640])
def test_wrapper_allocates_and_passes_128_row_slots(monkeypatch, width,
                                                    dtype):
    """Past 256 the wrapper allocates ceil(S / 128) f32 partial slots and
    passes 128 as the entry's ``block_k`` (after ``causal``), then the
    dtype's code; the entry holds it to its own plan."""
    lib = _Entry()
    monkeypatch.setattr(fa, "_lib", lambda name: lib)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_check_kernel_args",
                        lambda k, flat, rows=(): tuple(flat[0].shape))
    kern = fa.flash_bwd_onepass_kernel
    monkeypatch.setattr(kern, "launches", 0)
    bh, s = 2, 200
    x = torch.zeros(bh, s, width, dtype=dtype)
    rows = torch.zeros(bh, s)
    partials, dk, dv = kern(x, x, x, x, rows, rows, True)
    (name, args), = lib.calls
    assert name == "hvd_flash_bwd_onepass"
    # bh, s, d, causal, block_k, dtype code
    assert args[9:15] == (bh, s, width, 1, 128, fa.DTYPE_CODES[dtype])
    assert fa.onepass_block_k(width) == 128
    assert partials.dtype == torch.float32
    assert tuple(partials.shape) == (bh, 2, s, width)
    assert dk.dtype == dv.dtype == dtype
    assert kern.launches == 1


@functools.lru_cache(maxsize=None)
def _jax_onepass_partials(causal, block):
    """The JAX package's one-pass kernel in interpret mode, launched as
    ``_flash_attention_bwd_onepass_flat`` launches it, returning the
    per-slot f32 partials (BH, S / block, S, D) before their sum, dk and
    dv; jitted once per (causal, block)."""

    def run(q, k, v, g, lse, delta):
        bh, seq, d = q.shape
        nk = seq // block
        qspec = pl.BlockSpec((1, block, d), lambda i, t, j: (i, j, 0))
        kspec = pl.BlockSpec((1, block, d), lambda i, t, j: (i, t, 0))
        rowspec = pl.BlockSpec((1, block, 1), lambda i, t, j: (i, j, 0))
        return pl.pallas_call(
            functools.partial(_flash_bwd_onepass_kernel, block_q=block,
                              block_k=block, causal=causal),
            grid=(bh, nk, seq // block),
            in_specs=[qspec, kspec, kspec, qspec, rowspec, rowspec],
            out_specs=[
                pl.BlockSpec((1, 1, block, d), lambda i, t, j: (i, t, j, 0)),
                pl.BlockSpec((1, block, d), lambda i, t, j: (i, t, 0)),
                pl.BlockSpec((1, block, d), lambda i, t, j: (i, t, 0))],
            out_shape=[jax.ShapeDtypeStruct((bh, nk, seq, d), jnp.float32),
                       jax.ShapeDtypeStruct(k.shape, k.dtype),
                       jax.ShapeDtypeStruct(v.shape, v.dtype)],
            scratch_shapes=[pltpu.VMEM((block, d), jnp.float32),
                            pltpu.VMEM((block, d), jnp.float32)],
            interpret=True)(q, k, v, g, lse, delta)

    return jax.jit(run)


# (S, causal): ragged causal (two slots, the last 2 rows live in the
# second) and full (two whole slots)
SHAPES = ((130, True), (256, False))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("s,causal", SHAPES)
def test_plain_onepass_slots_match_pallas(s, causal, dtype):
    """Each 128-row slot's dq partial, dk and dv of the plain one-pass at
    BH 2, D 384 against the JAX one-pass kernel's (Pallas interpret mode,
    128-row blocks) on the same inputs, lse and delta."""
    bh, d, block = 2, 384, 128
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32)
                  * (1 / np.sqrt(d) if i == 0 else 1.0) for i in range(4))
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g.float() * o.float()).sum(-1)
    partials, dk, dv = fa.flash_bwd_onepass_reference(q, k, v, g, lse, delta,
                                                      causal)
    nk = -(-s // block)
    assert tuple(partials.shape) == (bh, nk, s, d)
    assert (partials.dtype, dk.dtype, dv.dtype) == (torch.float32, dtype,
                                                    dtype)
    if causal:  # the rows above each slot's diagonal are zeros
        for t in range(nk):
            assert torch.count_nonzero(partials[:, t, :block * t]) == 0
    jdtype = jnp.float16 if dtype == torch.float16 else jnp.bfloat16
    pad = nk * block - s  # zero rows past S, delta 0 there (causal only)
    assert causal or pad == 0

    def jx(t, rows=False):
        x = jnp.asarray(t.float().numpy()).astype(
            jdtype if t.dtype == dtype else jnp.float32)
        x = jnp.pad(x, ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2))
        return x[..., None] if rows else x

    dqp, dk_j, dv_j = _jax_onepass_partials(causal, block)(
        jx(q), jx(k), jx(v), jx(g), jx(lse, True), jx(delta, True))
    want = (np.asarray(dqp)[:, :, :s], np.asarray(dk_j[:, :s], np.float32),
            np.asarray(dv_j[:, :s], np.float32))
    for name, got, ref in zip(("dq partials", "dk", "dv"),
                              (partials, dk, dv), want):
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1, name
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chip_smoke_holds_the_four_hopper_kernels_past_256(dtype):
    """``chip_smoke.flash_kernels`` names all four Hopper kernels at 384
    in bf16 and f16, so its phase 2 holds the one-pass there (its
    partials in a NaN-poisoned block, its panels and a second launch bit
    for bit)."""
    kern = chip_smoke.flash_kernels(fa, dtype, "hopper", 384)
    assert kern == dict(zip(chip_smoke.FLASH_KERNELS, fa.HOPPER_KERNELS))


def test_hd512_step_counts_under_pallas_onepass():
    """One step of the hd512 decoder (12 layers) under ``pallas_onepass``
    must count 12 Hopper forwards and 12 Hopper one-pass launches, and
    ``check_counts`` refuses any other flash launch, a CUDA-core one-pass
    among them."""
    want = chip_smoke.wide_decoder_counts(12)
    assert want["pallas_onepass"] == {"flash_fwd_kernel": 12,
                                      "flash_bwd_onepass_kernel": 12}
    assert want["pallas"] == {"flash_fwd_kernel": 12,
                              "flash_bwd_dq_kernel": 12,
                              "flash_bwd_dkv_kernel": 12}
    hopper = {k.__name__ for k in fa.HOPPER_KERNELS}
    for counts in want.values():
        assert set(counts) <= hopper
    counts = dict.fromkeys(fa.launch_counts(), 0)
    counts.update(want["pallas_onepass"])
    chip_smoke.check_counts(counts, want["pallas_onepass"])
    counts["flash_bwd_onepass_simt_kernel"] = 12
    with pytest.raises(AssertionError, match="onepass_simt"):
        chip_smoke.check_counts(counts, want["pallas_onepass"])


SIZES = dict(vocab_size=256, d_model=1024, n_layers=1, n_heads=2,
             n_kv_heads=2, d_ff=256, max_seq=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd512_decoder_onepass_matches_jax(monkeypatch, dtype):
    """The decoder with 512-wide heads under ``pallas_onepass``: the port's
    flash path (the plain one-pass at width 512, 128-row slots) against
    the JAX decoder's flash (its Pallas one-pass in interpret mode,
    128-row k blocks), logits, loss and gradients within the module's
    tolerances."""
    monkeypatch.setattr(tt, "SIZES", SIZES)
    kw = dict(dtype=dtype, logits_dtype="bf16" if dtype == "bfloat16"
              else "f32")
    jcfg, pcfg = tt._cfgs(**kw)
    assert pcfg.head_dim == 512 and pcfg.n_heads == 2
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(9), jcfg))
    batch = tt._batch()
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", "pallas_onepass")
    monkeypatch.setenv("HVD_TPU_FLASH_BLOCK_K", "128")
    loss_jax, grads_jax, logits_jax = tt._jax_loss_and_grads(jcfg, params,
                                                             batch)
    model = params_from_jax(params, pcfg, device="cpu")
    slots = []
    onepass = fa.flash_bwd_onepass_reference
    monkeypatch.setattr(
        fa, "flash_bwd_onepass_reference",
        lambda *a: (lambda out: slots.append(tuple(out[0].shape)) or out)(
            onepass(*a)))
    tbatch = tt._torch_batch(batch)
    loss = pt.loss_fn(model, tbatch)
    loss.backward()
    n_heads = tt.BATCH * SIZES["n_heads"]
    assert slots == [(n_heads, SIZES["max_seq"] // 128, SIZES["max_seq"],
                      512)] * SIZES["n_layers"]
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
