"""The Hopper one-pass backward at head dim 256: its 64-row dq partial
slots, what its wrapper refuses before the device, the route it joins,
the function it computes against the JAX package's Pallas one-pass, and a
decoder with 256-wide heads under ``HVD_TPU_FLASH_BWD=pallas_onepass``
against the JAX decoder.

``flash_bwd_onepass_kernel`` (``csrc/flash_bwd_onepass.cu``) takes bf16 and
f16 at 32, 64, 128 and 256; at 256 a block holds 64 rows of K and V (the
dk/dv plan there, ``flash_bwd_kv.cuh``'s ``kv256::kblock_body``), so its
dq partials come one slot per 64 rows of k (``onepass_block_k``), where
every other width keeps 128.  The CUDA-core twin and the plain version
take the same slots.  So on the card bf16 and f16 run all four flash
kernels on Hopper up to 256.  Here, on the CPU, the wrapper raises on
what it does not take before it looks at the device, and the plain
versions run.  The plain backward with dP - delta formed in f64
(``exact_dp``, what ``chip_smoke.py`` holds the Hopper backward kernels
to on the card) is the f32 plain version up to f32 rounding.

The plain one-pass at D 256 (what the kernel computes, and what
``chip_smoke.py`` holds it to on the card, slot by slot) is held against
``horovod_tpu.ops.pallas_kernels._flash_attention_bwd_onepass_flat`` with
64-row blocks (the JAX package's smallest k block, the port's slot at 256)
in Pallas interpret mode on the same inputs, lse and delta, in f16 and
bf16: a ragged causal shape for the port's slots (S 192: three slots, the
first q rows of the later ones dead) and a full one (S 128).  Both sides
take P from the final lse and sum f32 partials; P and dS are cast at
values that differ in their last f32 bits (another exp, another order),
so a cast now and then lands one unit of the working type apart, and dk
and dv are rounded to it.  Readings of |plain - JAX| / (1 + |JAX|) over
both shapes: at most 6.6e-5 (dq), 3.0e-4 (dk) and 4.1e-4 (dv) in f16,
5.8e-4, 8.1e-4 and 4.5e-4 in bf16.  Limits: f16 2e-3, about 4x its
largest; bf16 1.6e-2, four bf16 units at unit scale (one unit, 3.9e-3,
would sit at 5x its largest reading).

The decoder is ``test_torch_port_hopper_wide_fwd.py``'s (2 layers, 2 heads
of 256, d_model 512, d_ff 256, vocab 256, seq 128, batch 2: two 64-row
slots a head), flash on both sides under ``pallas_onepass``, the JAX side
with ``HVD_TPU_FLASH_BLOCK_K=64`` (its Pallas flash in interpret mode).
f32: logits and loss at 1e-5, gradients at 1e-4 relative, as
``test_torch_port_transformer.py`` holds f32.  bf16 (logits from bf16
operands on both sides): the JAX forward rounds P at a running row max
where the plain version rounds it at the final one; loss at 1e-3 relative
and each gradient's relative norm error at 5e-2, the limits
``chip_smoke.py`` holds the full-width step to.  Readings: f32 loss 0
(equal), logits at 0.79 of their limit, every gradient within 0.17 of its
limit; bf16 loss 2.8e-5, worst gradient 1.8e-2 (ln1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import _flash_attention_bwd_onepass_flat
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_transformer as tt

TOL = {torch.float16: 2e-3, torch.bfloat16: 1.6e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width,slot", [(32, 128), (64, 128), (128, 128),
                                        (256, 64), (384, 128)])
def test_slot_rule(width, slot):
    """64 rows of k per partial slot at 256, 128 at every other padded
    width; the plain version's partials (BH, ceil(S / slot), S, width)
    sum to the plain two-pass dq at a ragged S."""
    assert fa.onepass_block_k(width) == slot
    assert fa.BLOCK_K == 128
    bh, s = 2, 130
    rng = np.random.RandomState(width)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, s, width).astype(np.float32))
                  for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, True)
    delta = (g * o).sum(-1)
    partials, dk, dv = fa.flash_bwd_onepass_reference(q, k, v, g, lse, delta,
                                                      True)
    assert tuple(partials.shape) == (bh, -(-s // slot), s, width)
    for t in range(partials.shape[1]):  # rows above each slot's diagonal
        assert torch.count_nonzero(partials[:, t, :slot * t]) == 0
    dq, dk2, dv2 = fa.flash_bwd_reference(q, k, v, g, lse, delta, True)
    torch.testing.assert_close(partials.sum(1), dq, rtol=1e-5, atol=1e-5)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_exact_dp_reference(width, causal):
    """The plain backward with dP - delta formed in f64 (``exact_dp``, what
    ``chip_smoke.py`` holds the Hopper kernels to) is the f32 plain version
    up to f32 rounding, and ``exact_dp=False`` is the f32 plain version bit
    for bit."""
    bh, s = 2, 130
    rng = np.random.RandomState(width + causal)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, s, width).astype(np.float32))
                  for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g * o).sum(-1)
    args = (q, k, v, g, lse, delta, causal)
    for ref in (fa.flash_bwd_reference, fa.flash_bwd_onepass_reference):
        plain, off, exact = ref(*args), ref(*args, exact_dp=False), \
            ref(*args, exact_dp=True)
        for a, b, c in zip(plain, off, exact):
            assert torch.equal(a, b)
            assert c.dtype == a.dtype and c.shape == a.shape
            torch.testing.assert_close(c, a, rtol=1e-5,
                                       atol=1e-5 * a.abs().max().item())


class _Entry:
    """A stand-in C library: records each call's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("kern", [fa.flash_bwd_onepass_kernel,
                                  fa.flash_bwd_onepass_simt_kernel],
                         ids=lambda k: k.__name__)
def test_wrappers_allocate_and_pass_the_slot(monkeypatch, kern, width):
    """Each one-pass wrapper allocates ceil(S / slot) partial slots and
    passes the slot's rows as the entry's ``block_k`` (after ``causal``),
    which the entry holds to its own plan: 64 at 256, 128 at 128."""
    lib = _Entry()
    monkeypatch.setattr(fa, "_lib", lambda name: lib)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_check_kernel_args",
                        lambda k, flat, rows=(): tuple(flat[0].shape))
    monkeypatch.setattr(kern, "launches", 0)
    bh, s = 2, 200
    x = torch.zeros(bh, s, width, dtype=torch.bfloat16)
    rows = torch.zeros(bh, s)
    partials, dk, dv = kern(x, x, x, x, rows, rows, True)
    (name, args), = lib.calls
    slot = 64 if width == 256 else 128
    assert name.endswith("flash_bwd_onepass")
    assert args[9:14] == (bh, s, width, 1, slot)  # bh, s, d, causal, block_k
    assert partials.dtype == torch.float32
    assert tuple(partials.shape) == (bh, -(-s // slot), s, width)
    assert kern.launches == 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_d256_route_is_hopper(dtype):
    """bf16 and f16 at 256: all four flash kernels on Hopper, the one-pass
    too, each taking the dtype and the width."""
    route = fa._kernels_for(dtype, 256)
    assert route == fa.HOPPER_KERNELS
    assert route[3] is fa.flash_bwd_onepass_kernel
    for kern in route:
        assert dtype in kern.dtypes and 256 in kern.widths


def _bwd_args(width, dtype, s=64, bh=2):
    x = torch.zeros(bh, s, width, dtype=dtype)
    rows = torch.zeros(bh, s)
    return (x, x, x, x, rows, rows, True)


def test_d256_onepass_refuses_f32_and_257():
    """At 256 f32 raises for its dtype and 257 for its width, both before
    the device is looked at; bf16 and f16 at 256 pass those checks and
    raise only because their tensors lie on the CPU."""
    kern = fa.flash_bwd_onepass_kernel
    with pytest.raises(ValueError, match="one dtype of"):
        kern(*_bwd_args(256, torch.float32))
    with pytest.raises(ValueError, match="head_dim in"):
        kern(*_bwd_args(257, torch.bfloat16))
    for dtype in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kern(*_bwd_args(256, dtype))


# (S, causal): ragged for the port's 64-row slots' diagonal, and full
SHAPES = ((192, True), (128, False))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("s,causal", SHAPES)
def test_plain_d256_onepass_matches_pallas(s, causal, dtype):
    """dq (the summed partials), dk and dv of the plain one-pass at BH 2,
    D 256 against the JAX one-pass (its Pallas kernel in interpret mode,
    64-row blocks) on the same inputs, lse and delta."""
    bh, d = 2, 256
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32)
                  * (1 / np.sqrt(d) if i == 0 else 1.0) for i in range(4))
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (g.float() * o.float()).sum(-1)
    partials, dk, dv = fa.flash_bwd_onepass_reference(q, k, v, g, lse, delta,
                                                      causal)
    assert tuple(partials.shape) == (bh, s // 64, s, d)
    assert (partials.dtype, dk.dtype, dv.dtype) == (torch.float32, dtype,
                                                    dtype)
    jdtype = jnp.float16 if dtype == torch.float16 else jnp.bfloat16

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            jdtype if t.dtype == dtype else jnp.float32)

    want = _flash_attention_bwd_onepass_flat(
        jx(q), jx(k), jx(v), jx(g), jx(lse)[..., None], jx(delta)[..., None],
        causal=causal, block_q=64, block_k=64, interpret=True)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              (partials.sum(1), dk, dv), want):
        assert ref.dtype == (jnp.float32 if name == "dq" else jdtype), name
        ref = np.asarray(ref, np.float32)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1, name
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)


SIZES = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2,
             n_kv_heads=2, d_ff=256, max_seq=128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd256_decoder_onepass_matches_jax(monkeypatch, dtype):
    """The decoder with 256-wide heads under ``pallas_onepass``: the port's
    flash path (the plain one-pass at width 256, 64-row slots) against the
    JAX decoder's flash (its Pallas one-pass in interpret mode, 64-row k
    blocks), logits, loss and gradients within the module's tolerances."""
    monkeypatch.setattr(tt, "SIZES", SIZES)
    kw = dict(dtype=dtype, logits_dtype="bf16" if dtype == "bfloat16"
              else "f32")
    jcfg, pcfg = tt._cfgs(**kw)
    assert pcfg.head_dim == 256 and pcfg.n_heads == pcfg.d_model // 256
    params = tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(7), jcfg))
    batch = tt._batch()
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", "pallas_onepass")
    monkeypatch.setenv("HVD_TPU_FLASH_BLOCK_K", "64")
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
    assert slots == [(n_heads, SIZES["max_seq"] // 64, SIZES["max_seq"],
                      256)] * SIZES["n_layers"]
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
