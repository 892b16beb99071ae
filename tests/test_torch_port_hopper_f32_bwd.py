"""The f32 dq and dk/dv on Hopper (``flash_bwd_dq_f32_kernel``,
``flash_bwd_dkv_f32_kernel``, ``csrc/flash_bwd_f32.cu``): their route,
their refusals before the device, the transposed copies their wrappers
pass, and their arithmetic emulated in torch.

On the card f32 runs the forward, dq, dk/dv and the one-pass on Hopper at
every padded width (the one-pass: ``test_torch_port_hopper_f32_onepass.py``).  The two kernels form S (S^T)
and the three output products (dS K, P^T dO, dS^T Q) in split TF32, as
``test_torch_port_hopper_f32_fwd.py``'s helpers emulate it: each
operand's hi (its top 19 bits) and lo, three TF32 products, the tensor
core's truncating sums in the kernels' chains (a fresh accumulator per
32-column chunk of the scores and per 64 keys or q rows of a product,
added in f32).  dP (dP^T) they form on the CUDA cores as the plain
version does, one f32 fma chain per element over D in order: here the
plain version's own f32 product.  The emulated backward is held to the
f32 plain version under ``chip_smoke.py``'s f32 limits
(``SIMT_TOL["float32"]``, by its ``compare``), the limits the kernels are
held to on the card.

Why dP stays on the CUDA cores: dS = P (dP - delta) cancels at a row
whose weight one key holds (a causal row 0 exactly), where dq is rounding
noise of the order dP was summed in.  Readings of ``worst`` (at most 1
passes) at BH 2, S 200 (dq, dk, dv): the design 0.20-0.39 at D 64, 256
and 384, causal and full; at D 64, causal, dq with dP in split TF32 3.46
and with a correctly rounded f32 dP 2.88 (the design 0.21); a dropped
split term 118-143; one truncating chain per row at D 640 1.58-1.9.
Against the JAX package's flash backward in f32 (Pallas in interpret
mode), through ``flash_attention``: at most 3.3e-6 of |port - JAX| / (1 +
|JAX|) (tolerance 2e-4, as ``test_torch_port_flash_dtypes.py`` holds
f32).

JAX is imported by that test alone, so that ``tools/chip_simt_probe.py
--f32-bwd`` can run this file's emulation on the card, where there is no
JAX.
"""

import functools
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_hopper_f32_fwd as fwd_emu

PADDED = (32, 64, 128, 256, 384, 512, 640)
F32_TOL = cs.SIMT_TOL["float32"]
THREE = fwd_emu.SMALL + ("hi_hi",)
# The kernels' chains of k-steps of 8 into one accumulator: the scores per
# 32-column chunk, the output products per 64 keys or q rows.
KERNEL_CHAINS = (4, 8)
BWD_KERNELS = (fa.flash_bwd_dq_f32_kernel, fa.flash_bwd_dkv_f32_kernel)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", PADDED)
def test_f32_backward_route_at_every_padded_width(width):
    """f32 at every padded width: the forward, dq, dk/dv and the one-pass
    on Hopper; bf16 and f16 keep their route."""
    route = fa._kernels_for(torch.float32, width)
    assert route == fa.F32_KERNELS
    assert route[3] is fa.flash_bwd_onepass_f32_kernel
    for kern in route:
        assert torch.float32 in kern.dtypes and width in kern.widths
    for dtype in (torch.bfloat16, torch.float16):
        assert not set(fa._kernels_for(dtype, width)) & set(fa.F32_KERNELS)


@pytest.mark.parametrize("kern", BWD_KERNELS, ids=lambda k: k.__name__)
@pytest.mark.parametrize("dtype,width,msg", [
    (torch.bfloat16, 128, "one dtype of"),
    (torch.float16, 384, "one dtype of"),
    (torch.float32, 96, "head_dim in"),
    (torch.float32, 300, "head_dim in"),
    (torch.float32, 384, "CUDA kernel"),
])
def test_f32_backward_refuses_before_the_device(kern, dtype, width, msg):
    """Each wrapper takes f32 at a padded width only, and raises on another
    dtype or width before it looks at the device; what it takes raises
    here for lying on the CPU.  No refusal counts as a launch."""
    fa.reset_launch_counts()
    x = torch.zeros(2, 64, width, dtype=dtype)
    rows = torch.zeros(2, 64)
    with pytest.raises(ValueError, match=msg):
        kern(x, x, x, x, rows, rows, True)
    assert kern.launches == 0


@pytest.mark.parametrize("s", [1, 64, 130, 200])
def test_transposed_copies_layout(s):
    """K^T (dq), Q^T and dO^T (dk/dv) as the wrappers pass them,
    ``f32_vt``: (BH, D, S8) contiguous f32, S8 the next multiple of 8;
    column 8 j + 4 h + c holds row 8 j + 2 c + h, so each group of 8 rows
    lies in the order 0, 2, 4, 6, 1, 3, 5, 7; the padded rows are zero."""
    rng = np.random.RandomState(s)
    x = torch.from_numpy(rng.randn(3, s, 64).astype(np.float32))
    xt = fa.f32_vt(x)
    s8 = -(-s // 8) * 8
    assert xt.shape == (3, 64, s8) and xt.is_contiguous()
    order = [xt[0, 0, 8 * j:8 * j + 8].tolist() for j in range(s8 // 8)]
    for j, got in enumerate(order):
        rows = [8 * j + r for r in (0, 2, 4, 6, 1, 3, 5, 7)]
        assert got == [x[0, r, 0].item() if r < s else 0.0 for r in rows]


def emulated_bwd(q, k, v, g, lse, delta, causal, form="trunc", terms=THREE,
                 chains=KERNEL_CHAINS, dp="plain"):
    """The kernels' function in torch -> (dq, dk, dv): S (dq's) and S^T
    (dk/dv's) in split TF32, P and P^T from lse, dP as ``dp`` says
    ("plain": the plain version's f32 product, the kernels' CUDA-core fma
    chains; "split": split TF32 in the scores' chains; "rounded": the f32
    value nearest the exact one), dS = P (dP - delta), and the three output
    products in split TF32.  ``chains``: the scores' and the products'
    chain lengths of the tensor core's truncating sums (None: f32 sums)."""
    ds, dst, pt = emulated_scores(q, k, v, g, lse, delta, causal, form, terms,
                                  chains, dp)
    p_chain = (chains or (None, None))[1]
    # dS K, dS^T Q and P^T dO as the kernels form them: the left operand's
    # columns as the A fragments hold them, against f32_vt(right) K-major
    return tuple(fwd_emu.pv_as_the_kernel(a, b, form, terms, p_chain)
                 for a, b in ((ds, k), (dst, q), (pt, g)))


def emulated_scores(q, k, v, g, lse, delta, causal, form="trunc",
                    terms=THREE, chains=KERNEL_CHAINS, dp="plain"):
    """``emulated_bwd``'s dS (dq's, from S), dS^T and P^T (dk/dv's, from
    S^T), as the kernels form them."""
    s_chain = (chains or (None, None))[0]
    keep = fa._causal_keep(q.shape[1], q.device)

    def dots(a, b):
        if dp == "plain":
            return a @ b.transpose(-1, -2)
        if dp == "rounded":
            return (a.double() @ b.double().transpose(-1, -2)).float()
        return fwd_emu.split_product(a, b.transpose(-1, -2), form, terms,
                                     s_chain)

    s = fwd_emu.split_product(q, k.transpose(-1, -2), form, terms, s_chain)
    p = torch.exp(s - lse[..., None])
    st = fwd_emu.split_product(k, q.transpose(-1, -2), form, terms, s_chain)
    pt = torch.exp(st - lse[..., None, :])
    if causal:
        p, pt = p.masked_fill(~keep, 0.0), pt.masked_fill(~keep.T, 0.0)
    ds = p * (dots(g, v) - delta[..., None])
    dst = pt * (dots(v, g) - delta[..., None, :])
    return ds, dst, pt


def inputs(bh, s, d, seed, causal=True):
    """q (pre-scaled), k, v, g from a seed, and lse and delta from the f32
    plain forward."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                  for _ in range(4))
    q = q / math.sqrt(d)
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    return q, k, v, g, lse, (g * o).sum(-1)


def worst(got, args, causal):
    """compare's ``worst`` of each of (dq, dk, dv) against the f32 plain
    version under the f32 limits."""
    want = fa.flash_bwd_reference(*args, causal)
    return [cs.compare(a, b, *F32_TOL)["worst"] for a, b in zip(got, want)]


def test_fragment_order_sums_every_row_once():
    """The products over keys or q rows, with a's columns in the A
    fragments' order against f32_vt's, are the plain products, exactly on
    integers (at S 13, a ragged group of 8)."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randint(-4, 5, (2, 13, 13)).astype(np.float32))
    b = torch.from_numpy(rng.randint(-4, 5, (2, 13, 64)).astype(np.float32))
    torch.testing.assert_close(
        fwd_emu.pv_as_the_kernel(a, b, "trunc", THREE, 8), a @ b, rtol=0,
        atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256, 384])
def test_emulated_backward_within_the_f32_limits(d, causal):
    """The design, emulated with the tensor core's truncating sums in the
    kernels' chains, against the f32 plain version at BH 2, S 200: dq, dk
    and dv each under chip_smoke's f32 limits."""
    args = inputs(2, 200, d, d + 7, causal)
    assert max(worst(emulated_bwd(*args, causal), args, causal)) <= 1.0


@pytest.mark.parametrize("dropped", fwd_emu.SMALL)
def test_a_dropped_split_term_fails_the_f32_limits(dropped):
    """Two TF32 terms put dq, dk and dv past the f32 limits by far: the
    check on the card can see a kernel that drops one."""
    args = inputs(2, 200, 256, 11)
    kept = tuple(t for t in fwd_emu.SMALL if t != dropped) + ("hi_hi",)
    assert min(worst(emulated_bwd(*args, True, terms=kept), args,
                     True)) > 16


def test_one_truncating_chain_fails_the_f32_limits():
    """Summed in one chain each (all of D into S, all keys or q rows into a
    product), the truncating sums drift past the f32 limits in every
    output at D 640, S 200: why the kernels add their chunks and tiles in
    f32."""
    args = inputs(2, 200, 640, 647)
    got = emulated_bwd(*args, True, chains=("all", "all"))
    assert min(worst(got, args, True)) > 1.0


@pytest.mark.parametrize("dp", ["split", "rounded"])
def test_dp_off_the_plain_order_fails_dq(dp):
    """dP summed otherwise than the plain version sums it puts dq past the
    f32 limits at a causal shape (row 0, where dS = P (dP - delta) is the
    rounding of dP and delta): in split TF32, and even correctly rounded.
    Why the kernels form dP on the CUDA cores in the plain version's
    order."""
    args = inputs(2, 200, 64, 71)
    assert worst(emulated_bwd(*args, True, dp=dp), args, True)[0] > 1.0


JAX_CASES = ((64, True), (192, True), (320, False))


@functools.lru_cache(maxsize=None)
def _jax_backward():
    """{(d, causal): (q, k, v, g, JAX dq, dk, dv)}: B 1, S 72, H 2 from a
    seed, the JAX flash backward in f32 (Pallas in interpret mode, the
    default ``pallas`` backward) in one jitted program."""
    import jax
    from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
    cases = []
    for d, causal in JAX_CASES:
        rng = np.random.RandomState(d + 1)
        cases.append(tuple(rng.randn(1, 72, 2, d).astype(np.float32)
                           for _ in range(4)))

    def grads(all_in):
        out = []
        for (q, k, v, g), (_, causal) in zip(all_in, JAX_CASES):
            _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), q, k, v)
            out.append(vjp(g))
        return out

    outs = jax.jit(grads)(cases)
    return {case: (*x, *(np.asarray(t) for t in got))
            for case, x, got in zip(JAX_CASES, cases, outs)}


@pytest.mark.parametrize("d,causal", JAX_CASES)
def test_emulated_f32_backward_matches_jax(monkeypatch, d, causal):
    """``flash_attention`` in f32 with its backward computed as the kernels
    compute it (padding to 64, 256 and 384, scaling, layout and delta as on
    the card) against the JAX package's flash backward under the default
    ``pallas`` choice."""
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", "pallas")
    q, k, v, g, *want = _jax_backward()[d, causal]
    monkeypatch.setattr(fa, "flash_bwd", lambda *a: emulated_bwd(*a))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention(qt, kt, vt, causal=causal).backward(
        torch.from_numpy(g))
    for got, jax_grad in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), jax_grad, rtol=2e-4,
                                   atol=2e-4)
