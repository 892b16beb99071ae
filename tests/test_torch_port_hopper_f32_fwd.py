"""The f32 flash forward on Hopper tensor cores (``flash_fwd_f32_kernel``,
``csrc/flash_fwd_f32.cu``): its route, its refusals before the device,
the V^T copy its wrapper passes, and its arithmetic, split TF32, emulated
in torch.

On the card f32 runs the forward on Hopper at every padded width, and
dq and dk/dv too (``test_torch_port_hopper_f32_bwd.py``), the one-pass on
the CUDA cores (``csrc/flash_simt.cu``).  The kernel forms
each f32 product a b as a_lo b_hi + a_hi b_lo + a_hi b_hi of TF32 parts
(hi: the top 19 bits of the f32 word, what the tensor core reads of it;
lo = x - hi, which the tensor core truncates to TF32 in turn).  Here that
split is emulated by masking the low 13 mantissa bits (and, for the
record, the round-to-nearest split that ``cvt.rna.tf32.f32`` would give),
and the emulated forward is held to the f32 plain version under
``chip_smoke.py``'s f32 limits (``SIMT_TOL["float32"]``, by its
``compare``), the limits the kernel is held to on the card.  A split
that drops one small term is off by about 2^-11 of each product and must
fail them.  The PV product is emulated as the kernel feeds it: P's
accumulator registers as the TF32 A fragments they become (keys 2c and
2c + 1 of each group of 8 as A's columns c and c + 4), against
``f32_vt(v)``, whose keys are stored in the matching order.

Readings of ``worst`` (at most 1 passes) at S 200, BH 2: the truncating
split 0.18-0.36, round-to-nearest 0.11-0.32 (both mostly the f32 plain
version's own rounding), a dropped term 87 (lo hi) and 120 (hi lo).
Against the JAX package's flash forward in f32 (Pallas in interpret
mode), through ``flash_attention``: at most 1.1e-6 of |port - JAX| / (1 +
|JAX|) (tolerance 2e-4, as ``test_torch_port_flash_dtypes.py`` holds
f32).

JAX is imported by that test alone, so that ``tools/chip_simt_probe.py
--f32-split`` can run this file's emulation on the card, where there is
no JAX.
"""

import functools
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from horovod_tpu_torch.ops import flash_attention as fa

PADDED = (32, 64, 128, 256, 384, 512, 640)
F32_TOL = cs.SIMT_TOL["float32"]
SMALL = ("lo_hi", "hi_lo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", PADDED)
def test_f32_route_at_every_padded_width(width):
    """f32: the forward on Hopper (split TF32) first, then dq and dk/dv
    on Hopper and the one-pass on the CUDA cores, each taking f32 at the
    width."""
    route = fa._kernels_for(torch.float32, width)
    assert route == (fa.flash_fwd_f32_kernel, fa.flash_bwd_dq_f32_kernel,
                     fa.flash_bwd_dkv_f32_kernel,
                     fa.flash_bwd_onepass_simt_kernel)
    for kern in route:
        assert torch.float32 in kern.dtypes and width in kern.widths


@pytest.mark.parametrize("dtype,width,msg", [
    (torch.bfloat16, 128, "one dtype of"),
    (torch.float16, 256, "one dtype of"),
    (torch.float32, 257, "head_dim in"),
    (torch.float32, 300, "head_dim in"),
    (torch.float32, 384, "CUDA kernel"),
])
def test_f32_forward_refuses_before_the_device(dtype, width, msg):
    """The wrapper takes f32 at a padded width only, and raises on another
    dtype or width before it looks at the device; what it takes raises
    here for lying on the CPU.  No refusal counts as a launch."""
    fa.reset_launch_counts()
    x = torch.zeros(2, 64, width, dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        fa.flash_fwd_f32_kernel(x, x, x, True)
    assert fa.flash_fwd_f32_kernel.launches == 0


@pytest.mark.parametrize("s", [1, 64, 130, 200])
def test_f32_vt_layout(s):
    """``f32_vt``: (BH, D, S8) contiguous f32, S8 the next multiple of 8;
    column 8 j + 4 h + c holds key 8 j + 2 c + h of V's column; the padded
    keys are zero."""
    rng = np.random.RandomState(s)
    v = torch.from_numpy(rng.randn(3, s, 32).astype(np.float32))
    vt = fa.f32_vt(v)
    s8 = -(-s // 8) * 8
    assert vt.shape == (3, 32, s8) and vt.is_contiguous()
    assert vt.dtype == torch.float32
    want = torch.zeros(3, 32, s8)
    for key in range(s):
        j, r = divmod(key, 8)
        want[:, :, 8 * j + 4 * (r % 2) + r // 2] = v[:, key, :]
    torch.testing.assert_close(vt, want, rtol=0, atol=0)


def tf32(x, form):
    """x (f32) to TF32, kept in f32: "trunc" masks the low 13 mantissa
    bits, "rna" rounds to the nearest TF32 value, ties away from zero."""
    bits = x.view(torch.int32)
    if form == "rna":
        bits = bits + 0x1000
    return (bits & -8192).view(torch.float32)


def split_product(a, b, form, terms, chain=None):
    """a @ b in split TF32: each operand as hi + lo, lo read as TF32 too;
    the terms named in ``terms`` summed, the small ones first.  With
    ``chain`` (a count of k-steps of 8, or "all"), summed as the tensor
    core sums: each k-step's terms one after another into an f32
    accumulator, each sum truncated toward zero (``truncating_sum``)."""
    a, b = a.contiguous(), b.contiguous()
    ah = tf32(a, form)
    al = tf32(a - ah, form)
    bh = tf32(b, form)
    bl = tf32(b - bh, form)
    pairs = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    if chain is not None:
        return truncating_sum([pairs[name] for name in terms], chain)
    out = None
    for name in terms:
        x, y = pairs[name]
        out = x @ y if out is None else out + x @ y
    return out


def round_toward_zero(x64):
    """f64 values to f32, truncated toward zero."""
    r = x64.to(torch.float32)
    return torch.where(r.double().abs() > x64.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def truncating_sum(pairs, chain):
    """sum of x @ y over ``pairs`` as wgmma k8 products sum them: per
    k-step of 8, each pair's 8 products into the accumulator, the sum
    truncated to f32 toward zero; a fresh accumulator every ``chain``
    k-steps ("all": one for the whole sum), added to the result in f32
    (rounded to nearest), as the kernel adds a chunk's S and a tile's
    P V."""
    steps = pairs[0][0].shape[-1] // 8
    chain = steps if chain == "all" else chain
    out, acc = None, None
    for s in range(steps):
        for x, y in pairs:
            part = x[..., 8 * s:8 * s + 8].double() @ y[..., 8 * s:8 * s + 8,
                                                         :].double()
            acc = round_toward_zero(part if acc is None else acc.double()
                                    + part)
        if (s + 1) % chain == 0 or s + 1 == steps:
            out = acc if out is None else out + acc
            acc = None
    return out


@functools.lru_cache(maxsize=None)
def fragment_keys():
    """The key of each of a TF32 A fragment's 8 columns, k-step j (keys
    8 j .. 8 j + 7), as the kernel fills the fragment from S's
    accumulator: thread c (lane % 4) holds S's columns 2c and 2c + 1 of
    rows r and r + 8 as s[4j + e] (column 2c + (e & 1), row r + 8 (e >>
    1)); the fragment takes a = (s[4j], s[4j+2], s[4j+1], s[4j+3]) and
    puts a[f] at row r + 8 (f & 1), column c + 4 (f >> 1)."""
    keys = [None] * 8
    for c in range(4):
        for f, e in enumerate((0, 2, 1, 3)):
            assert (f & 1) == (e >> 1)  # the same row
            keys[c + 4 * (f >> 1)] = 2 * c + (e & 1)
    return tuple(keys)


def pv_as_the_kernel(p, v, form, terms, chain=None):
    """P V as the kernel forms it: P's columns as the A fragments hold
    them, times f32_vt(v) read K-major, in split TF32."""
    bh, s, _ = p.shape
    s8 = -(-s // 8) * 8
    pp = torch.nn.functional.pad(p, (0, s8 - s))
    a = pp.view(bh, s, s8 // 8, 8)[..., list(fragment_keys())].reshape(
        bh, s, s8)
    return split_product(a, fa.f32_vt(v).transpose(-1, -2), form, terms,
                         chain)


# The kernel's chains of k-steps into one accumulator (csrc/flash_fwd_f32.cu,
# trap 3): S per 32-column chunk, P V per 64-key tile.
KERNEL_CHAINS = (4, 8)


def emulated_fwd(q, k, v, causal, form="trunc",
                 terms=SMALL + ("hi_hi",), chains=None):
    """The kernel's function in torch: S and P V in split TF32, the
    softmax in f32 (at the final max: the kernel's online form differs
    only in the order of its f32 sums).  ``chains``: None sums the products
    in f32 as torch does, else (S's, P V's) chain lengths of the tensor
    core's truncating sums."""
    s_chain, pv_chain = chains or (None, None)
    s = split_product(q, k.transpose(-1, -2), form, terms, s_chain)
    if causal:
        s = s.masked_fill(~fa._causal_keep(q.shape[1], q.device), fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = pv_as_the_kernel(p, v, form, terms, pv_chain) / l
    return o, (m + torch.log(l)).squeeze(-1)


def inputs(bh, s, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
               for _ in range(3))
    return q / math.sqrt(d), k, v


def test_fragment_keys_are_f32_vt_order():
    """The fragment's key order is the order f32_vt stores V^T's keys in,
    so P times the permuted V^T is P V, exactly on integers."""
    assert fragment_keys() == (0, 2, 4, 6, 1, 3, 5, 7)
    rng = np.random.RandomState(7)
    p = torch.from_numpy(rng.randint(-4, 5, (2, 13, 13)).astype(np.float32))
    v = torch.from_numpy(rng.randint(-4, 5, (2, 13, 32)).astype(np.float32))
    got = pv_as_the_kernel(p, v, "trunc", ("hi_hi",))
    torch.testing.assert_close(got, p @ v, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["trunc", "rna"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256, 384])
def test_split_tf32_within_the_f32_limits(d, causal, form):
    """The emulated kernel against the f32 plain version at BH 2, S 200,
    o and lse each under chip_smoke's f32 limits."""
    q, k, v = inputs(2, 200, d, d + causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    o, lse = emulated_fwd(q, k, v, causal, form)
    for got, want in ((o, o_ref), (lse, lse_ref)):
        assert cs.compare(got, want, *F32_TOL)["worst"] <= 1.0


@pytest.mark.parametrize("dropped", SMALL)
def test_a_dropped_split_term_fails_the_f32_limits(dropped):
    """Two TF32 terms (a small one left out) put o past the f32 limits by
    far: the check on the card can see a kernel that drops one."""
    q, k, v = inputs(2, 200, 256, 11)
    o_ref, _ = fa.flash_fwd_reference(q, k, v, True)
    kept = tuple(t for t in SMALL if t != dropped) + ("hi_hi",)
    o, _ = emulated_fwd(q, k, v, True, "trunc", kept)
    assert cs.compare(o, o_ref, *F32_TOL)["worst"] > 16


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [128, 640])
def test_truncating_sums_chained_as_the_kernel_chains_them(d, causal):
    """With the tensor core's truncating sums chained as the kernel
    chains them (a fresh accumulator per 32-column chunk of S and per
    64-key tile of P V), the emulated kernel stays within the f32 limits
    at BH 2, S 200."""
    q, k, v = inputs(2, 200, d, d + causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    o, lse = emulated_fwd(q, k, v, causal, chains=KERNEL_CHAINS)
    for got, want in ((o, o_ref), (lse, lse_ref)):
        assert cs.compare(got, want, *F32_TOL)["worst"] <= 1.0


def test_one_truncating_chain_fails_the_f32_limits():
    """Summed in one chain each (all of D into S, all keys into O), the
    truncating sums drift past the f32 limits at D 640, S 200: why the
    kernel adds its chunks and tiles in f32."""
    q, k, v = inputs(2, 200, 640, 641)
    o_ref, _ = fa.flash_fwd_reference(q, k, v, True)
    o, _ = emulated_fwd(q, k, v, True, chains=("all", "all"))
    assert cs.compare(o, o_ref, *F32_TOL)["worst"] > 1.0


JAX_CASES = ((64, True), (192, True), (320, False))


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """{(d, causal): (q, k, v, JAX o)}: B 1, S 72, H 2 from a seed, the JAX
    flash forward in f32 (interpret mode) in one jitted program."""
    import jax
    from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
    cases = []
    for d, causal in JAX_CASES:
        rng = np.random.RandomState(d)
        cases.append(tuple(rng.randn(1, 72, 2, d).astype(np.float32)
                           for _ in range(3)))
    outs = jax.jit(lambda all_in: [
        jax_flash(*x, causal=causal)
        for x, (_, causal) in zip(all_in, JAX_CASES)])(cases)
    return {case: (*x, np.asarray(o))
            for case, x, o in zip(JAX_CASES, cases, outs)}


@pytest.mark.parametrize("d,causal", JAX_CASES)
def test_emulated_f32_forward_matches_jax(monkeypatch, d, causal):
    """``flash_attention`` in f32 with its forward computed as the kernel
    computes it (padding to 64, 256 and 384, scaling, layout as on the
    card) against the JAX package's flash forward."""
    q, k, v, o_jax = _jax_forward()[d, causal]
    monkeypatch.setattr(fa, "flash_fwd", lambda *a: emulated_fwd(*a))
    o = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), o_jax, rtol=2e-4,
                               atol=2e-4)
