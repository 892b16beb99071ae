"""The f32 one-pass backward on Hopper (``flash_bwd_onepass_f32_kernel``,
``csrc/flash_bwd_f32.cu``): its route, its refusals before the device,
the slots and transposed copies its wrapper passes, and its arithmetic
emulated in torch.

On the card f32 runs all four flash steps on Hopper at every padded
width.  The one-pass is the f32 dk/dv kernel's body (S^T, P^T, dV on
consumer 0; dP^T on the CUDA cores, dS^T, dK on consumer 1) plus one more
product per 64-row k block and 64-row q tile: the dq partial dS K, dS
(the transpose of consumer 1's dS^T) against K^T (``f32_vt(k)``), in
split TF32 in one fresh accumulator of 64 keys.  A dq slot is
``onepass_block_k(D)`` rows of k (64 at D 256, 128 at every other width)
and one block's: at 128 rows the block walks the slot's two 64-row k
blocks in turn, and the second adds its partial to what the first
stored, in f32.  Here that is emulated with
``test_torch_port_hopper_f32_bwd.py``'s pieces (the split, the tensor
core's truncating sums in the kernel's chains, dP as the plain version
sums it) and held to the f32 plain version under ``chip_smoke.py``'s f32
limits (``SIMT_TOL["float32"]``, by its ``compare``), the limits the
kernel is held to on the card.

Readings of ``worst`` (at most 1 passes) at BH 2, S 200 (partials, dk,
dv): the design at most 0.362 at D 64, 256 and 384, causal and full, and
the partials' sum against the plain dq at most 0.304; a dropped split
term 127-154 on the partials (D 128); the second k block stored over the
first instead of added to it 1.15e5-1.19e5 (D 64).  Against the JAX
package's f32 one-pass (its Pallas kernel in interpret mode,
``HVD_TPU_FLASH_BLOCK_K`` at the port's slot), through
``flash_attention``'s autograd under ``HVD_TPU_FLASH_BWD=pallas_onepass``:
at most 2.8e-6 of |port - JAX| / (1 + |JAX|) (tolerance 2e-4, as
``test_torch_port_flash_dtypes.py`` holds f32).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_hopper_f32_bwd as bwd_emu
from tests import test_torch_port_hopper_f32_fwd as fwd_emu
from tests.test_torch_port_hopper_wide_onepass import _Entry

PADDED = (32, 64, 128, 256, 384, 512, 640)
F32_TOL = cs.SIMT_TOL["float32"]
KERN = fa.flash_bwd_onepass_f32_kernel
BK = 64  # k rows per k block, hence per partial chain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", PADDED)
def test_f32_onepass_route_at_every_padded_width(width):
    """f32 at every padded width: the one-pass on Hopper, the fourth of
    ``F32_KERNELS``, taking f32 at the width; bf16 and f16 never take
    it."""
    route = fa._kernels_for(torch.float32, width)
    assert route == fa.F32_KERNELS and route[3] is KERN
    assert torch.float32 in KERN.dtypes and width in KERN.widths
    for dtype in (torch.bfloat16, torch.float16):
        assert KERN not in fa._kernels_for(dtype, width)


@pytest.mark.parametrize("dtype,width,msg", [
    (torch.bfloat16, 128, "one dtype of"),
    (torch.float16, 384, "one dtype of"),
    (torch.float32, 96, "head_dim in"),
    (torch.float32, 300, "head_dim in"),
    (torch.float32, 384, "CUDA kernel"),
])
def test_f32_onepass_refuses_before_the_device(dtype, width, msg):
    """The wrapper takes f32 at a padded width only, and raises on another
    dtype or width before it looks at the device; what it takes raises
    here for lying on the CPU.  No refusal counts as a launch."""
    fa.reset_launch_counts()
    x = torch.zeros(2, 64, width, dtype=dtype)
    rows = torch.zeros(2, 64)
    with pytest.raises(ValueError, match=msg):
        KERN(x, x, x, x, rows, rows, True)
    assert KERN.launches == 0


@pytest.mark.parametrize("width,slot", [(64, 128), (128, 128), (256, 64),
                                        (384, 128)])
def test_wrapper_allocates_and_passes_the_slot(monkeypatch, width, slot):
    """The wrapper allocates ceil(S / slot) f32 partial slots, passes the
    slot's rows as the entry's ``block_k`` (after ``causal``), and passes
    Q^T, dO^T and K^T as ``f32_vt`` copies, in that order, after q, k, v
    and g."""
    lib = _Entry()
    copied = []
    vt = fa.f32_vt
    monkeypatch.setattr(fa, "_lib", lambda name: lib)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_check_kernel_args",
                        lambda k, flat, rows=(): tuple(flat[0].shape))
    monkeypatch.setattr(fa, "f32_vt",
                        lambda t: copied.append(t) or vt(t))
    monkeypatch.setattr(KERN, "launches", 0)
    bh, s = 2, 200
    q, k, v, g = (torch.full((bh, s, width), float(i)) for i in range(4))
    rows = torch.zeros(bh, s)
    partials, dk, dv = KERN(q, k, v, g, rows, rows, True)
    (name, args), = lib.calls
    assert name == "hvd_flash_bwd_onepass_f32"
    assert args[12:17] == (bh, s, width, 1, slot)  # bh, s, d, causal, block_k
    assert [t is x for t, x in zip(copied, (q, g, k))] == [True] * 3
    assert partials.dtype == dk.dtype == dv.dtype == torch.float32
    assert tuple(partials.shape) == (bh, -(-s // slot), s, width)
    assert KERN.launches == 1


def ds_k_as_the_kernel(ds, k, terms):
    """dS (BH, S, n keys) K (BH, n, D) as the kernel forms one k block's
    partial: dS's keys as the A fragments hold them (read from shared
    memory in f32_vt's order) against f32_vt(k) K-major, split TF32, one
    truncating chain of 8 k-steps (64 keys)."""
    bh, s, n = ds.shape
    n8 = -(-n // 8) * 8
    a = torch.nn.functional.pad(ds, (0, n8 - n)).view(bh, s, n8 // 8, 8)[
        ..., list(fwd_emu.fragment_keys())].reshape(bh, s, n8)
    return fwd_emu.split_product(a, fa.f32_vt(k).transpose(-1, -2), "trunc",
                                 terms, BK // 8)


def emulated_onepass(q, k, v, g, lse, delta, causal, terms=bwd_emu.THREE,
                     halves="added"):
    """The kernel's function in torch -> (partials, dk, dv): dk and dv as
    the dk/dv kernel forms them (``emulated_scores``' dS^T and P^T, the
    products in the kernel's chains), and each slot's partial from dS =
    (dS^T)^T: per 64-row k block one chain of ``ds_k_as_the_kernel``, the
    slot's second k block "added" to the first in f32, or "stored over"
    its rows from the block's first live q tile on (a fault)."""
    _, dst, pt = bwd_emu.emulated_scores(q, k, v, g, lse, delta, causal,
                                         terms=terms)
    chain = bwd_emu.KERNEL_CHAINS[1]
    dk, dv = (fwd_emu.pv_as_the_kernel(a, b, "trunc", terms, chain)
              for a, b in ((dst, q), (pt, g)))
    ds = dst.transpose(-1, -2)
    bh, s, d = q.shape
    slot = fa.onepass_block_k(d)
    partials = q.new_zeros(bh, -(-s // slot), s, d)
    for t in range(partials.shape[1]):
        for k0 in range(t * slot, min(t * slot + slot, s), BK):
            keys = slice(k0, min(k0 + BK, s))
            part = ds_k_as_the_kernel(ds[..., keys], k[:, keys], terms)
            if k0 == t * slot:
                partials[:, t] = part
            elif halves == "added":
                partials[:, t] += part
            else:
                first = k0 if causal else 0
                partials[:, t, first:] = part[:, first:]
    return partials, dk, dv


def worst(got, args, causal):
    """compare's ``worst`` of each of (partials, dk, dv) against the f32
    plain one-pass under the f32 limits, and of the partials' sum against
    the plain dq."""
    want = fa.flash_bwd_onepass_reference(*args, causal)
    dq = fa.flash_bwd_reference(*args, causal)[0]
    return [cs.compare(a, b, *F32_TOL)["worst"]
            for a, b in zip(got + (got[0].sum(1),), want + (dq,))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256, 384])
def test_emulated_onepass_within_the_f32_limits(d, causal):
    """The design, emulated with the tensor core's truncating sums in the
    kernel's chains and the slot's k blocks added in f32, against the f32
    plain version at BH 2, S 200 (128-row slots at 64 and 384, the last
    ragged; 64-row slots at 256): partials, dk and dv under chip_smoke's
    f32 limits, and the partials' sum under them against the plain dq."""
    args = bwd_emu.inputs(2, 200, d, d + 13, causal)
    assert max(worst(emulated_onepass(*args, causal), args, causal)) <= 1.0


@pytest.mark.parametrize("dropped", fwd_emu.SMALL)
def test_a_dropped_split_term_fails_the_partials(dropped):
    """Two TF32 terms put the partials past the f32 limits by far: the
    check on the card can see a kernel that drops one."""
    args = bwd_emu.inputs(2, 200, 128, 17)
    kept = tuple(t for t in fwd_emu.SMALL if t != dropped) + ("hi_hi",)
    assert worst(emulated_onepass(*args, True, terms=kept), args,
                 True)[0] > 16


@pytest.mark.parametrize("causal", [True, False])
def test_second_k_block_stored_over_the_first_fails(causal):
    """A 128-row slot whose second k block stores its partial over the
    first's instead of adding to it is far past the f32 limits (the fault
    ``tools/chip_fault_check.py`` plants on the card)."""
    args = bwd_emu.inputs(2, 200, 64, 19, causal)
    got = emulated_onepass(*args, causal, halves="stored over")
    assert worst(got, args, causal)[0] > 16


# (head dim, causal, S): padded to 64 (one 128-row slot, two at S 256),
# 256 (64-row slots) and 384 (three 128-column panels on the card)
JAX_CASES = ((64, True, 256), (192, True, 128), (320, False, 128))


@functools.lru_cache(maxsize=None)
def _jax_onepass():
    """{case: (q, k, v, g, JAX dq, dk, dv)}: B 1, H 2 from a seed, the JAX
    flash backward in f32 under ``pallas_onepass`` (its Pallas one-pass in
    interpret mode, k blocks of the port's slot rows)."""
    import os

    import jax
    from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
    out = {}
    old = {n: os.environ.get(n)
           for n in ("HVD_TPU_FLASH_BWD", "HVD_TPU_FLASH_BLOCK_K")}
    try:
        for d, causal, s in JAX_CASES:
            os.environ["HVD_TPU_FLASH_BWD"] = "pallas_onepass"
            os.environ["HVD_TPU_FLASH_BLOCK_K"] = str(
                fa.onepass_block_k(fa.padded_head_dim(d)))
            rng = np.random.RandomState(d + s)
            x = tuple(rng.randn(1, s, 2, d).astype(np.float32)
                      for _ in range(4))
            _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), *x[:3])
            out[d, causal, s] = x + tuple(np.asarray(t) for t in vjp(x[3]))
    finally:
        for n, v in old.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    return out


@pytest.mark.parametrize("d,causal,s", JAX_CASES)
def test_emulated_f32_onepass_matches_jax(monkeypatch, d, causal, s):
    """``flash_attention`` in f32 with its one-pass computed as the kernel
    computes it (padding to 64, 256 and 384, scaling, layout, delta and the
    partials' sum as on the card) against the JAX package's one-pass."""
    monkeypatch.setenv("HVD_TPU_FLASH_BWD", "pallas_onepass")
    q, k, v, g, *want = _jax_onepass()[d, causal, s]
    slots = []

    def onepass(*a):
        out = emulated_onepass(*a)
        slots.append(tuple(out[0].shape))
        return out

    monkeypatch.setattr(fa, "flash_bwd_onepass_reference", onepass)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention(qt, kt, vt, causal=causal).backward(
        torch.from_numpy(g))
    width = fa.padded_head_dim(d)
    assert slots == [(2, s // fa.onepass_block_k(width), s, width)]
    for got, jax_grad in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), jax_grad, rtol=2e-4,
                                   atol=2e-4)
