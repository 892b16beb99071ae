"""Flash attention: the hand-written CUDA kernels, their plain versions
and the autograd function around them.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py`` ``flash_attention``
(``_flash_fwd``, ``_flash_bwd``).  Around the kernels, in torch, as the
JAX package does it: GQA repeats KV heads; q is scaled by 1/sqrt(d) in
its own dtype; the head dim is zero-padded to the next width the kernels
take (32, 64, 128 or 256, and past 256 the next multiple of 128, as the
JAX package pads every head dim to a multiple of 128 lanes: zero columns
add 0 to every product) and the outputs sliced back;
``delta = rowsum(g * o)`` is computed in f32; dq is multiplied by
1/sqrt(d) in f32 before its cast; the layout goes ``(B, S, H, D) <->
(B*H, S, D)``.

The backward is chosen as the JAX package chooses it, by
``HVD_TPU_FLASH_BWD`` read when the backward runs: ``pallas`` (the
default) runs the dq and dk/dv kernels, ``pallas_onepass`` the one-pass
kernel, whose f32 dq partials (one per block of ``onepass_block_k(width)``
k rows: 64 at width 256, 128 at every other) are summed here
(``partials.sum(1)``, the XLA reduce outside the TPU kernel).

Each kernel has a wrapper (``*_kernel``) that launches it and counts its
launches in ``.launches``, and a plain PyTorch version (``*_reference``)
of the same function.  ``flash_fwd``/``flash_bwd`` pick the plain
version only for tensors on the CPU; on CUDA they launch the kernels that
``_kernels_for`` names for the inputs' dtype and padded width, which
raise on anything they do not take.  The Hopper kernels take bf16 and
f16: the forward (``csrc/flash_fwd.cu``), dq and dk/dv (``flash_bwd.cu``)
and the one-pass backward (``flash_bwd_onepass.cu``) at every padded width
(32, 64, 128, 256 and every multiple of 128 past 256); and f32: the
forward in split TF32
(``csrc/flash_fwd_f32.cu``, ``flash_fwd_f32_kernel``) at every padded
width, and dq, dk/dv and the one-pass backward (``csrc/flash_bwd_f32.cu``,
``flash_bwd_dq_f32_kernel``, ``flash_bwd_dkv_f32_kernel`` and
``flash_bwd_onepass_f32_kernel``: split TF32, dP on the CUDA cores) at
every padded width.  Their CUDA-core twins (``csrc/flash_simt.cu``,
``*_simt_kernel``) take f32, f16 and bf16 at every padded width and run on
no route: they stay as a second reference.  Any other dtype raises.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build

NEG_INF = -1e30
# the kernels' widths up to 256, flash_attention pads a head dim to one
# (past 256, to a multiple of 128)
_HEAD_DIMS = (32, 64, 128, 256)


class _PaddedWidths:
    """Every width ``padded_head_dim`` gives: 32, 64, 128, 256 and each
    multiple of 128 past 256 (the widths of every flash kernel)."""

    def __contains__(self, width) -> bool:
        return width in _HEAD_DIMS or (width > 256 and width % 128 == 0)

    def __repr__(self) -> str:
        return "(32, 64, 128, 256, or a multiple of 128 past 256)"


PADDED_WIDTHS = _PaddedWidths()
# rows of k per one-pass tile, hence per dq partial, at every width but
# 256 (``onepass_block_k``); passed to the kernel, which refuses a value
# other than its own
BLOCK_K = 128
BWD_CHOICES = ("pallas", "pallas_onepass", "chunked")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_fwd": {"hvd_flash_fwd": [_P] * 5 + [_I] * 5 + [_P]},
    "flash_bwd": {"hvd_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_P],
                  "hvd_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P]},
    "flash_bwd_onepass": {"hvd_flash_bwd_onepass": [_P] * 9 + [_I] * 6 + [_P]},
    "flash_fwd_f32": {"hvd_flash_fwd_f32": [_P] * 5 + [_I] * 4 + [_P]},
    "flash_bwd_f32": {"hvd_flash_bwd_dq_f32": [_P] * 8 + [_I] * 4 + [_P],
                      "hvd_flash_bwd_dkv_f32": [_P] * 10 + [_I] * 4 + [_P],
                      "hvd_flash_bwd_onepass_f32": [_P] * 12 + [_I] * 5
                      + [_P]},
    "flash_simt": {"hvd_simt_flash_fwd": [_P] * 5 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_onepass": [_P] * 9 + [_I] * 6 + [_P]},
}
# The code of each dtype that a kernel's C entry takes (flash_simt.cu all
# three; the Hopper sources f16 and bf16).
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HOPPER_DTYPES = (torch.bfloat16, torch.float16)
SIMT_DTYPES = tuple(DTYPE_CODES)


def _lib(name: str):
    return _build.load(name, _SIGNATURES[name])


def onepass_block_k(width: int) -> int:
    """Rows of k per one-pass dq partial slot at padded head dim
    ``width``: 64 at 256, where a Hopper block holds only 64 rows of K and
    V beside its ring (the JAX package's smallest k block), and BLOCK_K
    (128) at every other width.  The Hopper and CUDA-core one-pass kernels
    and the plain version all take it."""
    return 64 if width == 256 else BLOCK_K


# ---------------------------------------------------------------------------
# plain versions (f32 arithmetic, the kernels' casts)
# ---------------------------------------------------------------------------

def _causal_keep(s: int, device) -> torch.Tensor:
    idx = torch.arange(s, device=device)
    return idx[None, :] <= idx[:, None]


def flash_fwd_reference(q, k, v, causal: bool):
    """(BH, S, D) q (pre-scaled), k, v -> (o in q's dtype, lse (BH, S) f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], q.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_common(q, k, v, g, lse, delta, causal: bool, exact_dp=False):
    """ds = p * (g v^T - delta) (f32, p = 0 where masked), dk and dv f32:
    what both backward forms compute alike.  With ``exact_dp``, g v^T -
    delta is formed in f64 and rounded once: where it cancels to nothing
    (a row with one live key), f32 keeps only its own summation noise,
    which a kernel that sums in another order cannot match."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], q.device), 0.0)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float())
    wide = torch.float64 if exact_dp else torch.float32
    dp = torch.matmul(g.to(wide), v.to(wide).transpose(-1, -2))
    ds = p * (dp - delta[..., None].to(wide)).float()
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return ds, dk, dv


def flash_bwd_reference(q, k, v, g, lse, delta, causal: bool,
                        exact_dp=False):
    """-> (dq f32 in q's pre-scaled units, dk in k's dtype, dv in v's)."""
    ds, dk, dv = _bwd_common(q, k, v, g, lse, delta, causal, exact_dp)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_onepass_reference(q, k, v, g, lse, delta, causal: bool,
                                exact_dp=False):
    """-> (dq partials f32 (BH, nk, S, D), dk, dv): partial t is
    ``ds[:, :, k tile t] @ k[k tile t]`` over k tiles of ``bk =
    onepass_block_k(D)`` rows (nk = ceil(S / bk)), so that their sum is
    ``flash_bwd_reference``'s dq.  A tile the causal mask kills is exactly
    0."""
    bh, s, d = q.shape
    bk = onepass_block_k(d)
    nk = -(-s // bk)
    pad = nk * bk - s
    ds, dk, dv = _bwd_common(q, k, v, g, lse, delta, causal, exact_dp)
    ds_tiles = torch.nn.functional.pad(ds.to(k.dtype).float(), (0, pad))
    k_tiles = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    partials = torch.matmul(
        ds_tiles.view(bh, s, nk, bk).transpose(1, 2),
        k_tiles.view(bh, nk, bk, d))
    return partials, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_args(kernel, flat, rows=()):
    """Raise on inputs ``kernel`` does not take: (BH, S, D) tensors of one
    of its ``dtypes`` with D one of its ``widths`` (what
    ``flash_attention`` pads a head dim to) and f32 (BH, S) row
    statistics, all contiguous on one CUDA device, each starting on a
    16-byte boundary (TMA reads and writes tiles only from there)."""
    name, dtypes, widths = kernel.__name__, kernel.dtypes, kernel.widths
    bh, s, d = flat[0].shape
    for t in flat:
        if t.dtype != flat[0].dtype or t.dtype not in dtypes or \
                tuple(t.shape) != (bh, s, d):
            raise ValueError("%s takes (BH, S, D) tensors of one shape and "
                             "one dtype of %s, got %s %s"
                             % (name, [str(x) for x in dtypes], t.dtype,
                                tuple(t.shape)))
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, s):
            raise ValueError("%s takes f32 (BH, S) row statistics" % name)
    if d not in widths:
        raise ValueError("%s takes head_dim in %s, got %d: flash_attention "
                         "zero-pads a head dim to one of %s"
                         % (name, widths, d, PADDED_WIDTHS))
    for t in list(flat) + list(rows):
        if not t.is_cuda:
            raise ValueError("%s launches a CUDA kernel; got a tensor on %s"
                             % (name, t.device))
        if not t.is_contiguous():
            raise ValueError("%s takes contiguous tensors" % name)
        if t.device != flat[0].device:
            raise ValueError("%s takes tensors on one device" % name)
        if t.data_ptr() % 16:
            raise ValueError("%s takes tensors that start on a 16-byte "
                             "boundary" % name)
    return bh, s, d


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_kernel(q, k, v, causal: bool):
    """Hopper forward (``csrc/flash_fwd.cu``), bf16 or f16, at every padded
    width (past 256 one launch a 256-column panel of o, and one for a last
    128-column panel) -> (o in q's dtype, lse f32)."""
    bh, s, d = _check_kernel_args(flash_fwd_kernel, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_fwd").hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, d, int(causal), DTYPE_CODES[q.dtype],
        _stream(q)), "flash_fwd_kernel")
    flash_fwd_kernel.launches += 1
    return o, lse


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper dq (``csrc/flash_bwd.cu``), bf16 or f16, at every padded
    width (at 256 its wide plan: 64-row K and V tiles in three ring slots;
    past 256 one block per 256-column panel of dq, and one launch for a
    last 128-column panel, the scores streamed in 64-column chunks) -> dq
    f32, pre-scaled units."""
    bh, s, d = _check_kernel_args(flash_bwd_dq_kernel, (q, k, v, g),
                                  (lse, delta))
    dq = torch.empty(bh, s, d, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_bwd").hvd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        int(causal), DTYPE_CODES[q.dtype], _stream(q)),
        "flash_bwd_dq_kernel")
    flash_bwd_dq_kernel.launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper dk/dv (``csrc/flash_bwd.cu``), bf16 or f16, at every padded
    width (from 256 on 64-row k blocks whose consumers own dV and dK; past
    256 one block per 256-column panel of dk and dv, and one launch for a
    last 128-column panel, the scores streamed in 64-column chunks) ->
    (dk, dv) in k's dtype."""
    bh, s, d = _check_kernel_args(flash_bwd_dkv_kernel, (q, k, v, g),
                                  (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_bwd").hvd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, s, d, int(causal), DTYPE_CODES[q.dtype], _stream(q)),
        "flash_bwd_dkv_kernel")
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


def flash_bwd_onepass_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper one-pass backward (``csrc/flash_bwd_onepass.cu``), bf16 or
    f16, at every padded width (at 256 64-row k blocks whose consumers
    split the products, as dk/dv's there; past 256 dk/dv's panel plan, one
    block per 128-row dq slot and 256-column panel, and one launch for a
    last 128-column panel, the block walking the slot's two 64-row k
    blocks) -> (dq partials f32 (BH, nk, S, D), one slot per
    ``onepass_block_k(D)`` rows of k, dk, dv in k's dtype)."""
    bh, s, d = _check_kernel_args(flash_bwd_onepass_kernel, (q, k, v, g),
                                  (lse, delta))
    bk = onepass_block_k(d)
    partials = torch.empty(bh, -(-s // bk), s, d, dtype=torch.float32,
                           device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_bwd_onepass").hvd_flash_bwd_onepass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partials.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, s, d, int(causal), bk, DTYPE_CODES[q.dtype],
        _stream(q)), "flash_bwd_onepass_kernel")
    flash_bwd_onepass_kernel.launches += 1
    return partials, dk, dv


def f32_vt(v):
    """(BH, S, D) f32 v -> (BH, D, S8) contiguous, what the f32 kernels
    read as the B operand of a product over keys (or q rows): v^T (rows
    contiguous: TF32 products take both operands K-major), S zero-padded
    to S8, the next multiple of 8, and the rows of each group of 8 in the
    order 0, 2, 4, 6, 1, 3, 5, 7 (column 8 j + 4 h + c holds row 8 j + 2 c
    + h), so that the kernel's P, dS, P^T or dS^T goes from its
    accumulator registers to the product's TF32 operand with no shuffle
    (``csrc/flash_fwd_f32.cu``, trap 2).  The forward takes V's, dq K's,
    dk/dv dO's and Q's."""
    bh, s, d = v.shape
    s8 = -(-s // 8) * 8
    vp = v if s8 == s else torch.nn.functional.pad(v, (0, 0, 0, s8 - s))
    return vp.view(bh, s8 // 8, 4, 2, d).permute(0, 4, 1, 3, 2).reshape(
        bh, d, s8)


def flash_fwd_f32_kernel(q, k, v, causal: bool):
    """Hopper forward in f32 (``csrc/flash_fwd_f32.cu``, split-TF32
    ``wgmma``) at every padded width, from 256 on one block per
    128-column panel of o; V goes in as ``f32_vt(v)``, whose time is the
    call's -> (o f32, lse f32)."""
    bh, s, d = _check_kernel_args(flash_fwd_f32_kernel, (q, k, v))
    vt = f32_vt(v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_fwd_f32").hvd_flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), vt.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, d, int(causal), _stream(q)),
        "flash_fwd_f32_kernel")
    flash_fwd_f32_kernel.launches += 1
    return o, lse


def flash_bwd_dq_f32_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper dq in f32 (``csrc/flash_bwd_f32.cu``: S and dS K in split
    TF32, dP on the CUDA cores in the plain version's order) at every
    padded width, from 256 on one block per 128-column panel of dq; K goes
    in also as ``f32_vt(k)``, whose time is the call's -> dq f32,
    pre-scaled units."""
    bh, s, d = _check_kernel_args(flash_bwd_dq_f32_kernel, (q, k, v, g),
                                  (lse, delta))
    kt = f32_vt(k)
    dq = torch.empty_like(q)
    _build.check(_lib("flash_bwd_f32").hvd_flash_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), kt.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        int(causal), _stream(q)), "flash_bwd_dq_f32_kernel")
    flash_bwd_dq_f32_kernel.launches += 1
    return dq


def flash_bwd_dkv_f32_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper dk/dv in f32 (``csrc/flash_bwd_f32.cu``: S^T, P^T dO and
    dS^T Q in split TF32, dP^T on the CUDA cores) at every padded width,
    from 256 on one block per 128-column panel of dk and dv; Q and dO go in
    also as ``f32_vt(q)`` and ``f32_vt(g)``, whose time is the call's ->
    (dk, dv) f32."""
    bh, s, d = _check_kernel_args(flash_bwd_dkv_f32_kernel, (q, k, v, g),
                                  (lse, delta))
    qt, gt = f32_vt(q), f32_vt(g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_bwd_f32").hvd_flash_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), qt.data_ptr(),
        gt.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, s, d, int(causal), _stream(q)),
        "flash_bwd_dkv_f32_kernel")
    flash_bwd_dkv_f32_kernel.launches += 1
    return dk, dv


def flash_bwd_onepass_f32_kernel(q, k, v, g, lse, delta, causal: bool):
    """Hopper one-pass backward in f32 (``csrc/flash_bwd_f32.cu``: dk/dv's
    body plus dS K, split TF32 with dP on the CUDA cores) at every padded
    width, from 256 on one block per 128-column panel; one block per dq
    slot, which walks the slot's 64-row k blocks; Q, dO and K go in also as
    ``f32_vt`` copies, whose time is the call's -> (dq partials f32 (BH,
    nk, S, D), one slot per ``onepass_block_k(D)`` rows of k, dk, dv
    f32)."""
    bh, s, d = _check_kernel_args(flash_bwd_onepass_f32_kernel, (q, k, v, g),
                                  (lse, delta))
    bk = onepass_block_k(d)
    partials = torch.empty(bh, -(-s // bk), s, d, dtype=torch.float32,
                           device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    qt, gt, kt = f32_vt(q), f32_vt(g), f32_vt(k)
    _build.check(_lib("flash_bwd_f32").hvd_flash_bwd_onepass_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        qt.data_ptr(), gt.data_ptr(), kt.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), partials.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, s, d, int(causal), bk, _stream(q)), "flash_bwd_onepass_f32_kernel")
    flash_bwd_onepass_f32_kernel.launches += 1
    return partials, dk, dv


def _simt_args(kernel, flat, rows=()):
    bh, s, d = _check_kernel_args(kernel, flat, rows)
    return bh, s, d, DTYPE_CODES[flat[0].dtype]


def flash_fwd_simt_kernel(q, k, v, causal: bool):
    """CUDA-core forward (``csrc/flash_simt.cu``), f32, f16 or bf16 -> (o
    in q's dtype, lse f32)."""
    bh, s, d, code = _simt_args(flash_fwd_simt_kernel, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_simt").hvd_simt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, d, int(causal), code, _stream(q)),
        "flash_fwd_simt_kernel")
    flash_fwd_simt_kernel.launches += 1
    return o, lse


def flash_bwd_dq_simt_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA-core dq (``csrc/flash_simt.cu``) -> dq f32, pre-scaled units."""
    bh, s, d, code = _simt_args(flash_bwd_dq_simt_kernel, (q, k, v, g),
                                (lse, delta))
    dq = torch.empty(bh, s, d, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_simt").hvd_simt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        int(causal), code, _stream(q)), "flash_bwd_dq_simt_kernel")
    flash_bwd_dq_simt_kernel.launches += 1
    return dq


def flash_bwd_dkv_simt_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA-core dk/dv (``csrc/flash_simt.cu``) -> (dk, dv) in k's dtype."""
    bh, s, d, code = _simt_args(flash_bwd_dkv_simt_kernel, (q, k, v, g),
                                (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_simt").hvd_simt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, s, d, int(causal), code, _stream(q)), "flash_bwd_dkv_simt_kernel")
    flash_bwd_dkv_simt_kernel.launches += 1
    return dk, dv


def flash_bwd_onepass_simt_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA-core one-pass backward (``csrc/flash_simt.cu``) -> (dq
    partials f32 (BH, nk, S, D), one slot per ``onepass_block_k(D)`` rows
    of k, dk, dv)."""
    bh, s, d, code = _simt_args(flash_bwd_onepass_simt_kernel,
                                (q, k, v, g), (lse, delta))
    bk = onepass_block_k(d)
    partials = torch.empty(bh, -(-s // bk), s, d, dtype=torch.float32,
                           device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_simt").hvd_simt_flash_bwd_onepass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partials.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, s, d, int(causal), bk, code, _stream(q)),
        "flash_bwd_onepass_simt_kernel")
    flash_bwd_onepass_simt_kernel.launches += 1
    return partials, dk, dv


# The two families (fwd, dq, dk/dv, one-pass), each kernel with the
# dtypes and widths it takes.
HOPPER_KERNELS = (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
                  flash_bwd_onepass_kernel)
SIMT_KERNELS = (flash_fwd_simt_kernel, flash_bwd_dq_simt_kernel,
                flash_bwd_dkv_simt_kernel, flash_bwd_onepass_simt_kernel)
# The f32 kernels on Hopper (fwd, dq, dk/dv, one-pass): every step in f32.
F32_KERNELS = (flash_fwd_f32_kernel, flash_bwd_dq_f32_kernel,
               flash_bwd_dkv_f32_kernel, flash_bwd_onepass_f32_kernel)
KERNELS = HOPPER_KERNELS + SIMT_KERNELS + F32_KERNELS
# Every kernel takes every padded width, each family its dtypes.
for _fam, _dtypes in ((HOPPER_KERNELS, HOPPER_DTYPES),
                      (SIMT_KERNELS, SIMT_DTYPES),
                      (F32_KERNELS, (torch.float32,))):
    for _k in _fam:
        _k.widths, _k.dtypes, _k.launches = PADDED_WIDTHS, _dtypes, 0


def reset_launch_counts():
    for kern in KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def _kernels_for(dtype, width: int):
    """(fwd, dq, dk/dv, one-pass) kernels for CUDA tensors of ``dtype`` at
    a padded head dim of ``width``: chosen by the two alone, never as a
    retry after a failure.  Each step takes the Hopper kernel that takes
    the dtype and the width: bf16 and f16 run the four ``HOPPER_KERNELS``
    and f32 the four ``F32_KERNELS`` (split TF32), at every padded width.
    No route takes a CUDA-core twin."""
    if dtype not in SIMT_DTYPES:
        raise ValueError("flash attention on CUDA takes f32, f16 or bf16, "
                         "got %s" % dtype)
    if width not in PADDED_WIDTHS:
        raise ValueError("flash attention on CUDA takes a head dim "
                         "zero-padded to one of %s, got %d"
                         % (PADDED_WIDTHS, width))
    return F32_KERNELS if dtype == torch.float32 else HOPPER_KERNELS


def flash_fwd(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    return _kernels_for(q.dtype, q.shape[-1])[0](q, k, v, causal)


def bwd_choice() -> str:
    """``HVD_TPU_FLASH_BWD``: "pallas" (default) or "pallas_onepass".  An
    unknown value raises, so that a typo cannot pass for an A/B run."""
    choice = os.environ.get("HVD_TPU_FLASH_BWD", "pallas")
    if choice not in BWD_CHOICES:
        raise ValueError("HVD_TPU_FLASH_BWD must be 'pallas', "
                         "'pallas_onepass' or 'chunked', got %r" % choice)
    if choice == "chunked":
        raise NotImplementedError(
            "HVD_TPU_FLASH_BWD=chunked is the JAX package's XLA fallback, "
            "not a kernel, and is not ported (ROADMAP section B, "
            "'chunked'); use 'pallas' or 'pallas_onepass'")
    return choice


def flash_bwd(q, k, v, g, lse, delta, causal: bool):
    cpu = q.device.type == "cpu"
    _, dq_kernel, dkv_kernel, onepass_kernel = (
        (None,) * 4 if cpu else _kernels_for(q.dtype, q.shape[-1]))
    if bwd_choice() == "pallas_onepass":
        run = flash_bwd_onepass_reference if cpu else onepass_kernel
        partials, dk, dv = run(q, k, v, g, lse, delta, causal)
        return partials.sum(1), dk, dv
    if cpu:
        return flash_bwd_reference(q, k, v, g, lse, delta, causal)
    dq = dq_kernel(q, k, v, g, lse, delta, causal)
    dk, dv = dkv_kernel(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def padded_head_dim(d: int) -> int:
    """The kernels' width that holds a head dim of ``d``: the smallest of
    32, 64, 128 and 256 at or above it, and past 256 the next multiple of
    128 (the JAX package's ``_d_pad``)."""
    return next((w for w in _HEAD_DIMS if w >= d), -(-d // 128) * 128)


def _to_flat(x, width: int):
    """(B, S, H, D) -> contiguous (B*H, S, width), zero columns past D."""
    b, s, h, d = x.shape
    x = x.transpose(1, 2).reshape(b * h, s, d)
    if width != d:
        x = torch.nn.functional.pad(x, (0, width - d))
    return x.contiguous()


def _from_flat(x, b: int, h: int, d: int):
    """(B*H, S, width) -> (B, S, H, D), the first D columns."""
    _, s, width = x.shape
    return x.view(b, h, s, width)[..., :d].transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        b, _, h, d = q.shape
        width = padded_head_dim(d)
        # The true head dim's scale, as the JAX plan pre-scales before it
        # pads.  Scaled in q's own dtype: the factor is rounded to it
        # first, as q * pre_scale does on a bf16 array in the JAX package.
        scale = 1.0 / math.sqrt(d)
        qs = _to_flat(q * torch.tensor(scale, dtype=q.dtype, device=q.device),
                      width)
        kf, vf = _to_flat(k, width), _to_flat(v, width)
        o, lse = flash_fwd(qs, kf, vf, causal)
        ctx.save_for_backward(qs, kf, vf, o, lse)
        ctx.causal, ctx.scale, ctx.shape = causal, scale, (b, h, d)
        ctx.q_dtype = q.dtype
        return _from_flat(o, b, h, d)

    @staticmethod
    def backward(ctx, g):
        qs, kf, vf, o, lse = ctx.saved_tensors
        b, h, d = ctx.shape
        gf = _to_flat(g.to(o.dtype), o.shape[-1])
        delta = (gf.float() * o.float()).sum(-1)
        dq, dk, dv = flash_bwd(qs, kf, vf, gf, lse, delta, ctx.causal)
        dq = (dq.float() * ctx.scale).to(ctx.q_dtype)
        return (_from_flat(dq, b, h, d), _from_flat(dk, b, h, d),
                _from_flat(dv, b, h, d), None)


def flash_attention(q, k, v, causal: bool = True):
    """Fused attention on ``(batch, seq, heads, head_dim)`` tensors; GQA
    (fewer KV heads) repeats each KV head over its group of q heads.  On
    CUDA the kernels run as ``_kernels_for`` routes them by dtype and
    padded head dim (any width); another dtype raises."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return _FlashAttention.apply(q, k, v, causal)
