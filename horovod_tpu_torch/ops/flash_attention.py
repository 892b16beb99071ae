"""Flash attention: the hand-written CUDA kernels, their plain versions
and the autograd function around them.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py`` ``flash_attention``
(``_flash_fwd``, ``_flash_bwd``).  Around the kernels, in torch, as the
JAX package does it: GQA repeats KV heads; q is scaled by 1/sqrt(d) in
its own dtype; the head dim is zero-padded to the next width the kernels
take (32, 64 or 128; the JAX package pads to 128 lanes: zero columns add
0 to every product) and the outputs sliced back; ``delta = rowsum(g *
o)`` is computed in f32; dq is multiplied by 1/sqrt(d) in f32 before its
cast; the layout goes ``(B, S, H, D) <-> (B*H, S, D)``.

The backward is chosen as the JAX package chooses it, by
``HVD_TPU_FLASH_BWD`` read when the backward runs: ``pallas`` (the
default) runs the dq and dk/dv kernels, ``pallas_onepass`` the one-pass
kernel, whose f32 dq partials (one per 128-row k tile) are summed here
(``partials.sum(1)``, the XLA reduce outside the TPU kernel).

Each kernel has a wrapper (``*_kernel``) that launches it and counts its
launches in ``.launches``, and a plain PyTorch version (``*_reference``)
of the same function.  ``flash_fwd``/``flash_bwd`` pick the plain
version only for tensors on the CPU; on CUDA they launch the kernels of
the inputs' dtype, which raise on anything they do not take: bf16 goes
to the Hopper kernels (``csrc/flash_fwd.cu``, ``flash_bwd.cu``,
``flash_bwd_onepass.cu``), f32 and f16 to their CUDA-core twins
(``csrc/flash_simt.cu``, ``*_simt_kernel``), any other dtype raises.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)  # the kernels' widths; flash_attention pads to one
# rows of k per one-pass tile, hence per dq partial; passed to the kernel,
# which refuses a value other than its own
BLOCK_K = 128
BWD_CHOICES = ("pallas", "pallas_onepass", "chunked")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_fwd": {"hvd_flash_fwd": [_P] * 5 + [_I] * 4 + [_P]},
    "flash_bwd": {"hvd_flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_P],
                  "hvd_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_P]},
    "flash_bwd_onepass": {"hvd_flash_bwd_onepass": [_P] * 9 + [_I] * 5 + [_P]},
    "flash_simt": {"hvd_simt_flash_fwd": [_P] * 5 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P],
                   "hvd_simt_flash_bwd_onepass": [_P] * 9 + [_I] * 6 + [_P]},
}
# The dtypes of the Hopper kernels (flash_fwd.cu, flash_bwd.cu,
# flash_bwd_onepass.cu) and of the CUDA-core ones (flash_simt.cu), with the
# code the latter take for each.
HOPPER_DTYPES = (torch.bfloat16,)
SIMT_DTYPES = {torch.float32: 0, torch.float16: 1}


def _lib(name: str):
    return _build.load(name, _SIGNATURES[name])


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


def _bwd_common(q, k, v, g, lse, delta, causal: bool):
    """ds = p * (g v^T - delta) (f32, p = 0 where masked), dk and dv f32:
    what both backward forms compute alike."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], q.device), 0.0)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float())
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return ds, dk, dv


def flash_bwd_reference(q, k, v, g, lse, delta, causal: bool):
    """-> (dq f32 in q's pre-scaled units, dk in k's dtype, dv in v's)."""
    ds, dk, dv = _bwd_common(q, k, v, g, lse, delta, causal)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_onepass_reference(q, k, v, g, lse, delta, causal: bool):
    """-> (dq partials f32 (BH, nk, S, D), dk, dv): partial t is
    ``ds[:, :, k tile t] @ k[k tile t]`` over BLOCK_K-row k tiles (nk =
    ceil(S / BLOCK_K)), so that their sum is ``flash_bwd_reference``'s dq.  A
    tile the causal mask kills is exactly 0."""
    bh, s, d = q.shape
    nk = -(-s // BLOCK_K)
    pad = nk * BLOCK_K - s
    ds, dk, dv = _bwd_common(q, k, v, g, lse, delta, causal)
    ds_tiles = torch.nn.functional.pad(ds.to(k.dtype).float(), (0, pad))
    k_tiles = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    partials = torch.matmul(
        ds_tiles.view(bh, s, nk, BLOCK_K).transpose(1, 2),
        k_tiles.view(bh, nk, BLOCK_K, d))
    return partials, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_args(name: str, flat, rows=(), dtypes=HOPPER_DTYPES):
    """Raise on inputs the kernels do not take: they run on CUDA, on
    contiguous (BH, S, D) tensors of one of ``dtypes`` with D in
    32/64/128 (what ``flash_attention`` pads a head dim up to 128 to), and
    f32 (BH, S) row statistics, each starting on a 16-byte boundary (TMA
    reads and writes tiles only from there)."""
    bh, s, d = flat[0].shape
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
    if d not in _HEAD_DIMS:
        raise ValueError("%s takes head_dim in %s, got %d: flash_attention "
                         "zero-pads a head dim up to 128, and no kernel "
                         "takes a wider one" % (name, _HEAD_DIMS, d))
    return bh, s, d


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_kernel(q, k, v, causal: bool):
    """CUDA forward (``csrc/flash_fwd.cu``) -> (o bf16, lse f32)."""
    bh, s, d = _check_kernel_args("flash_fwd_kernel", (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_fwd").hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, d, int(causal), _stream(q)),
        "flash_fwd_kernel")
    flash_fwd_kernel.launches += 1
    return o, lse


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA dq (``csrc/flash_bwd.cu``) -> dq f32, pre-scaled units."""
    bh, s, d = _check_kernel_args("flash_bwd_dq_kernel", (q, k, v, g),
                                  (lse, delta))
    dq = torch.empty(bh, s, d, dtype=torch.float32, device=q.device)
    _build.check(_lib("flash_bwd").hvd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        int(causal), _stream(q)), "flash_bwd_dq_kernel")
    flash_bwd_dq_kernel.launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA dk/dv (``csrc/flash_bwd.cu``) -> (dk bf16, dv bf16)."""
    bh, s, d = _check_kernel_args("flash_bwd_dkv_kernel", (q, k, v, g),
                                  (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_bwd").hvd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, s, d, int(causal), _stream(q)), "flash_bwd_dkv_kernel")
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


def flash_bwd_onepass_kernel(q, k, v, g, lse, delta, causal: bool):
    """CUDA one-pass backward (``csrc/flash_bwd_onepass.cu``) ->
    (dq partials f32 (BH, nk, S, D), dk bf16, dv bf16)."""
    bh, s, d = _check_kernel_args("flash_bwd_onepass_kernel", (q, k, v, g),
                                  (lse, delta))
    partials = torch.empty(bh, -(-s // BLOCK_K), s, d, dtype=torch.float32,
                           device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_bwd_onepass").hvd_flash_bwd_onepass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partials.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, s, d, int(causal), BLOCK_K, _stream(q)),
        "flash_bwd_onepass_kernel")
    flash_bwd_onepass_kernel.launches += 1
    return partials, dk, dv


def _simt_args(name, flat, rows=()):
    bh, s, d = _check_kernel_args(name, flat, rows, tuple(SIMT_DTYPES))
    return bh, s, d, SIMT_DTYPES[flat[0].dtype]


def flash_fwd_simt_kernel(q, k, v, causal: bool):
    """CUDA-core forward (``csrc/flash_simt.cu``), f32 or f16 -> (o in
    q's dtype, lse f32)."""
    bh, s, d, code = _simt_args("flash_fwd_simt_kernel", (q, k, v))
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
    bh, s, d, code = _simt_args("flash_bwd_dq_simt_kernel", (q, k, v, g),
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
    bh, s, d, code = _simt_args("flash_bwd_dkv_simt_kernel", (q, k, v, g),
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
    partials f32 (BH, nk, S, D), dk, dv)."""
    bh, s, d, code = _simt_args("flash_bwd_onepass_simt_kernel",
                                (q, k, v, g), (lse, delta))
    partials = torch.empty(bh, -(-s // BLOCK_K), s, d, dtype=torch.float32,
                           device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_lib("flash_simt").hvd_simt_flash_bwd_onepass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partials.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, s, d, int(causal), BLOCK_K, code, _stream(q)),
        "flash_bwd_onepass_simt_kernel")
    flash_bwd_onepass_simt_kernel.launches += 1
    return partials, dk, dv


# The kernels by dtype: the Hopper ones take bf16, the CUDA-core ones f32
# and f16 (fwd, dq, dk/dv, one-pass).
HOPPER_KERNELS = (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
                  flash_bwd_onepass_kernel)
SIMT_KERNELS = (flash_fwd_simt_kernel, flash_bwd_dq_simt_kernel,
                flash_bwd_dkv_simt_kernel, flash_bwd_onepass_simt_kernel)
KERNELS = HOPPER_KERNELS + SIMT_KERNELS
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for kern in KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def _kernels_for(dtype):
    """(fwd, dq, dk/dv, one-pass) kernels for CUDA tensors of ``dtype``:
    chosen by the dtype alone, never as a retry after a failure."""
    if dtype in HOPPER_DTYPES:
        return HOPPER_KERNELS
    if dtype in SIMT_DTYPES:
        return SIMT_KERNELS
    raise ValueError(
        "flash attention on CUDA takes bf16 (Hopper kernels), f32 or f16 "
        "(CUDA-core kernels), got %s" % dtype)


def flash_fwd(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    return _kernels_for(q.dtype)[0](q, k, v, causal)


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
        (None,) * 4 if cpu else _kernels_for(q.dtype))
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
    32, 64 and 128 at or above it, else ``d`` itself (the plain versions
    take any width; the kernels raise)."""
    return next((w for w in _HEAD_DIMS if w >= d), d)


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
    CUDA, bf16 runs the Hopper kernels and f32 and f16 the CUDA-core ones,
    each at a head dim up to 128; another dtype raises."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return _FlashAttention.apply(q, k, v, causal)
