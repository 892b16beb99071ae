"""Fused train-mode BatchNorm (+ residual add) (+ ReLU): the hand-written
CUDA kernels, their plain versions and the autograd function around them.

Counterpart of ``horovod_tpu/ops/pallas_bn.py`` (``batch_norm_act`` and
its four kernels ``_stats_kernel``, ``_apply_kernel``,
``_bwd_red_kernel``, ``_bwd_dx_kernel``).  The kernels work on the
``(M, C)`` view of an activation whose channels are last in memory: a
2-D ``(M, C)`` tensor, or an NCHW tensor in ``torch.channels_last``,
whose view is free.  They take any M and C: the reference's ``_plan``
(folding C < 128 into 128 lanes, channel blocks of 128 or 256, M blocks
that divide M) and its ``None`` return for shapes that do not tile are
TPU tiling and are not copied.  The CUDA kernels pick their own tiles
(``csrc/batch_norm.cu``); the wrapper chooses the row chunks of a launch.

Each kernel has a wrapper (``bn_*_kernel``) that checks its arguments,
launches it and counts its launches in ``.launches``, and a plain PyTorch
version (``bn_*_reference``) with f32 arithmetic and the kernels' casts.
The dispatchers (``bn_stats`` ...) take the plain version only for
tensors on the CPU; on CUDA they launch the kernels, whose wrappers raise
on a tensor that is not on CUDA, not of the right type, or not
contiguous in the channels-last layout, so no layout copy hides on the
path.

Rounding: rinv is ``1 / sqrt(var + eps)`` (both IEEE-rounded; the
reference's ``rsqrt`` differs by an ulp at most) and every elementwise
step is one rounded f32 operation in the order written here, which the
kernels repeat exactly; only the sums' order differs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hvd_bn_stats": [_P] * 4 + [_I] * 5 + [_P],
    "hvd_bn_apply": [_P] * 7 + [_F] + [_I] * 6 + [_P],
    "hvd_bn_bwd_red": [_P] * 10 + [_F] + [_I] * 6 + [_P],
    "hvd_bn_bwd_dx": [_P] * 11 + [_F, _F] + [_I] * 6 + [_P],
}
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_CHUNKS = 65535  # grid.y limit of the launches
_TARGET_BLOCKS = 1024  # about 8 blocks of 256 threads on each of 132 SMs
_MIN_ROWS = 64


def _lib():
    return _build.load("batch_norm", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain versions (f32 arithmetic, the kernels' casts)
# ---------------------------------------------------------------------------

def _rinv(var, eps: float):
    return 1.0 / torch.sqrt(var + eps)


def _xhat_dy(x, dy, mean, var, gamma, beta, res, eps, relu):
    """xhat and the ReLU-masked upstream gradient, in f32; the mask is
    recomputed from x (and the residual) as xhat * gamma + beta."""
    xh = (x.float() - mean) * _rinv(var, eps)
    dy = dy.float()
    if relu:
        z = xh * gamma + beta
        if res is not None:
            z = z + res.float()
        dy = torch.where(z > 0, dy, torch.zeros_like(dy))
    return xh, dy


def bn_stats_reference(x2):
    """(M, C) -> (sum x, sum x*x) per channel, f32 [C]."""
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_apply_reference(x2, mean, var, gamma, beta, res2, eps: float,
                       relu: bool):
    """(x - mean) * (rinv * gamma) + beta (+ res) (ReLU), in x's dtype."""
    z = (x2.float() - mean) * (_rinv(var, eps) * gamma) + beta
    if res2 is not None:
        z = z + res2.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x2.dtype)


def bn_bwd_reductions_reference(x2, dy2, mean, var, gamma, beta, res2,
                                eps: float, relu: bool):
    """-> (dbeta, dgamma), f32 [C]: sums of dy_eff and dy_eff * xhat."""
    xh, dy = _xhat_dy(x2, dy2, mean, var, gamma, beta, res2, eps, relu)
    return dy.sum(0), (dy * xh).sum(0)


def bn_bwd_dx_reference(x2, dy2, mean, var, gamma, beta, dbeta, dgamma,
                        res2, eps: float, relu: bool):
    """-> (dx in x's dtype, dres in the residual's dtype or None)."""
    xh, dy = _xhat_dy(x2, dy2, mean, var, gamma, beta, res2, eps, relu)
    inv_m = _inv_m(x2.shape[0])
    dx = (gamma * _rinv(var, eps)) * (dy - dbeta * inv_m
                                      - xh * (dgamma * inv_m))
    return dx.to(x2.dtype), (None if res2 is None else dy.to(res2.dtype))


def _inv_m(m: int) -> float:
    """1/M as the kernels get it: rounded to f32 once."""
    return float(torch.tensor(1.0 / m, dtype=torch.float32))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def plan(m: int, c: int, vec: int):
    """Rows per chunk and number of chunks of a launch: about
    ``_TARGET_BLOCKS`` blocks of 32*vec channels by one chunk of rows,
    at least ``_MIN_ROWS`` rows a chunk unless M is smaller."""
    tiles = -(-c // (32 * vec))
    chunks = max(1, min(-(-m // _MIN_ROWS), -(-_TARGET_BLOCKS // tiles)))
    rows = -(-m // chunks)
    chunks = -(-m // rows)
    if chunks > _MAX_CHUNKS:
        rows = -(-m // _MAX_CHUNKS)
        chunks = -(-m // rows)
    return rows, chunks


def _check(name: str, rows_like, vectors):
    """Raise on what the kernels do not take: (M, C) tensors on CUDA, of
    one shape and one dtype (bf16 or f32), contiguous; f32 [C] vectors.
    Returns (m, c, vec): vec 2 when C is even and every row tensor is
    aligned for two-element loads."""
    x2 = rows_like[0]
    for t in list(rows_like) + list(vectors):
        if not t.is_cuda:
            raise ValueError("%s launches a CUDA kernel; got a tensor on %s"
                             % (name, t.device))
        if t.device != x2.device:
            raise ValueError("%s takes tensors on one device" % name)
        if not t.is_contiguous():
            raise ValueError("%s takes contiguous (M, C) tensors: the view "
                             "of a channels_last activation" % name)
    if x2.dim() != 2 or x2.dtype not in _DTYPES:
        raise ValueError("%s takes a bf16 or f32 (M, C) tensor, got %s %s"
                         % (name, x2.dtype, tuple(x2.shape)))
    m, c = x2.shape
    if not (0 < m < 2 ** 31 and 0 < c < 2 ** 31):
        raise ValueError("%s: empty or oversized (M, C) = (%d, %d)"
                         % (name, m, c))
    for t in rows_like:
        if t.dtype != x2.dtype or tuple(t.shape) != (m, c):
            raise ValueError("%s takes (M, C) tensors of one shape and dtype"
                             % name)
    for t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError("%s takes f32 [C] per-channel vectors" % name)
    width = 2 * x2.element_size()
    vec = 2 if c % 2 == 0 and all(t.data_ptr() % width == 0
                                  for t in rows_like) else 1
    return m, c, vec


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _is_bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def bn_stats_kernel(x2):
    """CUDA statistics (``csrc/batch_norm.cu``) -> (sum, sumsq) f32 [C]."""
    m, c, vec = _check("bn_stats_kernel", (x2,), ())
    rows, chunks = plan(m, c, vec)
    part = torch.empty(chunks, 2, c, dtype=torch.float32, device=x2.device)
    s = torch.empty(c, dtype=torch.float32, device=x2.device)
    q = torch.empty_like(s)
    _build.check(_lib().hvd_bn_stats(
        x2.data_ptr(), part.data_ptr(), s.data_ptr(), q.data_ptr(), m, c,
        rows, _is_bf16(x2), vec, _stream(x2)), "bn_stats_kernel")
    bn_stats_kernel.launches += 1
    return s, q


def bn_apply_kernel(x2, mean, var, gamma, beta, res2, eps: float,
                    relu: bool):
    """CUDA normalize + affine (+ residual) (+ ReLU) -> y in x's dtype."""
    m, c, vec = _check("bn_apply_kernel",
                       (x2,) + (() if res2 is None else (res2,)),
                       (mean, var, gamma, beta))
    rows, _ = plan(m, c, vec)
    y = torch.empty_like(x2)
    _build.check(_lib().hvd_bn_apply(
        x2.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), _ptr(res2), y.data_ptr(), eps, m, c, rows,
        _is_bf16(x2), vec, int(relu), _stream(x2)), "bn_apply_kernel")
    bn_apply_kernel.launches += 1
    return y


def bn_bwd_reductions_kernel(x2, dy2, mean, var, gamma, beta, res2,
                             eps: float, relu: bool):
    """CUDA dbeta and dgamma from one read of x and dy -> f32 [C] each."""
    m, c, vec = _check("bn_bwd_reductions_kernel",
                       (x2, dy2) + (() if res2 is None else (res2,)),
                       (mean, var, gamma, beta))
    rows, chunks = plan(m, c, vec)
    part = torch.empty(chunks, 2, c, dtype=torch.float32, device=x2.device)
    db = torch.empty(c, dtype=torch.float32, device=x2.device)
    dg = torch.empty_like(db)
    _build.check(_lib().hvd_bn_bwd_red(
        x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), var.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), _ptr(res2), part.data_ptr(),
        db.data_ptr(), dg.data_ptr(), eps, m, c, rows, _is_bf16(x2), vec,
        int(relu), _stream(x2)), "bn_bwd_reductions_kernel")
    bn_bwd_reductions_kernel.launches += 1
    return db, dg


def bn_bwd_dx_kernel(x2, dy2, mean, var, gamma, beta, dbeta, dgamma, res2,
                     eps: float, relu: bool):
    """CUDA dx (and dres) -> (dx in x's dtype, dres or None)."""
    m, c, vec = _check("bn_bwd_dx_kernel",
                       (x2, dy2) + (() if res2 is None else (res2,)),
                       (mean, var, gamma, beta, dbeta, dgamma))
    rows, _ = plan(m, c, vec)
    dx = torch.empty_like(x2)
    dres = None if res2 is None else torch.empty_like(res2)
    _build.check(_lib().hvd_bn_bwd_dx(
        x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), var.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), dbeta.data_ptr(),
        dgamma.data_ptr(), _ptr(res2), dx.data_ptr(), _ptr(dres), eps,
        _inv_m(m), m, c, rows, _is_bf16(x2), vec, int(relu), _stream(x2)),
        "bn_bwd_dx_kernel")
    bn_bwd_dx_kernel.launches += 1
    return dx, dres


KERNELS = (bn_stats_kernel, bn_apply_kernel, bn_bwd_reductions_kernel,
           bn_bwd_dx_kernel)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for kern in KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def bn_stats(x2):
    if x2.device.type == "cpu":
        return bn_stats_reference(x2)
    return bn_stats_kernel(x2)


def bn_apply(x2, mean, var, gamma, beta, res2, eps, relu):
    if x2.device.type == "cpu":
        return bn_apply_reference(x2, mean, var, gamma, beta, res2, eps, relu)
    return bn_apply_kernel(x2, mean, var, gamma, beta, res2, eps, relu)


def bn_bwd(x2, dy2, mean, var, gamma, beta, res2, eps, relu):
    """-> (dx, dres or None, dbeta, dgamma): the two backward kernels."""
    if x2.device.type == "cpu":
        db, dg = bn_bwd_reductions_reference(x2, dy2, mean, var, gamma, beta,
                                             res2, eps, relu)
        dx, dres = bn_bwd_dx_reference(x2, dy2, mean, var, gamma, beta, db,
                                       dg, res2, eps, relu)
    else:
        db, dg = bn_bwd_reductions_kernel(x2, dy2, mean, var, gamma, beta,
                                          res2, eps, relu)
        dx, dres = bn_bwd_dx_kernel(x2, dy2, mean, var, gamma, beta, db, dg,
                                    res2, eps, relu)
    return dx, dres, db, dg


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def mc_view(t: torch.Tensor) -> torch.Tensor:
    """The free ``(M, C)`` view of a channels-last tensor: 2-D (M, C)
    contiguous, or 4-D NCHW contiguous in ``torch.channels_last``.
    Raises on any other layout rather than copying."""
    if t.dim() == 2 and t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).view(-1, t.shape[1])
    raise ValueError("batch_norm_act takes (M, C) or channels_last NCHW "
                     "tensors; got shape %s, strides %s"
                     % (tuple(t.shape), t.stride()))


def _like(t2: torch.Tensor, shape) -> torch.Tensor:
    """An (M, C) result back in ``shape`` (NCHW in channels_last for
    4-D)."""
    if len(shape) == 2:
        return t2
    n, c, h, w = shape
    return t2.view(n, h, w, c).permute(0, 3, 1, 2)


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps: float, relu: bool):
        x2 = mc_view(x)
        res2 = None if residual is None else mc_view(residual)
        m = x2.shape[0]
        # The statistics never need differentiating: their dependence on
        # x is inside the backward's dx formula.
        s, q = bn_stats(x2.detach())
        mean = s / m
        var = torch.clamp_min(q / m - torch.square(s / m), 0.0)
        g, b = gamma.float(), beta.float()
        y2 = bn_apply(x2, mean, var, g, b, res2, eps, relu)
        ctx.save_for_backward(x2, g, b, res2, mean, var)
        ctx.eps, ctx.relu = eps, relu
        ctx.shape, ctx.dtypes = tuple(x.shape), (gamma.dtype, beta.dtype)
        ctx.res_shape = None if residual is None else tuple(residual.shape)
        ctx.mark_non_differentiable(mean, var)
        return _like(y2, ctx.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, g, b, res2, mean, var = ctx.saved_tensors
        dx, dres, db, dg = bn_bwd(x2, mc_view(dy), mean, var, g, b, res2,
                                  ctx.eps, ctx.relu)
        return (_like(dx, ctx.shape), dg.to(ctx.dtypes[0]),
                db.to(ctx.dtypes[1]),
                None if dres is None else _like(dres, ctx.res_shape),
                None, None)


def batch_norm_act(x, gamma, beta, residual=None, *, eps: float = 1e-5,
                   relu: bool = True):
    """Fused train-mode BN (+ residual add) (+ ReLU) over the channels of
    a channels-last activation (``(M, C)`` or channels_last NCHW).

    Returns ``(y, mean, var)``: y in x's dtype and layout; mean and var
    the f32 batch statistics (biased variance, clamped at 0), detached,
    for the running-statistics update.  The backward gives dx, dgamma
    and dbeta (f32 sums cast to gamma's and beta's dtypes) and the
    residual's gradient."""
    return _BatchNormAct.apply(x, gamma, beta, residual, eps, relu)
