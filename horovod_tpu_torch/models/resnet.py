"""ResNet-v1.5 (ResNet-50 flagship) as ``nn.Module``s.

Counterpart of ``horovod_tpu/models/resnet.py``.  Activations are NCHW
tensors in ``torch.channels_last`` (the memory order of the JAX model's
NHWC arrays), so BatchNorm's ``(M, C)`` view is free; parameters are f32
and each convolution casts its weight to the activation dtype per call.
Train-mode ``NormAct`` always runs ``batch_norm_act``: the four CUDA
kernels on CUDA, their plain versions on the CPU.  Eval mode
(``model.eval()``) is the reference's plain per-channel mul/add in the
activation dtype.  Sync-BN (``axis_name``) is not ported.

flax's ``"SAME"`` padding puts the odd pixel at the end: a 3x3 stride-2
convolution or max-pool over an even size pads (0, 1), not (1, 1), so
those pad explicitly (``same_pads``); the max-pool pads with -inf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.basics import resolve_device
from ..ops.batch_norm import batch_norm_act

STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    dtype: str = "bfloat16"  # activation dtype; parameters are f32

    def __post_init__(self):
        if self.depth not in STAGE_SIZES:
            raise ValueError("depth must be one of %s, got %r"
                             % (sorted(STAGE_SIZES), self.depth))

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial axis: (before, after),
    with the odd pixel after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """x padded for a SAME window of size k and stride s; also returns
    the symmetric padding left to the op when before == after."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


def max_pool_same(x):
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``:
    -inf padding, the odd pixel after."""
    x, pad = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=pad)


class Conv(nn.Module):
    """Bias-free convolution, SAME padding unless ``padding`` is given;
    weight f32 (out, in, kh, kw), cast to the input's dtype per call."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, device=None):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k,
                                               dtype=torch.float32,
                                               device=device))

    def forward(self, x):
        if self.padding is None:
            x, pad = _pad_same(x, self.k, self.stride)
        else:
            pad = (self.padding, self.padding)
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                        padding=pad)


class NormAct(nn.Module):
    """BatchNorm + optional residual add + optional ReLU, as one op.

    Train mode: ``batch_norm_act`` (batch statistics, biased variance),
    then the running statistics move as in the JAX model,
    ``ra = momentum * ra + (1 - momentum) * batch``, with the biased
    batch variance (not ``nn.BatchNorm2d``'s rule)."""

    def __init__(self, c: int, relu: bool = True, zero_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.relu, self.momentum, self.eps = relu, momentum, eps
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(c, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=torch.float32,
                                             device=device))
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32,
                                               device=device))

    def forward(self, x, residual=None):
        if not self.training:
            return self._eval(x, residual)
        y, mean, var = batch_norm_act(x, self.scale, self.bias, residual,
                                      eps=self.eps, relu=self.relu)
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y

    def _eval(self, x, residual):
        # Per-channel factors in f32, the activation-sized pass in x's
        # dtype, as the reference's _xla_apply.
        rinv = torch.rsqrt(self.var + self.eps)
        mul = (rinv * self.scale).to(x.dtype)
        add = (self.bias - self.mean * rinv * self.scale).to(x.dtype)
        z = x * mul[:, None, None] + add[:, None, None]
        if residual is not None:
            z = z + residual.to(x.dtype)
        if self.relu:
            z = torch.clamp_min(z, 0)
        return z


class BottleneckBlock(nn.Module):
    """1x1, 3x3 with the stride (v1.5), 1x1 x4; a projection (1x1 with
    the stride, NormAct without ReLU) when channels or stride change; the
    last NormAct starts at scale 0 and fuses the residual and the ReLU."""
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        cout = filters * 4
        self.conv1 = Conv(cin, filters, 1, device=device)
        self.norm1 = NormAct(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, stride, device=device)
        self.norm2 = NormAct(filters, device=device)
        self.conv3 = Conv(filters, cout, 1, device=device)
        self.proj = self.proj_norm = None
        if cin != cout or stride != 1:
            self.proj = Conv(cin, cout, 1, stride, device=device)
            self.proj_norm = NormAct(cout, relu=False, device=device)
        self.norm3 = NormAct(cout, zero_scale=True, device=device)

    def forward(self, x):
        residual = x
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.conv3(y)
        if self.proj is not None:
            residual = self.proj_norm(self.proj(x))
        return self.norm3(y, residual)


class BasicBlock(nn.Module):
    """3x3 with the stride, 3x3; projection and last NormAct as in
    ``BottleneckBlock``."""
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, device=device)
        self.norm1 = NormAct(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, device=device)
        self.proj = self.proj_norm = None
        if cin != filters or stride != 1:
            self.proj = Conv(cin, filters, 1, stride, device=device)
            self.proj_norm = NormAct(filters, relu=False, device=device)
        self.norm2 = NormAct(filters, zero_scale=True, device=device)

    def forward(self, x):
        residual = x
        y = self.conv2(self.norm1(self.conv1(x)))
        if self.proj is not None:
            residual = self.proj_norm(self.proj(x))
        return self.norm2(y, residual)


class ResNet(nn.Module):
    """Parameters start at the module defaults (zeros for weights);
    ``models.convert_resnet`` fills them (``params_from_flax``)."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        block = BottleneckBlock if cfg.depth >= 50 else BasicBlock
        self.stem = Conv(3, 64, 7, 2, padding=3, device=dev)
        self.stem_norm = NormAct(64, device=dev)
        blocks, cin = [], 64
        for i, n in enumerate(STAGE_SIZES[cfg.depth]):
            for j in range(n):
                filters = 64 * 2 ** i
                blocks.append(block(cin, filters, 2 if i > 0 and j == 0 else 1,
                                    device=dev))
                cin = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, cfg.num_classes, dtype=torch.float32,
                              device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW images (channels_last, e.g. an NHWC array permuted)
        -> f32 logits (N, classes)."""
        x = self.stem_norm(self.stem(x.to(self.cfg.act_dtype)))
        x = max_pool_same(x)
        for blk in self.blocks:
            x = blk(x)
        # Mean over H and W in the activation dtype (rounded once, as
        # jnp.mean does), taken over the NHWC view so that its gradient
        # comes back channels_last.
        x = x.permute(0, 2, 3, 1).flatten(1, 2).mean(1)
        return self.head(x.float())


def create_resnet50(num_classes: int = 1000, dtype: str = "bfloat16",
                    device=None) -> ResNet:
    return ResNet(ResNetConfig(50, num_classes, dtype), device)


def create_resnet101(num_classes: int = 1000, dtype: str = "bfloat16",
                     device=None) -> ResNet:
    return ResNet(ResNetConfig(101, num_classes, dtype), device)


def resnet_loss_fn(model: ResNet, batch) -> torch.Tensor:
    """Mean cross-entropy of f32 log-softmax logits; in train mode the
    forward also moves the running statistics."""
    logp = torch.log_softmax(model(batch["x"]), dim=-1)
    return -logp.gather(1, batch["y"][:, None]).mean()
