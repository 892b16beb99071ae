"""The flax ResNet variables <-> the port's ``ResNet``.

The JAX model (``horovod_tpu/models/resnet.py``) keeps
``{"params": ..., "batch_stats": ...}`` with flax's automatic names,
given in creation order: ``Conv_0``/``NormAct_0`` for the stem,
``BottleneckBlock_<i>`` (or ``BasicBlock_<i>``) for the blocks in order,
``Dense_0`` for the head.  Inside a block the convolutions and NormActs
are numbered as created, so in a block with a projection ``Conv_3`` and
``NormAct_2`` are the projection and ``NormAct_3`` is the last norm; in a
block without one, ``NormAct_2`` is the last norm (``BasicBlock``: one
fewer of each).  Conv kernels are HWIO (torch: OIHW); ``Dense`` kernels
are (in, out) (``nn.Linear.weight``: (out, in)).  NormAct keeps
``scale``/``bias`` in params and ``mean``/``var`` in batch_stats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .resnet import BasicBlock, ResNet, ResNetConfig

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# a normal cut at +-2 standard deviations, rescaled to unit variance.
_TRUNC_STD = 0.87962566103423978


def _block_names(block, bottleneck: bool):
    """(flax name, torch module) of a block's convolutions and norms."""
    convs = ([block.conv1, block.conv2, block.conv3] if bottleneck
             else [block.conv1, block.conv2])
    norms = [block.norm1, block.norm2] if bottleneck else [block.norm1]
    if block.proj is not None:
        convs.append(block.proj)
        norms.append(block.proj_norm)
    norms.append(block.norm3 if bottleneck else block.norm2)
    return ([("Conv_%d" % i, m) for i, m in enumerate(convs)],
            [("NormAct_%d" % i, m) for i, m in enumerate(norms)])


def _layout(model: ResNet):
    """Yields (path, module, kind) for every flax leaf owner: kind is
    "conv", "norm" or "dense"; path a tuple of flax names."""
    yield ("Conv_0",), model.stem, "conv"
    yield ("NormAct_0",), model.stem_norm, "norm"
    for i, blk in enumerate(model.blocks):
        bottleneck = not isinstance(blk, BasicBlock)
        name = ("BottleneckBlock_%d" if bottleneck else "BasicBlock_%d") % i
        convs, norms = _block_names(blk, bottleneck)
        for n, m in convs:
            yield (name, n), m, "conv"
        for n, m in norms:
            yield (name, n), m, "norm"
    yield ("Dense_0",), model.head, "dense"


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def init_params(depth: int = 50, num_classes: int = 1000,
                seed: int = 0) -> dict:
    """Random ``{"params", "batch_stats"}`` in the flax layout with flax's
    initialisers, from numpy: lecun-normal (truncated, fan_in) for conv
    and Dense kernels, Dense bias 0, NormAct scale 1 (0 for a block's
    last norm) and bias 0, batch_stats mean 0 and var 1 (the module's
    own defaults)."""
    rng = np.random.default_rng(seed)

    def lecun(shape, fan_in):
        out = rng.standard_normal(shape, dtype=np.float32)
        bad = np.abs(out) > 2
        while bad.any():
            out[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(out) > 2
        return out * np.float32(math.sqrt(1.0 / fan_in) / _TRUNC_STD)

    model = ResNet(ResNetConfig(depth, num_classes, "float32"), "cpu")
    with torch.no_grad():
        for _, mod, kind in _layout(model):
            if kind == "conv":
                o, i, kh, kw = mod.weight.shape
                w = lecun((kh, kw, i, o), kh * kw * i).transpose(3, 2, 0, 1)
                mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            elif kind == "dense":
                o, i = mod.weight.shape
                mod.weight.copy_(torch.from_numpy(lecun((i, o), i).T.copy()))
                mod.bias.zero_()
    return tree_from_module(model)


def params_from_flax(variables: dict, cfg: ResNetConfig,
                     device=None) -> ResNet:
    """A ``ResNet`` on ``device`` (CUDA unless "cpu") holding the flax
    variables' values (numpy or JAX arrays)."""
    model = ResNet(cfg, device)
    params, stats = variables["params"], variables["batch_stats"]

    def put(t, value, transpose=None):
        value = np.asarray(value, dtype=np.float32)
        if transpose is not None:
            value = value.transpose(transpose)
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError("shape %s does not fit a tensor of shape %s"
                             % (value.shape, tuple(t.shape)))
        t.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    with torch.no_grad():
        for path, mod, kind in _layout(model):
            p = _get(params, path)
            if kind == "conv":
                put(mod.weight, p["kernel"], (3, 2, 0, 1))
            elif kind == "dense":
                put(mod.weight, p["kernel"], (1, 0))
                put(mod.bias, p["bias"])
            else:
                put(mod.scale, p["scale"])
                put(mod.bias, p["bias"])
                s = _get(stats, path)
                put(mod.mean, s["mean"])
                put(mod.var, s["var"])
    return model


def tree_from_module(model: ResNet, grads: bool = False) -> dict:
    """The module as flax variables ``{"params", "batch_stats"}`` of
    numpy arrays, or with ``grads=True`` the parameters' gradients as a
    params-shaped tree."""
    def get(t, transpose=None):
        t = t.grad if grads else t
        out = t.detach().float().cpu().numpy().copy()
        return out if transpose is None else out.transpose(transpose)

    params, stats = {}, {}
    for path, mod, kind in _layout(model):
        if kind == "conv":
            _set(params, path + ("kernel",), get(mod.weight, (2, 3, 1, 0)))
        elif kind == "dense":
            _set(params, path + ("kernel",), get(mod.weight, (1, 0)))
            _set(params, path + ("bias",), get(mod.bias))
        else:
            _set(params, path + ("scale",), get(mod.scale))
            _set(params, path + ("bias",), get(mod.bias))
            if not grads:
                _set(stats, path + ("mean",), get(mod.mean))
                _set(stats, path + ("var",), get(mod.var))
    return params if grads else {"params": params, "batch_stats": stats}
