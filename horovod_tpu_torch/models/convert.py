"""The JAX parameter layout <-> the port's ``Transformer``.

The JAX model keeps a layer-stacked tree (``horovod_tpu.models.
transformer.init_params``)::

    {"embed": [V, d], "ln_f": [d],
     "layers": {"ln1": [L, d], "ln2": [L, d], "wq": [L, d, qh*hd],
                "wk"/"wv": [L, d, kvh*hd], "wo": [L, qh*hd, d],
                "w1"/"w3": [L, d, f], "w2": [L, f, d]}}

The port's weights have the same ``(in, out)`` layout, one layer each,
so nothing is transposed on the way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w3", "w2")


def init_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """A random tree in the JAX layout, with the JAX initialiser's
    distribution (normal / sqrt(fan_in), norms at one), from numpy."""
    rng = np.random.default_rng(seed)
    pd = np.dtype(cfg.param_dtype)
    d, hd, f, L = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_layers
    qh, kvh = cfg.n_heads, cfg.n_kv_heads

    def norm(shape, fan_in):
        out = rng.standard_normal(shape, dtype=np.float32)
        out /= math.sqrt(fan_in)
        return out.astype(pd, copy=False)

    return {
        "embed": norm((cfg.vocab_size, d), d),
        "ln_f": np.ones((d,), pd),
        "layers": {
            "ln1": np.ones((L, d), pd),
            "ln2": np.ones((L, d), pd),
            "wq": norm((L, d, qh * hd), d),
            "wk": norm((L, d, kvh * hd), d),
            "wv": norm((L, d, kvh * hd), d),
            "wo": norm((L, qh * hd, d), qh * hd),
            "w1": norm((L, d, f), d),
            "w3": norm((L, d, f), d),
            "w2": norm((L, f, d), f),
        },
    }


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device=None) -> Transformer:
    """A ``Transformer`` on ``device`` holding the JAX tree's values."""
    model = Transformer(cfg, device)
    with torch.no_grad():
        def put(param, value):
            value = np.asarray(value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError("shape %s does not fit parameter of shape "
                                 "%s" % (value.shape, tuple(param.shape)))
            param.copy_(torch.tensor(value))

        put(model.embed, np_tree["embed"])
        put(model.ln_f, np_tree["ln_f"])
        layers = np_tree["layers"]
        for i, layer in enumerate(model.layers):
            for key in LAYER_KEYS:
                put(getattr(layer, key), np.asarray(layers[key])[i])
    return model


def tree_from_module(model: Transformer, grads: bool = False) -> dict:
    """The module's parameters (or their gradients) as a JAX-layout
    numpy tree."""
    def get(p):
        t = p.grad if grads else p
        return t.detach().float().cpu().numpy()

    return {
        "embed": get(model.embed),
        "ln_f": get(model.ln_f),
        "layers": {key: np.stack([get(getattr(layer, key))
                                  for layer in model.layers])
                   for key in LAYER_KEYS},
    }
