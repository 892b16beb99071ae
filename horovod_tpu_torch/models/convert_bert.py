"""The JAX BERT parameter layout <-> the port's ``Bert``.

The JAX model keeps a layer-stacked tree (``horovod_tpu.models.bert.
init_params``)::

    {"word_embed": [V, d], "pos_embed": [max_seq, d],
     "type_embed": [type_vocab, d], "ln_embed_g"/"ln_embed_b": [d],
     "layers": {"wq"/"wk"/"wv"/"wo": [L, d, d], "bq"/"bk"/"bv"/"bo": [L, d],
                "ln1_g"/"ln1_b"/"ln2_g"/"ln2_b": [L, d], "w_in": [L, d, f],
                "b_in": [L, f], "w_out": [L, f, d], "b_out": [L, d]},
     "pooler_w": [d, d], "pooler_b": [d], "cls_w": [d, C], "cls_b": [C],
     "mlm_w": [d, d], "mlm_b": [d], "mlm_ln_g"/"mlm_ln_b": [d],
     "mlm_bias": [V]}

The port's weights have the same ``(in, out)`` layout, one layer each,
so nothing is transposed on the way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bert import LAYER_KEYS, TOP_KEYS, Bert, BertConfig


def init_params(cfg: BertConfig, seed: int = 0) -> dict:
    """A random tree in the JAX layout, with the JAX initialisers'
    distributions (normal / sqrt(fan_in) for the matrices, gains at one,
    biases at zero), from numpy."""
    rng = np.random.default_rng(seed)
    pd = np.dtype(cfg.param_dtype)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size

    def norm(shape, fan_in):
        out = rng.standard_normal(shape, dtype=np.float32)
        out /= math.sqrt(fan_in)
        return out.astype(pd, copy=False)

    def ones(*shape):
        return np.ones(shape, pd)

    def zeros(*shape):
        return np.zeros(shape, pd)

    return {
        "word_embed": norm((V, d), d),
        "pos_embed": norm((cfg.max_seq, d), d),
        "type_embed": norm((cfg.type_vocab, d), d),
        "ln_embed_g": ones(d), "ln_embed_b": zeros(d),
        "layers": {
            "wq": norm((L, d, d), d), "wk": norm((L, d, d), d),
            "wv": norm((L, d, d), d),
            "bq": zeros(L, d), "bk": zeros(L, d), "bv": zeros(L, d),
            "wo": norm((L, d, d), d), "bo": zeros(L, d),
            "ln1_g": ones(L, d), "ln1_b": zeros(L, d),
            "w_in": norm((L, d, f), d), "b_in": zeros(L, f),
            "w_out": norm((L, f, d), f), "b_out": zeros(L, d),
            "ln2_g": ones(L, d), "ln2_b": zeros(L, d),
        },
        "pooler_w": norm((d, d), d), "pooler_b": zeros(d),
        "cls_w": norm((d, cfg.n_classes), d), "cls_b": zeros(cfg.n_classes),
        "mlm_w": norm((d, d), d), "mlm_b": zeros(d),
        "mlm_ln_g": ones(d), "mlm_ln_b": zeros(d),
        "mlm_bias": zeros(V),
    }


def params_from_jax(np_tree: dict, cfg: BertConfig, device=None) -> Bert:
    """A ``Bert`` on ``device`` holding the JAX tree's values."""
    model = Bert(cfg, device)
    with torch.no_grad():
        def put(param, value):
            value = np.ascontiguousarray(value, dtype=np.float32)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError("shape %s does not fit parameter of shape "
                                 "%s" % (value.shape, tuple(param.shape)))
            param.copy_(torch.from_numpy(value))

        for key in TOP_KEYS:
            put(getattr(model, key), np_tree[key])
        layers = np_tree["layers"]
        for i, layer in enumerate(model.layers):
            for key in LAYER_KEYS:
                put(getattr(layer, key), np.asarray(layers[key])[i])
    return model


def tree_from_module(model: Bert, grads: bool = False) -> dict:
    """The module's parameters (or their gradients, zero where a
    parameter got none, as JAX's gradient tree holds them) as a
    JAX-layout numpy tree."""
    def get(p):
        t = p.grad if grads else p
        if t is None:
            return np.zeros(tuple(p.shape), np.float32)
        return t.detach().float().cpu().numpy()

    tree = {key: get(getattr(model, key)) for key in TOP_KEYS}
    tree["layers"] = {key: np.stack([get(getattr(layer, key))
                                     for layer in model.layers])
                      for key in LAYER_KEYS}
    return tree
