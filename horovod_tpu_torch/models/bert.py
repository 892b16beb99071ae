"""The BERT encoder as an ``nn.Module``: post-LN blocks, tanh GELU,
learned position and token-type embeddings, the [CLS] classification
head and the tied MLM head.

Counterpart of ``horovod_tpu/models/bert.py`` at tensor-parallel degree
1; data parallelism is ``DistributedOptimizer``'s.  Weights keep the JAX
layout ``(in, out)`` and are used as ``x @ w + b``, each cast to the
activation dtype per use, so that a bias is added after the product is
rounded, as the JAX forward does (``F.linear`` would add it before).  The
numerics follow the JAX code where they fix the bf16 rounding:

* GELU is the tanh approximation (``jax.nn.gelu``'s default), not
  torch's erf default;
* ``layer_norm`` normalises in f32, casts to x's dtype and applies its
  gain and bias in x's dtype (``F.layer_norm`` applies them in f32);
* the embedding lookups are summed and normalised in f32, then cast;
* the pooler, classifier and MLM head run in f32.

Attention without a padding mask runs ``flash_attention(causal=False)``
(its kernels on CUDA, their plain versions on the CPU) unless
``HOROVOD_FLASH_ATTENTION`` turns flash off (``use_flash_attention``);
with a mask, or with flash off, it takes the plain path in f32 torch
(additive bias for the mask), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..common import basics
from ..common.basics import resolve_device
from ..ops.api import SUM, allreduce
from ..ops.flash_attention import flash_attention
from .transformer import use_flash_attention

LAYER_KEYS = ("wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo", "ln1_g",
              "ln1_b", "w_in", "b_in", "w_out", "b_out", "ln2_g", "ln2_b")
TOP_KEYS = ("word_embed", "pos_embed", "type_embed", "ln_embed_g",
            "ln_embed_b", "pooler_w", "pooler_b", "cls_w", "cls_b", "mlm_w",
            "mlm_b", "mlm_ln_g", "mlm_ln_b", "mlm_bias")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    n_classes: int = 2            # sequence-classification head width
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("n_heads must divide d_model")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x, g, b, eps: float):
    """Normalise in f32, cast to x's dtype, then gain and bias in x's
    dtype: two roundings in bf16, as the JAX ``layer_norm``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * g.to(x.dtype) + b.to(x.dtype)


def _params(module: nn.Module, shapes: dict, dtype, device):
    for name, shape in shapes.items():
        module.register_parameter(name, nn.Parameter(
            torch.zeros(shape, dtype=dtype, device=device)))


class EncoderLayer(nn.Module):
    """One post-LN block: ``x = LN(x + attn(x)); x = LN(x + ffn(x))``."""

    def __init__(self, cfg: BertConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        _params(self, {
            "wq": (d, d), "wk": (d, d), "wv": (d, d),
            "bq": (d,), "bk": (d,), "bv": (d,),
            "wo": (d, d), "bo": (d,), "ln1_g": (d,), "ln1_b": (d,),
            "w_in": (d, f), "b_in": (f,), "w_out": (f, d), "b_out": (d,),
            "ln2_g": (d,), "ln2_b": (d,)}, getattr(torch, cfg.param_dtype),
            device)

    def attention(self, h, mask=None):
        """Bidirectional self-attention; ``mask`` [B, S], 1 = attend."""
        b, s, _ = h.shape
        hd, dt = self.cfg.head_dim, h.dtype
        q = (h @ self.wq.to(dt) + self.bq.to(dt)).reshape(b, s, -1, hd)
        k = (h @ self.wk.to(dt) + self.bk.to(dt)).reshape(b, s, -1, hd)
        v = (h @ self.wv.to(dt) + self.bv.to(dt)).reshape(b, s, -1, hd)
        if mask is None and use_flash_attention():
            attn = flash_attention(q, k, v, causal=False)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk",
                                  q.float() / math.sqrt(hd), k.float())
            if mask is not None:
                scores = scores + torch.where(
                    mask[:, None, None, :] > 0, 0.0, -1e9)
            p = torch.softmax(scores, dim=-1)
            attn = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dt)
        return attn.reshape(b, s, -1) @ self.wo.to(dt) + self.bo.to(dt)

    def ffn(self, h):
        dt = h.dtype
        a = gelu(h @ self.w_in.to(dt) + self.b_in.to(dt))
        return a @ self.w_out.to(dt) + self.b_out.to(dt)

    def forward(self, x, mask=None):
        eps = self.cfg.norm_eps
        x = layer_norm(x + self.attention(x, mask), self.ln1_g, self.ln1_b,
                       eps)
        return layer_norm(x + self.ffn(x), self.ln2_g, self.ln2_b, eps)


class Bert(nn.Module):
    """Parameters start at zero; ``models.convert_bert`` fills them
    (``params_from_jax``, ``init_params``).  The MLM decoder is the word
    embedding itself (tied); only its bias is a parameter of its own."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, pd = cfg.d_model, getattr(torch, cfg.param_dtype)
        _params(self, {
            "word_embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq, d),
            "type_embed": (cfg.type_vocab, d), "ln_embed_g": (d,),
            "ln_embed_b": (d,), "pooler_w": (d, d), "pooler_b": (d,),
            "cls_w": (d, cfg.n_classes), "cls_b": (cfg.n_classes,),
            "mlm_w": (d, d), "mlm_b": (d,), "mlm_ln_g": (d,),
            "mlm_ln_b": (d,), "mlm_bias": (cfg.vocab_size,)}, pd, dev)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dev)
                                    for _ in range(cfg.n_layers))

    def encode(self, tokens, token_type=None, mask=None):
        """tokens [B, S] -> hidden [B, S, d] in the activation dtype."""
        cfg = self.cfg
        x = self.word_embed[tokens] + self.pos_embed[:tokens.shape[1]][None]
        tt = token_type if token_type is not None else torch.zeros_like(tokens)
        x = x + self.type_embed[tt]
        x = layer_norm(x, self.ln_embed_g, self.ln_embed_b,
                       cfg.norm_eps).to(cfg.act_dtype)
        for layer in self.layers:
            x = layer(x, mask)
        return x

    forward = encode

    def mlm_logits(self, hidden):
        """[B, S, d] -> [B, S, V] f32, through the tied word embedding."""
        h = gelu(hidden.float() @ self.mlm_w.float() + self.mlm_b.float())
        h = layer_norm(h, self.mlm_ln_g.float(), self.mlm_ln_b.float(),
                       self.cfg.norm_eps)
        return h @ self.word_embed.float().t() + self.mlm_bias.float()

    def cls_logits(self, hidden):
        """The [CLS] pooled classification head: [B, S, d] -> [B, C] f32."""
        pooled = torch.tanh(hidden[:, 0].float() @ self.pooler_w.float()
                            + self.pooler_b.float())
        return pooled @ self.cls_w.float() + self.cls_b.float()


def _encode(model: Bert, batch):
    return model.encode(batch["tokens"], batch.get("token_type"),
                        batch.get("mask"))


def classification_loss(model: Bert, batch) -> torch.Tensor:
    """Mean [CLS] cross entropy of this rank's rows; the Average of
    ``DistributedOptimizer`` then gives the gradient of the JAX
    package's ``pmean``."""
    logits = model.cls_logits(_encode(model, batch))
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["labels"][:, None])[:, 0].mean()


def mlm_loss(model: Bert, batch) -> torch.Tensor:
    """Masked-LM loss over the GLOBAL count of masked positions.

    The JAX package sums the numerator and the denominator over dp before
    dividing.  Here the denominator is summed over the world (no gradient
    runs through it) and each rank returns ``size * num_rank / den``, so
    that the Average of ``DistributedOptimizer`` gives the JAX gradient
    when ranks mask different counts; the mean of the ranks' values is
    the global loss."""
    logits = model.mlm_logits(_encode(model, batch))
    tgt = logits.gather(-1, batch["targets"][..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - tgt
    m = batch["mlm_mask"].float()
    num = (nll * m).sum()
    den, size = m.sum().detach(), 1
    if basics.is_initialized() and basics.size() > 1:
        den, size = allreduce(den, op=SUM), basics.size()
    return size * num / den.clamp_min(1.0)
