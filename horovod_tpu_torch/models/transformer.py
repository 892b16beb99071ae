"""The flagship llama-style decoder as an ``nn.Module``.

Counterpart of ``horovod_tpu/models/transformer.py`` for the dense model
(no experts) at tensor and sequence parallel degree 1: RMSNorm, RoPE on
split halves, GQA attention through the flash kernels, a SiLU-gated FFN,
and logits from the tied embedding.  Weights keep the JAX layout
``(in, out)`` and are used as ``x @ w``, cast to the activation dtype
per use, as the JAX forward does.  Attention goes through
``flash_attention`` (its kernels on CUDA, their plain versions on the
CPU) unless ``HOROVOD_FLASH_ATTENTION`` is 0, false or False, which
takes ``local_attention``, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..common.basics import resolve_device
from ..ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1344
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"
    # One [d, (q+2kv)*hd] projection instead of three (and [d, 2f] for
    # the FFN gate): the weights stay separate and are concatenated per
    # forward, as in the JAX model.
    fused_qkv: bool = False
    fused_gate: bool = False
    # Vocab projection: "bf16" operands with an f32 result, "f32"
    # operands, or "auto", as in the JAX model: bf16 when flash attention
    # runs, f32 with the plain attention.
    logits_dtype: str = "auto"

    def __post_init__(self):
        if self.logits_dtype not in ("auto", "bf16", "f32"):
            raise ValueError("logits_dtype must be 'auto', 'bf16' or 'f32', "
                             "got %r" % (self.logits_dtype,))
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide d_model and n_kv_heads "
                             "must divide n_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def use_flash_attention() -> bool:
    """``HOROVOD_FLASH_ATTENTION`` as the JAX model reads it: 0, false or
    False turns flash attention off.  Unset, it is on (on the card, as on
    the TPU; the JAX package's default off the TPU is the one that
    differs)."""
    flag = os.environ.get("HOROVOD_FLASH_ATTENTION")
    return flag is None or flag not in ("0", "false", "False")


def local_attention(q, k, v, causal: bool = True):
    """Plain softmax attention on ``(batch, seq, heads, head_dim)``, the
    counterpart of the JAX package's ``local_attention``: f32 scores
    scaled by 1/sqrt(head_dim), masked with -1e30, an f32 softmax and
    product, the result cast to q's dtype; GQA repeats each KV head."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        idx = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(idx[None, :] > idx[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def rms_norm(x, scale, eps: float):
    """Normalise in f32, cast to x's dtype, then multiply by the scale
    cast to x's dtype (the JAX order, which fixes the bf16 rounding)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale.to(x.dtype)


def rope_tables(seq: int, head_dim: int, theta: float, dtype, device):
    """cos and sin, (1, seq, 1, head_dim/2), computed in f32 and cast to
    the activation dtype."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    ang = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
           * inv_freq[None, :])
    return (torch.cos(ang)[None, :, None, :].to(dtype),
            torch.sin(ang)[None, :, None, :].to(dtype))


def rope(cos, sin, x):
    """Rotate the two halves of the head dim: [x1 cos - x2 sin,
    x1 sin + x2 cos] (halves, as the JAX code does)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        pd = getattr(torch, cfg.param_dtype)
        d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=pd, device=device))

        self.ln1, self.ln2 = p(d), p(d)
        self.wq = p(d, cfg.n_heads * hd)
        self.wk = p(d, cfg.n_kv_heads * hd)
        self.wv = p(d, cfg.n_kv_heads * hd)
        self.wo = p(cfg.n_heads * hd, d)
        self.w1, self.w3, self.w2 = p(d, f), p(d, f), p(f, d)

    def attention(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        if cfg.fused_qkv:
            qkv = x @ torch.cat([self.wq, self.wk, self.wv], -1).to(x.dtype)
            q_sz, kv_sz = self.wq.shape[1], self.wk.shape[1]
            q, k, v = qkv.split([q_sz, kv_sz, kv_sz], dim=-1)
            q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
        else:
            q = (x @ self.wq.to(x.dtype)).reshape(b, s, -1, hd)
            k = (x @ self.wk.to(x.dtype)).reshape(b, s, -1, hd)
            v = (x @ self.wv.to(x.dtype)).reshape(b, s, -1, hd)
        q, k = rope(cos, sin, q), rope(cos, sin, k)
        attend = flash_attention if use_flash_attention() else local_attention
        attn = attend(q, k, v, causal=True).reshape(b, s, -1)
        return attn @ self.wo.to(x.dtype)

    def ffn(self, h):
        if self.cfg.fused_gate:
            a, g = (h @ torch.cat([self.w1, self.w3], -1).to(h.dtype)
                    ).chunk(2, dim=-1)
            a = F.silu(a)
        else:
            a = F.silu(h @ self.w1.to(h.dtype))
            g = h @ self.w3.to(h.dtype)
        return (a * g) @ self.w2.to(h.dtype)

    def forward(self, x, cos, sin):
        eps = self.cfg.norm_eps
        x = x + self.attention(rms_norm(x, self.ln1, eps), cos, sin)
        return x + self.ffn(rms_norm(x, self.ln2, eps))


class Transformer(nn.Module):
    """Parameters start at zero; ``models.convert`` fills them
    (``params_from_jax``, ``init_params``)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        pd = getattr(torch, cfg.param_dtype)
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model,
                                              dtype=pd, device=dev))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=pd,
                                             device=dev))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] in f32."""
        cfg = self.cfg
        act = cfg.act_dtype
        cos, sin = rope_tables(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                               act, tokens.device)
        x = self.embed[tokens].to(act)
        for layer in self.layers:
            x = layer(x, cos, sin)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if cfg.logits_dtype == "f32" or (cfg.logits_dtype == "auto"
                                         and not use_flash_attention()):
            return x.float() @ self.embed.float().t()
        # bf16 operands, f32 result: the bf16 values widened to f32 make
        # every product exact, so this equals a bf16 product with f32
        # accumulation (torch.matmul on bf16 would round the result).
        return x.to(act).float() @ self.embed.to(act).float().t()


def loss_fn(model: Transformer, batch) -> torch.Tensor:
    """Mean next-token negative log likelihood of this rank's batch:
    ``logsumexp(logits) - logits[target]``."""
    logits = model(batch["tokens"])
    tgt = logits.gather(-1, batch["targets"][..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).mean()
