"""BERT — transformer encoder for masked-LM pretraining
(≙ ``mxnet_tpu/models/bert.py``).

Plain functions over a params dict with the reference's keys, shapes
and layouts, plus :class:`BertModel`, an ``nn.Module`` holding the same
tree with trainable parameters.  What the reference's weights and
numbers depend on:

- dense kernels are ``(in, out)`` and applied as ``x @ W + b``;
- the fused ``qkv`` output is three contiguous blocks ``[q|k|v]`` of
  ``hidden`` each (not GPT's per-head interleave);
- post-LN layers, tanh GELU, no dropout (the functional ``apply`` has
  none, though ``BertConfig.dropout`` exists);
- unmasked attention goes through ``attention_fused`` (the flash
  kernels on the card); the masked branch is plain torch with -1e9.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import context as _context
from ..ops import nn as _nn
from ..ops.flash_attention import attention_fused
from ._tree import (as_modules, from_modules, leaves, map_tree,
                    params_from_numpy, params_to)

__all__ = ["BertConfig", "BertModel", "init_params", "params_from_numpy",
           "apply", "loss_fn", "leaves"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32


def _dense_init(gen, in_dim, out_dim, dtype):
    w = torch.randn(in_dim, out_dim, generator=gen) / math.sqrt(in_dim)
    return {"kernel": w.to(dtype), "bias": torch.zeros(out_dim, dtype=dtype)}


def init_params(cfg: BertConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (same scales as the reference).  They
    are drawn on the CPU with a ``torch.Generator`` and moved to
    ``device``, so one seed gives the same weights on every device."""
    device = _context.resolve(device)
    gen = torch.Generator().manual_seed(int(seed))
    d, dt = cfg.hidden, cfg.dtype

    def embed(n):
        return (torch.randn(n, d, generator=gen) * 0.02).to(dt)

    params = {
        "embed": {
            "tok": embed(cfg.vocab_size), "pos": embed(cfg.max_len),
            "typ": embed(cfg.type_vocab),
            "ln_g": torch.ones(d, dtype=dt), "ln_b": torch.zeros(d, dtype=dt),
        },
        "layers": [],
        "mlm": _dense_init(gen, d, cfg.vocab_size, dt),
    }
    for _ in range(cfg.layers):
        params["layers"].append({
            "qkv": _dense_init(gen, d, 3 * d, dt),      # [q|k|v] blocks
            "out": _dense_init(gen, d, d, dt),
            "ffn_in": _dense_init(gen, d, cfg.intermediate, dt),
            "ffn_out": _dense_init(gen, cfg.intermediate, d, dt),
            "ln1_g": torch.ones(d, dtype=dt),
            "ln1_b": torch.zeros(d, dtype=dt),
            "ln2_g": torch.ones(d, dtype=dt),
            "ln2_b": torch.zeros(d, dtype=dt),
        })
    return map_tree(params, lambda t: t.to(device))


def _proj(x, p):
    return torch.matmul(x, p["kernel"]) + p["bias"]


def _attention(x, p, heads, mask=None):
    """Multi-head self-attention from one fused QKV product.  q/k/v are
    (B, H, T, hd) views into it, passed to the kernels as they are."""
    B, T, D = x.shape
    H, hd = heads, D // heads
    q, k, v = (t.view(B, T, H, hd).transpose(1, 2)
               for t in _proj(x, p["qkv"]).split(D, dim=-1))
    if mask is None:
        ctx = attention_fused(q, k, v, 1.0 / math.sqrt(hd))
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.full_like(scores, -1e9))
        ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)
    return _proj(ctx.transpose(1, 2).reshape(B, T, D), p["out"])


def _layer(x, p, heads, mask=None):
    x = _nn.layer_norm(x + _attention(x, p, heads, mask), p["ln1_g"],
                       p["ln1_b"])
    h = _proj(_nn.gelu(_proj(x, p["ffn_in"])), p["ffn_out"])
    return _nn.layer_norm(x + h, p["ln2_g"], p["ln2_b"])


def apply(params, cfg: BertConfig, tokens, token_types=None, mask=None):
    """Forward: tokens (B, T) int → logits (B, T, vocab) fp32.  ``mask``
    (B, T) bool marks the keys each row may attend to."""
    T = tokens.shape[1]
    e = params["embed"]
    x = F.embedding(tokens, e["tok"]) + e["pos"][:T][None]
    if token_types is not None:
        x = x + F.embedding(token_types, e["typ"])
    x = _nn.layer_norm(x, e["ln_g"], e["ln_b"])
    for p in params["layers"]:
        x = _layer(x, p, cfg.heads, mask)
    return torch.matmul(x, params["mlm"]["kernel"]).float() + \
        params["mlm"]["bias"].float()


def loss_fn(params, cfg: BertConfig, tokens, labels, mask=None):
    """Masked-LM cross entropy; labels == -1 positions ignored, the sum
    divided by ``max(valid, 1)``."""
    logp = torch.log_softmax(apply(params, cfg, tokens, mask=mask), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / \
        valid.sum().clamp(min=1)


class BertModel(nn.Module):
    """``nn.Module`` holding the params tree as trainable parameters with
    the tree's keys; ``model.params`` is the dict the functions take."""

    def __init__(self, cfg: Optional[BertConfig] = None, params=None,
                 seed: int = 0, device=None, **overrides):
        super().__init__()
        self.cfg = cfg or BertConfig(**overrides)
        if params is None:
            params = init_params(self.cfg, seed, device)
        else:
            params = params_to(params, _context.resolve(device))
        self.tree = as_modules(params, requires_grad=True)

    @property
    def params(self) -> Dict:
        return from_modules(self.tree)

    def forward(self, tokens, token_types=None, mask=None):
        return apply(self.params, self.cfg, tokens, token_types, mask)
