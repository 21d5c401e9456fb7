"""GPT — decoder-only transformer for the autoregressive path
(≙ ``mxnet_tpu/models/gpt.py``).

Plain functions over a params dict with the reference's keys, shapes
and layouts, plus :class:`GPTModel`, an ``nn.Module`` holding the same
tree.  Layout rules that the reference's weights depend on:

- dense kernels are ``(in, out)`` and applied as ``x @ W + b``;
- the fused ``qkv`` output is laid out per head as ``[q|k|v]``:
  ``reshape(B, T, H, 3, hd)``, not the GPT-2 ``(B, T, 3, H, hd)`` split;
- GELU is the tanh approximation;
- masks use the finite ``-1e30``.

Three entry points, as in the reference:
- ``apply``: full causal forward → logits;
- ``prefill``: the same forward, also returning the per-layer K/V stacks
  ``(layers, B, T, H, hd)`` that seed the decode engine's ring cache;
- ``decode_step``: one token per row against the ring caches
  ``(layers, B, S, H, hd)``.  It writes this token's K/V at ``pos % S``
  before attending, and the caches are updated IN PLACE (the reference
  returns new arrays from a donated program).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .. import context as _context
from ..ops import nn as _nn
from ..ops.cuda_attention import causal_attention
from ._tree import (as_modules, from_modules, map_tree, params_from_numpy,
                    params_to)

__all__ = ["GPTConfig", "GPTModel", "init_params", "params_from_numpy",
           "apply", "prefill", "decode_step"]

# finite causal-mask value: softmax zeroes these exactly while a true
# -inf would turn fully masked rows into nan
_NEG_INF = -1e30


@dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_len: int = 1024
    dtype: torch.dtype = torch.float32


def _dense_init(gen, in_dim, out_dim, dtype):
    w = torch.randn(in_dim, out_dim, generator=gen) / math.sqrt(in_dim)
    return {"kernel": w.to(dtype), "bias": torch.zeros(out_dim, dtype=dtype)}


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (same scales as the reference).  They
    are drawn on the CPU with a ``torch.Generator`` and moved to
    ``device``, so one seed gives the same weights on every device."""
    device = _context.resolve(device)
    gen = torch.Generator().manual_seed(int(seed))
    d, dt = cfg.hidden, cfg.dtype

    def ones():
        return torch.ones(d, dtype=dt)

    def zeros():
        return torch.zeros(d, dtype=dt)

    params = {
        "embed": {
            "tok": (torch.randn(cfg.vocab_size, d, generator=gen)
                    * 0.02).to(dt),
            "pos": (torch.randn(cfg.max_len, d, generator=gen)
                    * 0.02).to(dt),
        },
        "layers": [],
        "ln_f_g": ones(), "ln_f_b": zeros(),
        "head": _dense_init(gen, d, cfg.vocab_size, dt),
    }
    for _ in range(cfg.layers):
        params["layers"].append({
            "qkv": _dense_init(gen, d, 3 * d, dt),     # per-head [q|k|v]
            "out": _dense_init(gen, d, d, dt),
            "ffn_in": _dense_init(gen, d, cfg.intermediate, dt),
            "ffn_out": _dense_init(gen, cfg.intermediate, d, dt),
            "ln1_g": ones(), "ln1_b": zeros(),
            "ln2_g": ones(), "ln2_b": zeros(),
        })
    return map_tree(params, lambda t: t.to(device))


def _proj(x, p):
    return torch.matmul(x, p["kernel"]) + p["bias"]


def _ffn(x, p):
    h = _nn.layer_norm(x, p["ln2_g"], p["ln2_b"])
    h = _nn.gelu(_proj(h, p["ffn_in"]))
    return x + _proj(h, p["ffn_out"])


def _layer_prefill(x, p, heads):
    """One pre-LN decoder block over the full prompt → (x', k, v) with
    k/v (B, T, H, hd) views into this layer's qkv projection."""
    B, T, D = x.shape
    H, hd = heads, D // heads
    h = _nn.layer_norm(x, p["ln1_g"], p["ln1_b"])
    t5 = _proj(h, p["qkv"]).view(B, T, H, 3, hd)
    q, k, v = t5[:, :, :, 0], t5[:, :, :, 1], t5[:, :, :, 2]
    ctx = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 1.0 / math.sqrt(hd))
    ctx = ctx.transpose(1, 2).reshape(B, T, D)
    x = x + _proj(ctx, p["out"])
    return _ffn(x, p), k, v


def _layer_step(x, p, heads, k_cache, v_cache, slot, valid):
    """One block for ONE token per row against the ring cache.  x (B, D);
    caches (B, S, H, hd), written in place; slot (B,) write index; valid
    (B, S) readable-slot mask.  Writes this token's K/V BEFORE attending
    — the current token always attends to itself."""
    B, D = x.shape
    H, hd = heads, D // heads
    h = _nn.layer_norm(x, p["ln1_g"], p["ln1_b"])
    t4 = _proj(h, p["qkv"]).view(B, H, 3, hd)
    q = t4[:, :, 0]
    rows = torch.arange(B, device=x.device)
    k_cache[rows, slot] = t4[:, :, 1]
    v_cache[rows, slot] = t4[:, :, 2]
    s = torch.einsum("bhd,bshd->bhs", q, k_cache) / math.sqrt(hd)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bshd->bhd", probs, v_cache)
    x = x + _proj(ctx.reshape(B, D), p["out"])
    return _ffn(x, p)


def _logits(params, x):
    h = _nn.layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    return torch.matmul(h, params["head"]["kernel"]).float() + \
        params["head"]["bias"].float()


def prefill(params, cfg: GPTConfig, tokens):
    """Full causal forward: tokens (B, T) int → (logits (B, T, vocab),
    k (layers, B, T, H, hd), v (same))."""
    B, T = tokens.shape
    e = params["embed"]
    x = e["tok"][tokens] + e["pos"][:T][None]
    ks, vs = [], []
    for p in params["layers"]:
        x, k, v = _layer_prefill(x, p, cfg.heads)
        ks.append(k)
        vs.append(v)
    return _logits(params, x), torch.stack(ks), torch.stack(vs)


def apply(params, cfg: GPTConfig, tokens):
    """Forward: tokens (B, T) int → logits (B, T, vocab)."""
    return prefill(params, cfg, tokens)[0]


def decode_step(params, cfg: GPTConfig, tok, pos, k_cache, v_cache):
    """One decode iteration: tok (B,) at absolute positions pos (B,),
    ring caches (layers, B, S, H, hd) → (logits (B, vocab), k_cache,
    v_cache), the caches updated in place.

    Ring discipline: token t lives at slot ``t % S``; a slot is readable
    once written — ``slot <= pos`` before the ring wraps, every slot
    after.  Positions past ``max_len`` clamp the position embedding; the
    engine evicts such rows before their output is read."""
    S = k_cache.shape[2]
    e = params["embed"]
    x = e["tok"][tok] + e["pos"][pos.clamp(0, cfg.max_len - 1)]
    slot = pos % S
    ar = torch.arange(S, device=pos.device)[None, :]
    valid = (ar <= pos[:, None]) | (pos[:, None] >= S)
    for i, p in enumerate(params["layers"]):
        x = _layer_step(x, p, cfg.heads, k_cache[i], v_cache[i], slot,
                        valid)
    return _logits(params, x), k_cache, v_cache


class GPTModel(nn.Module):
    """``nn.Module`` holding the params tree (frozen parameters with the
    tree's keys); ``model.params`` is the dict the functions take."""

    def __init__(self, cfg: Optional[GPTConfig] = None, params=None,
                 seed: int = 0, device=None, **overrides):
        super().__init__()
        self.cfg = cfg or GPTConfig(**overrides)
        if params is None:
            params = init_params(self.cfg, seed, device)
        else:
            params = params_to(params, _context.resolve(device))
        self.tree = as_modules(params)

    @property
    def params(self) -> Dict:
        return from_modules(self.tree)

    def forward(self, tokens):
        return apply(self.params, self.cfg, tokens)
