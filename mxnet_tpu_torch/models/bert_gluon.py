"""Gluon-block BERT (≙ ``mxnet_tpu/models/bert_gluon.py``: BERTModel,
BERTEncoder and the GluonNLP zoo's ``bert_12_768_12``).

The block tree and child names are the reference's, so ``collect_params``
gives the same dotted names and shapes
(``encoder.layer0.attention.qkv.weight``) and a ``.params`` file moves
between the two packages.  Layout is batch-major ``(B, T, D)``; the
decoder is the masked-LM head with untied weights.

Inside, the model is PyTorch: the two score products are
``torch.matmul`` (plain products outside any kernel, as in the
reference), and every LayerNorm block is the LayerNorm kernel (25
launches a forward).  The attention probabilities are
``softmax(where(mask, scores / sqrt(hd), -1e9))``: for fp32, bf16 or
fp16 scores that autograd does not record, one ``softmax_fused`` call
with the divisor and the key mask folded into the softmax kernel's load
(12 launches a BERT-base forward; in half precision the kernel rounds
the quotient and the mask value to the dtype, as the reference's
``scores / sqrt(hd)`` and ``where(mask, ·, -1e9)`` do); otherwise the
division, the mask and ``ops.nn.softmax`` (its autograd Function when
recording), as the reference composes them.  After ``net.cast("bfloat16")``
(``amp.convert_model``) every block runs on bf16 weights.
"""
from __future__ import annotations

import math

import torch

from ..gluon import nn
from ..ops import nn as _nn
from ..ops.cuda_kernels import softmax_fused, softmax_prologue_plain

__all__ = ["BERTSelfAttention", "BERTEncoderCell", "BERTEncoder",
           "BERTModel", "bert_12_768_12", "bert_small"]

# scores the softmax kernel takes with its prologue: fp32, bf16, fp16
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class BERTSelfAttention(nn.HybridBlock):
    """Multi-head self-attention with one fused QKV projection."""

    def __init__(self, units, heads, dropout=0.0):
        super().__init__()
        if units % heads:
            raise ValueError(f"units {units} not divisible by heads {heads}")
        self._units = units
        self._heads = heads
        self.qkv = nn.Dense(3 * units, flatten=False)
        self.proj = nn.Dense(units, flatten=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        B, T, D = x.shape
        H = self._heads
        hd = D // H
        qkv = self.qkv(x).reshape(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                # (B, H, T, hd)
        scores = torch.matmul(q, k.transpose(-1, -2))
        keep = None if mask is None else mask.reshape(B, T) != 0
        if scores.dtype in _KERNEL_DTYPES and not (
                torch.is_grad_enabled() and scores.requires_grad):
            # the scale and the key mask folded into the kernel's load
            attn = softmax_fused(scores, div=math.sqrt(hd), keep=keep)
        else:
            # the division and the mask as the reference composes them
            # (rounded to a half dtype), then the softmax
            attn = _nn.softmax(softmax_prologue_plain(
                scores, math.sqrt(hd), keep), axis=-1)
        if self.dropout is not None:
            attn = self.dropout(attn)
        ctx = torch.matmul(attn, v)                     # (B, H, T, hd)
        return self.proj(ctx.transpose(1, 2).reshape(B, T, D))


class BERTEncoderCell(nn.HybridBlock):
    """Post-LN transformer layer."""

    def __init__(self, units, heads, ffn_units, dropout=0.0):
        super().__init__()
        self.attention = BERTSelfAttention(units, heads, dropout)
        self.ln1 = nn.LayerNorm()
        self.ffn_in = nn.Dense(ffn_units, flatten=False)
        self.gelu = nn.GELU()
        self.ffn_out = nn.Dense(units, flatten=False)
        self.ln2 = nn.LayerNorm()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        a = self.attention(x, mask)
        if self.dropout is not None:
            a = self.dropout(a)
        x = self.ln1(x + a)
        h = self.ffn_out(self.gelu(self.ffn_in(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h)


class BERTEncoder(nn.HybridBlock):
    """Word, position and token-type embeddings, LayerNorm, then
    ``layers`` encoder cells (children ``layer0`` ...)."""

    def __init__(self, units=768, heads=12, layers=12, ffn_units=3072,
                 vocab_size=30522, max_length=512, type_vocab=2,
                 dropout=0.0):
        super().__init__()
        self._units = units
        self.word_embed = nn.Embedding(vocab_size, units)
        self.position_embed = nn.Embedding(max_length, units)
        self.token_type_embed = nn.Embedding(type_vocab, units)
        self.ln = nn.LayerNorm()
        self.dropout = nn.Dropout(dropout) if dropout else None
        self._cells = []
        for i in range(layers):
            cell = BERTEncoderCell(units, heads, ffn_units, dropout)
            setattr(self, f"layer{i}", cell)
            self._cells.append(cell)

    def forward(self, tokens, token_types=None, mask=None):
        T = tokens.shape[1]
        positions = torch.arange(T, device=tokens.device)
        x = self.word_embed(tokens) + self.position_embed(positions)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        for cell in self._cells:
            x = cell(x, mask)
        return x


class BERTModel(nn.HybridBlock):
    """Encoder + masked-LM decoder head (a Dense over the vocabulary,
    weights not tied to the word embedding)."""

    def __init__(self, units=768, heads=12, layers=12, ffn_units=3072,
                 vocab_size=30522, max_length=512, type_vocab=2,
                 dropout=0.0):
        super().__init__()
        self.encoder = BERTEncoder(units, heads, layers, ffn_units,
                                   vocab_size, max_length, type_vocab,
                                   dropout)
        self.decoder = nn.Dense(vocab_size, flatten=False)

    def forward(self, tokens, token_types=None, mask=None):
        return self.decoder(self.encoder(tokens, token_types, mask))


def bert_12_768_12(vocab_size=30522, **kwargs):
    """BERT-base ≙ the GluonNLP zoo's 'bert_12_768_12'."""
    return BERTModel(units=768, heads=12, layers=12, ffn_units=3072,
                     vocab_size=vocab_size, **kwargs)


def bert_small(vocab_size=1000, **kwargs):
    """Tiny config for tests and examples."""
    return BERTModel(units=64, heads=4, layers=2, ffn_units=128,
                     vocab_size=vocab_size, max_length=64, **kwargs)
