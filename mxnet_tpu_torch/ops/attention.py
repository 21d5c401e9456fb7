"""Transformer attention operators (≙ ``mxnet_tpu/ops/attention.py``,
itself ≙ ``src/operator/contrib/transformer.cc``).

Two families, in the reference's layouts:

- interleaved multi-head projections (``_contrib_interleaved_matmul_*``):
  QKᵀ and attention·V over the interleaved qkv projection gluon-nlp's
  BERT uses, ``(L, B, heads·3·D)`` → scores ``(B·heads, L, L)`` and back
  to ``(L, B, heads·D)``;
- sliding-window (Longformer) attention (``_contrib_sldwin_atten_*``):
  banded scores ``(B, L, H, D)`` → ``(B, L, H, w_len)`` with a dilation
  per head, the context product, and the 0/1 mask of valid positions.

The reference composes ``jnp.einsum`` and gathers that XLA fuses; no
Pallas kernel is involved, so here they are plain torch: ``torch.bmm``
/ ``torch.einsum`` and advanced indexing, differentiable by autograd as
the reference's are by JAX AD (the gathers' backward is a scatter-add,
as JAX's).  On the card the fp32 products run in full fp32 when TF32 is
off (``context.exact_fp32``, which every entry point calls).  Numbers
the reference computes in the input's dtype (the 1/√D scale, the causal
mask value) are computed in that dtype here too.
"""
from __future__ import annotations

import torch

__all__ = ["interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
           "sldwin_atten_score", "sldwin_atten_context",
           "sldwin_atten_mask_like"]


def _split_heads(x, heads, idx, parts):
    """(L, B, heads·parts·D) → (B·heads, L, D), slice ``idx`` of
    ``parts``."""
    L, B = x.shape[0], x.shape[1]
    t = x.reshape(L, B, heads, parts, -1)[:, :, :, idx, :]
    t = t.permute(1, 2, 0, 3)                   # (B, heads, L, D)
    return t.reshape(B * heads, L, -1)


def _merge_heads(out, heads):
    """(B·heads, L, D) → (L, B, heads·D)."""
    BH, L, D = out.shape
    out = out.reshape(BH // heads, heads, L, D).permute(2, 0, 1, 3)
    return out.reshape(L, BH // heads, heads * D)


def _scaled(q):
    """``q / √D`` with √D rounded to ``q``'s dtype first, as the
    reference's ``jnp.sqrt(jnp.asarray(D, q.dtype))`` is (√96 is 9.8125
    in bf16).  The root is taken on a CPU scalar: no copy to the card."""
    root = torch.tensor(float(q.shape[-1]), dtype=q.dtype).sqrt().item()
    return q / root


def interleaved_matmul_selfatt_qk(queries_keys_values, heads, causal=False):
    """(L, B, heads·3·D) interleaved qkv → scores (B·heads, L, L), q
    divided by √D first.  ``causal=True`` sets the scores above the
    diagonal to -1e30 in the scores' dtype: finite in fp32 and bf16,
    -inf in fp16, as in the reference."""
    q = _scaled(_split_heads(queries_keys_values, heads, 0, 3))
    k = _split_heads(queries_keys_values, heads, 1, 3)
    s = torch.bmm(q, k.transpose(1, 2))
    if causal:
        L = s.shape[-1]
        rows = torch.arange(L, device=s.device)[:, None]
        cols = torch.arange(L, device=s.device)[None, :]
        # cast from fp32, where it is finite: fp16 takes -inf as the
        # reference's cast does (a fill of fp16 with -1e30 would refuse)
        neg = s.new_full((), -1e30, dtype=torch.float32).to(s.dtype)
        s = torch.where(cols <= rows, s, neg)
    return s


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads):
    """attention (B·heads, L, L) · v → (L, B, heads·D)."""
    v = _split_heads(queries_keys_values, heads, 2, 3)
    return _merge_heads(torch.bmm(attention, v), heads)


def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """queries (Lq, B, heads·D) and interleaved kv (Lk, B, heads·2·D) →
    scores (B·heads, Lq, Lk), q divided by √D first."""
    Lq, B = queries.shape[0], queries.shape[1]
    q = queries.reshape(Lq, B, heads, -1).permute(1, 2, 0, 3) \
        .reshape(B * heads, Lq, -1)
    k = _split_heads(keys_values, heads, 0, 2)
    return torch.bmm(_scaled(q), k.transpose(1, 2))


def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    """interleaved kv (Lk, B, heads·2·D) and attention (B·heads, Lq, Lk)
    → (Lq, B, heads·D)."""
    v = _split_heads(keys_values, heads, 1, 2)
    return _merge_heads(torch.bmm(attention, v), heads)


# ------------------------------------------------ sliding window (Longformer)
def _window_offsets(w, symmetric, device):
    """Symmetric: offsets -w..w (w_len = 2w + 1); else -w..0 (w + 1)."""
    return torch.arange(-w, w + 1 if symmetric else 1, device=device)


def _key_positions(L, w, dilation, symmetric):
    """(H, L, w_len) key index of each (head, query, window slot), clipped
    into [0, L), and whether it was in range before the clip."""
    offs = _window_offsets(w, symmetric, dilation.device)
    pos = (torch.arange(L, device=dilation.device)[None, :, None]
           + offs[None, None, :] * dilation[:, None, None])
    valid = (pos >= 0) & (pos < L)
    return pos.clamp(0, L - 1), valid


def _dilation(dilation, device):
    return torch.as_tensor(dilation, device=device).long()


def _gather_keys(x, pos):
    """x (B, L, H, D) at ``pos`` (H, L, w_len) → (B, H, L, w_len, D): one
    ``index_select`` over the (head, position) rows, whose backward is a
    scatter-add (``index_add_``) as JAX's gather's is."""
    B, L, H, D = x.shape
    rows = x.permute(0, 2, 1, 3).reshape(B, H * L, D)
    heads = torch.arange(H, device=x.device)[:, None, None]
    idx = (heads * L + pos).reshape(-1)
    return rows.index_select(1, idx).reshape(B, *pos.shape, D)


def sldwin_atten_score(query, key, dilation, w, symmetric=True):
    """Banded scores: query and key (B, L, H, D), dilation (H,) → (B, L,
    H, w_len); a key position outside [0, L) is gathered clipped and
    scored 0 (not -inf), as in the reference."""
    L = query.shape[1]
    pos, valid = _key_positions(L, w, _dilation(dilation, query.device),
                                symmetric)
    kg = _gather_keys(key, pos)
    qh = query.permute(0, 2, 1, 3)              # (B, H, L, D)
    score = torch.einsum("bhid,bhijd->bhij", qh, kg)
    score = torch.where(valid[None], score, score.new_zeros(()))
    return score.permute(0, 2, 1, 3)


def sldwin_atten_context(score, value, dilation, w, symmetric=True):
    """score (B, L, H, w_len) · value (B, L, H, D) → (B, L, H, D); the
    weight of an out-of-range key position is zeroed before the
    product."""
    L = score.shape[1]
    pos, valid = _key_positions(L, w, _dilation(dilation, score.device),
                                symmetric)
    vg = _gather_keys(value, pos)
    sh = score.permute(0, 2, 1, 3)              # (B, H, L, w_len)
    sh = torch.where(valid[None], sh, sh.new_zeros(()))
    out = torch.einsum("bhij,bhijd->bhid", sh, vg)
    return out.permute(0, 2, 1, 3)


def sldwin_atten_mask_like(score, dilation, valid_length, w,
                           symmetric=True):
    """The 0/1 mask of ``score``'s valid window slots, in its dtype
    (the reference's index arithmetic, transformer-inl.h
    SldWinAttenMaskLike): a slot is 0 where its key lies before the
    sequence start, the query lies at or past ``valid_length`` (B,), or
    (symmetric) its key lies at or past ``valid_length``.  The floor
    divisions floor toward -inf on negative numerators, as ``jnp``'s
    ``//`` does."""
    B, L, H, w_len = score.shape
    dev = score.device
    d = _dilation(dilation, dev)[None, None, :, None]
    vl = torch.as_tensor(valid_length, device=dev).long()[:, None, None,
                                                          None]
    i = torch.arange(L, device=dev)[None, :, None, None]
    j = torch.arange(w_len, device=dev)[None, None, None, :]
    zero = (j < (w - torch.div(i, d, rounding_mode="floor"))) | (i >= vl)
    if symmetric:
        zero = zero | ((w_len - j - 1) <
                       (w - torch.div(vl - i - 1, d, rounding_mode="floor")))
    return torch.where(zero, 0.0, 1.0).to(score.dtype)
