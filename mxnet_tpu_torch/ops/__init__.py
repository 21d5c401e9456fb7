"""Ops of the port: each kernel with its plain version, and the nn ops
the GPT slice composes."""
from .cuda_attention import causal_attention, causal_attention_plain
from .cuda_kernels import layernorm_fused, layernorm_plain
from .nn import gelu, layer_norm

__all__ = ["causal_attention", "causal_attention_plain", "layernorm_fused",
           "layernorm_plain", "gelu", "layer_norm"]
