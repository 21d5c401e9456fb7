"""Ops of the port: each kernel with its plain version, and the nn ops
the GPT and BERT slices compose."""
from .cuda_attention import causal_attention, causal_attention_plain
from .cuda_kernels import (LayerNormFn, layernorm_bwd, layernorm_fused,
                           layernorm_plain)
from .flash_attention import (attention_dkv, attention_dkv_plain,
                              attention_dq, attention_dq_plain,
                              attention_fused, attention_fwd,
                              attention_fwd_plain)
from .nn import gelu, layer_norm

__all__ = ["causal_attention", "causal_attention_plain", "layernorm_fused",
           "layernorm_plain", "layernorm_bwd", "LayerNormFn",
           "attention_fused", "attention_fwd", "attention_dq",
           "attention_dkv", "attention_fwd_plain", "attention_dq_plain",
           "attention_dkv_plain", "gelu", "layer_norm"]
