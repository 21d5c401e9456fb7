"""AMP op lists (≙ ``mxnet_tpu/amp/lists.py``): which ops run in the
target dtype, which stay fp32, which cast to the widest dtype present.

Only ``TARGET_DTYPE_OPS`` is acted on, by :func:`mxnet_tpu_torch.amp.init`,
as in the reference; the other two lists document the split.  Names are
attributes of ``mxnet_tpu_torch.ops.nn``; a name the port does not have
is skipped.
"""

# ops (names in mxnet_tpu_torch.ops.nn) cast to the target dtype: the
# matrix products and convolutions, which the tensor cores run in bf16
TARGET_DTYPE_OPS = [
    "fully_connected",
    "dense",
    "convolution",
    "conv_transpose",
]

# ops kept in fp32: bandwidth-bound or numerically sensitive
FP32_OPS = [
    "softmax", "log_softmax", "masked_softmax", "masked_log_softmax",
    "batch_norm", "layer_norm", "instance_norm", "group_norm", "rms_norm",
    "softmax_cross_entropy", "l2_normalize",
]

# ops that cast all inputs to the widest dtype present (≙ amp_multicast)
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "where", "concatenate", "stack",
]
