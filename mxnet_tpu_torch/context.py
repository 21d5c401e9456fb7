"""Devices (≙ ``mxnet_tpu/context.py`` ``cpu``/``gpu``/``num_gpus``).

The port's entry points run on the card unless the caller asks for the
CPU.  :func:`resolve` turns a caller's ``device`` argument into a
``torch.device``; with none given it is the card, and with no card it
raises rather than quietly running on the CPU.  :func:`exact_fp32` is
the one switch that keeps fp32 products in full fp32 on the card.
"""
from __future__ import annotations

import torch

__all__ = ["cpu", "gpu", "num_gpus", "default_device", "current_context",
           "current_device", "resolve", "waitall", "exact_fp32"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """The current CUDA device; raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: mxnet_tpu_torch runs on the GPU by default; "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def current_context() -> torch.device:
    """≙ ``mx.current_context()``: the device entry points run on when
    given none, :func:`default_device` (the port has no ``with``-scoped
    device stack)."""
    return default_device()


current_device = current_context


def waitall():
    """≙ ``mx.waitall()``: wait until every card this process has used
    has finished its queued work; nothing to wait for without one."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (a ``cuda`` device with no index
    gets the current one); None means :func:`default_device`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def exact_fp32():
    """Keep fp32 matrix products and convolutions in full fp32: TF32 off
    for cuBLAS and for cuDNN.  PyTorch leaves ``cudnn.allow_tf32`` True
    by default, so without this every cuDNN convolution would silently
    run in TF32 (about three decimal digits).  bf16 and fp16 products
    keep fp32 sums too (cuBLAS may otherwise reduce split sums in the
    half type), as the reference accumulates them.  Process-wide, as
    PyTorch's flags are; every entry point that runs on the card calls
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
