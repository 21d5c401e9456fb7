"""The rtc route's example user kernels (``rtc_kernels.cu``: axpy and
the out-dtype-templated ``double_it``, the JAX package's rtc test
kernels as CUDA source) with their plain PyTorch versions and a 1-D
launch, as a user of ``rtc.CudaModule`` writes them.

    mod = rtc_example.module()
    out = rtc_example.axpy(mod.get_kernel("axpy"), x, y)   # 2x + y

``chip_smoke.py`` launches them on the card and holds them against the
plain versions; the CPU tests hold the plain versions against the JAX
package's Pallas kernels.
"""
from __future__ import annotations

from pathlib import Path

import torch

from .. import rtc

__all__ = ["SOURCE", "EXPORTS", "module", "grid_1d", "axpy", "double",
           "axpy_plain", "double_plain"]

SOURCE = Path(__file__).resolve().with_name("rtc_kernels.cu")
EXPORTS = ("double_it<float>", "double_it<int>")
THREADS = 256
BLOCKS_PER_SM = 8


def module() -> rtc.CudaModule:
    return rtc.CudaModule(SOURCE.read_text(), exports=EXPORTS)


_sms = {}


def grid_1d(n: int, device) -> tuple:
    """Enough 256-thread blocks for ``n`` elements, at most 8 an SM (the
    kernels loop over the rest)."""
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return (max(1, min(-(-n // THREADS), sms * BLOCKS_PER_SM)),)


def axpy(kern, x, y):
    """``o = 2x + y`` by the rtc kernel ``axpy``."""
    n = x.numel()
    return kern.launch([x, y, n], grid=grid_1d(n, x.device),
                       block=(THREADS,))


def double(kern, x, dtype=torch.float32):
    """``o = dtype(2x)`` by the templated rtc kernel ``double_it``."""
    n = x.numel()
    return kern.launch([x, n], grid=grid_1d(n, x.device), block=(THREADS,),
                       out_dtype=dtype)


def axpy_plain(x, y):
    return x * 2.0 + y


def double_plain(x, dtype=torch.float32):
    return (x * 2.0).to(dtype)
