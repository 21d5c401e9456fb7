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

__all__ = ["SOURCE", "EXPORTS", "module", "grid_1d", "grid_axpy",
           "vector_path", "axpy", "double", "axpy_plain", "double_plain"]

SOURCE = Path(__file__).resolve().with_name("rtc_kernels.cu")
EXPORTS = ("double_it<float>", "double_it<int>")
THREADS = 256
BLOCKS_PER_SM = 8
AXPY_ITEMS = 4          # items (float4 vectors, or floats) a thread
AXPY_VEC = 4            # floats a 16-byte vector
MAX_BLOCKS = 2 ** 31 - 1


def module() -> rtc.CudaModule:
    return rtc.CudaModule(SOURCE.read_text(), exports=EXPORTS)


_sms = {}


def grid_1d(n: int, device) -> tuple:
    """Enough 256-thread blocks for ``n`` elements, at most 8 an SM (the
    kernel loops over the rest): ``double_it``'s launch."""
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return (max(1, min(-(-n // THREADS), sms * BLOCKS_PER_SM)),)


def grid_axpy(n: int, vector: bool) -> tuple:
    """One 256-thread block per four items a thread: 256 x 4 x 4 floats
    on the 16-byte path, 256 x 4 on the scalar one (the kernel loops over
    what the grid does not cover, so any grid is right)."""
    per_block = THREADS * AXPY_ITEMS * (AXPY_VEC if vector else 1)
    return (max(1, min(-(-n // per_block), MAX_BLOCKS)),)


def vector_path(*tensors) -> bool:
    """Whether ``axpy`` on these operands (x, y and its output) takes the
    16-byte path: the kernel's own test, every pointer 16-byte aligned,
    with at least one vector to move."""
    return tensors[0].numel() >= AXPY_VEC and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def axpy(kern, x, y):
    """``o = 2x + y`` by the rtc kernel ``axpy``, on a grid sized for the
    path the kernel will take (its output is a new, aligned tensor)."""
    n = x.numel()
    return kern.launch([x, y, n], grid=grid_axpy(n, vector_path(x, y)),
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
