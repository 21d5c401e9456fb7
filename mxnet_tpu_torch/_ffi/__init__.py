"""mx._ffi — the PackedFunc-style function registry.

≙ ``mxnet_tpu/_ffi/`` (upstream ``python/mxnet/_ffi/``, the TVM-style
FFI): dynamically typed functions addressable by a dotted name
(``register_func("my.func")`` ↔ ``get_global_func("my.func")``).  The
port keeps the Python registry and its built-ins; the JAX package's
native functions (``MXTFunc*`` over ``libmxtpu_rt.so``) belong to a
library the port never loads.
"""
from __future__ import annotations

from .function import (Function, register_func, get_global_func,  # noqa: F401
                       list_global_func_names, remove_global_func)
